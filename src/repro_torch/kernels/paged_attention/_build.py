"""Build and load the paged-attention CUDA kernel.

``nvcc`` compiles ``csrc/paged_attention.cu`` alone into a shared library
with a plain C interface, for ``sm_90a``, at first use. The library lands
in ``build/`` beside this file (listed in ``.gitignore``) under a name
that carries a hash of the source and flags, so an edit rebuilds and an
unchanged source loads what an earlier call built. Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCE = Path(__file__).parent / "csrc" / "paged_attention.cu"
BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """The CUDA compiler: on ``PATH``, else under the toolkit PyTorch
    found (``torch.utils.cpp_extension.CUDA_HOME``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the paged-attention kernel cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpaged_attention_{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the kernel if this source has not been built yet. Returns
    the library's path and the compiler's output (registers, shared
    memory and spills per kernel, from ``-Xptxas -v``)."""
    lib = library_path()
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    output = res.stdout + res.stderr
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{output}")
    log.write_text(output)
    os.replace(tmp, lib)
    return lib, output


def load() -> tuple[ctypes.CDLL, str]:
    """Build if needed, load, and declare the C entry points' types."""
    path, output = build()
    lib = ctypes.CDLL(str(path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_attention_decode.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,   # tensors
        i32, i32, i32, i32, i32, i32,                       # B H KH D T P
        i32, i32, f32, f32, i32,                            # dtypes, scale, cap, window
        ptr,                                                # stream
    ]
    lib.paged_attention_decode.restype = i32
    lib.paged_attention_decode_smem.argtypes = [i32, i32, i32]
    lib.paged_attention_decode_smem.restype = ctypes.c_size_t
    return lib, output
