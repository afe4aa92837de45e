"""Build a kernel's CUDA source into a shared library with ``nvcc``.

Every kernel of the port is one ``csrc/*.cu`` file with a plain C
interface (it may include ``*.cuh`` headers beside it), compiled alone
for ``sm_90a`` at its first launch and loaded with ``ctypes``. The
library lands in the kernel's ``build/`` directory (listed in
``.gitignore``) under a name that carries a hash of the source, its
headers and the flags, so an edit rebuilds and an unchanged source loads
what an earlier call built. Nothing here runs at import time.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

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
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def library_path(source: Path) -> Path:
    """The library's path: the hash covers the source, the headers beside it
    (``*.cuh``, which a source includes) and the flags."""
    headers = sorted(source.parent.glob("*.cuh"))
    digest = hashlib.sha256(b"".join(h.read_bytes() for h in (source, *headers))
                            + " ".join(NVCC_FLAGS).encode())
    return source.parent.parent / "build" / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"


def build(source: Path) -> tuple[Path, str]:
    """Compile ``source`` if it has not been built yet. Returns the
    library's path and the compiler's output (registers, shared memory
    and spills per kernel, from ``-Xptxas -v``)."""
    lib = library_path(source)
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, log.read_text() if log.exists() else ""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    output = res.stdout + res.stderr
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{output}")
    log.write_text(output)
    os.replace(tmp, lib)
    return lib, output


class Kernel:
    """A CUDA kernel behind a wrapper: built and loaded by ``loader`` (a
    ``_build.load``) at its first launch, never at import. ``launches``
    counts the wrapper's launches of the kernel and nothing else: calls
    that took the plain version on CPU tensors do not count. A kernel with
    several routes names them (``routes``), and its wrapper counts its
    launches by route there too. A kernel that counts its own launches on
    the device takes :meth:`counter`'s address, and
    :meth:`device_launches` reads it: a replayed graph calls no wrapper,
    so only the device sees its launches."""

    def __init__(self, loader, routes=()):
        self.launches = 0
        #: launches by route
        self.routes = dict.fromkeys(routes, 0)
        self.build_log = ""
        self._lib = None
        self._loader = loader
        self._counters: dict[int, torch.Tensor] = {}

    def load(self):
        if self._lib is None:
            self._lib, self.build_log = self._loader()
        return self._lib

    def counter(self, dev: torch.device) -> torch.Tensor:
        """The device's launch counter: one int32, allocated at the first
        launch on the device and kept, so a captured graph's kernels add to
        the same address at every replay. A graph captures a launch only
        after its eager warm-up run, which allocates the counter first."""
        idx = _device_index(dev)
        if idx not in self._counters:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("the launch counter must exist before a capture")
            self._counters[idx] = torch.zeros(1, dtype=torch.int32, device=dev)
        return self._counters[idx]

    def device_launches(self, dev) -> int:
        """Launches the card ran on ``dev`` since the counter's first
        launch, in or out of graphs (reads the device: a sync)."""
        counter = self._counters.get(_device_index(torch.device(dev)))
        return 0 if counter is None else int(counter.item())


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def aligned(t: torch.Tensor) -> bool:
    """Rows start on 16-byte boundaries, as ``cp.async`` needs: the pointer,
    and every stride but the last, in whole 16-byte steps."""
    step = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(st % step == 0 for st in t.stride()[:-1])


def records_grad(*operands) -> bool:
    """Whether autograd would record a call on ``operands`` (None entries
    ignored): grad enabled and an operand that requires grad. A wrapper
    with no backward kernel raises then, rather than return a result
    without a gradient."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in operands)


def check_status(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
