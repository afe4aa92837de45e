"""Build and load the flash-attention CUDA kernel
(``csrc/flash_attention.cu``) through :mod:`repro_torch.kernels._nvcc`, at
first use."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels import _nvcc

SOURCE = Path(__file__).parent / "csrc" / "flash_attention.cu"


def load() -> tuple[ctypes.CDLL, str]:
    """Build if needed, load, and declare the C entry point's types."""
    path, output = _nvcc.build(SOURCE)
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.flash_attention_fwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr,                # q k v kv_lengths out
        i32, i32, i32, i32, i32, i32, i32,      # B H KH Sq Skv D dtype
        *[i64] * 12,                            # strides of q, k, v, out
        f32, f32,                               # scale, softcap
        i32, i32, i32, i32, i32,                # causal window q_offset hole_lo hole_hi
        ptr,                                    # stream
    ]
    lib.flash_attention_fwd.restype = i32
    for name in ("flash_attention_smem", "flash_attention_mma_smem"):
        getattr(lib, name).argtypes = [i32]
        getattr(lib, name).restype = ctypes.c_size_t
    return lib, output
