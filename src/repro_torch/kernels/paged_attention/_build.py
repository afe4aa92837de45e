"""Build and load the paged-attention CUDA kernel (``csrc/paged_attention.cu``)
through :mod:`repro_torch.kernels._nvcc`, at first use."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels import _nvcc

SOURCE = Path(__file__).parent / "csrc" / "paged_attention.cu"


def load() -> tuple[ctypes.CDLL, str]:
    """Build if needed, load, and declare the C entry points' types."""
    path, output = _nvcc.build(SOURCE)
    lib = ctypes.CDLL(str(path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_attention_decode.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,   # tensors
        ptr, ptr,                                           # workspace, launch counter
        i32, i32, i32, i32, i32, i32, i32, i32,             # B H KH D T P splits cols
        i32, i32, f32, f32, i32,                            # dtypes, scale, cap, window
        ptr,                                                # stream
    ]
    lib.paged_attention_decode.restype = i32
    lib.paged_attention_decode_smem.argtypes = [i32, i32, i32, i32]
    lib.paged_attention_decode_smem.restype = ctypes.c_size_t
    return lib, output
