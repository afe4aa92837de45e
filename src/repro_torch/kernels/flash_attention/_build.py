"""Build and load the flash-attention CUDA kernels through
:mod:`repro_torch.kernels._nvcc`, at first use: the forward
(``csrc/flash_attention.cu``) and the backward
(``csrc/flash_attention_bwd.cu``), each its own ``nvcc`` build."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels import _nvcc

SOURCE = Path(__file__).parent / "csrc" / "flash_attention.cu"
BWD_SOURCE = Path(__file__).parent / "csrc" / "flash_attention_bwd.cu"


def load() -> tuple[ctypes.CDLL, str]:
    """Build the forward if needed, load, and declare its C entry point's types."""
    path, output = _nvcc.build(SOURCE)
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.flash_attention_fwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,           # q k v kv_lengths out lse
        i32, i32, i32, i32, i32, i32, i32,      # B H KH Sq Skv D dtype
        *[i64] * 12,                            # strides of q, k, v, out
        f32, f32,                               # scale, softcap
        i32, i32, i32, i32, i32,                # causal window q_offset hole_lo hole_hi
        ptr, ptr,                               # hole_lo on the device, launch counter
        ptr,                                    # stream
    ]
    lib.flash_attention_fwd.restype = i32
    for name in ("flash_attention_smem", "flash_attention_mma_smem"):
        getattr(lib, name).argtypes = [i32]
        getattr(lib, name).restype = ctypes.c_size_t
    return lib, output


def load_bwd() -> tuple[ctypes.CDLL, str]:
    """Build the backward if needed, load, and declare its C entry point's types."""
    path, output = _nvcc.build(BWD_SOURCE)
    lib = ctypes.CDLL(str(path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_bwd.argtypes = [
        *[ptr] * 10,                            # q k v o dout lse di dq dk dv
        i32, i32, i32, i32, i32, i32, i32, i32, # B H KH Sq Skv D dtype route
        ctypes.POINTER(ctypes.c_longlong),      # 24 strides: (b, h, s) of q k v o dout dq dk dv
        f32, f32, i32, i32,                     # scale, softcap, causal, window
        ptr,                                    # stream
    ]
    lib.flash_attention_bwd.restype = i32
    lib.flash_attention_bwd_smem.argtypes = [i32]
    lib.flash_attention_bwd_smem.restype = ctypes.c_size_t
    lib.flash_attention_bwd_mma_smem.argtypes = [i32, i32]
    lib.flash_attention_bwd_mma_smem.restype = ctypes.c_size_t
    return lib, output
