"""Build and load the SSD scan's CUDA kernels through
:mod:`repro_torch.kernels._nvcc`, at first use: the forward
(``csrc/ssd.cu``) and the backward (``csrc/ssd_bwd.cu``), each its own
``nvcc`` build."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels import _nvcc

SOURCE = Path(__file__).parent / "csrc" / "ssd.cu"
BWD_SOURCE = Path(__file__).parent / "csrc" / "ssd_bwd.cu"


def load() -> tuple[ctypes.CDLL, str]:
    """Build the forward if needed, load, and declare its C entry points' types."""
    path, output = _nvcc.build(SOURCE)
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr,      # x dt A B C y final_state
        ptr,                                    # workspace (tensor-core route)
        i32, i32, i32, i32, i32, i32,           # B S H P N Q
        i32, i32,                               # dtypes of x and B/C
        i64, i64, i64, i64, i64, i64, i64, i64, i64,   # strides
        i32, i32, i32,                          # route, state splits, P splits
        ptr,                                    # stream
    ]
    lib.ssd_scan.restype = i32
    lib.ssd_smem.argtypes = [i32, i32, i32]
    lib.ssd_smem.restype = ctypes.c_size_t
    return lib, output


def load_bwd() -> tuple[ctypes.CDLL, str]:
    """Build the backward if needed, load, and declare its C entry points' types."""
    path, output = _nvcc.build(BWD_SOURCE)
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_bwd.argtypes = [
        *[ptr] * 7,                             # x dt A B C dy dfinal
        *[ptr] * 5,                             # dx ddt dA dB dC
        ptr,                                    # workspace
        i32, i32, i32, i32, i32, i32,           # B S H P N Q
        i32, i32,                               # dtypes of x (and dy) and B/C
        ctypes.POINTER(ctypes.c_longlong),      # 12 strides: x (b, s, h), dt, B, C (b, s), dy
        i32,                                    # route
        ptr,                                    # stream
    ]
    lib.ssd_bwd.restype = i32
    lib.ssd_bwd_smem.argtypes = [i32, i32, i32, i32]   # P N Q route
    lib.ssd_bwd_smem.restype = ctypes.c_size_t
    return lib, output
