"""Build and load the SSD scan CUDA kernel (``csrc/ssd.cu``) through
:mod:`repro_torch.kernels._nvcc`, at first use."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels import _nvcc

SOURCE = Path(__file__).parent / "csrc" / "ssd.cu"


def load() -> tuple[ctypes.CDLL, str]:
    """Build if needed, load, and declare the C entry points' types."""
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
