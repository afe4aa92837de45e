"""Public entry point of the Mamba-2 SSD scan.

The wrapper chooses by the tensors' device, with no flag: CUDA tensors
launch the Hopper kernel (``csrc/ssd.cu``) or raise; CPU tensors take the
plain PyTorch version, ``ssd_reference``. There is no fallback from the
kernel to the plain version.

``ssd(x, dt, A, Bm, Cm, chunk=128)`` is the counterpart of
``repro.kernels.ssd``: x ``[B, S, H, P]``, dt ``[B, S, H]`` f32 (after
softplus), A ``[H]`` f32, and a single B/C group as ``[B, S, N]`` or
``[B, S, 1, N]``. Returns y ``[B, S, H, P]`` in x's dtype and the final
state ``[B, H, P, N]`` f32. Unlike the Pallas kernel, S need not be a
multiple of ``chunk``: the tail is masked as the plain version pads it.
Inputs may be strided views (the model passes slices of its fused
projection) as long as their last dimension is contiguous.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _nvcc
from repro_torch.kernels.ssd import _build
from repro_torch.kernels.ssd.ref import ssd_reference

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: shared memory a block may use on Hopper (bytes)
_SMEM_LIMIT = 232448


class SsdKernel(_nvcc.Kernel):
    """The CUDA kernel behind the wrapper (see :class:`_nvcc.Kernel`)."""

    def __init__(self):
        super().__init__(_build.load)

    def __call__(self, x, dt, A, Bm, Cm, *, chunk: int):
        if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 3 or Cm.dim() != 3:
            raise ValueError(
                f"want x [B,S,H,P], dt [B,S,H], A [H], B/C [B,S,N]; got {tuple(x.shape)}, "
                f"{tuple(dt.shape)}, {tuple(A.shape)}, {tuple(Bm.shape)}, {tuple(Cm.shape)}"
            )
        Bsz, S, H, P = x.shape
        N = Bm.shape[-1]
        if (tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,)
                or tuple(Bm.shape) != (Bsz, S, N) or tuple(Cm.shape) != (Bsz, S, N)):
            raise ValueError(
                f"shapes disagree: x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
                f"B {tuple(Bm.shape)}, C {tuple(Cm.shape)}"
            )
        dev = x.device
        for name, t in {"dt": dt, "A": A, "B": Bm, "C": Cm}.items():
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, x on {dev}")
            if t.stride(-1) != 1:
                raise ValueError(f"{name} must be contiguous in its last dimension")
        if x.stride(-1) != 1:
            raise ValueError("x must be contiguous in its last dimension")
        if x.dtype not in _DTYPE_CODES or Bm.dtype not in _DTYPE_CODES or Cm.dtype != Bm.dtype:
            raise TypeError(f"x and B/C must be float32 or bfloat16 (B and C alike), "
                            f"not {x.dtype}, {Bm.dtype}, {Cm.dtype}")
        if dt.dtype != torch.float32 or A.dtype != torch.float32:
            raise TypeError(f"dt and A must be float32, not {dt.dtype}, {A.dtype}")
        if chunk <= 0:
            raise ValueError(f"chunk must be positive, not {chunk}")

        lib = self.load()
        smem = lib.ssd_smem(P, N, chunk)
        if smem > _SMEM_LIMIT:
            raise ValueError(f"P={P}, N={N}, chunk={chunk} need {smem} B of shared memory, "
                             f"more than {_SMEM_LIMIT}")
        y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=dev)
        final_state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.ssd_scan(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                y.data_ptr(), final_state.data_ptr(),
                Bsz, S, H, P, N, chunk, _DTYPE_CODES[x.dtype], _DTYPE_CODES[Bm.dtype],
                x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1),
                Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
                stream,
            )
        _nvcc.check_status(err, "ssd_scan")
        self.launches += 1
        return y, final_state


#: the one kernel instance the wrapper launches; its ``launches`` is the
#: count a run reads to show that prefill went through the kernel
KERNEL = SsdKernel()


def ssd(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """Mamba-2 SSD scan. x [B,S,H,P]; B/C [B,S,N] or [B,S,1,N] (one group)."""
    if Bm.dim() == 4:
        if Bm.shape[2] != 1 or Cm.shape[2] != 1:
            raise ValueError("ssd takes a single B/C group")
        Bm, Cm = Bm[:, :, 0, :], Cm[:, :, 0, :]
    if x.is_cuda:
        return KERNEL(x, dt, A, Bm, Cm, chunk=chunk)
    return ssd_reference(x, dt, A, Bm[:, :, None, :], Cm[:, :, None, :], chunk=chunk)
