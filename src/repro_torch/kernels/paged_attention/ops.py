"""Public entry points of paged decode attention.

The wrapper chooses by the tensors' device, with no flag: CUDA tensors
launch the Hopper kernel (``csrc/paged_attention.cu``) or raise; CPU
tensors take the plain PyTorch version in ``ref.py``. There is no
fallback from the kernel to the plain version.

``paged_attention_decode`` is the serving hot path: the current token's
``k_new``/``v_new`` ``[B, KH, D]`` (global position ``lengths - 1``) are
operands, read in place of the pool at that position, so the layer loop
never writes the pool; the model commits every layer's append once after
the loop. On an int8 pool the new token is attended at full precision,
as the plain version does. ``paged_attention`` is the same kernel with no
new token. Optional ``k_scales``/``v_scales`` ``[N]`` f32 are the per-page
dequant sidecars of an int8 pool; ``None`` means bf16 (or f32) pages.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.ref import (
    paged_attention_decode_ref,
    paged_attention_ref,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


class PagedAttentionKernel:
    """The CUDA kernel behind the wrapper: built and loaded at its first
    launch, never at import. ``launches`` counts the kernel's launches and
    nothing else (calls that took the plain version do not count)."""

    def __init__(self):
        self.launches = 0
        self.build_log = ""
        self._lib = None

    def load(self):
        if self._lib is None:
            from repro_torch.kernels.paged_attention import _build

            self._lib, self.build_log = _build.load()
        return self._lib

    def __call__(self, q, k_new, v_new, k_pages, v_pages, block_tables, lengths,
                 k_scales, v_scales, *, softcap, window):
        B, H, D = _shape(q, 3, "q")
        N, T, KH, D_k = _shape(k_pages, 4, "k_pages")
        P = _shape(block_tables, 2, "block_tables")[1]
        dev = q.device
        tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
                   "block_tables": block_tables, "lengths": lengths}
        if k_new is not None:
            tensors.update(k_new=k_new, v_new=v_new)
        if k_scales is not None:
            tensors.update(k_scales=k_scales, v_scales=v_scales)
        for name, t in tensors.items():
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, q on {dev}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if D_k != D or H % KH or tuple(v_pages.shape) != tuple(k_pages.shape):
            raise ValueError(
                f"shapes disagree: q {tuple(q.shape)}, k_pages {tuple(k_pages.shape)}, "
                f"v_pages {tuple(v_pages.shape)}"
            )
        if q.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"q must be float32 or bfloat16, not {q.dtype}")
        if k_pages.dtype not in _DTYPE_CODES or v_pages.dtype != k_pages.dtype:
            raise TypeError(f"pages must share a dtype in {list(_DTYPE_CODES)}")
        if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
            raise TypeError("block_tables and lengths must be int32")
        if tuple(lengths.shape) != (B,) or block_tables.shape[0] != B:
            raise ValueError("block_tables and lengths must have one row per query")
        if k_new is not None and (
            k_new.dtype != q.dtype or v_new.dtype != q.dtype
            or tuple(k_new.shape) != (B, KH, D) or tuple(v_new.shape) != (B, KH, D)
        ):
            raise ValueError(f"k_new/v_new must be {(B, KH, D)} in {q.dtype}")
        quantized = k_pages.dtype == torch.int8
        if quantized != (k_scales is not None) or (k_scales is None) != (v_scales is None):
            raise ValueError("int8 pages take k_scales and v_scales; other pages take neither")
        if quantized and (
            k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32
            or tuple(k_scales.shape) != (N,) or tuple(v_scales.shape) != (N,)
        ):
            raise ValueError(f"k_scales/v_scales must be float32 of shape {(N,)}")
        if window is not None and window <= 0:
            raise ValueError(f"window must be positive, not {window}")
        if softcap is not None and softcap <= 0:
            raise ValueError(f"softcap must be positive, not {softcap}")

        lib = self.load()
        out = torch.empty_like(q)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.paged_attention_decode(
                q.data_ptr(),
                k_new.data_ptr() if k_new is not None else None,
                v_new.data_ptr() if v_new is not None else None,
                k_pages.data_ptr(), v_pages.data_ptr(),
                block_tables.data_ptr(), lengths.data_ptr(),
                k_scales.data_ptr() if quantized else None,
                v_scales.data_ptr() if quantized else None,
                out.data_ptr(),
                B, H, KH, D, T, P,
                _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pages.dtype],
                D ** -0.5, softcap or 0.0, window or 0,
                stream,
            )
        if err != 0:
            raise RuntimeError(f"paged_attention_decode launch failed: CUDA error {err}")
        self.launches += 1
        return out


def _shape(t, ndim: int, name: str):
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, has shape {tuple(t.shape)}")
    return t.shape


#: the one kernel instance the wrappers launch; its ``launches`` is the
#: count a run reads to show that decode went through the kernel
KERNEL = PagedAttentionKernel()


def paged_attention(
    q, k_pages, v_pages, block_tables, lengths,
    k_scales=None, v_scales=None, *, softcap=None, window=None,
):
    """Decode attention over a paged KV pool (layouts in ``csrc``)."""
    if q.is_cuda:
        return KERNEL(
            q, None, None, k_pages, v_pages, block_tables, lengths,
            k_scales, v_scales, softcap=softcap, window=window,
        )
    return paged_attention_ref(
        q, k_pages, v_pages, block_tables, lengths, k_scales, v_scales,
        softcap=softcap, window=window,
    )


def paged_attention_decode(
    q, k_new, v_new, k_pages, v_pages, block_tables, lengths,
    k_scales=None, v_scales=None, *, softcap=None, window=None,
):
    """Decode attention for a token whose KV is not yet in the pool."""
    if q.is_cuda:
        return KERNEL(
            q, k_new, v_new, k_pages, v_pages, block_tables, lengths,
            k_scales, v_scales, softcap=softcap, window=window,
        )
    return paged_attention_decode_ref(
        q, k_new, v_new, k_pages, v_pages, block_tables, lengths,
        k_scales, v_scales, softcap=softcap, window=window,
    )
