"""Public entry points of paged decode attention.

The wrapper chooses by the tensors' device, with no flag: CUDA tensors
launch the Hopper kernel (``csrc/paged_attention.cu``) or raise; CPU
tensors take the plain PyTorch version in ``ref.py``. There is no
fallback from the kernel to the plain version. The kernel has no
backward: a CUDA call that autograd would record raises
``NotImplementedError`` instead of returning a result without a gradient.

``paged_attention_decode`` is the serving hot path: the current token's
``k_new``/``v_new`` ``[B, KH, D]`` (global position ``lengths - 1``) are
operands, read in place of the pool at that position, so the layer loop
never writes the pool; the model commits every layer's append once after
the loop. On an int8 pool the new token is attended at full precision,
as the plain version does. ``paged_attention`` is the same kernel with no
new token. Optional ``k_scales``/``v_scales`` ``[N]`` f32 are the per-page
dequant sidecars of an int8 pool; ``None`` means bf16 (or f32) pages.

The kernel splits the block table's columns into ranges (flash-decoding):
``_split_plan`` chooses them on the host from the table's width and the
card's SM count, each range's partial softmax state goes to an f32
workspace ``[B, H, splits, D + 2]`` that the wrapper allocates per call on
q's device, and a second pass inside the same C call merges the partials.
``ref.paged_attention_split_ref`` is that decomposition in plain PyTorch.

Beside the wrapper's count of its launches (``KERNEL.launches``), the
kernel counts the launches the card ran in one int32 on each device
(``KERNEL.device_launches``): a replayed CUDA graph calls no wrapper, and
this count still sees its kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _nvcc
from repro_torch.kernels.paged_attention import _build
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_decode_ref,
    paged_attention_ref,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (32, 64, 128, 160, 256)
#: keys a split covers at the least: below this a block's fixed cost
#: (loading q, merging its warps, writing a partial) outweighs its loads
_MIN_SPLIT_KEYS = 64


def _split_plan(P: int, T: int, n_sm: int, rows: int) -> tuple[int, int]:
    """How the kernel cuts a block table of ``P`` columns of ``T``-token
    pages: ``(splits, cols)``, split ``s`` covering columns
    ``[s * cols, min(P, (s + 1) * cols))``. Enough splits that ``rows``
    blocks a split (batch rows x KV heads) fill the card's ``n_sm`` SMs
    about twice, and no split shorter than ``_MIN_SPLIT_KEYS`` keys. It
    reads host integers only, never ``lengths``, so a call needs no
    device-to-host sync."""
    want = max(1, -(-2 * n_sm // rows))
    cols = min(P, max(1, -(-P // want), -(-_MIN_SPLIT_KEYS // T)))
    return -(-P // cols), cols


class PagedAttentionKernel(_nvcc.Kernel):
    """The CUDA kernel behind the wrapper (see :class:`_nvcc.Kernel`)."""

    def __init__(self):
        super().__init__(_build.load)
        self._n_sm: dict[int, int] = {}
        self._counters: dict[int, torch.Tensor] = {}

    def sm_count(self, dev: torch.device) -> int:
        """The card's SM count, read once per device."""
        idx = dev.index if dev.index is not None else torch.cuda.current_device()
        if idx not in self._n_sm:
            self._n_sm[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
        return self._n_sm[idx]

    def _counter(self, dev: torch.device) -> torch.Tensor:
        """The device's launch counter: one int32, allocated at the first
        launch on the device and kept, so a captured graph's kernels add to
        the same address at every replay. A graph captures a launch only
        after its eager warm-up run, which allocates the counter first."""
        idx = dev.index if dev.index is not None else torch.cuda.current_device()
        if idx not in self._counters:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("the launch counter must exist before a capture")
            self._counters[idx] = torch.zeros(1, dtype=torch.int32, device=dev)
        return self._counters[idx]

    def device_launches(self, dev) -> int:
        """Launches the card ran on ``dev`` since the counter's first
        launch, in or out of graphs (reads the device: a sync)."""
        dev = torch.device(dev)
        idx = dev.index if dev.index is not None else torch.cuda.current_device()
        counter = self._counters.get(idx)
        return 0 if counter is None else int(counter.item())

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
        if D not in _HEAD_DIMS:
            raise ValueError(f"head dimension {D} is not one of {_HEAD_DIMS}")
        if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
            raise ValueError("k_pages and v_pages must start on a 16-byte boundary")

        lib = self.load()
        splits, cols = _split_plan(P, T, self.sm_count(dev), B * KH)
        out = torch.empty_like(q)
        ws = (torch.empty((B, H, splits, D + 2), dtype=torch.float32, device=dev)
              if splits > 1 else None)
        counter = self._counter(dev)
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
                out.data_ptr(), ws.data_ptr() if ws is not None else None,
                counter.data_ptr(), B, H, KH, D, T, P, splits, cols,
                _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pages.dtype],
                D ** -0.5, softcap or 0.0, window or 0,
                stream,
            )
        _nvcc.check_status(err, "paged_attention_decode")
        self.launches += 1
        return out


def _shape(t, ndim: int, name: str):
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, has shape {tuple(t.shape)}")
    return t.shape


#: the one kernel instance the wrappers launch; its ``launches`` is the
#: count a run reads to show that decode went through the kernel
KERNEL = PagedAttentionKernel()


def _refuse_grad(*operands) -> None:
    """Decode attention has no backward kernel: a CUDA call that autograd
    would record raises rather than return a result without a gradient."""
    if _nvcc.records_grad(*operands):
        raise NotImplementedError(
            "paged attention has no backward kernel yet (ROADMAP): a gradient through it "
            "on the card would be lost; CPU tensors train through the plain version")


def paged_attention(
    q, k_pages, v_pages, block_tables, lengths,
    k_scales=None, v_scales=None, *, softcap=None, window=None,
):
    """Decode attention over a paged KV pool (layouts in ``csrc``)."""
    if q.is_cuda:
        _refuse_grad(q, k_pages, v_pages)
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
        _refuse_grad(q, k_new, v_new, k_pages, v_pages)
        return KERNEL(
            q, k_new, v_new, k_pages, v_pages, block_tables, lengths,
            k_scales, v_scales, softcap=softcap, window=window,
        )
    return paged_attention_decode_ref(
        q, k_new, v_new, k_pages, v_pages, block_tables, lengths,
        k_scales, v_scales, softcap=softcap, window=window,
    )
