"""Public entry points of sequence (prefill) attention.

Two entry points over one Hopper kernel (``csrc/flash_attention.cu``),
which reads its operands through the strides the wrapper passes, so
neither layout is copied into the other:

* ``flash_attention(q, k, v, *, causal, window, softcap, q_offset)`` in
  ``[B, H, S, D]``: the counterpart of ``repro.kernels.flash_attention``;
  its plain version is ``flash_attention_ref``.
* ``prefill_attention(q, k, v, *, causal, window, cap, q_offset,
  kv_lengths, kv_hole)`` in the model's ``[B, S, H, D]``: what the model's
  prefill calls; its plain version is ``blockwise_attention``.

Each chooses by the tensors' device, with no flag: CUDA tensors launch the
kernel or raise; CPU tensors take the plain version, through which
autograd runs as through any PyTorch code. There is no fallback
from the kernel to the plain version. The kernel takes ragged ``Sq`` and
``Skv`` (no divisibility requirement), GQA (``H % KH == 0``), head
dimensions 32, 64, 128, 160 (zamba2's shared block) and 256 (gemma2-9b),
and f32 or bf16: bf16 runs on the tensor cores when every row start is
16-byte aligned and on CUDA cores otherwise, f32 on CUDA cores. A query row that sees no key at all comes back as 0 from
the kernel (the plain versions give the mean of v there); no serving path
produces such a row.

Gradients on the card: when autograd records (``torch.is_grad_enabled()``)
and an operand requires grad, a CUDA call goes through
:class:`_FlashAttentionFn`, whose forward launches the kernel with its
per-row log-sum-exp and whose backward launches the backward kernel
(``csrc/flash_attention_bwd.cu``; plain version
:func:`~repro_torch.kernels.flash_attention.ref.flash_attention_bwd_ref`).
Every other CUDA call launches the forward alone, as serving always has.
The backward takes no ``q_offset``, ``kv_lengths`` or ``kv_hole``: a
gradient asked through them raises (ROADMAP), and no training path uses
them. It has two routes, chosen by ``_bwd_route`` from dtype, head
dimension and alignment alone, never on a failure: ``tensor_core`` (bf16,
D in 32, 64, 128, every row start 16-byte aligned: ``mma.sync`` passes)
and ``cuda_core`` (everything else: the first version's f32 tiles).
``KERNEL.backward_kernel.routes`` counts the backward's launches by route.

``flash_cost``, ``prefill_cost`` and ``backward_cost`` count one call's
work for the roofline (:mod:`repro_torch.kernels.roofline`);
``audit_spec`` gives the step auditor (:mod:`repro_torch.analysis.jitaudit`)
a prefill call at two sequence lengths.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _nvcc, leaf, roofline
from repro_torch.kernels.flash_attention import _build
from repro_torch.kernels.flash_attention.ref import blockwise_attention, flash_attention_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128, 160, 256)
_BWD_ROUTE_CODES = {"cuda_core": 0, "tensor_core": 1}
#: head dimensions the backward's tensor-core passes take (at 160 and 256
#: the f32 accumulators of dK and dV would not fit in registers)
_BWD_TENSOR_CORE_HEAD_DIMS = (32, 64, 128)


def _bwd_route(tensors, D: int) -> str:
    """The backward's route for these operands and outputs (q, k, v, out,
    dout, dq, dk, dv), from their dtype, the head dimension and their
    alignment alone."""
    if (D in _BWD_TENSOR_CORE_HEAD_DIMS and all(t.dtype == torch.bfloat16 for t in tensors)
            and all(_nvcc.aligned(t) for t in tensors)):
        return "tensor_core"
    return "cuda_core"


class FlashAttentionKernel(_nvcc.Kernel):
    """The CUDA kernel behind both wrappers (see :class:`_nvcc.Kernel`).
    ``seq_dim`` and ``head_dim`` name where the sequence and the heads sit
    in the 4-D operands (2 and 1 for ``[B, H, S, D]``, 1 and 2 for
    ``[B, S, H, D]``)."""

    def __init__(self):
        super().__init__(_build.load)
        #: the backward kernel, its own build; its ``launches`` counts the
        #: backward's launches (``backward_launches``), its ``routes`` them
        #: by route
        self.backward_kernel = _nvcc.Kernel(_build.load_bwd, routes=_BWD_ROUTE_CODES)

    @property
    def backward_launches(self) -> int:
        return self.backward_kernel.launches

    @backward_launches.setter
    def backward_launches(self, n: int) -> None:
        self.backward_kernel.launches = n

    def __call__(self, q, k, v, *, seq_dim: int, head_dim: int, causal: bool, window,
                 softcap, q_offset: int, kv_lengths=None, kv_hole=None, with_lse=False):
        """The forward; with ``with_lse`` returns ``(out, lse)``, ``lse`` the
        f32 ``[B, H, Sq]`` log-sum-exp of each query row's scores."""
        for name, t in {"q": q, "k": k, "v": v}.items():
            if t.dim() != 4:
                raise ValueError(f"{name} must have 4 dims, has shape {tuple(t.shape)}")
            if t.stride(-1) != 1:
                raise ValueError(f"{name} must be contiguous in its last dimension")
        B, D = q.shape[0], q.shape[3]
        H, Sq = q.shape[head_dim], q.shape[seq_dim]
        KH, Skv = k.shape[head_dim], k.shape[seq_dim]
        dev = q.device
        if (tuple(v.shape) != tuple(k.shape) or k.shape[0] != B or k.shape[3] != D
                or H % KH):
            raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                             f"v {tuple(v.shape)}")
        if D not in _HEAD_DIMS:
            raise ValueError(f"head dimension {D} is not one of {_HEAD_DIMS}")
        if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
            raise TypeError(f"q, k and v must share float32 or bfloat16, not "
                            f"{q.dtype}, {k.dtype}, {v.dtype}")
        for name, t in {"k": k, "v": v, "kv_lengths": kv_lengths}.items():
            if t is not None and t.device != dev:
                raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if kv_lengths is not None and (
                kv_lengths.dtype != torch.int32 or tuple(kv_lengths.shape) != (B,)
                or not kv_lengths.is_contiguous()):
            raise ValueError(f"kv_lengths must be contiguous int32 of shape {(B,)}")
        if window is not None and window <= 0:
            raise ValueError(f"window must be positive, not {window}")
        if softcap is not None and softcap <= 0:
            raise ValueError(f"softcap must be positive, not {softcap}")
        if q_offset < 0:
            raise ValueError(f"q_offset must be non-negative, not {q_offset}")
        hole_lo, hole_hi = (0, 0) if kv_hole is None else (int(kv_hole[0]), int(kv_hole[1]))

        lib = self.load()
        out = torch.empty(q.shape, dtype=q.dtype, device=dev)
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev) if with_lse else None

        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                kv_lengths.data_ptr() if kv_lengths is not None else None, out.data_ptr(),
                lse.data_ptr() if lse is not None else None,
                B, H, KH, Sq, Skv, D, _DTYPE_CODES[q.dtype],
                *(s for t in (q, k, v, out) for s in _strides(t, seq_dim, head_dim)),
                D ** -0.5, softcap or 0.0, int(causal), window or 0, int(q_offset),
                hole_lo, hole_hi, stream,
            )
        _nvcc.check_status(err, "flash_attention_fwd")
        self.launches += 1
        return (out, lse) if with_lse else out

    def backward(self, q, k, v, out, dout, lse, *, seq_dim: int, head_dim: int, causal: bool,
                 window, softcap, route: str | None = None):
        """dq, dk, dv of the forward that gave ``out`` and ``lse`` on
        ``q, k, v`` (same layout and masks), given ``dout``; each in its
        operand's type and layout. ``route`` forces a route (for timing
        both on one input); ``None`` takes the one ``_bwd_route`` chooses."""
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        if dout.shape != out.shape or dout.dtype != out.dtype:
            raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not match the "
                             f"output {tuple(out.shape)} {out.dtype}")
        B, D = q.shape[0], q.shape[3]
        H, Sq = q.shape[head_dim], q.shape[seq_dim]
        KH, Skv = k.shape[head_dim], k.shape[seq_dim]
        dev = q.device
        if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, Sq) or not lse.is_contiguous():
            raise ValueError(f"lse must be contiguous float32 of shape {(B, H, Sq)}")
        lib = self.backward_kernel.load()
        dq = torch.empty(q.shape, dtype=q.dtype, device=dev)
        dk = torch.empty(k.shape, dtype=k.dtype, device=dev)
        dv = torch.empty(v.shape, dtype=v.dtype, device=dev)
        di = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
        tensors = (q, k, v, out, dout, dq, dk, dv)
        if route not in (None, *_BWD_ROUTE_CODES):
            raise ValueError(f"route must be one of {list(_BWD_ROUTE_CODES)}, not {route!r}")
        chosen = _bwd_route(tensors, D)
        if route == "tensor_core" and chosen != "tensor_core":
            raise ValueError("these dtypes, head dimension or strides cannot take the "
                             "tensor-core route")
        route = route or chosen
        strides = [s for t in tensors for s in _strides(t, seq_dim, head_dim)]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.flash_attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                B, H, KH, Sq, Skv, D, _DTYPE_CODES[q.dtype], _BWD_ROUTE_CODES[route],
                (ctypes.c_longlong * len(strides))(*strides),
                D ** -0.5, softcap or 0.0, int(causal), window or 0, stream,
            )
        _nvcc.check_status(err, "flash_attention_bwd")
        self.backward_launches += 1
        self.backward_kernel.routes[route] += 1
        return dq, dk, dv


def _strides(t, seq_dim: int, head_dim: int) -> tuple[int, int, int]:
    """(batch, head, sequence) strides of a 4-D operand, in elements."""
    return t.stride(0), t.stride(head_dim), t.stride(seq_dim)


#: the one kernel instance both wrappers launch; its ``launches`` is the
#: count a run reads to show that prefill went through the kernel
KERNEL = FlashAttentionKernel()


class _FlashAttentionFn(torch.autograd.Function):
    """The kernel under autograd: the forward launches it with the
    log-sum-exp and keeps q, k, v, the output and the log-sum-exp; the
    backward launches the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, seq_dim, head_dim, causal, window, softcap):
        out, lse = KERNEL(q, k, v, seq_dim=seq_dim, head_dim=head_dim, causal=causal,
                          window=window, softcap=softcap, q_offset=0, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = dict(seq_dim=seq_dim, head_dim=head_dim, causal=causal, window=window,
                        softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = KERNEL.backward(q, k, v, out, dout, lse, **ctx.mask)
        return dq, dk, dv, None, None, None, None, None


def visible_pairs(Sq: int, Skv: int, *, causal: bool, window=None, q_offset: int = 0,
                  kv_hole=None, kv_length=None) -> int:
    """(query, key) pairs one head of one row attends: query ``i`` sits at
    position ``q_offset + i``; it sees keys up to it when ``causal``, the
    last ``window`` positions when windowed, none in ``kv_hole``'s
    ``[lo, hi)`` and none at or past ``kv_length``."""
    pos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(Skv, pos + 1) if causal else np.full(Sq, Skv, np.int64)
    if kv_length is not None:
        hi = np.minimum(hi, int(kv_length))
    lo = np.maximum(0, pos - window + 1) if window else np.zeros(Sq, np.int64)
    n = np.maximum(0, hi - lo)
    if kv_hole is not None:
        h_lo, h_hi = int(kv_hole[0]), int(kv_hole[1])
        n -= np.maximum(0, np.minimum(hi, h_hi) - np.maximum(lo, h_lo))
    return int(n.sum())


def cost(q, k, v, *, seq_dim: int, head_dim: int, causal: bool, window=None,
         q_offset: int = 0, kv_hole=None, kv_lengths=None) -> dict:
    """One forward call's work: ``{"flops", "bytes", "op_type"}``. Bytes: q,
    k and v read once and the output written once. Operations: q·kᵀ and
    p·v over the visible (query, key) pairs (:func:`visible_pairs`).
    ``kv_lengths`` are host values (a CUDA tensor is read, a sync).
    Operands are tensors or anything with their ``shape`` and ``dtype``."""
    B, D = q.shape[0], q.shape[3]
    H, Sq = q.shape[head_dim], q.shape[seq_dim]
    KH, Skv = k.shape[head_dim], k.shape[seq_dim]
    if kv_lengths is None:
        rows = [None] * B
    else:
        if isinstance(kv_lengths, torch.Tensor):
            kv_lengths = kv_lengths.detach().cpu()
        rows = np.asarray(kv_lengths, np.int64).reshape(B).tolist()
    visible = sum(visible_pairs(Sq, Skv, causal=causal, window=window, q_offset=q_offset,
                                kv_hole=kv_hole, kv_length=r) for r in rows)
    n_bytes = (2 * B * Sq * H * D + 2 * B * Skv * KH * D) * q.dtype.itemsize
    return dict(flops=4 * H * D * visible, bytes=n_bytes, op_type=roofline.op_type(q.dtype))


def flash_cost(q, k, v, *, causal=True, window=None, softcap=None, q_offset=0) -> dict:
    """:func:`cost` of a :func:`flash_attention` call (``[B, H, S, D]``)."""
    return cost(q, k, v, seq_dim=2, head_dim=1, causal=causal, window=window,
                q_offset=q_offset)


def prefill_cost(q, k, v, *, causal: bool, window=None, cap=None, q_offset: int = 0,
                 kv_lengths=None, kv_hole=None) -> dict:
    """:func:`cost` of a :func:`prefill_attention` call (``[B, S, H, D]``)."""
    return cost(q, k, v, seq_dim=1, head_dim=2, causal=causal, window=window,
                q_offset=q_offset, kv_hole=kv_hole, kv_lengths=kv_lengths)


def backward_cost(q, k, v, *, seq_dim: int, head_dim: int, causal: bool, window=None) -> dict:
    """One backward call's work (``KERNEL.backward``): bytes, q, k, v, the
    output, its gradient and the log-sum-exp read once, dq, dk and dv
    written once; operations, the five products (the scores, dP, dV, dK
    and dQ) over the visible pairs."""
    B, D = q.shape[0], q.shape[3]
    H, Sq = q.shape[head_dim], q.shape[seq_dim]
    KH, Skv = k.shape[head_dim], k.shape[seq_dim]
    visible = B * H * visible_pairs(Sq, Skv, causal=causal, window=window)
    n_bytes = ((4 * B * Sq * H * D + 4 * B * Skv * KH * D) * q.dtype.itemsize
               + 4 * B * H * Sq)
    return dict(flops=5 * 2 * D * visible, bytes=n_bytes, op_type=roofline.op_type(q.dtype))


def _refuse_grad(q_offset=0, kv_lengths=None, kv_hole=None) -> None:
    """The backward kernel's refusals: its queries start at position 0 and
    every key up to the mask is real."""
    for name, given in (("q_offset", q_offset), ("kv_lengths", kv_lengths is not None),
                        ("kv_hole", kv_hole is not None)):
        if given:
            raise NotImplementedError(
                f"the flash backward kernel takes no {name}; no training path uses it "
                "(ROADMAP, kernel work on flash_attention)")


@leaf.entry("flash_attention.flash_attention", flash_cost, host_operands=("q_offset",))
def flash_attention(q, k, v, *, causal=True, window=None, softcap=None, q_offset=0):
    """Sequence attention, q [B,H,Sq,D]; k, v [B,KH,Skv,D] -> [B,H,Sq,D]."""
    if q.is_cuda:
        if _nvcc.records_grad(q, k, v):
            _refuse_grad(q_offset)
            return _FlashAttentionFn.apply(q, k, v, 2, 1, causal, window, softcap)
        return KERNEL(q, k, v, seq_dim=2, head_dim=1, causal=causal, window=window,
                      softcap=softcap, q_offset=q_offset)
    return flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                               q_offset=q_offset)


@leaf.entry("flash_attention.prefill_attention", prefill_cost,
            host_operands=("q_offset", "kv_hole"))
def prefill_attention(q, k, v, *, causal: bool, window=None, cap=None, q_offset: int = 0,
                      kv_lengths=None, kv_hole=None):
    """Prefill attention in the model's layout, q [B,Sq,H,D]; k, v
    [B,Skv,KH,D] -> [B,Sq,H,D] (arguments as ``blockwise_attention``)."""
    if q.is_cuda:
        if _nvcc.records_grad(q, k, v):
            _refuse_grad(q_offset, kv_lengths, kv_hole)
            return _FlashAttentionFn.apply(q, k, v, 1, 2, causal, window, cap)
        return KERNEL(q, k, v, seq_dim=1, head_dim=2, causal=causal, window=window,
                      softcap=cap, q_offset=q_offset, kv_lengths=kv_lengths,
                      kv_hole=kv_hole)
    return blockwise_attention(q, k, v, causal=causal, window=window, cap=cap,
                               q_offset=q_offset, kv_lengths=kv_lengths, kv_hole=kv_hole)


def audit_spec(device=None) -> dict:
    """The step auditor's kernel target: one causal bf16 prefill call in the
    model's layout (``[B, S, H, D]``, the layout the engine's prefill
    passes) at 64 tokens of 4 heads of 64, probed against 128 (the op
    sequence must not depend on the length). Inputs on ``device``, drawn
    from a seed; ``None`` is the card."""
    from repro_torch.serving.engine import resolve_device

    device = resolve_device(device)

    def make(seq: int):
        def args():
            g = torch.Generator().manual_seed(0)
            return tuple(torch.randn((1, seq, 4, 64), generator=g).to(device, torch.bfloat16)
                         for _ in range(3))

        return args

    return {
        "name": "kernels.flash_attention",
        "fn": lambda q, k, v: prefill_attention(q, k, v, causal=True),
        "make_args": make(64),
        "probe_args": make(128),
        "bucket": {"seq": 64, "heads": 4, "head_dim": 64},
    }
