"""Block library of the port: the dense and MoE families (with gemma2's
window-limited ring cache for its local layers and whisper's
bidirectional encoder blocks), Mamba-2, and zamba2's shared attention
block.

The counterpart of ``repro/models/layers.py``. Every block is a
(``describe_*``, ``apply_*``) pair: ``describe_*`` builds a dict of
:class:`~repro_torch.models.params.Leaf` descriptors, ``apply_*`` is a
plain function of one layer's parameters (anything indexable by leaf
name) and the activations. Layers are stacked along a leading ``[L, ...]``
dimension of the stored tensors (:func:`stack`), and the model loops over
the layer index where the reference ran ``lax.scan``.

Prefill attention goes through
:func:`repro_torch.kernels.flash_attention.ops.prefill_attention`, decode
attention reads the paged pool through
:func:`repro_torch.kernels.paged_attention.ops.paged_attention_decode` and
a dense slot cache through :func:`decode_attention` (the same kernel over
the slots seen as pages: 16-token pages, or for whisper's cross cache of
1500 positions pages of :func:`dividing_page_tokens`), and
the Mamba-2 block's sequence-mode scan through
:func:`repro_torch.kernels.ssd.ops.ssd`: each launches its Hopper kernel
for CUDA tensors and takes its plain version (:func:`blockwise_attention`,
``ssd_reference``; the reference ran these in plain jnp) for CPU tensors.
The Mamba-2 decode step is the plain ``ssd_decode_step``, as in the
reference. The large projections (QKV, wo, FFN, in/out_proj) and the MoE
layer's dispatch, expert and combine products stay ``torch.matmul`` /
``torch.bmm``, as the reference leaves them (plain jnp einsums, no Pallas
kernel) to XLA.

On a mesh of more than one device the weights are DTensors and a
:class:`ShardCtx` places the activations by the rules at the reference's
sites on the dense path (q/k/v, the FFN hidden, the block outputs);
where a row-parallel product leaves partial sums (``wo``, ``w_down``) it
reduces them in f32 before they join the residual stream. The attention
entry points run each rank's heads on its local shards, over the page
pool or the dense slot caches, each rank's block of the KV heads. The
MoE layer runs on each rank's columns of every expert's hidden
dimension with the routed tokens replicated, and reduces its partial sum
once, in f32 (:func:`apply_moe`): no expert weight is gathered. In
training (the dense and MoE families) the batch is sharded over "data"
as well, each rank running its own rows, and :meth:`ShardCtx.param`
gathers each weight's FSDP-sharded "embed" dimension before use; every
collective has its transpose in the backward
(:mod:`repro_torch.dist.local`). The Mamba-2 block runs on each rank's
SSD heads (:func:`apply_mamba_block`), zamba2's shared block as the dense
block does.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.dist.local import (
    full,
    gather_columns,
    is_dtensor,
    mean_over_ranks,
    on_blocks,
    on_local_heads,
    place_block,
    redistribute,
    row_mean,
    summed_gradient,
    vocab_embedding,
)
from repro_torch.dist.sharding import ShardingRules
from repro_torch.kernels import leaf
from repro_torch.kernels.flash_attention.ops import prefill_attention
from repro_torch.kernels.flash_attention.ref import blockwise_attention  # noqa: F401 (re-export)
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ops import paged_attention, paged_attention_decode
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.kernels.ssd.ref import ssd_decode_step
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import Leaf, put_block

F32 = torch.float32
#: the logical axes of one layer's slot cache ``[B, S, KH, HD]``
SLOT_AXES = ("batch", "kv_seq", "kv_heads_act", "head_dim")
#: the logical axes of a sequence's queries and K/V ``[B, S, heads, HD]``
HEADS_ACT = ("batch", None, "heads_act", None)
KV_HEADS_ACT = ("batch", None, "kv_heads_act", None)


@dataclass
class ShardCtx:
    """Mesh + rules for activation sharding constraints: the counterpart of
    the reference's ``ShardCtx``. An engine makes one only for a mesh of
    more than one device, where its weights are DTensors; :data:`NULL_CTX`
    (no mesh) changes nothing, and every method passes a plain tensor as
    it is."""

    mesh: object | None = None
    rules: ShardingRules | None = None

    def constrain(self, x, logical):
        """``x`` redistributed to the placements the rules give
        ``logical`` at ``x``'s shape (partial sums are reduced, shards
        gathered or split)."""
        if self.mesh is None or self.rules is None or not is_dtensor(x):
            return x
        want = self.rules.sharding(self.mesh, logical, tuple(x.shape)).placements()
        return x if tuple(x.placements) == want else redistribute(x, want)

    def split_heads(self, x, n: int, hd: int, logical):
        """``x [B, S, n*hd]`` as ``[B, S, n, hd]`` placed by ``logical``
        (heads at dimension 2). The flat tensor is placed first, since a
        shard of the flat columns that splits a head (``n`` not divisible
        by the model axis, which the rules then replicate) cannot be
        viewed as whole heads."""
        shape = (*x.shape[:2], n, hd)
        if self.mesh is not None and is_dtensor(x):
            want = self.rules.sharding(self.mesh, logical, shape).placements()
            if tuple(x.placements) != want:
                x = redistribute(x, want)
        return x.reshape(shape)

    def from_local(self, t, logical, shape):
        """``t``, this rank's block of a tensor of ``shape`` placed by
        ``logical`` (the page pool's or the slot caches' heads), as a
        DTensor."""
        if self.mesh is None:
            return t
        sh = self.rules.sharding(self.mesh, logical, tuple(shape))
        return place_block(t, self.mesh.device_mesh(), sh.placements(), shape)

    def place(self, t, logical):
        """``t`` placed by ``logical``: a DTensor as :meth:`constrain`
        places it; a plain tensor that every rank holds whole (a batch's
        frames or image embeddings) as this rank's block of it, with no
        collective."""
        if self.mesh is None:
            return t
        if is_dtensor(t):
            return self.constrain(t, logical)
        return put_block(t, self.rules.sharding(self.mesh, logical, tuple(t.shape)))

    @staticmethod
    def local(x):
        """This rank's block of ``x`` (a plain tensor as it is)."""
        return x.to_local() if is_dtensor(x) else x

    @staticmethod
    def full(x):
        """The whole of ``x`` on every rank (a plain tensor as it is)."""
        return full(x) if is_dtensor(x) else x

    def embedding(self, tokens, table, logical):
        """``F.embedding(tokens, table)`` placed by ``logical``: on a mesh
        each rank looks up the rows it holds and the partial sums are
        reduced (the table's vocabulary is never gathered; its width is,
        where FSDP shards it, :meth:`param`). ``tokens`` may be a DTensor
        sharded by rows (a batch over "data")."""
        if not is_dtensor(table):
            return F.embedding(tokens, table)
        return self.constrain(vocab_embedding(tokens, self.param(table)), logical)

    def param(self, w):
        """A parameter as the step uses it. On a mesh, a weight whose
        "embed" dimension FSDP shards over an axis of :data:`FSDP_AXES` is
        gathered there first (the reference has no such call: XLA inserts
        the all-gather); under remat the gather runs again in the
        recompute, in the forward's order on every rank. Under autograd
        every parameter goes through it, gathered or not: its gradient comes
        back in the parameter's own placements, reduce-scattered where it
        was gathered and all-reduced over the axes whose ranks each hold a
        partial sum of it (their rows of the batch)."""
        if self.mesh is None or not is_dtensor(w):
            return w
        from torch.distributed.tensor import Replicate

        names = self.mesh.axis_names
        want = tuple(Replicate() if names[i] in FSDP_AXES and p.is_shard() else p
                     for i, p in enumerate(w.placements))
        return redistribute(w, want)

    def params(self, tree):
        """:meth:`param` over a nested dict of parameters (one layer's)."""
        if self.mesh is None:
            return tree
        return {k: self.params(v) if isinstance(v, dict) else self.param(v)
                for k, v in tree.items()}

    def scope(self):
        """The context a step on this mesh runs in: plain tensors that every
        rank holds whole (tokens, positions, lengths) act as replicated
        DTensors beside the sharded ones. The page pool's tensors are the
        rank's own blocks, and enter only through :meth:`from_local` or a
        kernel entry point's local shards."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import implicit_replication

        return implicit_replication()


NULL_CTX = ShardCtx()
#: the mesh axes over which the train rules shard a weight's "embed"
#: dimension (FSDP): :meth:`ShardCtx.param` gathers them before use
FSDP_AXES = ("data",)


def stack(tree, n: int):
    """Add a leading stacked-layers dim to every Leaf."""
    if isinstance(tree, Leaf):
        return Leaf((n, *tree.shape), ("layers", *tree.axes), tree.dtype,
                    tree.scale, tree.init)
    return {k: stack(v, n) for k, v in tree.items()}


# =========================================================== tiny primitives
@on_blocks
def rmsnorm(x, w, eps=1e-6, *, group_mean=None):
    """RMS norm over the last dimension. ``group_mean`` takes the mean of
    squares over a rank's columns to the mean over every rank's
    (:func:`~repro_torch.dist.local.mean_over_ranks`): the Mamba-2
    block's gated norm on a rank's heads."""
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    if group_mean is not None:
        var = group_mean(var)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * (1.0 + w.to(x.dtype))


def softcap(t, cap):
    if cap is None:
        return t
    return cap * torch.tanh(t / cap)


def silu(x):
    """silu as the reference computes it, x * 1/(1 + exp(-x)) rounding to
    x's dtype after every op: bit-equal to XLA's bf16 expansion, where
    ``F.silu`` rounds once."""
    return x * (1 / (1 + torch.exp(-x)))


def softplus(x):
    """softplus as ``jax.nn.softplus`` computes it, ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


@on_blocks
def rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions broadcastable to [..., S]."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=F32, device=x.device) / half)
    angles = positions.to(F32)[..., None] * freqs            # [..., S, half]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ================================================================= attention
def describe_attention(cfg: ModelConfig, d_in: int | None = None, heads=None,
                       kv_heads=None, head_dim=None, bias: bool | None = None):
    """The attention leaves; each width defaults to ``cfg``'s. The keywords
    mirror the reference's ``describe_attention``; the shared block passes
    them as the reference's does, and only its ``d_in``, ``head_dim`` and
    ``bias`` differ from ``cfg``'s."""
    d = d_in or cfg.d_model
    h = heads or cfg.num_heads
    kh = kv_heads or cfg.num_kv_heads
    hd = head_dim or cfg.head_dim
    bias = cfg.qkv_bias if bias is None else bias
    p = {
        "wq": Leaf((d, h * hd), ("embed", "heads")),
        "wk": Leaf((d, kh * hd), ("embed", "heads")),
        "wv": Leaf((d, kh * hd), ("embed", "heads")),
        "wo": Leaf((h * hd, d), ("heads", "embed")),
    }
    if bias:
        p["bq"] = Leaf((h * hd,), ("heads",), init="zeros")
        p["bk"] = Leaf((kh * hd,), ("heads",), init="zeros")
        p["bv"] = Leaf((kh * hd,), ("heads",), init="zeros")
    return p


def promote(x, w):
    """``x`` in the type ``x @ w`` has in jnp, where a bf16 ``x`` against
    f32 weights promotes to f32 (exactly); ``torch.matmul`` refuses mixed
    types. Only whisper's encoder meets it: the reference casts ``frames``
    to bf16 whatever the weights' type."""
    return x.to(torch.promote_types(x.dtype, w.dtype))


def _project_qkv(p, x, h, kh, hd, positions, theta, ctx=NULL_CTX):
    x = promote(x, p["wq"])
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = ctx.split_heads(q, h, hd, HEADS_ACT)
    k = ctx.split_heads(k, kh, hd, KV_HEADS_ACT)
    v = ctx.split_heads(v, kh, hd, KV_HEADS_ACT)
    return rope(q, positions, theta), rope(k, positions, theta), v


def slot_operands(ctx, k_cache, v_cache, kv_heads: int) -> tuple:
    """A layer's slot buffers ``[B, S, KH, HD]`` as :func:`decode_attention`
    takes them: on a mesh this rank's blocks of the ``kv_heads`` KV heads,
    as DTensors of the whole shape (plain tensors as they are)."""
    shape = (*k_cache.shape[:2], kv_heads, k_cache.shape[3])
    return ctx.from_local(k_cache, SLOT_AXES, shape), ctx.from_local(v_cache, SLOT_AXES, shape)


def slot_pages(cache, page_tokens: int):
    """A slot cache ``[B, S, KH, D]`` seen as a page pool, without a copy:
    pages ``[B*S/T, T, KH, D]`` and the block table ``[B, S/T]`` int32 whose
    row ``b`` names the pages ``b*S/T + arange(S/T)``. ``S`` must be a
    multiple of ``T`` (``page_tokens``)."""
    B, S, KH, D = cache.shape
    if S % page_tokens:
        raise ValueError(
            f"a slot cache of {S} positions is not a whole number of "
            f"{page_tokens}-token pages")
    P = S // page_tokens
    pages = cache.view(B * P, page_tokens, KH, D)
    table = torch.arange(B * P, dtype=torch.int32, device=cache.device).view(B, P)
    return pages, table


#: the largest page :func:`dividing_page_tokens` chooses
_MAX_CROSS_PAGE = 32


def dividing_page_tokens(seq: int) -> int:
    """The largest page size not above ``_MAX_CROSS_PAGE`` that divides
    ``seq``: the page :func:`slot_pages` reads a slot cache of ``seq``
    positions in when ``seq`` is no whole number of 16-token pages
    (whisper's cross cache of 1500 encoder positions: 30; the reduced
    config's 24: 24)."""
    t = min(_MAX_CROSS_PAGE, seq)
    while seq % t:
        t -= 1
    return t


def _decode_attention_cost(q, k_cache, v_cache, *, lengths, window=None, cap=None,
                           page_tokens: int = 16) -> dict:
    """The paged kernel's cost over the slot cache read as pages, as
    :func:`decode_attention` reads it on the card."""
    B, S, KH, D = k_cache.shape
    T = page_tokens
    pages = torch.empty((-(-B * S // T), T, KH, D), dtype=k_cache.dtype, device="meta")
    table = torch.empty((B, -(-S // T)), dtype=torch.int32, device="meta")
    return paged_ops.cost(q, pages, table, lengths, window=window)


@leaf.entry("layers.decode_attention", _decode_attention_cost)
def decode_attention(q, k_cache, v_cache, *, lengths, window=None, cap=None,
                     page_tokens: int = 16):
    """Single-token attention over a slot cache.

    q: [B, H, D]; k_cache/v_cache: [B, S, KH, D]; lengths: [B] (tokens
    valid, inclusive of the one just written). Returns ``[B, H*D]`` in
    q's dtype.

    On CUDA tensors the caches are read as ``page_tokens``-token pages
    (:func:`slot_pages`) by the paged-attention kernel, whose visible
    positions ``[lengths - window, lengths)`` are the reference's mask; it
    raises where the kernel refuses the shapes. On CPU tensors this is the
    reference's masked softmax in plain PyTorch: scores and the weighted
    sum in f32, the weights rounded to q's dtype before the sum, as the
    reference's einsums take them. Either way the step auditor sees one
    call of the paged kernel over the slot pages (:mod:`repro_torch.kernels.leaf`).

    On a mesh ``q`` is a DTensor placed by heads and the caches are
    DTensors placed by KV heads (dimension 2), each rank's block its own
    slot buffers: the body runs on each rank's heads
    (:func:`~repro_torch.dist.local.on_local_heads`), and the output is
    placed as ``q``'s heads are. Where the rank's query heads read other
    KV heads than it holds in order (the KV replicated because the model
    axis does not divide them, e.g. GQA 6/3), the slot caches are
    narrowed to those heads: a copy of both caches a call.
    """
    if is_dtensor(q):
        B, H, D = q.shape

        def body(q_l, k_l, v_l):
            out = decode_attention(q_l[:, 0], k_l, v_l, lengths=lengths, window=window,
                                   cap=cap, page_tokens=page_tokens)
            return out.view(q_l.shape)

        out = on_local_heads(body, q.unsqueeze(1), (k_cache, v_cache), head_dim=2)
        return out[:, 0].reshape(B, H * D)
    B, S, KH, D = k_cache.shape
    H = q.shape[1]
    if q.is_cuda:
        k_pages, table = slot_pages(k_cache, page_tokens)
        v_pages, _ = slot_pages(v_cache, page_tokens)
        out = paged_attention(q, k_pages, v_pages, table, lengths.to(torch.int32),
                              softcap=cap, window=window)
        return out.reshape(B, H * D)
    G = H // KH
    s = torch.einsum("bhgd,bshd->bhgs", q.reshape(B, KH, G, D).to(F32),
                     k_cache.to(F32)) * (D ** -0.5)
    s = softcap(s, cap)
    pos = torch.arange(S, device=q.device)[None, :]
    lens = lengths.long()[:, None]
    mask = pos < lens
    if window is not None:
        mask &= pos >= (lens - window)
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, -1e30))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(q.dtype).to(F32), v_cache.to(F32))
    out = out / p.sum(-1)[..., None]
    return out.reshape(B, H * D).to(q.dtype)


# ======================================================================= FFN
def describe_ffn(cfg: ModelConfig, d_in: int | None = None, d_ff: int | None = None,
                 d_out: int | None = None):
    """The gated FFN's leaves; each width defaults to ``cfg``'s. The
    keywords mirror the reference's ``describe_ffn``; the shared block passes
    them as the reference's does, and only its ``d_in`` (and so ``d_out``)
    differs from ``cfg``'s."""
    d = d_in or cfg.d_model
    f = d_ff or cfg.d_ff
    o = d_out or d
    return {
        "w_gate": Leaf((d, f), ("embed", "ffn")),
        "w_up": Leaf((d, f), ("embed", "ffn")),
        "w_down": Leaf((f, o), ("ffn", "embed")),
    }


def apply_ffn(p, x, ctx=NULL_CTX):
    h = silu(x @ p["w_gate"]) * (x @ p["w_up"])
    h = ctx.constrain(h, ("batch", None, "ffn_act"))
    return _row_parallel(ctx, h, p["w_down"])


def _row_parallel(ctx, h, w):
    """``h @ w``. On a mesh, where ``w`` is sharded by its rows, each rank's
    partial sum is taken and reduced in f32 and rounded once to ``h``'s
    dtype, as the one-device product rounds its f32 accumulator once: bf16
    partial sums, rounded twice, drift from the one-device result through
    the layers (0.19 in full-width qwen's logits over 24 layers, beyond
    the model band). The output is replicated, as the residual stream
    is."""
    if not is_dtensor(w):
        return h @ w
    y = ctx.constrain(h.float() @ w.float(), ("batch", "seq", "embed_act"))
    return y.to(h.dtype)


# ======================================================================= MoE
def describe_moe(cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    p = {
        "router": Leaf((d, e), ("embed", None), scale=0.02),
        "w_gate": Leaf((e, d, f), ("experts", "embed", "expert_ffn")),
        "w_up": Leaf((e, d, f), ("experts", "embed", "expert_ffn")),
        "w_down": Leaf((e, f, d), ("experts", "expert_ffn", "embed")),
    }
    if cfg.dense_residual:  # arctic: dense FFN in parallel with the MoE
        p["dense"] = describe_ffn(cfg)
    return p


def moe_capacity(cfg: ModelConfig, g: int) -> int:
    """Slots an expert takes per group of ``g`` tokens, in the reference's
    Python float arithmetic."""
    return max(1, int(g * cfg.top_k * cfg.capacity_factor / cfg.num_experts))


def moe_route(p, xg, cfg: ModelConfig):
    """The routing half of :func:`apply_moe` for grouped tokens ``xg``
    ``[G, g, d]``: router softmax in f32, top-k, renormalised gates, and
    each (token, k) entry's position in its expert's queue.

    Returns ``(gates [G,g,E], top_vals [G,g,k], top_idx [G,g,k],
    pos [G,g,k], keep [G,g,k])``: ``pos`` is the exclusive cumsum of the
    group's entries in (token, k) order, ``keep`` marks ``pos < cap``.
    Everything stays on the device (a decode graph captures it): top-k is
    a stable descending sort, so ties go to the lower expert index as in
    ``jax.lax.top_k``.
    """
    e, k = cfg.num_experts, cfg.top_k
    n_groups, g, _ = xg.shape
    logits = xg.to(F32) @ p["router"].to(F32)                  # [G,g,E]
    gates = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_vals, top_idx = top_vals[..., :k], top_idx[..., :k]
    top_vals = top_vals / torch.clamp_min(top_vals.sum(-1, keepdim=True), 1e-9)
    onehot = top_idx[..., None] == torch.arange(e, device=xg.device)   # [G,g,k,E]
    flat = onehot.reshape(n_groups, g * k, e).to(torch.int32)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(n_groups, g, k, e)
    pos = torch.gather(pos, 3, top_idx[..., None])[..., 0]     # [G,g,k]
    return gates, top_vals, top_idx, pos, pos < moe_capacity(cfg, g)


def apply_moe(p, x, cfg: ModelConfig, ctx=NULL_CTX):
    """GShard-style capacity dispatch (top-k, grouped tokens), as the
    reference's ``apply_moe``: tokens are grouped ``[B*S/g, g]`` with
    ``g = min(4096, S)``; per group each expert takes
    ``cap = g * top_k * capacity_factor / E`` slots and drops the entries
    past them. Every expert runs on its ``cap`` slots of every group, so a
    call reads all E experts' weights. Returns ``(y, aux_loss)``.

    The slot masks compare positions against ``arange(cap)`` where the
    reference takes ``one_hot`` (which gives a zero row past ``cap``). The
    dispatch and combine products run in ``x.dtype``: dispatch holds 0/1,
    combine each kept entry's gate rounded to ``x.dtype``, as the
    reference casts them. arctic's dense residual FFN runs beside the
    experts on the same input.

    On a mesh (the weights DTensors) the layer runs on each rank's own
    blocks (:func:`_apply_moe_sharded`): no expert weight is gathered.
    """
    if not is_dtensor(p["w_gate"]):
        y, aux = _moe_experts(p, x, cfg)
    else:
        y, aux = _apply_moe_sharded(p, x, cfg, ctx)
    if "dense" in p:
        if is_dtensor(x):
            # the dense FFN's gradient of x is a partial sum over "model",
            # the experts' a whole one: made whole before autograd adds them
            x = redistribute(x, x.placements)
        y = y + apply_ffn(p["dense"], x, ctx)
    return y, aux


class _BmmF32(torch.autograd.Function):
    """``a @ b`` batched, accumulated and returned in f32 without a
    rounding to ``a``'s type: on the card cuBLAS writes the f32
    accumulator out (``out_dtype``, which autograd does not
    differentiate), with no f32 copy of ``b`` (an expert weight block);
    elsewhere both are cast up exactly. The backward rounds the f32
    gradient once to ``a``'s type and takes the two products in it, as
    autograd's backward of the product in ``a``'s type (whose output it
    would have rounded) takes them."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda:
            return torch.bmm(a, b, out_dtype=F32)
        return torch.bmm(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = torch.bmm(g, b.transpose(1, 2)) if ctx.needs_input_grad[0] else None
        gb = torch.bmm(a.transpose(1, 2), g) if ctx.needs_input_grad[1] else None
        return ga, gb


def _same(t):
    return t


def _moe_experts(p, x, cfg: ModelConfig, partial: bool = False, whole_grad=_same):
    """The routed experts of :func:`apply_moe` on plain tensors. With
    ``partial`` ``p``'s expert weights are one rank's columns of every
    expert's hidden dimension (``w_gate``/``w_up`` by columns,
    ``w_down`` by rows): ``y`` is then that rank's partial sum in f32, the
    down and combine products accumulated in f32 and not rounded.
    ``whole_grad`` takes the tokens where they enter the dispatch product
    and the gates where they enter the combine product: their gradients
    there are then partial sums, which it makes whole
    (:func:`~repro_torch.dist.local.summed_gradient`)."""
    B, S, d = x.shape
    e = cfg.num_experts
    g = min(4096, S)
    n_groups = B * S // g
    xg = x.reshape(n_groups, g, d)
    gates, top_vals, top_idx, pos, keep = moe_route(p, xg, cfg)
    cap = moe_capacity(cfg, g)
    dev = x.device
    # slot (expert, c) of a kept entry: [G,g,k,E,C], summed over k
    at = ((top_idx[..., None] == torch.arange(e, device=dev))[..., None]
          & (pos[..., None, None] == torch.arange(cap, device=dev))
          & keep[..., None, None])
    dispatch = at.sum(2, dtype=x.dtype)                               # [G,g,E,C]
    combine = (at * whole_grad(top_vals)[..., None, None]).sum(2).to(x.dtype)  # [G,g,E,C]

    # expert inputs [E, G*C, d]: every slot's token (0 where empty)
    xe = torch.bmm(dispatch.reshape(n_groups, g, e * cap).transpose(1, 2), whole_grad(xg))
    xe = xe.reshape(n_groups, e, cap, d).transpose(0, 1).reshape(e, n_groups * cap, d)
    h = silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    if partial:
        ye, combine = _BmmF32.apply(h, p["w_down"]), combine.float()
    else:
        ye = torch.bmm(h, p["w_down"])                                # [E, G*C, d]
    ye = ye.reshape(e, n_groups, cap, d).transpose(0, 1).reshape(n_groups, e * cap, d)
    y = torch.bmm(combine.reshape(n_groups, g, e * cap), ye).reshape(B, S, d)

    # load-balance auxiliary loss (Switch-style)
    counts = torch.zeros_like(gates).scatter_add_(
        2, top_idx, torch.ones_like(top_vals))                       # [G,g,E]
    density = counts.mean(1)
    router_prob = gates.mean(1)
    aux = (density * router_prob).sum(-1).mean() * (e / cfg.top_k)
    return y, aux


def _apply_moe_sharded(p, x, cfg: ModelConfig, ctx):
    """The routed experts on a mesh, where the rules shard each expert's
    hidden dimension (``expert_ffn``) over the model axis, leave the
    experts whole and, in training, shard the weights' ``embed`` over
    "data" (FSDP: a block's body takes its weights through
    :meth:`ShardCtx.param`, which gathers it inside the remat block, so
    the recompute gathers it again; a weight still sharded over "data"
    here raises). The reference's
    constraints put the dispatched tokens' expert dimension on the model
    axis, which under placements as explicit as the port's would gather
    every expert weight (6.34 GB a layer and a step for dbrx-132b). Here
    each rank runs the layer on its own rows of ``x`` (the batch over
    "data"; a group is a sequence's tokens, so a rank's rows are whole
    groups) and on all of them over "model": every rank routes its tokens
    alike (the router is whole), runs ``w_gate``/``w_up`` on its columns
    and ``w_down`` on its rows, and the partial sums are reduced once, in
    f32, after the combine product (the smaller tensor, ``[B, S, d]``),
    then rounded once to ``x``'s type, as :func:`_row_parallel` does. A
    hidden dimension the model axis does not divide is whole on every
    rank (the rules' fallback), and the layer is then one rank's whole
    result.

    Under autograd the gradients of the tokens entering the dispatch
    product and of the gates entering the combine product are each model
    rank's partial sum (its columns): :func:`~repro_torch.dist.local.
    summed_gradient` sums them there over "model", so the router's and
    ``x``'s gradients come out whole and equal on every model rank, and
    the aux loss, which every model rank computes alike, reaches the
    router once. Each weight's gradient is a partial sum over the rows'
    ranks, which :meth:`ShardCtx.param`'s backward reduces (scatters,
    where FSDP shards it). The aux loss is the mean over every rank's
    rows (:func:`~repro_torch.dist.local.row_mean`), a plain 0-d tensor
    equal on every rank, as the reference's mean over all groups."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    w = {k: p[k] for k in ("router", "w_gate", "w_up", "w_down")}
    mesh = w["w_down"].device_mesh
    ffn = sorted(i for i, pl in enumerate(w["w_down"].placements) if pl.is_shard(1))
    for name, dim in (("w_gate", 2), ("w_up", 2), ("w_down", 1), ("router", None)):
        placed = w[name].placements
        if any(not (pl.is_replicate() or (dim is not None and pl.is_shard(dim) and i in ffn))
               for i, pl in enumerate(placed)):
            raise ValueError(f"the MoE layer on a mesh shards each expert's hidden "
                             f"dimension alone; {name} is placed {placed}")
    xp = tuple(x.placements)
    rows = [i for i, pl in enumerate(xp) if pl.is_shard(0)]
    if any(not (pl.is_replicate() or pl.is_shard(0)) for pl in xp) or set(rows) & set(ffn):
        raise ValueError(f"the MoE layer on a mesh takes its input whole but for its "
                         f"rows, on other mesh dimensions than the experts' hidden one; "
                         f"got {xp}")
    local = {k: t.to_local(grad_placements=tuple(
                 Partial() if i in rows else pl for i, pl in enumerate(t.placements)))
             for k, t in w.items()}
    y, aux = _moe_experts(local, x.to_local(grad_placements=xp), cfg, partial=bool(ffn),
                          whole_grad=lambda t: summed_gradient(t, mesh, ffn))
    placements = [Shard(0) if i in rows else Partial() if i in ffn else Replicate()
                  for i in range(mesh.ndim)]
    y = ctx.constrain(place_block(y, mesh, placements, x.shape),
                      ("batch", "seq", "embed_act"))
    return y.to(x.dtype), row_mean(aux, mesh, rows)


def apply_ffn_or_moe(p, x, cfg: ModelConfig, ctx=NULL_CTX):
    """A block's feed-forward: the MoE layer where ``cfg.num_experts`` is
    set, else the FFN. Returns ``(y, aux)``, the MoE layer's load-balance
    loss or 0.0 for the FFN, as the reference's blocks return it."""
    if cfg.num_experts:
        return apply_moe(p, x, cfg, ctx)
    return apply_ffn(p, x, ctx), 0.0


# ================================================================ dense block
def describe_dense_block(cfg: ModelConfig):
    return {
        "ln1": Leaf((cfg.d_model,), ("embed_act",), init="zeros"),
        "attn": describe_attention(cfg),
        "ln2": Leaf((cfg.d_model,), ("embed_act",), init="zeros"),
        "ffn": describe_moe(cfg) if cfg.num_experts else describe_ffn(cfg),
    }


def apply_dense_block(
    p, x, cfg: ModelConfig, *, positions, window=None, cache=None, lengths=None,
    prefix=None, prefix_valid=None, page_tokens: int = 16,
    ring_window: int | None = None, causal: bool = True, with_aux: bool = False,
    ctx=NULL_CTX,
):
    """One transformer block. Modes (with ``with_aux`` each returns
    ``(x, kv, aux)``, ``aux`` the MoE layer's load-balance loss or 0.0, as the
    reference's block does; the training loss reads it):

    * sequence mode (``cache`` is None): returns ``(x, (k, v))``; attention
      is causal unless ``causal=False`` (whisper's encoder). With
      ``prefix=(pk, pv)`` (chunked prefill over a radix-cached prefix),
      attention runs over concat(prefix, current) — positions must
      already be offset by the prefix length. ``prefix_valid`` marks how
      many prefix positions are real when the prefix is padded to a
      bucket; positions in ``[prefix_valid, Sp)`` are masked. It may be a
      0-dim int32 tensor on the device, which goes to the flash kernel as
      the hole's lower end as it is (the upper end and ``q_offset`` are
      ``Sp``, fixed by the shapes).
    * decode mode (``cache = (k_cache, v_cache)`` slot buffers
      ``[B, S, KH, HD]``): writes the new token at ``lengths - 1`` in
      place, where the reference returned updated buffers, then attends
      through :func:`decode_attention` (``page_tokens`` is the page size
      the kernel reads the slots in); returns ``(x, (k_cache, v_cache))``.
      With ``ring_window`` the slots are a ring holding the last
      ``ring_window`` tokens (gemma2's window-limited local cache): the
      token goes to slot ``(lengths - 1) % ring_window`` and attention
      covers the first ``min(lengths, ring_window)`` slots with no window
      (RoPE is baked into K, and attention does not depend on the order
      of its keys). On the card the slots are read as pages, so a ring
      that fills its cache must be a whole number of ``page_tokens``-token
      pages (:func:`slot_pages` raises otherwise).

    ``ctx`` places the activations on a mesh; in decode mode the slot
    buffers are then this rank's own block of the KV heads (plain
    tensors), written with the rank's block of the new token's KV and
    read through :func:`decode_attention` as DTensors placed by KV heads.
    """
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    a_in = rmsnorm(x, p["ln1"])
    q, k, v = _project_qkv(p["attn"], a_in, h, kh, hd, positions, cfg.rope_theta, ctx)
    if cache is None:
        k_att, v_att, q_off, hole = k, v, 0, None
        if prefix is not None:
            pk, pv = prefix
            k_att = torch.cat([pk.to(k.dtype), k], dim=1)
            v_att = torch.cat([pv.to(v.dtype), v], dim=1)
            q_off = pk.shape[1]
            if prefix_valid is not None:
                hole = (prefix_valid, q_off)
        attn = prefill_attention(
            q, k_att, v_att, causal=causal, window=window,
            cap=cfg.attn_logit_softcap, q_offset=q_off, kv_hole=hole,
        )
        B, S, _, _ = attn.shape
        attn = attn.reshape(B, S, h * hd)
        new_kv = (k, v)
    else:
        k_cache, v_cache = cache
        if ring_window is not None:
            idx = (lengths - 1) % ring_window
            attn_lengths = torch.clamp(lengths, max=ring_window)
            window = None
        else:
            idx = lengths - 1                                  # write position
            attn_lengths = lengths
        _write_slot(k_cache, ctx.local(k)[:, 0], idx)
        _write_slot(v_cache, ctx.local(v)[:, 0], idx)
        attn = decode_attention(
            q[:, 0], *slot_operands(ctx, k_cache, v_cache, kh), lengths=attn_lengths,
            window=window, cap=cfg.attn_logit_softcap, page_tokens=page_tokens,
        )[:, None, :]
        new_kv = (k_cache, v_cache)
    x = x + _row_parallel(ctx, attn, p["attn"]["wo"])
    f_out, aux = apply_ffn_or_moe(p["ffn"], rmsnorm(x, p["ln2"]), cfg, ctx)
    x = ctx.constrain(x + f_out, ("batch", "seq", "embed_act"))
    return (x, new_kv, aux) if with_aux else (x, new_kv)


def _write_slot(cache, new, idx):
    """cache: [B, S, ...]; new: [B, ...]; idx: [B] position per row.
    Writes in place (the reference returned the updated array)."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, idx.long()] = new.to(cache.dtype)


def apply_dense_block_paged(
    p, x, cfg: ModelConfig, *, k_pages, v_pages, block_tables, lengths,
    k_scales=None, v_scales=None, window=None, ctx=NULL_CTX,
):
    """Decode mode of :func:`apply_dense_block` over a *paged* KV pool.

    Takes one layer's slice of the ``PagePool`` (``k_pages``/``v_pages``
    ``[N, T, KH, HD]``) *read-only* and attends through ``block_tables``
    ``[B, P]``. The new token's KV (global position ``lengths[b] - 1``) is
    an operand of the attention kernel, which reads it in place of the
    pool at that position; it is *returned*, not written — the caller
    commits every layer's append to the pool after the layer loop. On an
    int8-resident pool ``k_scales``/``v_scales`` carry this layer's
    per-page dequant sidecar (``[N]``).
    Returns ``(x', (k_new, v_new))`` with k_new/v_new ``[B, KH, HD]``.
    On a mesh (``ctx``) the pages are the rank's own blocks of the pool
    and k_new/v_new DTensors placed by KV heads.
    """
    h_, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    B = x.shape[0]
    a_in = rmsnorm(x, p["ln1"])
    positions = (lengths - 1)[:, None]
    q, k, v = _project_qkv(p["attn"], a_in, h_, kh, hd, positions, cfg.rope_theta, ctx)
    k_new, v_new = k[:, 0], v[:, 0]
    attn = paged_attention_decode(
        q[:, 0], k_new, v_new, k_pages, v_pages, block_tables, lengths,
        k_scales, v_scales, softcap=cfg.attn_logit_softcap, window=window,
    )                                                      # [B, H, D]
    x = x + _row_parallel(ctx, attn.reshape(B, 1, h_ * hd), p["attn"]["wo"])
    f_out, _ = apply_ffn_or_moe(p["ffn"], rmsnorm(x, p["ln2"]), cfg, ctx)
    x = ctx.constrain(x + f_out, ("batch", "seq", "embed_act"))
    return x, (k_new, v_new)


# ============================================================== mamba2 block
def describe_mamba_block(cfg: ModelConfig):
    d = cfg.d_model
    inner = cfg.ssm_inner
    h, n, w = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_conv_width
    g = 1  # single B/C group
    conv_dim = inner + 2 * g * n
    return {
        "ln": Leaf((d,), ("embed_act",), init="zeros"),
        "in_proj": Leaf((d, 2 * inner + 2 * g * n + h), ("embed", "ssm_heads")),
        "conv_w": Leaf((w, conv_dim), ("conv", "ssm_heads"), scale=0.2),
        "conv_b": Leaf((conv_dim,), ("ssm_heads",), init="zeros"),
        "dt_bias": Leaf((h,), ("ssm_heads",), init="zeros"),
        "A_log": Leaf((h,), ("ssm_heads",), scale=0.5),
        "D": Leaf((h,), ("ssm_heads",), init="ones"),
        "norm": Leaf((inner,), ("ssm_heads",), init="zeros"),
        "out_proj": Leaf((inner, d), ("ssm_heads", "embed")),
    }


def mamba_columns(cfg: ModelConfig, rank: int, size: int, device=None):
    """The columns a rank at position ``rank`` of ``size`` over the model
    axis takes of the Mamba-2 block's whole ``in_proj`` product ``[z | x |
    B | C | dt]`` and of the conv's channels ``[x | B | C]``: its heads'
    ``z``, ``x`` and ``dt`` and all of ``B`` and ``C`` (one group, which
    every head reads). Returns ``(proj, conv)``, int64 indices. The
    rank's conv state holds the conv channels in this order."""
    inner, n, h = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads

    def span(lo, hi):
        return torch.arange(lo, hi, device=device)

    heads = span(rank * inner // size, (rank + 1) * inner // size)
    conv = torch.cat([heads, span(inner, inner + 2 * n)])
    dt0 = 2 * inner + 2 * n
    proj = torch.cat([heads, inner + conv, span(dt0 + rank * h // size,
                                                dt0 + (rank + 1) * h // size)])
    return proj, conv


@dataclass(frozen=True)
class _HeadShard:
    """This rank's share of the Mamba-2 block's SSD heads: position
    ``rank`` of ``size`` along mesh dimension ``dim``."""

    mesh: object
    dim: int
    rank: int
    size: int

    def columns(self, t, idx):
        return gather_columns(t, self.mesh, self.dim, idx)

    def mean(self, t):
        return mean_over_ranks(t, self.mesh, self.dim)


def apply_mamba_block(p, x, cfg: ModelConfig, *, cache=None, ctx=NULL_CTX):
    """Mamba-2 block. Sequence mode: ``cache=None`` -> ``(y, (ssm_state,
    conv_state))``, the scan through :func:`repro_torch.kernels.ssd.ops.ssd`.
    Decode mode: ``cache=(ssm_state [B,H,P,N], conv_state [B,W-1,conv_dim])``,
    one token through the plain ``ssd_decode_step``.

    On a mesh (the weights DTensors, ``x`` the residual stream, whole but
    for its rows) the block runs on each rank's rows and, where the rules
    shard ``ssm_heads`` over the model axis, on its heads alone
    (:func:`_apply_mamba_sharded`); the caches are then the rank's own
    plain tensors: the state its heads', the conv state its heads' ``x``
    channels and then all of ``B`` and ``C`` (:func:`mamba_columns`)."""
    if is_dtensor(x):
        return _apply_mamba_sharded(p, x, cfg, cache, ctx)
    y, new_cache = _mamba_body(p, x, cfg, cache)
    return x + y @ p["out_proj"], new_cache


def _mamba_body(p, x, cfg: ModelConfig, cache, heads: _HeadShard | None = None):
    """The Mamba-2 block up to ``out_proj`` on plain tensors: returns the
    gated, normed ``y`` and the new cache. With ``heads`` ``p`` holds one
    rank's blocks (``in_proj`` and the conv's leaves contiguous blocks of
    their columns, the rest its heads') and ``y`` is its heads' columns:
    the rank's columns of the ``in_proj`` product and of the conv's leaves
    are gathered and selected (:func:`mamba_columns`), and the gated norm
    takes its mean over every rank's columns."""
    inner, n, hh, w = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv_width
    hp = cfg.ssm_head_dim
    xn = rmsnorm(x, p["ln"])
    conv_w, conv_b, mean = p["conv_w"], p["conv_b"], None
    if heads is None:
        zxbcdt = xn @ p["in_proj"]
    else:
        inner, hh, mean = inner // heads.size, hh // heads.size, heads.mean
        proj, conv = mamba_columns(cfg, heads.rank, heads.size, x.device)
        # xn's gradient along the rank's block of in_proj is its share
        xn = summed_gradient(xn, heads.mesh, [heads.dim])
        zxbcdt = heads.columns(xn @ p["in_proj"], proj)
        conv_w, conv_b = heads.columns(conv_w, conv), heads.columns(conv_b, conv)
    z = zxbcdt[..., :inner]
    xBC = zxbcdt[..., inner:2 * inner + 2 * n]
    dt = zxbcdt[..., 2 * inner + 2 * n:]
    A = -torch.exp(p["A_log"].to(F32))

    if cache is None:
        B_, S, _ = x.shape
        # causal depthwise conv over [B,S,conv_dim]
        pad = torch.nn.functional.pad(xBC, (0, 0, w - 1, 0))
        conv_state = pad[:, -(w - 1):, :] if w > 1 else None
        xBC = _causal_conv(pad, conv_w, conv_b, S)
        xs, Bmat, Cmat = xBC[..., :inner], xBC[..., inner:inner + n], xBC[..., inner + n:]
        xs = xs.reshape(B_, S, hh, hp)
        dt = softplus(dt.to(F32) + p["dt_bias"].to(F32))
        y, final_state = ssd(xs, dt, A, Bmat, Cmat, chunk=cfg.ssm_chunk)
        y = y + xs * p["D"].to(x.dtype)[None, None, :, None]
        y = y.reshape(B_, S, inner)
        new_cache = (final_state.to(F32), conv_state)
    else:
        ssm_state, conv_state = cache
        B_ = x.shape[0]
        xBC1 = xBC[:, 0]                                         # [B, conv_dim]
        window = torch.cat([conv_state, xBC1[:, None, :]], dim=1)   # [B, W, c]
        xBC1 = torch.einsum("bwc,wc->bc", window, conv_w) + conv_b
        xBC1 = silu(xBC1)
        new_conv = window[:, 1:, :]
        xs = xBC1[..., :inner].reshape(B_, hh, hp)
        Bmat = xBC1[..., inner:inner + n][:, None, :]
        Cmat = xBC1[..., inner + n:][:, None, :]
        dt1 = softplus(dt[:, 0].to(F32) + p["dt_bias"].to(F32))
        y, new_state = ssd_decode_step(ssm_state, xs, dt1, A, Bmat, Cmat)
        y = y + xs * p["D"].to(x.dtype)[None, :, None]
        y = y.reshape(B_, 1, inner)
        new_cache = (new_state, new_conv)

    y = y * silu(z)
    return rmsnorm(y, p["norm"], group_mean=mean), new_cache


#: the Mamba-2 block's leaves and the dimension of each that the rules
#: shard by heads (``None``: never sharded)
_MAMBA_HEAD_DIMS = {"ln": None, "in_proj": 1, "conv_w": 1, "conv_b": 0, "dt_bias": 0,
                    "A_log": 0, "D": 0, "norm": 0, "out_proj": 0}


def _apply_mamba_sharded(p, x, cfg: ModelConfig, cache, ctx):
    """The Mamba-2 block on a mesh. Each rank runs its own rows of ``x``
    (the batch over "data") and, where the rules shard ``ssm_heads`` over
    "model", its own heads: the SSD scan, forward and backward, sees
    those alone, made contiguous. The leaves the rules shard by heads
    split ``in_proj``'s product ``[z | x | B | C | dt]`` and the conv's
    ``[x | B | C]`` in contiguous halves that are not a rank's heads (at
    mamba2-2.7b's width rank 0's half of ``in_proj`` holds all of ``z``):
    each rank takes its block of the product, ``xn @ in_proj`` on its
    columns, and of the conv's leaves, and :func:`~repro_torch.dist.local.
    gather_columns` gathers them and keeps the rank's heads' columns and
    all of ``B`` and ``C``. The product is gathered, not ``in_proj``
    (54 MB a layer at full width): in training a microbatch's product is
    about the weight's size and a decode step's a few kB; the conv's
    leaves are a few kB. Its backward sums each column's gradient over the
    ranks once, in f32: the ``B``/``C`` columns' (every rank's heads read
    them, so each rank's is a partial sum) and the heads' (one rank's,
    zeros elsewhere). ``xn``'s gradient along the product is each rank's
    partial sum, summed over "model" (:func:`~repro_torch.dist.local.
    summed_gradient`). The gated norm's mean runs over every rank's
    columns (:func:`~repro_torch.dist.local.mean_over_ranks`, forward and
    backward), and ``y @ out_proj`` (its rows the rank's heads) is each
    rank's partial sum, reduced in f32 and rounded once, as
    :func:`_row_parallel` does. Where the model axis does not divide the
    heads the rules replicate ``ssm_heads`` and the block runs whole on
    every rank, as the reference's does.

    Weights whose "embed" FSDP shards come here gathered
    (:meth:`ShardCtx.param`); each leaf's gradient is a partial sum over
    the rows' ranks, which that gather's backward reduces."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = p["in_proj"].device_mesh
    tp = [i for i, pl in enumerate(p["in_proj"].placements) if pl.is_shard(1)]
    for name, dim in _MAMBA_HEAD_DIMS.items():
        placed = p[name].placements
        if any(not (pl.is_replicate() or (dim is not None and pl.is_shard(dim) and i in tp))
               for i, pl in enumerate(placed)) or (dim is not None and len(tp) != sum(
                   pl.is_shard() for pl in placed)):
            raise ValueError(f"the Mamba-2 block on a mesh shards every ssm_heads leaf by "
                             f"its heads on one mesh dimension, or none; {name} is placed "
                             f"{placed}, in_proj {p['in_proj'].placements}")
    if len(tp) > 1:
        raise ValueError(f"SSD heads sharded over more than one mesh dimension: "
                         f"{p['in_proj'].placements}")
    xp = tuple(x.placements)
    rows = [i for i, pl in enumerate(xp) if pl.is_shard(0)]
    if any(not (pl.is_replicate() or pl.is_shard(0)) for pl in xp) or set(rows) & set(tp):
        raise ValueError(f"the Mamba-2 block on a mesh takes its input whole but for its "
                         f"rows, on other mesh dimensions than its heads; got {xp}")
    local = {k: p[k].to_local(grad_placements=tuple(
                 Partial() if i in rows else pl for i, pl in enumerate(p[k].placements)))
             for k in _MAMBA_HEAD_DIMS}
    heads = (_HeadShard(mesh, tp[0], mesh.get_local_rank(tp[0]), mesh.size(tp[0]))
             if tp else None)
    y, new_cache = _mamba_body(local, x.to_local(grad_placements=xp), cfg, cache, heads)
    if heads is None:
        y = y @ local["out_proj"]
    else:
        y = y.float() @ local["out_proj"].float()
    placements = [Shard(0) if i in rows else Partial() if i in tp else Replicate()
                  for i in range(mesh.ndim)]
    y = redistribute(place_block(y, mesh, placements, x.shape), xp)
    return x + y.to(x.dtype), new_cache


def _causal_conv(padded, w, b, out_len):
    """padded: [B, S+W-1, C]; depthwise causal conv, silu."""
    W = w.shape[0]
    out = sum(padded[:, i:i + out_len, :] * w[i][None, None, :] for i in range(W))
    return silu(out + b)


# =================================================== zamba2 shared attention
def describe_shared_block(cfg: ModelConfig):
    """Zamba2: ONE transformer block shared across the depth, operating on
    concat(hidden, initial embedding) = 2*d_model, projected back to d_model."""
    d2 = 2 * cfg.d_model
    hd = cfg.hybrid_head_dim
    return {
        "ln1": Leaf((d2,), ("embed_act",), init="zeros"),
        "attn": describe_attention(cfg, d_in=d2, heads=cfg.num_heads,
                                   kv_heads=cfg.num_kv_heads, head_dim=hd, bias=False),
        "ln2": Leaf((d2,), ("embed_act",), init="zeros"),
        "ffn": describe_ffn(cfg, d_in=d2, d_ff=cfg.d_ff, d_out=d2),
        "down": Leaf((d2, cfg.d_model), ("embed", None)),
    }


def apply_shared_block(p, h, x0, cfg: ModelConfig, *, positions, cache=None,
                       lengths=None, page_tokens: int = 16, ctx=NULL_CTX):
    """h: hidden [B,S,d]; x0: initial embedding [B,S,d]. Returns ``(h', kv)``.

    Sequence mode (``cache`` None): causal attention through
    :func:`prefill_attention` (the flash kernel on the card); ``kv`` is this
    call's ``(k, v)``. Decode mode (``cache = (k_cache, v_cache)`` slot
    buffers ``[B, S, KH, hybrid_head_dim]``): the token is written at
    ``lengths - 1`` in place and attends through :func:`decode_attention`
    (the paged kernel over the slots on the card); ``kv`` is the caches.

    On a mesh (``ctx``) the block runs as the dense block does: each rank
    attends its own heads, ``wo`` and the FFN's ``w_down`` reduce their
    partial sums in f32, and the slot buffers are the rank's own block of
    the KV heads."""
    heads, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hybrid_head_dim
    xin = torch.cat([h, x0], dim=-1)                          # [B,S,2d]
    a_in = rmsnorm(xin, p["ln1"])
    q, k, v = _project_qkv(p["attn"], a_in, heads, kh, hd, positions, cfg.rope_theta, ctx)
    if cache is None:
        attn = prefill_attention(q, k, v, causal=True)
        B, S = attn.shape[:2]
        attn = attn.reshape(B, S, heads * hd)
        new_kv = (k, v)
    else:
        k_cache, v_cache = cache
        idx = lengths - 1
        _write_slot(k_cache, ctx.local(k)[:, 0], idx)
        _write_slot(v_cache, ctx.local(v)[:, 0], idx)
        attn = decode_attention(q[:, 0], *slot_operands(ctx, k_cache, v_cache, kh),
                                lengths=lengths, page_tokens=page_tokens)[:, None, :]
        new_kv = (k_cache, v_cache)
    xin = xin + _row_parallel(ctx, attn, p["attn"]["wo"])
    xin = xin + apply_ffn(p["ffn"], rmsnorm(xin, p["ln2"]), ctx)
    return ctx.constrain(h + xin @ p["down"], ("batch", "seq", "embed_act")), new_kv
