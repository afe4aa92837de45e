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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import leaf
from repro_torch.kernels.flash_attention.ops import prefill_attention
from repro_torch.kernels.flash_attention.ref import blockwise_attention  # noqa: F401 (re-export)
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ops import paged_attention, paged_attention_decode
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.kernels.ssd.ref import ssd_decode_step
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import Leaf

F32 = torch.float32


def stack(tree, n: int):
    """Add a leading stacked-layers dim to every Leaf."""
    if isinstance(tree, Leaf):
        return Leaf((n, *tree.shape), ("layers", *tree.axes), tree.dtype,
                    tree.scale, tree.init)
    return {k: stack(v, n) for k, v in tree.items()}


# =========================================================== tiny primitives
def rmsnorm(x, w, eps=1e-6):
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
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


def _project_qkv(p, x, h, kh, hd, positions, theta):
    B, S, _ = x.shape
    x = promote(x, p["wq"])
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, h, hd)
    k = k.reshape(B, S, kh, hd)
    v = v.reshape(B, S, kh, hd)
    return rope(q, positions, theta), rope(k, positions, theta), v


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
    """
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


def apply_ffn(p, x):
    h = silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


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


def apply_moe(p, x, cfg: ModelConfig):
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
    reference casts them.
    """
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
    combine = (at * top_vals[..., None, None]).sum(2).to(x.dtype)     # [G,g,E,C]

    # expert inputs [E, G*C, d]: every slot's token (0 where empty)
    xe = torch.bmm(dispatch.reshape(n_groups, g, e * cap).transpose(1, 2), xg)
    xe = xe.reshape(n_groups, e, cap, d).transpose(0, 1).reshape(e, n_groups * cap, d)
    h = silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"])                                    # [E, G*C, d]
    ye = ye.reshape(e, n_groups, cap, d).transpose(0, 1).reshape(n_groups, e * cap, d)
    y = torch.bmm(combine.reshape(n_groups, g, e * cap), ye).reshape(B, S, d)

    # load-balance auxiliary loss (Switch-style)
    counts = torch.zeros_like(gates).scatter_add_(
        2, top_idx, torch.ones_like(top_vals))                       # [G,g,E]
    density = counts.mean(1)
    router_prob = gates.mean(1)
    aux = (density * router_prob).sum(-1).mean() * (e / cfg.top_k)

    if "dense" in p:
        y = y + apply_ffn(p["dense"], x)
    return y, aux


def apply_ffn_or_moe(p, x, cfg: ModelConfig):
    """A block's feed-forward: the MoE layer where ``cfg.num_experts`` is
    set, else the FFN. Returns ``(y, aux)``, the MoE layer's load-balance
    loss or 0.0 for the FFN, as the reference's blocks return it."""
    if cfg.num_experts:
        return apply_moe(p, x, cfg)
    return apply_ffn(p, x), 0.0


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
      bucket; positions in ``[prefix_valid, Sp)`` are masked.
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
    """
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    a_in = rmsnorm(x, p["ln1"])
    q, k, v = _project_qkv(p["attn"], a_in, h, kh, hd, positions, cfg.rope_theta)
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
        _write_slot(k_cache, k[:, 0], idx)
        _write_slot(v_cache, v[:, 0], idx)
        attn = decode_attention(
            q[:, 0], k_cache, v_cache, lengths=attn_lengths, window=window,
            cap=cfg.attn_logit_softcap, page_tokens=page_tokens,
        )[:, None, :]
        new_kv = (k_cache, v_cache)
    x = x + (attn @ p["attn"]["wo"])
    f_out, aux = apply_ffn_or_moe(p["ffn"], rmsnorm(x, p["ln2"]), cfg)
    x = x + f_out
    return (x, new_kv, aux) if with_aux else (x, new_kv)


def _write_slot(cache, new, idx):
    """cache: [B, S, ...]; new: [B, ...]; idx: [B] position per row.
    Writes in place (the reference returned the updated array)."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, idx.long()] = new.to(cache.dtype)


def apply_dense_block_paged(
    p, x, cfg: ModelConfig, *, k_pages, v_pages, block_tables, lengths,
    k_scales=None, v_scales=None, window=None,
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
    """
    h_, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    B = x.shape[0]
    a_in = rmsnorm(x, p["ln1"])
    positions = (lengths - 1)[:, None]
    q, k, v = _project_qkv(p["attn"], a_in, h_, kh, hd, positions, cfg.rope_theta)
    k_new, v_new = k[:, 0], v[:, 0]
    attn = paged_attention_decode(
        q[:, 0], k_new, v_new, k_pages, v_pages, block_tables, lengths,
        k_scales, v_scales, softcap=cfg.attn_logit_softcap, window=window,
    )                                                      # [B, H, D]
    x = x + (attn.reshape(B, 1, h_ * hd) @ p["attn"]["wo"])
    f_out, _ = apply_ffn_or_moe(p["ffn"], rmsnorm(x, p["ln2"]), cfg)
    x = x + f_out
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


def _mamba_split(cfg: ModelConfig, zxbcdt):
    inner = cfg.ssm_inner
    n = cfg.ssm_state
    z = zxbcdt[..., :inner]
    xBC = zxbcdt[..., inner : 2 * inner + 2 * n]
    dt = zxbcdt[..., 2 * inner + 2 * n :]
    return z, xBC, dt


def apply_mamba_block(p, x, cfg: ModelConfig, *, cache=None):
    """Mamba-2 block. Sequence mode: ``cache=None`` -> ``(y, (ssm_state,
    conv_state))``, the scan through :func:`repro_torch.kernels.ssd.ops.ssd`.
    Decode mode: ``cache=(ssm_state [B,H,P,N], conv_state [B,W-1,conv_dim])``,
    one token through the plain ``ssd_decode_step``."""
    inner, n, hh, w = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv_width
    hp = cfg.ssm_head_dim
    res = x
    xn = rmsnorm(x, p["ln"])
    zxbcdt = xn @ p["in_proj"]
    z, xBC, dt = _mamba_split(cfg, zxbcdt)
    A = -torch.exp(p["A_log"].to(F32))

    if cache is None:
        B_, S, _ = x.shape
        # causal depthwise conv over [B,S,conv_dim]
        pad = torch.nn.functional.pad(xBC, (0, 0, w - 1, 0))
        conv_state = pad[:, -(w - 1):, :] if w > 1 else None
        xBC = _causal_conv(pad, p["conv_w"], p["conv_b"], S)
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
        xBC1 = torch.einsum("bwc,wc->bc", window, p["conv_w"]) + p["conv_b"]
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
    y = rmsnorm(y, p["norm"])
    out = res + y @ p["out_proj"]
    return out, new_cache


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
                       lengths=None, page_tokens: int = 16):
    """h: hidden [B,S,d]; x0: initial embedding [B,S,d]. Returns ``(h', kv)``.

    Sequence mode (``cache`` None): causal attention through
    :func:`prefill_attention` (the flash kernel on the card); ``kv`` is this
    call's ``(k, v)``. Decode mode (``cache = (k_cache, v_cache)`` slot
    buffers ``[B, S, KH, hybrid_head_dim]``): the token is written at
    ``lengths - 1`` in place and attends through :func:`decode_attention`
    (the paged kernel over the slots on the card); ``kv`` is the caches."""
    heads, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hybrid_head_dim
    xin = torch.cat([h, x0], dim=-1)                          # [B,S,2d]
    a_in = rmsnorm(xin, p["ln1"])
    q, k, v = _project_qkv(p["attn"], a_in, heads, kh, hd, positions, cfg.rope_theta)
    if cache is None:
        attn = prefill_attention(q, k, v, causal=True)
        B, S = attn.shape[:2]
        attn = attn.reshape(B, S, heads * hd)
        new_kv = (k, v)
    else:
        k_cache, v_cache = cache
        idx = lengths - 1
        _write_slot(k_cache, k[:, 0], idx)
        _write_slot(v_cache, v[:, 0], idx)
        attn = decode_attention(q[:, 0], k_cache, v_cache, lengths=lengths,
                                page_tokens=page_tokens)[:, None, :]
        new_kv = (k_cache, v_cache)
    xin = xin + attn @ p["attn"]["wo"]
    xin = xin + apply_ffn(p["ffn"], rmsnorm(xin, p["ln2"]))
    return h + xin @ p["down"], new_kv
