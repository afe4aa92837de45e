"""Block library of the port: the dense, non-alternating family.

The counterpart of ``repro/models/layers.py``. Every block is a
(``describe_*``, ``apply_*``) pair: ``describe_*`` builds a dict of
:class:`~repro_torch.models.params.Leaf` descriptors, ``apply_*`` is a
plain function of one layer's parameters (anything indexable by leaf
name) and the activations. Layers are stacked along a leading ``[L, ...]``
dimension of the stored tensors (:func:`stack`), and the model loops over
the layer index where the reference ran ``lax.scan``.

Prefill attention is :func:`blockwise_attention` (online softmax in plain
PyTorch, as the reference's is in plain jnp). Decode attention reads the
paged pool through :func:`repro_torch.kernels.paged_attention.ops.paged_attention_decode`,
which launches the Hopper kernel for CUDA tensors. The large projections
(QKV, wo, FFN) stay ``torch.matmul``, as the reference leaves them to XLA.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.ops import paged_attention_decode
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
def describe_attention(cfg: ModelConfig):
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": Leaf((d, h * hd), ("embed", "heads")),
        "wk": Leaf((d, kh * hd), ("embed", "heads")),
        "wv": Leaf((d, kh * hd), ("embed", "heads")),
        "wo": Leaf((h * hd, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = Leaf((h * hd,), ("heads",), init="zeros")
        p["bk"] = Leaf((kh * hd,), ("heads",), init="zeros")
        p["bv"] = Leaf((kh * hd,), ("heads",), init="zeros")
    return p


def _project_qkv(p, x, h, kh, hd, positions, theta):
    B, S, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, h, hd)
    k = k.reshape(B, S, kh, hd)
    v = v.reshape(B, S, kh, hd)
    return rope(q, positions, theta), rope(k, positions, theta), v


def _largest_divisor(n: int, pref: int) -> int:
    """Largest divisor of ``n`` that is <= ``pref``."""
    d = min(pref, n)
    while n % d:
        d -= 1
    return d


def blockwise_attention(
    q, k, v, *, causal: bool, window: int | None = None, cap: float | None = None,
    q_offset: int = 0, kv_lengths=None, kv_hole=None, q_block: int = 512,
    kv_block: int = 1024,
):
    """Flash-style online-softmax attention in plain PyTorch.

    q: [B, Sq, H, D]; k, v: [B, Skv, KH, D] (GQA: H = KH * G).
    ``q_offset``: absolute position of q[0] (chunked prefill).
    ``kv_lengths``: [B] valid KV lengths (None = all valid).
    ``kv_hole``: optional ``(lo, hi)`` — KV indices in ``[lo, hi)`` are
    masked for every query (the padding between a bucketed prefix's real
    length and its padded one).

    Scores and the P·V product accumulate in f32 from the bf16 operands
    (the reference's ``preferred_element_type=F32``); probabilities are
    rounded to q's dtype before the P·V product, as in the reference.
    """
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    if KH != H:
        k = torch.repeat_interleave(k, H // KH, dim=2)
        v = torch.repeat_interleave(v, H // KH, dim=2)
        KH = H
    G = H // KH
    qb = _largest_divisor(Sq, q_block)
    kb = _largest_divisor(Skv, kv_block)
    nq, nk = Sq // qb, Skv // kb
    scale = D ** -0.5
    dev = q.device

    # sliding-window block skip: a q block at positions [lo, lo+qb) only
    # sees kv blocks intersecting (lo - window, lo + qb); skipped blocks are
    # fully masked, so the skip is exact
    skip_blocks = (
        window is not None and causal and kv_lengths is None
        and kv_hole is None and (window + qb) // kb + 2 < nk
    )
    n_vis = min(nk, (window + qb) // kb + 2) if skip_blocks else nk
    k_pos_all = torch.arange(Skv, device=dev)

    outs = []
    for qi in range(nq):
        qblk = q[:, qi * qb:(qi + 1) * qb].reshape(B, qb, KH, G, D).to(F32)
        qp = q_offset + torch.arange(qi * qb, (qi + 1) * qb, device=dev)
        lo_blk = max(0, (q_offset + qi * qb - window + 1) // kb) if skip_blocks else 0
        m = torch.full((B, qb, KH, G), -1e30, dtype=F32, device=dev)
        l = torch.zeros((B, qb, KH, G), dtype=F32, device=dev)
        acc = torch.zeros((B, qb, KH, G, D), dtype=F32, device=dev)
        for j in range(n_vis):
            ki = lo_blk + j if skip_blocks else j
            in_range = ki < nk
            ki = min(ki, nk - 1)
            kblk = k[:, ki * kb:(ki + 1) * kb]
            vblk = v[:, ki * kb:(ki + 1) * kb]
            kp = k_pos_all[ki * kb:(ki + 1) * kb]
            s = torch.einsum("bqhgd,bkhd->bqhgk", qblk, kblk.to(F32)) * scale
            s = softcap(s, cap)
            mask = torch.full((qb, kb), in_range, dtype=torch.bool, device=dev)
            if causal:
                mask &= qp[:, None] >= kp[None, :]
            if window is not None:
                mask &= (qp[:, None] - kp[None, :]) < window
            m_ = mask[None, :, None, None, :]
            if kv_lengths is not None:
                m_ = m_ & (kp[None, :] < kv_lengths[:, None])[:, None, None, None, :]
            if kv_hole is not None:
                lo, hi = kv_hole
                m_ = m_ & ~((kp >= lo) & (kp < hi))[None, None, None, None, :]
            s = torch.where(m_, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            pexp = torch.exp(s - m_new[..., None])
            l = l * alpha + pexp.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", pexp.to(q.dtype).to(F32), vblk.to(F32)
            )
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])   # [B,qb,KH,G,D]
    out = torch.cat(outs, dim=1).reshape(B, Sq, H, D)
    return out.to(q.dtype)


# ======================================================================= FFN
def describe_ffn(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": Leaf((d, f), ("embed", "ffn")),
        "w_up": Leaf((d, f), ("embed", "ffn")),
        "w_down": Leaf((f, d), ("ffn", "embed")),
    }


def apply_ffn(p, x):
    g = x @ p["w_gate"]
    # silu as the reference computes it, x * 1/(1 + exp(-x)) rounding to
    # x's dtype after every op: bit-equal to XLA's bf16 expansion, where
    # F.silu rounds once
    h = (g * (1 / (1 + torch.exp(-g)))) * (x @ p["w_up"])
    return h @ p["w_down"]


# ================================================================ dense block
def describe_dense_block(cfg: ModelConfig):
    return {
        "ln1": Leaf((cfg.d_model,), ("embed_act",), init="zeros"),
        "attn": describe_attention(cfg),
        "ln2": Leaf((cfg.d_model,), ("embed_act",), init="zeros"),
        "ffn": describe_ffn(cfg),
    }


def apply_dense_block(
    p, x, cfg: ModelConfig, *, positions, window=None, prefix=None,
    prefix_valid=None,
):
    """One transformer block in sequence mode: returns ``(x, (k, v))``.

    With ``prefix=(pk, pv)`` (chunked prefill over a radix-cached prefix),
    attention runs over concat(prefix, current) — positions must already
    be offset by the prefix length. ``prefix_valid`` marks how many prefix
    positions are real when the prefix is padded to a bucket; positions in
    ``[prefix_valid, Sp)`` are masked.
    """
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    a_in = rmsnorm(x, p["ln1"])
    q, k, v = _project_qkv(p["attn"], a_in, h, kh, hd, positions, cfg.rope_theta)
    k_att, v_att, q_off, hole = k, v, 0, None
    if prefix is not None:
        pk, pv = prefix
        k_att = torch.cat([pk.to(k.dtype), k], dim=1)
        v_att = torch.cat([pv.to(v.dtype), v], dim=1)
        q_off = pk.shape[1]
        if prefix_valid is not None:
            hole = (prefix_valid, q_off)
    attn = blockwise_attention(
        q, k_att, v_att, causal=True, window=window,
        cap=cfg.attn_logit_softcap, q_offset=q_off, kv_hole=hole,
    )
    B, S, _, _ = attn.shape
    x = x + (attn.reshape(B, S, h * hd) @ p["attn"]["wo"])
    x = x + apply_ffn(p["ffn"], rmsnorm(x, p["ln2"]))
    return x, (k, v)


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
    x = x + apply_ffn(p["ffn"], rmsnorm(x, p["ln2"]))
    return x, (k_new, v_new)
