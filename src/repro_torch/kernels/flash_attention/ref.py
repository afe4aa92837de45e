"""Plain PyTorch versions of sequence (prefill) attention.

``flash_attention_ref`` is the counterpart of
``repro/kernels/flash_attention/ref.py`` (a dense masked softmax, layout
``[B, H, S, D]``); ``blockwise_attention`` is the counterpart of
``repro/models/layers.py::blockwise_attention`` (an online softmax over
blocks, the model's layout ``[B, S, H, D]``, with ``kv_lengths`` and
``kv_hole``), which the model's prefill runs on CPU tensors. The Hopper
kernel (``csrc/flash_attention.cu``) is held against both on the card.
``flash_attention_bwd_ref`` is the plain version of the backward kernel
(``csrc/flash_attention_bwd.cu``): autograd through
``blockwise_attention`` in f32. The tests and the smoke run hold the
kernel against it; no training path calls it.
"""
from __future__ import annotations

import torch

F32 = torch.float32


def flash_attention_ref(q, k, v, *, causal=True, window=None, softcap=None, q_offset=0):
    """q [B,H,Sq,D]; k,v [B,KH,Skv,D] -> [B,H,Sq,D]."""
    B, H, Sq, D = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    G = H // KH
    dev = q.device
    qf = q.reshape(B, KH, G, Sq, D).to(F32) * (D ** -0.5)
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, k.to(F32))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = q_offset + torch.arange(Sq, device=dev)[:, None]
    kpos = torch.arange(Skv, device=dev)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=dev)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = torch.where(mask[None, None, None], s, -1e30)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", w, v.to(F32))
    return out.reshape(B, H, Sq, D).to(q.dtype)


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
            if cap is not None:
                s = cap * torch.tanh(s / cap)
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


def flash_attention_bwd_ref(q, k, v, do, *, causal: bool, window: int | None = None,
                            cap: float | None = None):
    """dq, dk, dv (f32) of :func:`blockwise_attention` on ``q, k, v``
    ([B, S, H, D], the model's layout) cast to f32, for the output
    gradient ``do``: ``torch.autograd.grad`` through the plain forward."""
    with torch.enable_grad():
        qf, kf, vf = (t.detach().to(F32).requires_grad_(True) for t in (q, k, v))
        out = blockwise_attention(qf, kf, vf, causal=causal, window=window, cap=cap)
        return torch.autograd.grad(out, (qf, kf, vf), do.to(F32))
