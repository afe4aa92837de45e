"""Plain PyTorch version of paged decode attention: gather pages densely,
run masked softmax attention. The port's counterpart of
``repro/kernels/paged_attention/ref.py``.

Semantics (shared with the CUDA kernel in ``csrc/paged_attention.cu``):

* GQA — ``H = KH * G`` query heads share KH KV heads;
* ``softcap`` — gemma2-style logit capping ``cap * tanh(s / cap)``;
* ``window`` — only the last ``window`` positions
  (``[length - window, length)``) are visible;
* ragged ``lengths`` — positions at or past a sequence's length are
  masked, so partially filled tail pages and the padding of a block
  table never reach the output;
* ``k_scales``/``v_scales`` — int8 pools: pages are dequantized *in the
  gather* (``q_page.float() * scale[page]``), as the kernel does per tile.

The wrapper in ``ops.py`` uses these functions for CPU tensors only.
"""
from __future__ import annotations

import torch

F32 = torch.float32


def _gather_pages(k_pages, v_pages, block_tables, k_scales, v_scales):
    """Dense gather -> ``[B, P*T, KH, D]``, dequantizing int8 pools."""
    B, P = block_tables.shape
    T, KH, D = k_pages.shape[1:]
    idx = block_tables.long()
    k = k_pages[idx]                                 # [B, P, T, KH, D]
    v = v_pages[idx]
    if k_scales is not None:
        k = k.to(F32) * k_scales[idx][..., None, None, None]
        v = v.to(F32) * v_scales[idx][..., None, None, None]
    return k.reshape(B, P * T, KH, D), v.reshape(B, P * T, KH, D)


def paged_attention_ref(
    q, k_pages, v_pages, block_tables, lengths,
    k_scales=None, v_scales=None, *, softcap=None, window=None,
):
    k, v = _gather_pages(k_pages, v_pages, block_tables, k_scales, v_scales)
    return _gathered_attention(q, k, v, lengths, softcap, window)


def paged_attention_decode_ref(
    q, k_new, v_new, k_pages, v_pages, block_tables, lengths,
    k_scales=None, v_scales=None, *, softcap=None, window=None,
):
    """Decode step where the current token's KV (``k_new``/``v_new``
    ``[B, KH, D]``, global position ``lengths - 1``) has *not* been
    written to the pool yet: it is inserted into the gathered context.
    On an int8 pool the insert lands in the dequantized f32 gather, so the
    new token is attended at full precision."""
    B = q.shape[0]
    k, v = _gather_pages(k_pages, v_pages, block_tables, k_scales, v_scales)
    rows = torch.arange(B, device=q.device)
    pos = lengths.long() - 1
    k = k.clone()
    v = v.clone()
    k[rows, pos] = k_new.to(k.dtype)
    v[rows, pos] = v_new.to(v.dtype)
    return _gathered_attention(q, k, v, lengths, softcap, window)


def _gathered_attention(q, k, v, lengths, softcap, window):
    B, H, D = q.shape
    S = k.shape[1]
    KH = k.shape[2]
    G = H // KH
    k = k.to(F32)
    v = v.to(F32)
    qf = q.reshape(B, KH, G, D).to(F32) * (D ** -0.5)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(S, device=q.device)[None, :]
    lens = lengths.long()[:, None]
    mask = pos < lens
    if window is not None:
        mask &= pos >= (lens - window)
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w, v)
    return out.reshape(B, H, D).to(q.dtype)
