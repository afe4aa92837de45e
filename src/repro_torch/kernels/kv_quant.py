"""Per-page int8 KV quantization: the format layer behind tiered KV pages.

The port's counterpart of ``repro/kernels/kv_quant.py``. It is the single
source of truth for what a page weighs in each format and for the
quantize / dequantize / requantize transforms that the pool, the paged
attention kernel, its plain version and the host staging path share.

Format vocabulary (``PAGE_FORMATS``):

* ``"bf16"`` — raw bfloat16 payload, 2 bytes/element, no sidecar. Host
  staging keeps the exact bits, so round trips are bit-exact.
* ``"int8"`` — symmetric int8 payload, 1 byte/element, plus one fp32
  scale per (layer, page) for K and one for V in a *sidecar* array.
  ``scale = max(|x|) / 127`` over the page's ``T*KH*HD`` elements;
  dequant is ``x̂ = q * scale``.

Bitwise agreement: the tensor transforms divide ``x / scale`` in f32 (not
a multiply by the reciprocal) and round with ``torch.round``, which rounds
half to even like ``np.rint``. So device-side and host-side quantization
of the same page give identical bytes, as :func:`quantize_np` requires.
The pool's int8 appends update the pool tensors in place, where the
reference returned new arrays.
"""
from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32

#: the page formats a tier can declare; anything else is a config error
PAGE_FORMATS = ("bf16", "int8")

#: quantized values live in [-QMAX, QMAX] (symmetric, no -128 asymmetry)
QMAX = 127.0

#: floor for scales so an all-zero page stays representable (and division
#: by the scale is always finite)
SCALE_EPS = 1e-8


def check_format(fmt: str) -> str:
    if fmt not in PAGE_FORMATS:
        raise ValueError(f"unknown KV page format {fmt!r}; pick from {PAGE_FORMATS}")
    return fmt


def bytes_per_element(fmt: str) -> int:
    """Payload bytes per KV element in ``fmt`` (sidecar excluded)."""
    return 1 if check_format(fmt) == "int8" else 2


def page_wire_bytes(
    layers: int, page_tokens: int, kv_heads: int, head_dim: int, fmt: str
) -> int:
    """Bytes one page occupies on the wire (and at rest) in ``fmt``:
    K+V payload plus, for int8, the fp32 scale sidecar (one scale per
    layer for K and one for V)."""
    elems = layers * page_tokens * kv_heads * head_dim * 2  # K and V
    payload = elems * bytes_per_element(fmt)
    sidecar = layers * 2 * 4 if fmt == "int8" else 0
    return payload + sidecar


def token_wire_bytes(layers: int, kv_heads: int, head_dim: int, fmt: str) -> int:
    """Bytes one token's KV contributes in ``fmt`` — the per-token figure
    schedulers price transfers with. Scale sidecars are per *page*, not per
    token, so they amortize away here."""
    return layers * 2 * kv_heads * head_dim * bytes_per_element(fmt)  # lint: kv008-ok (the format-aware helper itself; the 2 is the K/V planes)


# ------------------------------------------------------------- tensor side
def _quantize_f32(xf: torch.Tensor):
    """``xf`` f32 ``[..., T, KH, HD]`` -> (int8 payload, f32 scales)."""
    amax = xf.abs().amax(dim=(-3, -2, -1))
    scales = torch.clamp_min(amax, SCALE_EPS) / QMAX
    q = torch.round(xf / scales[..., None, None, None])
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8), scales


def quantize_pages(x: torch.Tensor):
    """Quantize pages to int8 with one scale per page.

    ``x``: ``[..., T, KH, HD]`` — any number of leading axes (the pool uses
    ``[L, N, T, KH, HD]``, the kernel's layer slice ``[N, T, KH, HD]``).
    Returns ``(q int8 same-shape, scales f32 over the leading axes)``.
    """
    return _quantize_f32(x.to(F32))


def dequantize_pages(q: torch.Tensor, scales: torch.Tensor, dtype=torch.bfloat16):
    """Inverse of :func:`quantize_pages` (up to quantization error)."""
    return (q.to(F32) * scales[..., None, None, None]).to(dtype)


def requantize_insert_run(q_k, s_k, pages, offsets, new_vals) -> None:
    """Insert one new token per batch row into quantized pages, all layers
    at once, **in place**.

    ``q_k`` ``[L, N, T, KH, HD]`` int8 and ``s_k`` ``[L, N]`` f32 are the
    pool tensors; ``pages``/``offsets`` ``[B]`` int64 name distinct pages
    (each batch row owns its tail page); ``new_vals`` ``[L, B, KH, HD]``.
    The touched pages are dequantized, the token written, each page's
    scale re-derived (the new token may exceed the old amax) and the
    page requantized — the paged decode step's post-loop commit.
    """
    B = pages.shape[0]
    tiles = q_k[:, pages].to(F32) * s_k[:, pages][..., None, None, None]
    rows = torch.arange(B, device=tiles.device)
    tiles[:, rows, offsets] = new_vals.to(F32)
    q, new_s = _quantize_f32(tiles)
    q_k[:, pages] = q
    s_k[:, pages] = new_s


def requantize_insert(q_pages, scales, pages, offsets, new_vals) -> None:
    """One-layer twin of :func:`requantize_insert_run`: ``q_pages``
    ``[N, T, KH, HD]``, ``scales`` ``[N]``, ``new_vals`` ``[B, KH, HD]``,
    updated in place."""
    requantize_insert_run(
        q_pages[None], scales[None], pages, offsets, new_vals[None]
    )


# -------------------------------------------------------------- numpy side
def quantize_np(x: np.ndarray):
    """Host-staging quantizer: ``x`` ``[L, T, KH, HD]`` (one page, all
    layers) → ``(int8 payload, f32 scales [L])``. Mirrors
    :func:`quantize_pages` exactly so device- and host-side quantization of
    the same page produce identical bytes."""
    xf = np.asarray(x, np.float32)
    amax = np.max(np.abs(xf), axis=(1, 2, 3))
    scales = (np.maximum(amax, SCALE_EPS) / QMAX).astype(np.float32)
    q = np.rint(xf / scales[:, None, None, None])
    return np.clip(q, -QMAX, QMAX).astype(np.int8), scales


def dequantize_np(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Inverse of :func:`quantize_np` → float32 ``[L, T, KH, HD]``."""
    return q.astype(np.float32) * np.asarray(scales, np.float32)[:, None, None, None]
