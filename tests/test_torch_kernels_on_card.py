"""The redesigned attention kernels on the card, against their plain
versions: the split-K paged decode kernel at split boundaries and over
tables wider than any row, and the bf16 tensor-core flash kernel at every
head dimension, with GQA, ragged tails and a hole behind a query offset.

Every test here is marked ``cuda`` and skips where there is no card. The
file imports neither JAX nor the JAX package, so it runs on a machine with
a card and PyTorch alone::

    python -m pytest -q -m cuda tests/test_torch_kernels_on_card.py

Bands are the reference's own (``tests/test_kernels.py`` ``tol()``): 2e-3
in f32, 2e-2 in bf16.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import kv_quant
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention import ref as paged_ref

BANDS = {torch.float32: dict(rtol=2e-3, atol=2e-3), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev).to(dtype)


PAGED_CASES = {
    # name -> (B, H, KH, D, T, P, lengths, pages); the serving shape's table
    # (24 columns of 16 tokens) splits into ranges of 64 keys on an H100
    "lengths at split boundaries": (4, 16, 16, 64, 16, 24, [64, 65, 128, 1], "bfloat16"),
    "lengths at split boundaries int8": (4, 16, 16, 64, 16, 24, [63, 64, 256, 384], "int8"),
    "table wider than any row": (3, 16, 16, 64, 16, 40, [200, 17, 97], "bfloat16"),
    "gqa table wider than any row f32": (2, 32, 4, 128, 16, 32, [300, 129], "float32"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PAGED_CASES))
def test_paged_kernel_matches_split_and_dense_plain_versions(card, name):
    B, H, KH, D, T, P, lengths, pages = PAGED_CASES[name]
    rng = np.random.default_rng(30)
    dtype = torch.bfloat16 if pages == "bfloat16" else torch.float32
    N = B * P + 3
    q, k_new, v_new = (randn(rng, s, dtype, card) for s in ((B, H, D), (B, KH, D), (B, KH, D)))
    kf, vf = (randn(rng, (N, T, KH, D), torch.float32, card) for _ in range(2))
    if pages == "int8":
        (k, ks), (v, vs) = kv_quant.quantize_pages(kf), kv_quant.quantize_pages(vf)
    else:
        k, v, ks, vs = kf.to(dtype), vf.to(dtype), None, None
    tables = torch.from_numpy(rng.permutation(N)[: B * P].reshape(B, P).astype(np.int32)).to(card)
    lens = torch.tensor(lengths, dtype=torch.int32, device=card)
    before = paged_ops.KERNEL.launches
    got = paged_ops.paged_attention_decode(q, k_new, v_new, k, v, tables, lens, ks, vs)
    torch.cuda.synchronize()
    assert paged_ops.KERNEL.launches == before + 1
    want = paged_ref.paged_attention_decode_ref(q, k_new, v_new, k, v, tables, lens, ks, vs)
    torch.testing.assert_close(got.float(), want.float(), **BANDS[dtype])
    _, cols = paged_ops._split_plan(P, T, paged_ops.KERNEL.sm_count(card), B * KH)
    split = paged_ref.paged_attention_split_ref(q, k_new, v_new, k, v, tables, lens, ks, vs,
                                                cols=cols)
    torch.testing.assert_close(got.float(), split.float(), **BANDS[dtype])


FLASH_CASES = {
    # name -> (B, Sq, Skv, H, KH, D, kwargs), the model's [B, S, H, D] layout
    "d32 ragged": (2, 77, 77, 4, 4, 32, dict(causal=True)),
    "d64 ragged tail bidir": (1, 130, 201, 8, 8, 64, dict(causal=False)),
    "d128 ragged": (1, 100, 100, 4, 4, 128, dict(causal=True)),
    "d128 gqa window softcap": (2, 150, 150, 8, 2, 128, dict(causal=True, window=70, cap=30.0)),
    "gqa4 ragged q_offset": (1, 45, 173, 16, 4, 64, dict(causal=True, q_offset=128)),
    "hole q_offset gqa": (2, 64, 192, 8, 2, 64, dict(causal=True, q_offset=128,
                                                     kv_hole=(83, 128))),
    "hole q_offset d32": (1, 33, 161, 4, 4, 32, dict(causal=True, q_offset=128,
                                                     kv_hole=(64, 128))),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_kernel_in_bf16_matches_blockwise(card, name):
    B, Sq, Skv, H, KH, D, kw = FLASH_CASES[name]
    rng = np.random.default_rng(31)
    q = randn(rng, (B, Sq, H, D), torch.bfloat16, card)
    k, v = (randn(rng, (B, Skv, KH, D), torch.bfloat16, card) for _ in range(2))
    before = flash_ops.KERNEL.launches
    got = flash_ops.prefill_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_ops.KERNEL.launches == before + 1
    want = flash_ref.blockwise_attention(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **BANDS[torch.bfloat16])


@pytest.mark.cuda
def test_flash_kernel_in_bf16_with_unaligned_rows(card):
    """Rows that do not start on 16-byte boundaries (a head stride of 65
    elements) take the CUDA-core kernel in bf16, and agree all the same."""
    rng = np.random.default_rng(32)
    wide = randn(rng, (3, 90, 8, 65), torch.bfloat16, card)
    q, k, v = (wide[i:i + 1, ..., :64] for i in range(3))
    got = flash_ops.prefill_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    want = flash_ref.blockwise_attention(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), **BANDS[torch.bfloat16])
