"""The redesigned kernels on the card, against their plain versions: the
split-K paged decode kernel at split boundaries, over tables wider than
any row, at dbrx-132b's GQA 6:1, at zamba2's head dimension 160 (bf16,
f32 and int8 pages) and over 30-token pages (whisper's cross cache of
1500 encoder positions, also read as a slot cache); the bf16 tensor-core
flash kernel at every head dimension (32 to 256; 160 and 256 also on the
f32 CUDA-core kernel), with GQA, ragged tails and a hole behind a query
offset (its lower end also read on the device, in and out of a captured
graph, bit-equal to the host integer, with the kernel's launch counter),
and at whisper's encoder, its cross-attention prefill and
internvl2-26b's prefill in bf16 and f32; and
the SSD scan's tensor-core passes at mamba2's widths (one chunk, ragged
and long sequences, other chunk sizes, two rows, strided slices of one
fused tensor), with f32 and mixed dtypes on the CUDA-core route; the
flash backward kernel against autograd through ``blockwise_attention`` at
chip_smoke's shapes (bit-for-bit repeatable, in either layout), and the
wrappers' refusals under grad (flash without q_offset, kv_hole and
kv_lengths; paged attention, which has no backward kernel); the SSD
backward kernel against autograd through ``ssd_reference`` (the
reference's shapes, mamba2's and zamba2's widths, ragged, one chunk,
slices of a fused tensor, P = N = 256; with and without a final-state
cotangent; bit-for-bit repeatable whichever route the forward took), its
launch counter and its refusals; and AdamW's f32 square root on the card,
which must round correctly.

Every test here is marked ``cuda`` and skips where there is no card. The
file imports neither JAX nor the JAX package, so it runs on a machine with
a card and PyTorch alone::

    python -m pytest -q -m cuda tests/test_torch_kernels_on_card.py

Bands are the reference's own (``tests/test_kernels.py`` ``tol()``): 2e-3
in f32, 2e-2 in bf16, and 1e-2 for the SSD's final state.
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
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref

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
    # dbrx-132b's decode: 48 query heads over 8 KV heads of 128, a group of
    # 6 that the kernel covers in blocks of 4 heads (the second block of a
    # KV head holds heads 4-5 and two empty rows)
    "dbrx gqa 6:1": (3, 48, 8, 128, 16, 24, [384, 250, 97], "bfloat16"),
    "dbrx gqa 6:1 int8": (3, 48, 8, 128, 16, 24, [17, 200, 1], "int8"),
    # zamba2's shared-block decode: 32 heads of 160, where a key spans 20
    # lanes (one key a warp step); lengths across the 64-key split boundaries
    "zamba2 d160": (2, 32, 32, 160, 16, 25, [384, 200], "bfloat16"),
    "zamba2 d160 f32": (3, 32, 32, 160, 16, 25, [65, 129, 1], "float32"),
    "zamba2 d160 int8": (3, 32, 32, 160, 16, 25, [64, 257, 17], "int8"),
    # whisper's cross cache: 30-token pages (the largest divisor of its 1500
    # encoder positions not above 32), a full row and one ending in a page
    "whisper cross pages of 30": (2, 16, 16, 64, 30, 50, [1500, 777], "bfloat16"),
    "whisper cross pages of 30 f32": (2, 16, 16, 64, 30, 50, [1500, 31], "float32"),
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


@pytest.mark.cuda
def test_paged_kernel_counts_its_launches_on_the_device(card):
    """A wrapper call adds one to the wrapper's count and one to the
    kernel's own count on the device; a replay of a captured launch adds
    to the device's count only."""
    rng = np.random.default_rng(34)
    B, H, KH, D, T, P = 2, 8, 2, 64, 16, 4
    q = randn(rng, (B, H, D), torch.bfloat16, card)
    k, v = (randn(rng, (B * P, T, KH, D), torch.bfloat16, card) for _ in range(2))
    tables = torch.arange(B * P, dtype=torch.int32, device=card).reshape(B, P)
    lens = torch.tensor([40, 64], dtype=torch.int32, device=card)

    def call():
        return paged_ops.paged_attention(q, k, v, tables, lens)

    call()
    torch.cuda.synchronize()
    launches, counted = paged_ops.KERNEL.launches, paged_ops.KERNEL.device_launches(card)
    call()
    assert paged_ops.KERNEL.launches == launches + 1
    assert paged_ops.KERNEL.device_launches(card) == counted + 1
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        call()
    launches, counted = paged_ops.KERNEL.launches, paged_ops.KERNEL.device_launches(card)
    for _ in range(3):
        graph.replay()
    assert paged_ops.KERNEL.device_launches(card) == counted + 3
    assert paged_ops.KERNEL.launches == launches


#: a chunk behind a bucketed prefix, the hole's lower end read on the
#: device: name -> (B, Sq, Sp, H, KH, D, the lower end); q_offset and the
#: upper end are Sp. Kv tiles are 64 keys: a lower end inside a tile, one
#: that makes the hole straddle a tile edge, one on an edge (a whole tile
#: skipped) and the whole prefix in the hole
FLASH_DEVICE_HOLE_CASES = {
    "inside a tile gqa": (2, 64, 128, 8, 2, 64, 100),
    "across a tile edge": (1, 64, 128, 8, 8, 64, 50),
    "on a tile edge d32 ragged": (1, 33, 128, 4, 4, 32, 64),
    "whole prefix d128 gqa 6:1": (1, 64, 192, 48, 8, 128, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", sorted(FLASH_DEVICE_HOLE_CASES))
def test_flash_kernel_reads_the_hole_lo_on_the_device(card, name, dtype):
    """The hole's lower end as an int32 on the card gives the bits of the
    same call with it as a host integer, in a direct call and in a
    captured graph replayed after the value changes; each launch adds one
    to the kernel's own count on the device, a replay to that count
    only."""
    B, Sq, Sp, H, KH, D, lo = FLASH_DEVICE_HOLE_CASES[name]
    rng = np.random.default_rng(37)
    q = randn(rng, (B, Sq, H, D), dtype, card)
    k, v = (randn(rng, (B, Sp + Sq, KH, D), dtype, card) for _ in range(2))

    def call(lo_value):
        return flash_ops.prefill_attention(q, k, v, causal=True, q_offset=Sp,
                                           kv_hole=(lo_value, Sp))

    lo_dev = torch.tensor(lo, dtype=torch.int32, device=card)
    want = call(lo)
    counted = flash_ops.KERNEL.device_launches(card)
    got = call(lo_dev)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()
    assert flash_ops.KERNEL.device_launches(card) == counted + 1
    torch.testing.assert_close(want.float(), flash_ref.blockwise_attention(
        q, k, v, causal=True, q_offset=Sp, kv_hole=(lo, Sp)).float(), **BANDS[dtype])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call(lo_dev)
    launches, counted = flash_ops.KERNEL.launches, flash_ops.KERNEL.device_launches(card)
    for other in (Sp - 1, lo, (lo + Sp) // 2):
        lo_dev.fill_(other)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, call(other)), other
    assert flash_ops.KERNEL.launches == launches + 3          # the three direct calls
    assert flash_ops.KERNEL.device_launches(card) == counted + 6


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
    # dbrx-132b's prefill: GQA 6:1 at D = 128, a bucket-padded prompt and a
    # chunk over a bucketed prefix
    "dbrx gqa 6:1": (1, 384, 384, 48, 8, 128, dict(causal=True)),
    "dbrx gqa 6:1 chunk hole": (1, 64, 192, 48, 8, 128, dict(causal=True, q_offset=128,
                                                              kv_hole=(100, 128))),
}

#: head dimensions beyond 128, in bf16 (two warp groups at 160, one at 256)
#: and f32 (the CUDA-core kernel): zamba2's shared attention block (32
#: heads of 160) and gemma2-9b (16 heads over 8 KV heads of 256), causal
#: with a ragged tail, a chunk at q_offset behind a kv_hole, and gemma2's
#: window with its softcap
WIDE_FLASH_CASES = {
    "d160 ragged": (1, 200, 200, 32, 32, 160, dict(causal=True)),
    "d160 chunk hole": (1, 64, 192, 32, 32, 160, dict(causal=True, q_offset=128,
                                                      kv_hole=(83, 128))),
    "d256 ragged": (1, 200, 200, 16, 8, 256, dict(causal=True)),
    "d256 chunk hole": (1, 64, 192, 16, 8, 256, dict(causal=True, q_offset=128,
                                                     kv_hole=(83, 128))),
    # gemma2-9b's local layers: a window and the attention softcap (q is
    # scaled by CAPPED_Q_SCALE so the logits reach the cap)
    "d256 gqa window softcap": (1, 300, 300, 16, 8, 256, dict(causal=True, window=100,
                                                              cap=50.0)),
}
#: phase 8's model shapes at full width: whisper-medium's encoder (1500
#: bidirectional positions, 16x64), its cross-attention from a 64-token
#: prompt over them, and internvl2-26b's prefill of 256 image tokens and a
#: 600-token prompt (48 query heads over 8 KV heads of 128)
MODEL_FLASH_CASES = {
    "whisper encoder": (1, 1500, 1500, 16, 16, 64, dict(causal=False)),
    "whisper cross": (1, 64, 1500, 16, 16, 64, dict(causal=False)),
    "internvl2 prefill": (1, 856, 856, 48, 8, 128, dict(causal=True)),
}
#: q's scale in the softcapped cases: with unit k the scores have std 8
#: and their largest reach ~25, where cap·tanh(s/cap) bends them
CAPPED_Q_SCALE = 8.0


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
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", sorted(WIDE_FLASH_CASES))
def test_flash_kernel_at_head_dims_160_and_256_matches_blockwise(card, name, dtype):
    B, Sq, Skv, H, KH, D, kw = WIDE_FLASH_CASES[name]
    rng = np.random.default_rng(33)
    q = randn(rng, (B, Sq, H, D), dtype, card) * (CAPPED_Q_SCALE if "cap" in kw else 1.0)
    k, v = (randn(rng, (B, Skv, KH, D), dtype, card) for _ in range(2))
    before = flash_ops.KERNEL.launches
    got = flash_ops.prefill_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_ops.KERNEL.launches == before + 1
    want = flash_ref.blockwise_attention(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **BANDS[dtype])
    if "cap" in kw:
        # the band can tell: the plain version without the softcap lies outside it
        uncapped = flash_ref.blockwise_attention(q, k, v, **{**kw, "cap": None})
        with pytest.raises(AssertionError):
            torch.testing.assert_close(uncapped.float(), want.float(), **BANDS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", sorted(MODEL_FLASH_CASES))
def test_flash_kernel_at_whisper_and_internvl2_shapes(card, name, dtype):
    B, Sq, Skv, H, KH, D, kw = MODEL_FLASH_CASES[name]
    rng = np.random.default_rng(36)
    q = randn(rng, (B, Sq, H, D), dtype, card)
    k, v = (randn(rng, (B, Skv, KH, D), dtype, card) for _ in range(2))
    before = flash_ops.KERNEL.launches
    got = flash_ops.prefill_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_ops.KERNEL.launches == before + 1
    want = flash_ref.blockwise_attention(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **BANDS[dtype])
    # the band can tell: the plain version without the ragged last kv tile
    # of 64 keys (1500 = 23 tiles and 28, 856 = 13 and 24), and for the
    # bidirectional cases with a causal mask, lies outside it
    whole_tiles = torch.full((B,), Skv - Skv % 64, dtype=torch.int32, device=card)
    faults = [flash_ref.blockwise_attention(q, k, v, kv_lengths=whole_tiles, **kw)]
    if not kw["causal"]:
        faults.append(flash_ref.blockwise_attention(q, k, v, causal=True))
    for fault in faults:
        with pytest.raises(AssertionError):
            torch.testing.assert_close(fault.float(), want.float(), **BANDS[dtype])


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


#: mamba2-2.7b's scan: 80 heads of 64, state 128
SSD_H, SSD_P, SSD_N = 80, 64, 128
SSD_STATE_BAND = dict(rtol=1e-2, atol=1e-2)
SSD_CASES = {
    # name -> (B, S, chunk); S = 1 and 77 are one partial chunk, 128 one
    # full one (the replay's common prefill), 200 ragged over two
    "S=1": (1, 1, 128),
    "S=77": (1, 77, 128),
    "S=128": (1, 128, 128),
    "S=200": (1, 200, 128),
    "S=256": (1, 256, 128),
    "S=1024": (1, 1024, 128),
    "chunk 64 S=200": (1, 200, 64),
    "chunk 256 S=300": (1, 300, 256),
    "B=2 S=200": (2, 200, 128),
}


def ssd_inputs(rng, b, s, dev, x_dtype=torch.bfloat16, bc_dtype=torch.bfloat16,
               fused=False):
    """x [b,s,H,P], dt (after softplus), A (negative), B, C [b,s,N]; with
    ``fused`` x, B and C are strided slices of one [b, s, H*P + 2N] tensor,
    as the model's conv output gives them."""
    inner = SSD_H * SSD_P
    if fused:
        xbc = randn(rng, (b, s, inner + 2 * SSD_N), x_dtype, dev)
        x = xbc[..., :inner].reshape(b, s, SSD_H, SSD_P)
        B, C = xbc[..., inner:inner + SSD_N], xbc[..., inner + SSD_N:]
    else:
        x = randn(rng, (b, s, SSD_H, SSD_P), x_dtype, dev)
        B, C = (randn(rng, (b, s, SSD_N), bc_dtype, dev) for _ in range(2))
    dt = torch.nn.functional.softplus(randn(rng, (b, s, SSD_H), torch.float32, dev))
    A = -randn(rng, (SSD_H,), torch.float32, dev).abs()
    return x, dt, A, B, C


def check_ssd(x, dt, A, B, C, chunk, route):
    """One wrapper call on ``route``, held against ``ssd_reference`` and the
    passes' plain version."""
    before = dict(ssd_ops.KERNEL.routes)
    y, st = ssd_ops.ssd(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_ops.KERNEL.routes[route] == before[route] + 1
    yr, sr = ssd_ref.ssd_reference(x, dt, A, B[:, :, None], C[:, :, None], chunk=chunk)
    torch.testing.assert_close(y.float(), yr.float(), **BANDS[x.dtype])
    torch.testing.assert_close(st, sr, **SSD_STATE_BAND)
    if route == "tensor_core":
        yp, sp = ssd_ref.ssd_chunked_passes_ref(x, dt, A, B, C, chunk=chunk,
                                                split_operands=True)
        torch.testing.assert_close(y.float(), yp.float(), **BANDS[x.dtype])
        torch.testing.assert_close(st, sp, **SSD_STATE_BAND)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SSD_CASES))
def test_ssd_tensor_core_route_matches_plain_versions(card, name):
    b, s, chunk = SSD_CASES[name]
    rng = np.random.default_rng(33)
    check_ssd(*ssd_inputs(rng, b, s, card), chunk, "tensor_core")


@pytest.mark.cuda
@pytest.mark.parametrize("s", [77, 256])
def test_ssd_tensor_core_route_takes_slices_of_a_fused_tensor(card, s):
    rng = np.random.default_rng(34)
    x, dt, A, B, C = ssd_inputs(rng, 1, s, card, fused=True)
    assert not x.is_contiguous() and not B.is_contiguous()
    check_ssd(x, dt, A, B, C, 128, "tensor_core")


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,bc_dtype", [(torch.float32, torch.float32),
                                              (torch.bfloat16, torch.float32),
                                              (torch.float32, torch.bfloat16)])
def test_ssd_f32_and_mixed_dtypes_take_the_cuda_core_route(card, x_dtype, bc_dtype):
    rng = np.random.default_rng(35)
    check_ssd(*ssd_inputs(rng, 1, 200, card, x_dtype, bc_dtype), 128, "cuda_core")


@pytest.mark.cuda
@pytest.mark.parametrize("window,cap", [(None, None), (100, None), (None, 30.0)],
                         ids=["plain", "window", "softcap"])
def test_dense_slot_decode_attention_runs_the_paged_kernel(card, window, cap):
    """A slot cache at the serving shape, read as 16-token pages by the
    paged kernel, against the reference's masked softmax on the CPU."""
    from repro_torch.models.layers import decode_attention

    rng = np.random.default_rng(31)
    B, H, KH, D, S = 3, 16, 16, 64, 384
    q, k, v = (randn(rng, s, torch.bfloat16, "cpu")
               for s in ((B, H, D), (B, S, KH, D), (B, S, KH, D)))
    lens = torch.tensor([S, 250, 1], dtype=torch.int32)
    before = paged_ops.KERNEL.launches
    got = decode_attention(q.to(card), k.to(card), v.to(card), lengths=lens.to(card),
                           window=window, cap=cap, page_tokens=16)
    torch.cuda.synchronize()
    assert paged_ops.KERNEL.launches == before + 1
    want = decode_attention(q, k, v, lengths=lens, window=window, cap=cap, page_tokens=16)
    torch.testing.assert_close(got.cpu().float(), want.float(), **BANDS[torch.bfloat16])
    with pytest.raises(ValueError, match="whole number"):
        decode_attention(q.to(card), k[:, :380].to(card), v[:, :380].to(card),
                         lengths=lens.to(card), page_tokens=16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cross_cache_decode_attention_reads_30_token_pages(card, dtype):
    """whisper's cross cache at full width, 1500 encoder positions (no
    whole number of 16-token pages), read through ``decode_attention`` as
    pages of ``dividing_page_tokens(1500)`` = 30 by the paged kernel, every
    position visible, against the reference's masked softmax on the CPU."""
    from repro_torch.models.layers import decode_attention, dividing_page_tokens

    rng = np.random.default_rng(37)
    B, H, KH, D, S = 2, 16, 16, 64, 1500
    q, k, v = (randn(rng, s, dtype, "cpu") for s in ((B, H, D), (B, S, KH, D), (B, S, KH, D)))
    lens = torch.full((B,), S, dtype=torch.int32)
    T = dividing_page_tokens(S)
    assert T == 30
    before = paged_ops.KERNEL.launches
    got = decode_attention(q.to(card), k.to(card), v.to(card), lengths=lens.to(card),
                           page_tokens=T)
    torch.cuda.synchronize()
    assert paged_ops.KERNEL.launches == before + 1
    want = decode_attention(q, k, v, lengths=lens, page_tokens=T)
    torch.testing.assert_close(got.cpu().float(), want.float(), **BANDS[dtype])


# ------------------------------------------------------------ flash backward
#: the backward kernel's cases, chip_smoke's shapes in [B, S, H, D]:
#: qwen1.5-0.5b's training shape; a gemma2-like layer (GQA 2:1 at D = 256,
#: window and softcap, q scaled by 8 so the cap binds); D = 160; whisper's
#: cross-attention (64 queries over 1500 encoder positions, bidirectional);
#: ragged tails at D = 128 (1000 rows: the copies past the last row are
#: zero-filled); and D = 32 with GQA 4:1, a window and a softcap
FLASH_BWD_CASES = {
    "qwen training": dict(B=4, Sq=1024, Skv=1024, H=16, KH=16, D=64, causal=True),
    "gemma2 d256 gqa window softcap": dict(B=1, Sq=640, Skv=640, H=16, KH=8, D=256,
                                           causal=True, window=256, cap=50.0, q_scale=8.0),
    "d160": dict(B=1, Sq=384, Skv=384, H=32, KH=32, D=160, causal=True),
    "whisper cross": dict(B=2, Sq=64, Skv=1500, H=16, KH=16, D=64, causal=False),
    "ragged gqa d128": dict(B=1, Sq=1000, Skv=1000, H=32, KH=8, D=128, causal=True),
    "d32 gqa window softcap": dict(B=2, Sq=300, Skv=300, H=8, KH=2, D=32, causal=True,
                                   window=100, cap=30.0, q_scale=4.0),
}


def bwd_route(c, dtype) -> str:
    """The route the backward must take on a case's contiguous operands:
    the tensor cores for bf16 at D <= 128, else the CUDA cores."""
    return "tensor_core" if dtype == torch.bfloat16 and c["D"] <= 128 else "cuda_core"


def flash_bwd_inputs(c, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    q = randn(rng, (c["B"], c["Sq"], c["H"], c["D"]), torch.float32, dev) * c.get("q_scale", 1.0)
    k = randn(rng, (c["B"], c["Skv"], c["KH"], c["D"]), dtype, dev)
    v = randn(rng, (c["B"], c["Skv"], c["KH"], c["D"]), dtype, dev)
    do = randn(rng, (c["B"], c["Sq"], c["H"], c["D"]), dtype, dev)
    return q.to(dtype), k, v, do


def kernel_grads(q, k, v, do, **mask):
    qq, kk, vv = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = flash_ops.prefill_attention(qq, kk, vv, **mask)
    assert out.grad_fn is not None
    out.backward(do)
    return qq.grad, kk.grad, vv.grad


def assert_grad_close(got, want, tol):
    """|got - want| <= tol · (max|want| + |want|): the gradient's own scale
    sets the band, so small entries are held as tightly as large ones."""
    want = want.float()
    err = (got.float() - want).abs()
    assert bool((err <= tol * (want.abs().max() + want.abs())).all()), err.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", sorted(FLASH_BWD_CASES))
def test_flash_backward_matches_autograd_through_blockwise(card, name, dtype):
    c = FLASH_BWD_CASES[name]
    q, k, v, do = flash_bwd_inputs(c, dtype, card)
    mask = dict(causal=c["causal"], window=c.get("window"), cap=c.get("cap"))
    before = flash_ops.KERNEL.backward_launches
    routes = dict(flash_ops.KERNEL.backward_kernel.routes)
    got = kernel_grads(q, k, v, do, **mask)
    torch.cuda.synchronize()
    assert flash_ops.KERNEL.backward_launches == before + 1
    route = bwd_route(c, dtype)
    assert flash_ops.KERNEL.backward_kernel.routes[route] == routes[route] + 1
    want = flash_ref.flash_attention_bwd_ref(q, k, v, do, **mask)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert_grad_close(g, w, BANDS[dtype]["atol"])


@pytest.mark.cuda
def test_flash_backward_is_deterministic_and_layout_free(card):
    """Two runs give the same bits (no atomics), and the [B, H, S, D] entry
    point gives the [B, S, H, D] one's gradients, transposed: on the
    CUDA-core route (D = 256) and on the tensor-core route (D = 32, 64)."""
    for name in ("gemma2 d256 gqa window softcap", "d32 gqa window softcap", "qwen training"):
        c = FLASH_BWD_CASES[name]
        q, k, v, do = flash_bwd_inputs(c, torch.bfloat16, card, seed=1)
        mask = dict(causal=True, window=c.get("window"), cap=c.get("cap"))
        routes = dict(flash_ops.KERNEL.backward_kernel.routes)
        first = kernel_grads(q, k, v, do, **mask)
        second = kernel_grads(q, k, v, do, **mask)
        qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
        out = flash_ops.flash_attention(qh, kh, vh, causal=True, window=c.get("window"),
                                        softcap=c.get("cap"))
        out.backward(do.transpose(1, 2))
        route = bwd_route(c, torch.bfloat16)
        assert flash_ops.KERNEL.backward_kernel.routes[route] == routes[route] + 3, name
        for a, b, h in zip(first, second, (qh.grad, kh.grad, vh.grad)):
            assert torch.equal(a, b), name
            assert torch.equal(a, h.transpose(1, 2)), name


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qwen training", "ragged gqa d128", "d32 gqa window softcap",
                                  "whisper cross"])
def test_flash_backward_routes_agree_on_one_input(card, name):
    """The tensor-core and CUDA-core routes, forced on the same bf16 input,
    each hold the plain backward's band; a bf16 q whose rows are not
    16-byte aligned takes the CUDA-core route by itself."""
    c = FLASH_BWD_CASES[name]
    q, k, v, do = flash_bwd_inputs(c, torch.bfloat16, card, seed=2)
    mask = dict(causal=c["causal"], window=c.get("window"), cap=c.get("cap"))
    want = flash_ref.flash_attention_bwd_ref(q, k, v, do, **mask)
    out, lse = flash_ops.KERNEL(q, k, v, seq_dim=1, head_dim=2, causal=c["causal"],
                                window=c.get("window"), softcap=c.get("cap"), q_offset=0,
                                with_lse=True)
    for route in ("tensor_core", "cuda_core"):
        before = flash_ops.KERNEL.backward_kernel.routes[route]
        got = flash_ops.KERNEL.backward(q, k, v, out, do, lse, seq_dim=1, head_dim=2,
                                        causal=c["causal"], window=c.get("window"),
                                        softcap=c.get("cap"), route=route)
        torch.cuda.synchronize()
        assert flash_ops.KERNEL.backward_kernel.routes[route] == before + 1
        for g, w in zip(got, want):
            assert_grad_close(g, w, BANDS[torch.bfloat16]["atol"])
    # q's rows start 2 bytes past a 16-byte boundary (a slice of a wider
    # leaf, which autograd does not copy)
    D = c["D"]
    wide = torch.zeros((*q.shape[:3], D + 8), dtype=torch.bfloat16, device=card)
    wide[..., 1:D + 1] = q
    wide.requires_grad_(True)
    kk, vv = (t.detach().clone().requires_grad_(True) for t in (k, v))
    before = dict(flash_ops.KERNEL.backward_kernel.routes)
    flash_ops.prefill_attention(wide[..., 1:D + 1], kk, vv, **mask).backward(do)
    torch.cuda.synchronize()
    assert flash_ops.KERNEL.backward_kernel.routes["cuda_core"] == before["cuda_core"] + 1
    assert flash_ops.KERNEL.backward_kernel.routes["tensor_core"] == before["tensor_core"]
    for g, w in zip((wide.grad[..., 1:D + 1], kk.grad, vv.grad), want):
        assert_grad_close(g, w, BANDS[torch.bfloat16]["atol"])


@pytest.mark.cuda
def test_flash_under_grad_refuses_what_its_backward_lacks(card):
    rng = np.random.default_rng(3)
    q = randn(rng, (1, 64, 4, 64), torch.bfloat16, card).requires_grad_(True)
    k = randn(rng, (1, 128, 4, 64), torch.bfloat16, card)
    v = randn(rng, (1, 128, 4, 64), torch.bfloat16, card)
    lengths = torch.tensor([100], dtype=torch.int32, device=card)
    for kw in (dict(q_offset=64), dict(q_offset=64, kv_hole=(50, 64)), dict(kv_lengths=lengths)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            flash_ops.prefill_attention(q, k, v, causal=True, **kw)
    with torch.no_grad():   # serving: the forward alone, no autograd node
        before = (flash_ops.KERNEL.launches, flash_ops.KERNEL.backward_launches)
        out = flash_ops.prefill_attention(q, k, v, causal=True, q_offset=64)
        assert out.grad_fn is None
        assert (flash_ops.KERNEL.launches, flash_ops.KERNEL.backward_launches) == (
            before[0] + 1, before[1])


#: the SSD backward's cases: name -> (B, S, H, P, N, chunk, fused). The
#: reference's shapes (tests/test_kernels.py), mamba2's widths (ragged over
#: chunks, one chunk, two rows of slices of one fused tensor as the model's
#: conv output gives them), zamba2's N = 64, N and P of 256 at chunk 64 (the
#: tensor-core route's gradient pass in two and four passes over its
#: columns) and the widest P and N
SSD_BWD_CASES = {
    "reference 2x32 chunk 8": (2, 32, 2, 8, 8, 8, False),
    "reference 1x64 chunk 16": (1, 64, 4, 16, 16, 16, False),
    "reference 2x128 chunk 32": (2, 128, 4, 32, 16, 32, False),
    "mamba2 S=1000": (1, 1000, 80, 64, 128, 128, False),
    "mamba2 S=128 one chunk": (1, 128, 80, 64, 128, 128, False),
    "mamba2 fused B=2 S=300": (2, 300, 80, 64, 128, 128, True),
    "zamba2 N=64 S=384": (1, 384, 80, 64, 64, 128, False),
    "N=256 chunk 64 S=300": (1, 300, 2, 64, 256, 64, False),
    "P=256 chunk 64 S=300": (1, 300, 2, 256, 64, 64, False),
    "P=N=256 chunk 256 S=300": (1, 300, 2, 256, 256, 256, False),
}


def ssd_bwd_route(c, dtype) -> str:
    """The route the SSD backward must take on a case's (aligned) operands:
    the tensor cores for bf16 at P and N multiples of 16, a chunk that is a
    multiple of 64 and a working set that fits a block (not P = N = 256 at
    chunk 256), else the CUDA cores."""
    _, _, _, p, n, chunk, _ = c
    tc = (dtype == torch.bfloat16 and p % 16 == 0 and n % 16 == 0 and chunk % 64 == 0
          and (p, n, chunk) != (256, 256, 256))
    return "tensor_core" if tc else "cuda_core"


def ssd_bwd_case(c, dtype, dev, with_dfinal, seed=0):
    """The leaves (x, B, C, or the fused tensor they are sliced from; dt;
    A), a function from the leaves to the scan's operands, dy and the final
    state's cotangent (or None). dt is near 0.05, as mamba2's dt_bias puts
    it."""
    b, s, h, p, n, _, fused = c
    rng = np.random.default_rng(seed)
    if fused:
        leaves = [randn(rng, (b, s, h * p + 2 * n), dtype, dev)]

        def operands(xbc, dt, A):
            return (xbc[..., :h * p].reshape(b, s, h, p), dt, A, xbc[..., h * p:h * p + n],
                    xbc[..., h * p + n:])
    else:
        leaves = [randn(rng, (b, s, h, p), dtype, dev), randn(rng, (b, s, n), dtype, dev),
                  randn(rng, (b, s, n), dtype, dev)]

        def operands(x, B, C, dt, A):
            return x, dt, A, B, C
    leaves.append(torch.nn.functional.softplus(randn(rng, (b, s, h), torch.float32, dev) - 3.0))
    leaves.append(-randn(rng, (h,), torch.float32, dev).abs())
    dy = randn(rng, (b, s, h, p), dtype, dev)
    dfinal = randn(rng, (b, h, p, n), torch.float32, dev) if with_dfinal else None
    return leaves, operands, dy, dfinal


def ssd_kernel_grads(leaves, operands, dy, dfinal, chunk):
    """The leaves' gradients through ``ssd`` under autograd (the forward
    kernel, then the backward kernel), split back into x, dt, A, B, C."""
    ls = [t.detach().clone().requires_grad_(True) for t in leaves]
    y, final = ssd_ops.ssd(*operands(*ls), chunk=chunk)
    assert y.grad_fn is not None
    outs, grads = ([y, final], [dy, dfinal]) if dfinal is not None else ([y], [dy])
    torch.autograd.backward(outs, grads)
    x, dt, A, B, C = operands(*[t.grad for t in ls])
    return x, dt, A, B, C


#: (case, dtype) pairs through ``ssd`` under autograd: the f32 forward
#: (its CUDA-core kernel keeps the [P, N] state in shared memory) takes no
#: P = N = 256, so that case runs in f32 through the backward kernel alone
SSD_BWD_GRAD_CASES = [(name, dtype) for name in SSD_BWD_CASES
                      for dtype in (torch.bfloat16, torch.float32)
                      if not (name.startswith("P=N=256") and dtype == torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("with_dfinal", [False, True], ids=["no dfinal", "dfinal"])
@pytest.mark.parametrize("name,dtype", SSD_BWD_GRAD_CASES,
                         ids=[f"{n}-{str(d)[6:]}" for n, d in SSD_BWD_GRAD_CASES])
def test_ssd_backward_matches_autograd_through_the_reference(card, name, dtype, with_dfinal):
    """Through ``ssd`` under autograd on the route the case must take (the
    tensor cores for every aligned bf16 case they fit), and for those the
    CUDA-core route forced on the same inputs: both within the band."""
    c = SSD_BWD_CASES[name]
    leaves, operands, dy, dfinal = ssd_bwd_case(c, dtype, card, with_dfinal)
    route = ssd_bwd_route(c, dtype)
    before = (ssd_ops.KERNEL.launches, ssd_ops.KERNEL.backward_launches,
              ssd_ops.KERNEL.backward_kernel.routes[route])
    got = ssd_kernel_grads(leaves, operands, dy, dfinal, c[5])
    torch.cuda.synchronize()
    assert (ssd_ops.KERNEL.launches, ssd_ops.KERNEL.backward_launches,
            ssd_ops.KERNEL.backward_kernel.routes[route]) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    ops_ = operands(*leaves)
    want = ssd_ref.ssd_bwd_ref(*ops_, dy, dfinal, chunk=c[5])
    runs = [got]
    if route == "tensor_core":
        runs.append(ssd_ops.KERNEL.backward(*ops_, dy, dfinal, chunk=c[5], route="cuda_core"))
        torch.cuda.synchronize()
    for run in runs:
        for g, w, t in zip(run, want, ops_):
            assert g.dtype == t.dtype and g.shape == t.shape
            assert_grad_close(g, w, BANDS[dtype]["atol"])


@pytest.mark.cuda
@pytest.mark.parametrize("with_dfinal", [False, True], ids=["no dfinal", "dfinal"])
def test_ssd_backward_kernel_takes_p_and_n_of_256_in_f32(card, with_dfinal):
    c = SSD_BWD_CASES["P=N=256 chunk 256 S=300"]
    leaves, operands, dy, dfinal = ssd_bwd_case(c, torch.float32, card, with_dfinal)
    ops_ = operands(*leaves)
    got = ssd_ops.KERNEL.backward(*ops_, dy, dfinal, chunk=c[5])
    torch.cuda.synchronize()
    want = ssd_ref.ssd_bwd_ref(*ops_, dy, dfinal, chunk=c[5])
    for g, w, t in zip(got, want, ops_):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert_grad_close(g, w, BANDS[torch.float32]["atol"])


@pytest.mark.cuda
def test_ssd_backward_tensor_core_smem_matches_the_route_rule(card):
    """The Python rule that routes the backward (``_bwd_tc_smem``) and the
    kernel's own count of its tensor-core blocks' shared memory agree."""
    lib = ssd_ops.KERNEL.backward_kernel.load()
    for P, N, Q in [(64, 128, 128), (64, 64, 128), (64, 256, 64), (256, 64, 64),
                    (128, 128, 128), (64, 128, 256), (256, 256, 256), (32, 16, 64)]:
        assert lib.ssd_bwd_smem(P, N, Q, 1) == ssd_ops._bwd_tc_smem(P, N, Q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_ssd_backward_stays_finite_where_the_plain_scan_overflows(card, dtype):
    """dt as full-width random weights give it (~0.7): a chunk's decay
    passes 88, autograd through ``ssd_reference`` gives NaN (its masked
    exp overflows above the diagonal), and the kernel is held to the
    passes' plain version, which masks before the exp. bf16 runs on the
    tensor cores, f32 on the CUDA cores."""
    c = SSD_BWD_CASES["mamba2 S=1000"]
    leaves, operands, dy, _ = ssd_bwd_case(c, dtype, card, False)
    leaves[-2] = torch.nn.functional.softplus(
        randn(np.random.default_rng(5), tuple(leaves[-2].shape), torch.float32, card))
    route = ssd_bwd_route(c, dtype)
    assert route == ("tensor_core" if dtype == torch.bfloat16 else "cuda_core")
    routed = ssd_ops.KERNEL.backward_kernel.routes[route]
    got = ssd_kernel_grads(leaves, operands, dy, None, c[5])
    assert ssd_ops.KERNEL.backward_kernel.routes[route] == routed + 1
    ops_ = operands(*leaves)
    assert any(torch.isnan(g).any() for g in ssd_ref.ssd_bwd_ref(*ops_, dy, None, chunk=c[5]))
    want = ssd_ref.ssd_backward_passes_ref(*ops_, dy, None, chunk=c[5])
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert_grad_close(g, w, BANDS[dtype]["atol"])


@pytest.mark.cuda
def test_ssd_backward_is_deterministic_and_free_of_the_forward_route(card):
    """Two runs give the same bits (no atomics), on each backward route:
    bf16 (aligned: the forward and the backward on the tensor cores) and
    f32 (both on the CUDA cores); the backward recomputes what it needs,
    so its gradients through ``ssd`` equal a direct call of the backward
    kernel bit for bit. The three calls of a dtype take one backward route
    (the two routes round differently, ROADMAP §3), asserted; the
    CUDA-core route forced on the bf16 inputs repeats bit for bit too."""
    c = SSD_BWD_CASES["mamba2 fused B=2 S=300"]
    for dtype, route in ((torch.bfloat16, "tensor_core"), (torch.float32, "cuda_core")):
        leaves, operands, dy, dfinal = ssd_bwd_case(c, dtype, card, True, seed=1)
        routes = dict(ssd_ops.KERNEL.routes)
        bwd_routes = dict(ssd_ops.KERNEL.backward_kernel.routes)
        first = ssd_kernel_grads(leaves, operands, dy, dfinal, c[5])
        second = ssd_kernel_grads(leaves, operands, dy, dfinal, c[5])
        assert ssd_ops.KERNEL.routes[route] == routes[route] + 2
        direct = ssd_ops.KERNEL.backward(*operands(*leaves), dy, dfinal, chunk=c[5])
        torch.cuda.synchronize()
        assert ssd_ops.KERNEL.backward_kernel.routes[route] == bwd_routes[route] + 3
        for a, b, d in zip(first, second, direct):
            assert torch.equal(a, b) and torch.equal(a, d)
    leaves, operands, dy, dfinal = ssd_bwd_case(c, torch.bfloat16, card, True, seed=1)
    forced = [ssd_ops.KERNEL.backward(*operands(*leaves), dy, dfinal, chunk=c[5],
                                      route="cuda_core") for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*forced):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_ssd_under_grad_refuses_what_its_backward_lacks(card):
    """A chunk whose gradient pass would not fit a block's shared memory
    (1024 at P = N = 256) raises before the forward runs."""
    leaves, operands, _, _ = ssd_bwd_case((1, 1100, 2, 256, 256, 1024, False), torch.bfloat16,
                                          card, False)
    before = ssd_ops.KERNEL.launches
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ssd_ops.ssd(*operands(leaves[0].requires_grad_(True), *leaves[1:]), chunk=1024)
    assert ssd_ops.KERNEL.launches == before


@pytest.mark.cuda
def test_ssd_and_paged_refuse_gradients_on_the_card(card):
    """The SSD scan has a backward kernel: under grad it returns a result
    with an autograd node, whose backward launches that kernel once, and
    under ``no_grad`` the forward alone. Paged attention has none: under
    grad it raises rather than return a result that autograd would not
    differentiate."""
    rng = np.random.default_rng(4)
    x, dt, A, B, C = ssd_inputs(rng, 1, 128, card)
    before = (ssd_ops.KERNEL.launches, ssd_ops.KERNEL.backward_launches)
    y, _ = ssd_ops.ssd(x.requires_grad_(True), dt, A, B, C, chunk=64)
    assert y.grad_fn is not None
    y.float().sum().backward()
    torch.cuda.synchronize()
    assert x.grad is not None and x.grad.shape == x.shape
    assert (ssd_ops.KERNEL.launches, ssd_ops.KERNEL.backward_launches) == (
        before[0] + 1, before[1] + 1)
    with torch.no_grad():
        y, _ = ssd_ops.ssd(x, dt, A, B, C, chunk=64)
        assert y.grad_fn is None
    assert ssd_ops.KERNEL.backward_launches == before[1] + 1
    q = randn(rng, (2, 16, 64), torch.bfloat16, card).requires_grad_(True)
    pages = randn(rng, (8, 16, 16, 64), torch.bfloat16, card)
    table = torch.arange(8, dtype=torch.int32, device=card).view(2, 4)
    lengths = torch.tensor([64, 30], dtype=torch.int32, device=card)
    new = randn(rng, (2, 16, 64), torch.bfloat16, card)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        paged_ops.paged_attention(q, pages, pages, table, lengths)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        paged_ops.paged_attention_decode(q, new, new, pages, pages, table, lengths)


@pytest.mark.cuda
def test_adamw_square_root_on_the_card_is_correctly_rounded(card):
    """AdamW takes torch's f32 ``sqrt`` on the card (the f64 route only on
    the CPU): over every exponent of the positive f32 range, denormals and
    zero included, it equals the f64 root rounded to f32, bit for bit."""
    from repro_torch.train.optimizer import _sqrt

    gen = torch.Generator(device=card).manual_seed(6)
    bits_ = torch.randint(0, 0x7F800000, (1 << 24,), generator=gen, device=card,
                          dtype=torch.int32)
    x = torch.cat([bits_.view(torch.float32), torch.zeros(1, device=card)])
    want = torch.sqrt(x.double()).float()
    assert torch.equal(torch.sqrt(x).view(torch.int32), want.view(torch.int32))
    assert torch.equal(_sqrt(x).view(torch.int32), want.view(torch.int32))
