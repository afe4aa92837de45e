"""The split-K (flash-decoding) decomposition of the port's paged decode
kernel, on the CPU.

The CUDA kernel cuts the block table's columns into ranges that
``ops._split_plan`` chooses, keeps one partial softmax state per range and
merges the partials by log-sum-exp. ``ref.paged_attention_split_ref`` does
exactly that in plain PyTorch; here it is held against the port's dense
``paged_attention_decode_ref``/``paged_attention_ref``, the JAX reference's
oracles and the Pallas kernel in interpret mode, on the same numpy inputs.
Bands: 1e-5 in f32 (the same operands, summed in another order) and the
reference's 2e-2 in bf16 (``tests/test_kernels.py`` ``tol()``: one rounding
of the bf16 output).

A row of length 0 sees no key: the dense versions return the mean of v
there (every score at -1e30 gives p = 1), the kernel and the split version
zeros. No serving path produces such a row, so the comparisons leave it
out and the zeros are checked on their own.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import kv_quant as jkvq
from repro.kernels.paged_attention import ref as jref
from repro.kernels.paged_attention.kernel import paged_attention as pallas_paged_attention
from repro_torch.kernels import kv_quant as tkvq
from repro_torch.kernels.paged_attention import ops, ref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU: one intra-op thread per process keeps
    torch from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JAX_REF = jax.jit(jref.paged_attention_ref, static_argnames=("softcap", "window"))
JAX_DECODE_REF = jax.jit(jref.paged_attention_decode_ref,
                         static_argnames=("softcap", "window"))
F32_BAND = dict(rtol=1e-5, atol=1e-5)
BF16_BAND = dict(rtol=2e-2, atol=2e-2)


def make_inputs(seed, B, H, KH, D, T, P, lengths):
    """One case as numpy arrays: q, the new token's k/v, a pool with three
    spare pages, a shuffled block table and the lengths."""
    rng = np.random.default_rng(seed)
    n_pages = B * P + 3
    return {
        "q": rng.standard_normal((B, H, D), dtype=np.float32),
        "k_new": rng.standard_normal((B, KH, D), dtype=np.float32),
        "v_new": rng.standard_normal((B, KH, D), dtype=np.float32),
        "k": rng.standard_normal((n_pages, T, KH, D), dtype=np.float32),
        "v": rng.standard_normal((n_pages, T, KH, D), dtype=np.float32),
        "tables": rng.permutation(n_pages)[: B * P].reshape(B, P).astype(np.int32),
        "lengths": np.asarray(lengths, np.int32),
    }


def torch_operands(case, dtype=torch.float32, quantized=False):
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    for name in ("q", "k_new", "v_new"):
        t[name] = t[name].to(dtype)
    if quantized:
        t["k"], t["ks"] = tkvq.quantize_pages(t["k"])
        t["v"], t["vs"] = tkvq.quantize_pages(t["v"])
    else:
        t["k"], t["v"], t["ks"], t["vs"] = t["k"].to(dtype), t["v"].to(dtype), None, None
    return t


def split(t, cols, with_new=True, **kw):
    new = (t["k_new"], t["v_new"]) if with_new else (None, None)
    return ref.paged_attention_split_ref(
        t["q"], *new, t["k"], t["v"], t["tables"], t["lengths"], t["ks"], t["vs"],
        cols=cols, **kw)


def dense(t, with_new=True, **kw):
    if with_new:
        return ref.paged_attention_decode_ref(
            t["q"], t["k_new"], t["v_new"], t["k"], t["v"], t["tables"], t["lengths"],
            t["ks"], t["vs"], **kw)
    return ref.paged_attention_ref(t["q"], t["k"], t["v"], t["tables"], t["lengths"],
                                   t["ks"], t["vs"], **kw)


def live_rows(case):
    return case["lengths"] > 0


def assert_rows_close(got, want, rows, band):
    np.testing.assert_allclose(np.asarray(got, np.float32)[rows],
                               np.asarray(want, np.float32)[rows], **band)


# ------------------------------------------------------------ the planner
@pytest.mark.parametrize("P,T,n_sm,rows", [
    (24, 16, 132, 48),     # the serving shape: 6 splits of 4 pages
    (24, 16, 132, 1),
    (4, 16, 132, 48),
    (1, 16, 132, 3),
    (25, 16, 132, 48),
    (7, 8, 132, 6),
    (256, 16, 132, 8),
    (100, 1, 16, 2),
    (3, 64, 132, 1),
])
def test_plan_covers_every_column_exactly_once(P, T, n_sm, rows):
    splits, cols = ops._split_plan(P, T, n_sm, rows)
    assert splits >= 1 and cols >= 1
    covered = np.zeros(P, np.int64)
    for s in range(splits):
        lo, hi = s * cols, min(P, (s + 1) * cols)
        assert lo < hi, "a split past the table's end"
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert cols * T >= min(P * T, ops._MIN_SPLIT_KEYS)


def test_plan_at_the_serving_shape_fills_the_card_twice():
    """B=3 rows x 16 KV heads, a 24-column table of 16-token pages, 132 SMs:
    at least ~2 x 132 blocks, and never a plan from ``lengths``."""
    splits, cols = ops._split_plan(24, 16, 132, 3 * 16)
    assert (splits, cols) == (6, 4)
    assert 3 * 16 * splits >= 2 * 132


# ------------------------------------------------------------ the split version
#: name -> (B, H, KH, D, T, P, lengths, cols, attention kwargs)
SPLIT_CASES = {
    # 7 visible pages in splits of 3: the last split is short
    "uneven splits": (2, 4, 4, 64, 8, 8, [56, 50], 3, {}),
    # the window starts inside split 1 and makes split 0 empty
    "window cuts a split": (2, 8, 2, 64, 8, 8, [60, 41], 2, dict(window=19)),
    # the new token is the first row of the last split
    "new token opens the last split": (1, 4, 2, 64, 8, 6, [41], 5, {}),
    # lengths of 0 and 1 beside full rows; rows 0 and 1 leave splits empty
    "lengths 0 and 1": (4, 4, 4, 64, 8, 4, [0, 1, 32, 9], 1, {}),
    # a table far wider than any row: most splits are empty
    "wide table": (3, 8, 4, 64, 16, 24, [97, 16, 1], 4, dict(softcap=30.0)),
    # GQA 4:1 and MQA with a window and a softcap
    "gqa": (3, 16, 4, 128, 16, 5, [80, 33, 17], 2, dict(window=40, softcap=20.0)),
    "mqa": (2, 8, 1, 32, 16, 4, [64, 17], 1, {}),
    # lengths at the split boundaries
    "boundaries": (4, 4, 4, 64, 16, 8, [32, 33, 64, 128], 2, {}),
}


@pytest.mark.parametrize("with_new", [True, False])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_matches_the_dense_plain_version(name, with_new):
    B, H, KH, D, T, P, lengths, cols, kw = SPLIT_CASES[name]
    case = make_inputs(20, B, H, KH, D, T, P, lengths)
    t = torch_operands(case)
    got = split(t, cols, with_new, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, D)
    assert_rows_close(got, dense(t, with_new, **kw), live_rows(case), F32_BAND)
    assert (got[torch.from_numpy(~live_rows(case))] == 0).all()


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_matches_the_jax_oracle(name):
    B, H, KH, D, T, P, lengths, cols, kw = SPLIT_CASES[name]
    case = make_inputs(21, B, H, KH, D, T, P, lengths)
    j = {k: jnp.asarray(v) for k, v in case.items()}
    want = JAX_DECODE_REF(j["q"], j["k_new"], j["v_new"], j["k"], j["v"], j["tables"],
                          j["lengths"], None, None, **kw)
    assert_rows_close(split(torch_operands(case), cols, **kw), want, live_rows(case), F32_BAND)


@pytest.mark.parametrize("name", ["uneven splits", "wide table", "gqa", "lengths 0 and 1"])
def test_split_in_bf16_matches_the_jax_oracle(name):
    B, H, KH, D, T, P, lengths, cols, kw = SPLIT_CASES[name]
    case = make_inputs(22, B, H, KH, D, T, P, lengths)
    j = {k: jnp.asarray(v, jnp.int32 if k in ("tables", "lengths") else jnp.bfloat16)
         for k, v in case.items()}
    want = JAX_DECODE_REF(j["q"], j["k_new"], j["v_new"], j["k"], j["v"], j["tables"],
                          j["lengths"], None, None, **kw)
    got = split(torch_operands(case, torch.bfloat16), cols, **kw)
    assert got.dtype == torch.bfloat16
    assert_rows_close(got.float(), want, live_rows(case), BF16_BAND)


@pytest.mark.parametrize("with_new", [True, False])
@pytest.mark.parametrize("name", ["uneven splits", "window cuts a split", "gqa",
                                  "lengths 0 and 1"])
def test_split_on_int8_pages_matches_the_jax_oracle(name, with_new):
    """int8 pages with per-page scales indexed by the physical page id: the
    two packages quantize bit for bit, so the operands are the same."""
    B, H, KH, D, T, P, lengths, cols, kw = SPLIT_CASES[name]
    case = make_inputs(23, B, H, KH, D, T, P, lengths)
    j = {k: jnp.asarray(v) for k, v in case.items()}
    jk, jks = jkvq.quantize_pages(j["k"])
    jv, jvs = jkvq.quantize_pages(j["v"])
    if with_new:
        want = JAX_DECODE_REF(j["q"], j["k_new"], j["v_new"], jk, jv, j["tables"],
                              j["lengths"], jks, jvs, **kw)
    else:
        want = JAX_REF(j["q"], jk, jv, j["tables"], j["lengths"], jks, jvs, **kw)
    t = torch_operands(case, quantized=True)
    got = split(t, cols, with_new, **kw)
    assert_rows_close(got, want, live_rows(case), F32_BAND)
    assert_rows_close(got, dense(t, with_new, **kw), live_rows(case), F32_BAND)


@pytest.mark.parametrize("quantized", [False, True])
def test_split_matches_pallas_kernel_in_interpret_mode(quantized):
    """Against the TPU kernel itself, run as the reference's tests run it on
    the CPU, with a window and a softcap, splits of one page."""
    case = make_inputs(24, 3, 8, 2, 64, 8, 4, [32, 19, 8])
    j = {k: jnp.asarray(v) for k, v in case.items()}
    if quantized:
        jk, jks = jkvq.quantize_pages(j["k"])
        jv, jvs = jkvq.quantize_pages(j["v"])
    else:
        jk, jv, jks, jvs = j["k"], j["v"], None, None
    want = pallas_paged_attention(j["q"], jk, jv, j["tables"], j["lengths"], jks, jvs,
                                  softcap=30.0, window=12, interpret=True)
    got = split(torch_operands(case, quantized=quantized), 1, with_new=False,
                softcap=30.0, window=12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_BAND)


@pytest.mark.parametrize("cols", [1, 2, 3, 5, 8])
def test_split_does_not_depend_on_the_cut(cols):
    """Every cut of the same table gives the same attention."""
    case = make_inputs(25, 2, 4, 2, 64, 8, 8, [61, 26])
    t = torch_operands(case)
    assert_rows_close(split(t, cols, window=30), split(t, 8, window=30),
                      live_rows(case), F32_BAND)


def test_split_never_reads_past_the_visible_columns():
    """Padding columns of the table may name another slot's live page:
    poisoning every page outside a row's visible columns changes nothing."""
    case = make_inputs(26, 2, 4, 4, 64, 8, 6, [19, 8])
    t = torch_operands(case)
    want = split(t, 2)
    visible = {int(p) for b, n in enumerate([3, 1]) for p in case["tables"][b, :n]}
    for name in ("k", "v"):
        poisoned = t[name].clone()
        for page in range(poisoned.shape[0]):
            if page not in visible:
                poisoned[page] = float("nan")
        t[name] = poisoned
    torch.testing.assert_close(split(t, 2), want, rtol=0, atol=0)


def test_wrapper_takes_the_plain_version_on_cpu_without_counting():
    case = make_inputs(27, 1, 4, 4, 64, 16, 24, [300])
    t = torch_operands(case)
    before = ops.KERNEL.launches
    got = ops.paged_attention_decode(t["q"], t["k_new"], t["v_new"], t["k"], t["v"],
                                     t["tables"], t["lengths"])
    assert ops.KERNEL.launches == before
    splits, cols = ops._split_plan(24, 16, 132, 4)
    torch.testing.assert_close(split(t, cols), got, **F32_BAND)
