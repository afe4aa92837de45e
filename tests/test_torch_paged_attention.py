"""Paged decode attention of the PyTorch port against the JAX reference.

The port's plain version (``repro_torch.kernels.paged_attention.ref``) and
its wrapper on CPU tensors (``ops``, which takes the plain version there)
are held against the reference's jnp oracle on the same numpy inputs, and
one case against the Pallas kernel in interpret mode. Bands are the
reference's own: ``tol()`` of ``tests/test_kernels.py`` (2e-3 in f32,
2e-2 in bf16, where the two frameworks round the bf16 output of an f32
computation that sums in another order) and ``EXACT_BAND``/``QUANT_BAND``
of ``tests/test_kv_quant.py`` for int8 pages.

The CUDA kernel itself runs only on a card: ``test_kernel_matches_plain_on_card``
is marked ``cuda`` and skips where there is none.
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


PAGED_SHAPES = [
    # B, H, KH, D, page_tokens, pages_per_seq (tests/test_kernels.py)
    (1, 4, 4, 64, 8, 2),      # MHA
    (3, 8, 2, 64, 8, 4),      # GQA 4:1
    (2, 16, 8, 128, 16, 3),   # GQA 2:1, 128-dim
    (4, 4, 1, 64, 16, 5),     # MQA
    (2, 8, 8, 160, 16, 3),    # MHA at zamba2's shared-block head dim, 2·2560/32
]
#: int8 bands of tests/test_kv_quant.py
EXACT_BAND = 2e-3
QUANT_BAND = 5e-2

#: the reference oracles, jitted: one compile per shape instead of one per
#: eager op keeps the file fast
JAX_REF = jax.jit(jref.paged_attention_ref, static_argnames=("softcap", "window"))
JAX_DECODE_REF = jax.jit(jref.paged_attention_decode_ref,
                         static_argnames=("softcap", "window"))

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(dtype: str) -> dict:
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-3, atol=2e-3)


def make_inputs(seed, B, H, KH, D, T, P, lengths=None, with_new=True):
    """One case as numpy arrays (f32 values, int32 indices)."""
    rng = np.random.default_rng(seed)
    n_pages = B * P + 3
    case = {
        "q": rng.standard_normal((B, H, D), dtype=np.float32),
        "k": rng.standard_normal((n_pages, T, KH, D), dtype=np.float32),
        "v": rng.standard_normal((n_pages, T, KH, D), dtype=np.float32),
        "tables": rng.permutation(n_pages)[: B * P].reshape(B, P).astype(np.int32),
        "lengths": np.asarray(
            lengths if lengths is not None else rng.integers(1, P * T + 1, B), np.int32
        ),
    }
    if with_new:
        case["k_new"] = rng.standard_normal((B, KH, D), dtype=np.float32)
        case["v_new"] = rng.standard_normal((B, KH, D), dtype=np.float32)
    return case


def run_both(case, dtype="float32", quantized=False, **kw):
    """The reference oracle and the port's wrapper (CPU) on one case;
    returns both outputs as f32 numpy arrays."""
    jdt, tdt = DTYPES[dtype]
    jx = {k: jnp.asarray(v) for k, v in case.items()}
    tx = {k: torch.from_numpy(v) for k, v in case.items()}
    for name in ("q", "k_new", "v_new"):
        if name in case:
            jx[name] = jx[name].astype(jdt)
            tx[name] = tx[name].to(tdt)
    if quantized:
        jk, jks = jkvq.quantize_pages(jx["k"])
        jv, jvs = jkvq.quantize_pages(jx["v"])
        tk, tks = tkvq.quantize_pages(tx["k"])
        tv, tvs = tkvq.quantize_pages(tx["v"])
    else:
        jk, jv, jks, jvs = jx["k"].astype(jdt), jx["v"].astype(jdt), None, None
        tk, tv, tks, tvs = tx["k"].to(tdt), tx["v"].to(tdt), None, None
    if "k_new" in case:
        want = JAX_DECODE_REF(
            jx["q"], jx["k_new"], jx["v_new"], jk, jv, jx["tables"], jx["lengths"],
            jks, jvs, **kw)
        got = ops.paged_attention_decode(
            tx["q"], tx["k_new"], tx["v_new"], tk, tv, tx["tables"], tx["lengths"],
            tks, tvs, **kw)
    else:
        want = JAX_REF(
            jx["q"], jk, jv, jx["tables"], jx["lengths"], jks, jvs, **kw)
        got = ops.paged_attention(
            tx["q"], tk, tv, tx["tables"], tx["lengths"], tks, tvs, **kw)
    assert got.dtype == tx["q"].dtype and tuple(got.shape) == tuple(case["q"].shape)
    return np.asarray(want, np.float32), got.float().numpy()


@pytest.mark.parametrize("with_new", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", PAGED_SHAPES)
def test_plain_version_matches_reference(shape, dtype, with_new):
    want, got = run_both(make_inputs(0, *shape, with_new=with_new), dtype)
    np.testing.assert_allclose(got, want, **tol(dtype))


@pytest.mark.parametrize("window", [6, 16, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_matches_reference(window, dtype):
    case = make_inputs(1, 3, 8, 2, 64, 8, 4, lengths=[32, 19, 5])
    want, got = run_both(case, dtype, window=window)
    np.testing.assert_allclose(got, want, **tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softcap_and_partial_tail_pages_match_reference(dtype):
    # every length lands mid-page, so tail garbage must stay masked
    case = make_inputs(2, 4, 4, 1, 64, 16, 5, lengths=[1, 17, 31, 75])
    want, got = run_both(case, dtype, softcap=5.0)
    np.testing.assert_allclose(got, want, **tol(dtype))


INT8_CASES = {
    # tests/test_kv_quant.py TestInt8KernelParity.CASES
    "gqa": dict(B=3, H=8, KH=2, D=64, T=8, P=4, lengths=[32, 19, 8],
                softcap=None, window=None),
    "softcap": dict(B=2, H=8, KH=4, D=64, T=8, P=3, lengths=[24, 11],
                    softcap=20.0, window=None),
    "window": dict(B=3, H=8, KH=4, D=64, T=8, P=4, lengths=[32, 21, 3],
                   softcap=None, window=6),
    "partial-tail": dict(B=1, H=4, KH=2, D=64, T=8, P=2, lengths=[13],
                         softcap=None, window=None),
    "all-at-once": dict(B=2, H=8, KH=2, D=64, T=16, P=3, lengths=[39, 15],
                        softcap=50.0, window=20),
    # zamba2's shared-block decode: MHA at D = 160
    "d160": dict(B=2, H=4, KH=4, D=160, T=16, P=3, lengths=[48, 17],
                 softcap=None, window=None),
}


@pytest.mark.parametrize("with_new", [False, True])
@pytest.mark.parametrize("name", sorted(INT8_CASES))
def test_int8_pages_match_reference(name, with_new):
    c = dict(INT8_CASES[name])
    kw = dict(softcap=c.pop("softcap"), window=c.pop("window"))
    case = make_inputs(3, lengths=c.pop("lengths"), with_new=with_new, **c)
    want, got = run_both(case, "float32", quantized=True, **kw)
    assert np.max(np.abs(got - want)) < EXACT_BAND
    # and the int8 result tracks the port's own unquantized result
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    args = [t["q"], t["k"], t["v"], t["tables"], t["lengths"]]
    if with_new:
        args[1:1] = [t["k_new"], t["v_new"]]
    fn = ref.paged_attention_decode_ref if with_new else ref.paged_attention_ref
    exact = fn(*args, **kw).numpy()
    assert np.max(np.abs(got - exact)) < QUANT_BAND


@pytest.mark.parametrize("quantized", [False, True])
def test_plain_version_matches_pallas_kernel_in_interpret_mode(quantized):
    case = make_inputs(4, 3, 8, 2, 64, 8, 4, lengths=[32, 19, 8], with_new=False)
    jx = {k: jnp.asarray(v) for k, v in case.items()}
    tx = {k: torch.from_numpy(v) for k, v in case.items()}
    if quantized:
        jk, jks = jkvq.quantize_pages(jx["k"])
        jv, jvs = jkvq.quantize_pages(jx["v"])
        tk, tks = tkvq.quantize_pages(tx["k"])
        tv, tvs = tkvq.quantize_pages(tx["v"])
    else:
        jk, jv, jks, jvs = jx["k"], jx["v"], None, None
        tk, tv, tks, tvs = tx["k"], tx["v"], None, None
    want = pallas_paged_attention(jx["q"], jk, jv, jx["tables"], jx["lengths"], jks, jvs,
                                  softcap=30.0, window=12, interpret=True)
    got = ref.paged_attention_ref(tx["q"], tk, tv, tx["tables"], tx["lengths"], tks, tvs,
                                  softcap=30.0, window=12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol("float32"))


def test_decode_insert_equals_writing_the_pool_first():
    """The decode variant reads k_new/v_new at position lengths-1 in place
    of the pool — identical to scattering the token into its tail page and
    running the plain attention."""
    case = make_inputs(5, 3, 8, 2, 64, 8, 4, lengths=[32, 9, 1])
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    got = ref.paged_attention_decode_ref(
        t["q"], t["k_new"], t["v_new"], t["k"], t["v"], t["tables"], t["lengths"])
    k, v = t["k"].clone(), t["v"].clone()
    pos = t["lengths"].long() - 1
    pages = t["tables"][torch.arange(3), pos // 8].long()
    k[pages, pos % 8] = t["k_new"]
    v[pages, pos % 8] = t["v_new"]
    want = ref.paged_attention_ref(t["q"], k, v, t["tables"], t["lengths"])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrapper_rejects_bad_operands_before_launching():
    """The kernel's checks run before anything is built or launched."""
    case = make_inputs(6, 1, 4, 4, 64, 8, 2)
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    kern = ops.PagedAttentionKernel()
    with pytest.raises(TypeError, match="int32"):
        kern(t["q"], None, None, t["k"], t["v"], t["tables"].long(), t["lengths"],
             None, None, softcap=None, window=None)
    with pytest.raises(ValueError, match="scales"):
        kern(t["q"], None, None, t["k"].to(torch.int8), t["v"].to(torch.int8),
             t["tables"], t["lengths"], None, None, softcap=None, window=None)
    assert kern.launches == 0 and kern._lib is None


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
def test_kernel_matches_plain_on_card(quantized):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    case = make_inputs(7, 3, 16, 16, 64, 16, 24, lengths=[384, 250, 97])
    t = {k: torch.from_numpy(v).cuda() for k, v in case.items()}
    for name in ("q", "k_new", "v_new"):
        t[name] = t[name].to(torch.bfloat16)
    if quantized:
        k, ks = tkvq.quantize_pages(t["k"])
        v, vs = tkvq.quantize_pages(t["v"])
    else:
        k, v, ks, vs = t["k"].bfloat16(), t["v"].bfloat16(), None, None
    before = ops.KERNEL.launches
    got = ops.paged_attention_decode(t["q"], t["k_new"], t["v_new"], k, v, t["tables"],
                                     t["lengths"], ks, vs)
    torch.cuda.synchronize()
    assert ops.KERNEL.launches == before + 1
    want = ref.paged_attention_decode_ref(t["q"], t["k_new"], t["v_new"], k, v, t["tables"],
                                          t["lengths"], ks, vs)
    torch.testing.assert_close(got.float(), want.float(), **tol("bfloat16"))
