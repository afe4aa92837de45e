"""The port's sequence (prefill) attention against the JAX reference.

``flash_attention`` (layout ``[B, H, S, D]``) on CPU tensors takes the
plain ``flash_attention_ref`` and is held against the Pallas kernel in
interpret mode and against the reference's oracle; ``prefill_attention``
(the model's ``[B, S, H, D]``) on CPU tensors takes the plain
``blockwise_attention`` and is held against the reference's
``blockwise_attention`` with ``q_offset``, ``kv_hole`` and ``kv_lengths``.
The two layouts, which share one kernel on the card, are held against
each other. Bands are the reference's own ``tol()`` of
``tests/test_kernels.py`` (2e-3 in f32, 2e-2 in bf16: the frameworks sum
in another order and round the bf16 output once, and ``blockwise_attention``
rounds the probabilities to bf16 before the P·V product where the dense
oracle does not).

The plain backward, ``flash_attention_bwd_ref`` (the gradient the backward
kernel is held to on the card), is held in f32 against ``jax.vjp`` of the
reference's ``blockwise_attention``; the backward's choice of route
(``ops._bwd_route``) is pure Python and is held here too.

The CUDA kernel itself runs only on a card: ``test_kernel_matches_plain_on_card``
is marked ``cuda`` and skips where there is none.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as pallas_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro.models.layers import blockwise_attention as jax_blockwise
from repro_torch.kernels.flash_attention import ops, ref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU: one intra-op thread per process keeps
    torch from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FLASH_SHAPES = [
    # B, H, KH, S, D, qb, kb (tests/test_kernels.py)
    (2, 4, 4, 64, 32, 16, 16),
    (1, 8, 2, 128, 64, 32, 32),
    (2, 4, 1, 64, 64, 64, 16),
]
VARIANTS = {
    "causal": dict(causal=True),
    "window": dict(causal=True, window=24),
    "bidir": dict(causal=False),
    "softcap": dict(causal=True, softcap=50.0),
}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-3, atol=2e-3)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def qkv(seed, q_shape, kv_shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(q_shape, dtype=np.float32),
            rng.standard_normal(kv_shape, dtype=np.float32),
            rng.standard_normal(kv_shape, dtype=np.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_flash_attention_on_cpu_matches_pallas_interpret(shape, dtype, variant):
    B, H, KH, S, D, qb, kb = shape
    jd, td = DTYPES[dtype]
    kw = VARIANTS[variant]
    q, k, v = qkv(11, (B, H, S, D), (B, KH, S, D))
    want = pallas_flash(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
                        q_block=qb, kv_block=kb, interpret=True, **kw)
    before = ops.KERNEL.launches
    got = ops.flash_attention(torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
                              torch.from_numpy(v).to(td), **kw)
    assert ops.KERNEL.launches == before          # CPU tensors take the plain version
    assert got.dtype == td and tuple(got.shape) == (B, H, S, D)
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_flash_attention_ref_matches_jax_oracle(variant):
    """The plain version against the reference's oracle, GQA 4:1, with a
    ragged length and a query offset (what the Pallas kernel cannot take)."""
    B, H, KH, Sq, Skv, D = 1, 8, 2, 37, 53, 64
    kw = dict(VARIANTS[variant], q_offset=Skv - Sq)
    q, k, v = qkv(12, (B, H, Sq, D), (B, KH, Skv, D))
    want = jax_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), **kw)
    np.testing.assert_allclose(f32(got), f32(want), **tol("float32"))


def test_flash_attention_q_offset_chunk():
    """Chunked prefill: the suffix attends over the full KV with offset
    positions and equals the tail of the full computation."""
    B, H, S, D = 1, 4, 64, 32
    q, k, v = (torch.from_numpy(a) for a in qkv(13, (B, H, S, D), (B, H, S, D)))
    full = ops.flash_attention(q, k, v, causal=True)
    tail = ops.flash_attention(q[:, :, 32:], k, v, causal=True, q_offset=32)
    np.testing.assert_allclose(f32(tail), f32(full[:, :, 32:]), **tol("float32"))


PREFILL_VARIANTS = {
    # name: (B, Sq, Skv, H, KH, D, kwargs)
    "monolithic": (1, 48, 48, 4, 4, 64, dict(causal=True)),
    "chunk+hole": (1, 32, 96, 4, 4, 64, dict(causal=True, q_offset=64, kv_hole=(45, 64))),
    "gqa+lengths": (2, 24, 40, 4, 2, 64, dict(causal=True, q_offset=16,
                                              kv_lengths=[40, 29])),
    "window+cap": (1, 40, 40, 4, 4, 128, dict(causal=True, window=12, cap=30.0)),
    "bidir ragged": (2, 30, 30, 4, 1, 32, dict(causal=False)),
    # head dimensions beyond 128: zamba2's shared block (2·2560/32 = 160)
    # and gemma2-9b (256), with a ragged tail and a chunk behind a hole
    "d160 ragged": (1, 37, 37, 4, 4, 160, dict(causal=True)),
    "d160 chunk+hole": (1, 24, 72, 4, 4, 160, dict(causal=True, q_offset=48,
                                                   kv_hole=(30, 48))),
    "d256 gqa ragged": (1, 37, 37, 4, 2, 256, dict(causal=True)),
    "d256 chunk+hole": (1, 24, 72, 4, 2, 256, dict(causal=True, q_offset=48,
                                                   kv_hole=(30, 48))),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(PREFILL_VARIANTS))
def test_prefill_attention_on_cpu_matches_jax_blockwise(variant, dtype):
    B, Sq, Skv, H, KH, D, kw = PREFILL_VARIANTS[variant]
    jd, td = DTYPES[dtype]
    q, k, v = qkv(14, (B, Sq, H, D), (B, Skv, KH, D))
    jkw, tkw = dict(kw), dict(kw)
    if "kv_lengths" in kw:
        jkw["kv_lengths"] = jnp.asarray(kw["kv_lengths"], jnp.int32)
        tkw["kv_lengths"] = torch.tensor(kw["kv_lengths"], dtype=torch.int32)
    want = jax_blockwise(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd), **jkw)
    before = ops.KERNEL.launches
    got = ops.prefill_attention(torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
                                torch.from_numpy(v).to(td), **tkw)
    assert ops.KERNEL.launches == before
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


@pytest.mark.parametrize("variant", ["causal", "window", "softcap"])
def test_the_two_layouts_agree(variant):
    """``prefill_attention`` in [B,S,H,D] and ``flash_attention`` in
    [B,H,S,D] compute one function (one kernel on the card)."""
    kw = dict(VARIANTS[variant])
    pkw = dict(causal=kw["causal"], window=kw.get("window"), cap=kw.get("softcap"))
    B, H, KH, S, D = 2, 8, 2, 50, 64
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in qkv(15, (B, H, S, D), (B, KH, S, D)))
    a = ops.flash_attention(q, k, v, **kw)
    b = ops.prefill_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **pkw)
    np.testing.assert_allclose(f32(b.transpose(1, 2)), f32(a), **tol("bfloat16"))


BWD_CASES = {
    # name: (B, Sq, Skv, H, KH, D, kwargs)
    "causal": (2, 40, 40, 4, 4, 32, dict(causal=True)),
    "window+softcap": (1, 48, 48, 4, 4, 64, dict(causal=True, window=12, cap=30.0)),
    "gqa 2:1": (1, 37, 37, 4, 2, 64, dict(causal=True)),
    "cross": (2, 24, 53, 4, 4, 32, dict(causal=False)),
}
#: the plain backward against the reference's gradient, both in f32: each
#: gradient within 1e-5 of its own largest entry (the two sum in another
#: order; nothing is rounded to bf16)
BWD_RTOL = 1e-5


@pytest.mark.parametrize("name", list(BWD_CASES))
def test_plain_backward_matches_jax_vjp_of_blockwise(name):
    B, Sq, Skv, H, KH, D, kw = BWD_CASES[name]
    q, k, v = qkv(17, (B, Sq, H, D), (B, Skv, KH, D))
    do = np.random.default_rng(18).standard_normal((B, Sq, H, D), dtype=np.float32)
    if "cap" in kw:
        q = q * 4.0             # scores past the softcap's knee, so the cap binds
    _, vjp = jax.vjp(lambda a, b, c: jax_blockwise(a, b, c, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = ref.flash_attention_bwd_ref(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), torch.from_numpy(do), **kw)
    for g, w, t in zip(got, want, (q, k, v)):
        w = f32(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == t.shape
        np.testing.assert_allclose(f32(g), w, rtol=0, atol=BWD_RTOL * np.abs(w).max())


def _strided(shape, dtype, offset=0, pad=0):
    """A [..., D] view of a wider buffer: rows ``D + pad`` apart, starting
    ``offset`` elements in."""
    *lead, D = shape
    buf = torch.zeros((*lead, D + pad + offset), dtype=dtype)
    return buf[..., offset:offset + D]


@pytest.mark.parametrize("case", ["bf16 d64", "bf16 d32", "bf16 d128", "bf16 d160", "bf16 d256",
                                  "f32 d64", "bf16 unaligned start", "bf16 unaligned stride"])
def test_backward_route_follows_dtype_head_dim_and_alignment(case):
    """bf16 at D <= 128 with 16-byte-aligned rows takes the tensor cores;
    f32, D = 160 or 256, or a row start or stride off 16 bytes takes the
    CUDA cores. The choice reads dtypes, shapes and strides alone."""
    dtype = torch.float32 if case.startswith("f32") else torch.bfloat16
    D = int(case.split("d")[-1]) if " d" in case else 64
    ts = [_strided((1, 8, 2, D), dtype) for _ in range(8)]
    if case == "bf16 unaligned start":
        ts[4] = _strided((1, 8, 2, D), dtype, offset=1)      # dout 2 bytes off
    if case == "bf16 unaligned stride":
        ts[1] = _strided((1, 8, 2, D), dtype, pad=4)         # k rows 8 bytes apart extra
    want = "tensor_core" if dtype == torch.bfloat16 and D <= 128 and "unaligned" not in case \
        else "cuda_core"
    assert ops._bwd_route(ts, D) == want


def test_blockwise_attention_is_importable_from_layers():
    from repro_torch.models import layers

    assert layers.blockwise_attention is ref.blockwise_attention


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _, td = DTYPES[dtype]
    # the chunked-prefill shape of the serving path: a 64-token chunk over
    # a 64-token bucketed prefix whose last 19 positions are padding
    q, k, v = (torch.from_numpy(a).cuda().to(td)
               for a in qkv(16, (1, 64, 16, 64), (1, 128, 16, 64)))
    kw = dict(causal=True, q_offset=64, kv_hole=(45, 64))
    before = ops.KERNEL.launches
    got = ops.prefill_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.KERNEL.launches == before + 1
    want = ref.blockwise_attention(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **tol(dtype))
