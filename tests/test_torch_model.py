"""The port's model against the JAX reference at reduced size.

Weights come from ``materialize(seed=0)`` in both packages and must be
byte-equal leaf for leaf; ``load_jax_params`` carries the reference's
arrays across and must give the same tensors. Activations are bf16 in
both. Op for op the port rounds as the reference's eager ops do (its FFN
spells out the logistic as XLA expands it), but the reference runs its
layers under ``lax.scan``, where XLA fuses elementwise chains and keeps
f32 between them: the reference's own compiled and eager blocks differ
by up to two bf16 ulps in most elements, and that compounds over the
layers. So outputs are held to a bf16 band: ``ATOL`` = 2**-4, one bf16
ulp at the residual stream's magnitude here (up to ~8), plus ``RTOL`` =
2**-6 of the value. Decode is teacher-forced: both models are fed the
same tokens, so a near-tie never sends them down different contexts.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import kv_quant as jkvq
from repro.models import Model as JaxModel
from repro.models import materialize as jax_materialize
from repro.models.layers import blockwise_attention as jax_blockwise
from repro_torch.configs import get_config
from repro_torch.kernels import kv_quant as tkvq
from repro_torch.models import Model, load_jax_params, materialize
from repro_torch.models.layers import blockwise_attention
from repro_torch.models.params import flatten_tree


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU: one intra-op thread per process keeps
    torch from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 2**-4
RTOL = 2**-6


def to_np(x) -> np.ndarray:
    """Any bf16/f32 array or tensor -> f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want):
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=RTOL, atol=ATOL)


def bits(x) -> np.ndarray:
    """Raw bytes of a bf16 array/tensor as int16, of anything else as is."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.fixture(scope="module")
def models():
    cfg = get_config("qwen1.5-0.5b").reduced()
    jcfg = jax_get_config("qwen1.5-0.5b").reduced()
    jmodel = JaxModel(jcfg)
    jparams = jax_materialize(jmodel.describe(), seed=0)
    params = materialize(Model(cfg).describe(), seed=0)
    return cfg, Model(cfg, params), params, jmodel, jparams


def test_materialize_is_byte_equal_to_reference(models):
    _, _, params, _, jparams = models
    import jax

    jleaves = {
        ".".join(str(k.key) for k in path): leaf
        for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]
    }
    tleaves = dict(flatten_tree(params))
    assert list(tleaves) == list(jleaves)          # same sorted-key order
    for name, t in tleaves.items():
        np.testing.assert_array_equal(bits(t), bits(jleaves[name]), err_msg=name)


def test_load_jax_params_carries_every_leaf(models):
    cfg, _, params, _, jparams = models
    import jax

    loaded = load_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    for (name, a), (_, b) in zip(flatten_tree(loaded), flatten_tree(params)):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=name)
    bad = jax.tree.map(np.asarray, jparams)
    bad["blocks"]["attn"].pop("bq")
    with pytest.raises(ValueError, match="bq"):
        load_jax_params(bad, cfg)


@pytest.mark.parametrize("variant", ["causal", "q_offset+hole", "window", "gqa+lengths"])
def test_blockwise_attention_matches_reference(variant):
    rng = np.random.default_rng(7)
    B, Sq, Skv, H, D = 2, 24, 40, 4, 64
    KH = 2 if variant == "gqa+lengths" else 4
    q = rng.standard_normal((B, Sq, H, D), dtype=np.float32)
    k = rng.standard_normal((B, Skv, KH, D), dtype=np.float32)
    v = rng.standard_normal((B, Skv, KH, D), dtype=np.float32)
    kw = dict(causal=True, q_offset=Skv - Sq, q_block=8, kv_block=8)
    if variant == "q_offset+hole":
        kw["kv_hole"] = (5, 16)
    elif variant == "window":
        kw.update(window=6, cap=30.0)
    elif variant == "gqa+lengths":
        kw["kv_lengths"] = np.asarray([40, 29], np.int32)
    jkw = dict(kw)
    tkw = dict(kw)
    if "kv_lengths" in kw:
        jkw["kv_lengths"] = jnp.asarray(kw["kv_lengths"])
        tkw["kv_lengths"] = torch.from_numpy(kw["kv_lengths"])
    want = jax_blockwise(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                         jnp.asarray(v, jnp.bfloat16), **jkw)
    got = blockwise_attention(torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16(),
                              torch.from_numpy(v).bfloat16(), **tkw)
    close(got, want)


def test_prefill_matches_reference(models):
    cfg, model, _, jmodel, jparams = models
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 29)).astype(np.int32)
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    logits, cache = model.prefill({"tokens": torch.from_numpy(toks).long()})
    assert tuple(logits.shape) == (1, cfg.vocab_size) and logits.dtype == torch.float32
    close(logits, jlogits)
    close(cache["k"], jcache["k"])
    close(cache["v"], jcache["v"])


def test_prefill_over_padded_prefix_matches_reference(models):
    """Chunked prefill: a suffix over a prefix padded past its real length
    (``positions_offset``/``prefix_valid``), logits at ``logit_index``."""
    cfg, model, _, jmodel, jparams = models
    rng = np.random.default_rng(2)
    ctx = rng.integers(0, cfg.vocab_size, (1, 40)).astype(np.int32)
    p_real, p_pad = 21, 32
    _, jpre = jmodel.prefill(jparams, {"tokens": jnp.asarray(ctx[:, :p_real])})
    pad = ((0, 0), (0, 0), (0, p_pad - p_real), (0, 0), (0, 0))
    garbage = rng.standard_normal(jpre["k"].shape[:2] + (p_pad - p_real,)
                                  + jpre["k"].shape[3:], dtype=np.float32)
    pk = np.array(jnp.pad(jpre["k"], pad).astype(jnp.float32))
    pv = np.array(jnp.pad(jpre["v"], pad).astype(jnp.float32))
    pk[:, :, p_real:] = garbage                     # must stay masked
    pv[:, :, p_real:] = garbage
    suffix = np.concatenate([ctx[:, p_real:], np.zeros((1, 5), np.int32)], axis=1)
    jlogits, jcache = jmodel.prefill(
        jparams, {"tokens": jnp.asarray(suffix)},
        prefix={"k": jnp.asarray(pk, jnp.bfloat16), "v": jnp.asarray(pv, jnp.bfloat16)},
        logit_index=40 - p_real - 1, positions_offset=p_real, prefix_valid=p_real)
    logits, cache = model.prefill(
        {"tokens": torch.from_numpy(suffix).long()},
        prefix={"k": torch.from_numpy(pk).bfloat16(), "v": torch.from_numpy(pv).bfloat16()},
        logit_index=40 - p_real - 1, positions_offset=p_real, prefix_valid=p_real)
    close(logits, jlogits)
    close(cache["k"], jcache["k"])
    # the padded chunk equals the unchunked context at the same position
    full, _ = model.prefill({"tokens": torch.from_numpy(ctx).long()})
    close(logits, full)


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_decode_paged_teacher_forced_matches_reference(models, fmt):
    cfg, model, _, jmodel, jparams = models
    L, KH, HD, T, N = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, 8, 12
    rng = np.random.default_rng(3)
    lens0 = [21, 9, 1]                                  # row 2: a scratch-like row
    B = len(lens0)
    # the same starting pool for both: random pages (a prefilled context
    # would do too; the kernel cannot tell)
    kp0 = rng.standard_normal((L, N, T, KH, HD), dtype=np.float32)
    vp0 = rng.standard_normal((L, N, T, KH, HD), dtype=np.float32)
    tables = np.asarray([[3, 7, 1, 10], [5, 2, 0, 0], [11, 11, 11, 11]], np.int32)
    if fmt == "int8":
        jk, jks = jkvq.quantize_pages(jnp.asarray(kp0))
        jv, jvs = jkvq.quantize_pages(jnp.asarray(vp0))
        tk, tks = tkvq.quantize_pages(torch.from_numpy(kp0))
        tv, tvs = tkvq.quantize_pages(torch.from_numpy(vp0))
    else:
        jk = jnp.asarray(kp0, jnp.bfloat16)
        jv = jnp.asarray(vp0, jnp.bfloat16)
        tk = torch.from_numpy(kp0).bfloat16()
        tv = torch.from_numpy(vp0).bfloat16()
        jks = jvs = tks = tvs = None
    for step in range(4):
        lens = np.asarray([n + step for n in lens0], np.int32)
        if step:
            lens[2] = 1                                  # a masked row stays put
        pos = lens - 1
        tp = tables[np.arange(B), pos // T]
        to = pos % T
        toks = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
        jout = jmodel.decode_paged(
            jparams, jk, jv, jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(tables),
            jnp.asarray(tp), jnp.asarray(to), jks, jvs)
        if fmt == "int8":
            jlogits, jk, jv, jks, jvs = jout
        else:
            jlogits, jk, jv = jout
        logits = model.decode_paged(
            tk, tv, torch.from_numpy(toks).long(), torch.from_numpy(lens),
            torch.from_numpy(tables), torch.from_numpy(tp), torch.from_numpy(to), tks, tvs)
        close(logits, jlogits)
    if fmt == "int8":
        # the appended tokens are in the band, and requantizing their page
        # may round either side of one int8 level: band + one level
        for q, sc, jq, jsc in ((tk, tks, jk, jks), (tv, tvs, jv, jvs)):
            np.testing.assert_allclose(sc.numpy(), np.asarray(jsc), rtol=RTOL)
            got = tkvq.dequantize_pages(q, sc, torch.float32).numpy()
            want = np.asarray(jkvq.dequantize_pages(jq, jsc, jnp.float32))
            level = np.asarray(jsc)[..., None, None, None]
            assert (np.abs(got - want) <= ATOL + RTOL * np.abs(want) + level).all()
    else:
        close(tk, jk)
        close(tv, jv)
