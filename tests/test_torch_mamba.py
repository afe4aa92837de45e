"""The port's mamba2 model against the JAX reference at reduced size.

Weights come from ``materialize(seed=0)`` in both packages and must be
byte-equal leaf for leaf, including the stacked leaves that the port draws
one layer slice at a time; ``load_jax_params`` carries the reference's
arrays across and must give the same tensors. Prefill (sequence mode: the
SSD scan) and teacher-forced decode steps (the recurrent step) are held
to the bf16 model band of ``tests/test_torch_model.py``: ``ATOL`` = 2**-4
plus ``RTOL`` = 2**-6 of the value, because the reference runs its layers
under ``lax.scan``, where XLA fuses elementwise chains and keeps f32
between them while the port rounds op for op. Logits, the f32 SSM state
and the bf16 conv state are all held to it.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import materialize as jax_materialize
from repro.models.layers import apply_mamba_block as jax_apply_mamba_block
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import Model, load_jax_params, materialize
from repro_torch.models.layers import apply_mamba_block
from repro_torch.models.params import Leaf, flatten_tree, leaves


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
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want):
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=RTOL, atol=ATOL)


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def jax_leaves(tree) -> dict:
    return {
        ".".join(str(k.key) for k in path): leaf
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


@pytest.fixture(scope="module")
def models():
    cfg = get_config("mamba2-2.7b").reduced()
    jcfg = jax_get_config("mamba2-2.7b").reduced()
    jmodel = JaxModel(jcfg)
    jparams = jax_materialize(jmodel.describe(), seed=0)
    params = materialize(Model(cfg).describe(), seed=0)
    return cfg, Model(cfg, params), params, jmodel, jparams


def test_materialize_is_byte_equal_to_reference(models):
    _, _, params, _, jparams = models
    jl = jax_leaves(jparams)
    tl = dict(flatten_tree(params))
    assert list(tl) == list(jl)                     # same sorted-key order
    for name, t in tl.items():
        np.testing.assert_array_equal(bits(t), bits(jl[name]), err_msg=name)


@pytest.mark.parametrize("shape", [(3, 5, 7), (2, 4, 3, 5)])
def test_sliced_draw_is_the_whole_draw(shape):
    """Drawing a stacked leaf one leading slice at a time from one
    generator gives the bytes of drawing it whole, in C order."""
    got = materialize({"w": Leaf(shape, ("layers",) + (None,) * (len(shape) - 1))}, seed=3)
    rng = np.random.default_rng(3)
    whole = rng.standard_normal(shape, dtype=np.float32) * (1.0 / np.sqrt(shape[-2]))
    want = torch.from_numpy(np.asarray(whole, np.float32)).to(torch.bfloat16)
    np.testing.assert_array_equal(bits(got["w"]), bits(want))


def test_load_jax_params_carries_every_leaf(models):
    cfg, _, params, _, jparams = models
    loaded = load_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    for (name, a), (_, b) in zip(flatten_tree(loaded), flatten_tree(params)):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=name)
    bad = jax.tree.map(np.asarray, jparams)
    bad["blocks"].pop("A_log")
    with pytest.raises(ValueError, match="A_log"):
        load_jax_params(bad, cfg)


def test_describe_cache_matches_reference(models):
    cfg, model, _, jmodel, _ = models
    from repro.models.params import is_leaf

    jl = {".".join(str(k.key) for k in path): leaf for path, leaf in
          jax.tree_util.tree_flatten_with_path(jmodel.describe_cache(2, 64), is_leaf=is_leaf)[0]}
    tl = dict(leaves(model.describe_cache(2, 64)))
    assert list(tl) == sorted(jl) == ["conv", "ssm"]
    for name, leaf in tl.items():
        assert tuple(leaf.shape) == tuple(jl[name].shape), name
        assert str(leaf.dtype).removeprefix("torch.") == jnp.dtype(jl[name].dtype).name, name


def test_mamba_block_matches_reference(models):
    """One block in sequence mode, the layer-0 weights, a ragged length."""
    cfg, model, params, _, jparams = models
    x = np.random.default_rng(2).standard_normal((1, 37, cfg.d_model), dtype=np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"])
    tp = {k: v[0] for k, v in params["blocks"].items()}
    jy, (jst, jcv) = jax_apply_mamba_block(jp, jnp.asarray(x, jnp.bfloat16), jax_get_config(
        "mamba2-2.7b").reduced())
    y, (st, cv) = apply_mamba_block(tp, torch.from_numpy(x).bfloat16(), cfg)
    close(y, jy)
    close(st, jst)
    close(cv, jcv)


@pytest.fixture(scope="module")
def prefilled(models):
    cfg, model, _, jmodel, jparams = models
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 29)).astype(np.int32)
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks)})
    logits, cache = model.prefill({"tokens": torch.from_numpy(toks).long()})
    return toks, (jlogits, jcache), (logits, cache)


def test_prefill_matches_reference(models, prefilled):
    cfg = models[0]
    _, (jlogits, jcache), (logits, cache) = prefilled
    assert tuple(logits.shape) == (1, cfg.vocab_size) and logits.dtype == torch.float32
    assert cache["ssm"].dtype == torch.float32 and cache["conv"].dtype == torch.bfloat16
    assert tuple(cache["ssm"].shape) == tuple(jcache["ssm"].shape)
    assert tuple(cache["conv"].shape) == tuple(jcache["conv"].shape)
    close(logits, jlogits)
    close(cache["ssm"], jcache["ssm"])
    close(cache["conv"], jcache["conv"])


def test_decode_steps_match_reference(models, prefilled):
    """Teacher-forced decode from the prefilled state: every step's logits
    and the final state within the band."""
    cfg, model, _, jmodel, jparams = models
    toks, (_, jcache), (_, cache) = prefilled
    jdecode = jax.jit(jmodel.decode)
    feed = [int(t) for t in np.random.default_rng(5).integers(0, cfg.vocab_size, 5)]
    for i, tok in enumerate(feed):
        length = toks.shape[1] + i + 1
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray([tok], jnp.int32),
                                  jnp.asarray([length], jnp.int32))
        logits, cache = model.decode(cache, torch.tensor([tok]),
                                     torch.tensor([length], dtype=torch.int32))
        close(logits, jlogits)
    close(cache["ssm"], jcache["ssm"])
    close(cache["conv"], jcache["conv"])


def test_prefill_equals_prefill_then_decode(models):
    """The port's own consistency: decoding the last token from the state
    of the shorter prefix gives the full prefill's logits (the scan and
    the recurrence compute one model)."""
    cfg, model, _, _, _ = models
    toks = torch.from_numpy(
        np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 21)).astype(np.int64))
    full, _ = model.prefill({"tokens": toks})
    _, cache = model.prefill({"tokens": toks[:, :-1]})
    step, _ = model.decode(cache, toks[:, -1], torch.tensor([21], dtype=torch.int32))
    close(step, full)


def test_the_dense_only_and_ssm_only_entry_points_refuse(models):
    cfg, model, *_ = models
    with pytest.raises(NotImplementedError):
        model.decode_paged(None, None, None, None, None, None, None)
    # the dense family's slot-cache decode is served now
    # (tests/test_torch_dense_slots.py): its cache is slot buffers, the ssm
    # family's a fixed-size state
    dense = Model(get_config("qwen1.5-0.5b").reduced())
    assert set(dense.describe_cache(2, 64)) == {"k", "v"}
    assert set(model.describe_cache(2, 64)) == {"ssm", "conv"}
    # every family constructs: the zamba2 hybrid and gemma2's alternation
    # (tests/test_torch_zamba2.py, tests/test_torch_gemma2.py), whisper's
    # encoder-decoder with its cross caches and internvl2's dense cache
    # (tests/test_torch_whisper.py, tests/test_torch_internvl2.py)
    for arch in ARCH_IDS:
        Model(get_config(arch))
    assert "shared_k" in Model(get_config("zamba2-2.7b").reduced()).describe_cache(2, 64)
    assert set(Model(get_config("gemma2-9b").reduced()).describe_cache(2, 64)) == {
        "local", "global"}
    assert set(Model(get_config("whisper-medium").reduced()).describe_cache(2, 64)) == {
        "k", "v", "ck", "cv"}
    assert set(Model(get_config("internvl2-26b").reduced()).describe_cache(2, 64)) == {
        "k", "v"}
