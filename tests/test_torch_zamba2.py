"""The zamba2 hybrid in the port against the JAX reference.

Reduced zamba2-2.7b: 2 groups of 2 Mamba-2 blocks, each group followed by
the one shared attention block on ``concat(hidden, embedding)`` (4 heads
of 2·256/4 = 128), SSD state 32. Weights are the reference's
``materialize(seed=0)`` carried across with ``load_jax_params``, in bf16,
or cast to f32 exactly on both sides. What is held:

* the parameter and cache trees (names, shapes, dtypes) at full width and
  reduced, the shared block's leaves included;
* ``apply_shared_block`` in sequence and in decode mode on bit-equal
  inputs;
* ``prefill`` logits and its ``ssm``/``conv``/``shared_k``/``shared_v``
  caches;
* 8 teacher-forced ``decode`` steps from the prefill's caches, the shared
  slots padded to ``max_seq``;
* decode against a prefill of the longer sequence;
* ``prefill(prefix=...)`` raises, and the paged ``Engine`` and the
  serving launcher refuse the family, as the reference's do.

Bands: weights in f32 give logits to 1e-4 and equal greedy tokens; in bf16
the model band 2**-4 + 2**-6·|x| (ROADMAP §3), greedy tokens in the
reference's tie set.
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
from repro.models.layers import apply_shared_block as jax_shared_block
from repro.models.params import is_leaf
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import Model, load_jax_params
from repro_torch.models.layers import apply_shared_block
from repro_torch.models.params import leaves
from repro_torch.serving import Engine, SsmEngine


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU: one intra-op thread per process keeps
    torch from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "zamba2-2.7b"
ATOL, RTOL = 2**-4, 2**-6
F32_TOL = dict(rtol=1e-4, atol=1e-4)
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
CACHE_KEYS = ("ssm", "conv", "shared_k", "shared_v")


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def tol(precision: str) -> dict:
    return F32_TOL if precision == "f32" else dict(rtol=RTOL, atol=ATOL)


def tie_set(jlogits) -> set:
    """Tokens whose bf16-rounded logit equals the bf16-rounded maximum."""
    rounded = np.asarray(jnp.asarray(jlogits, jnp.bfloat16).astype(jnp.float32))
    return set(np.flatnonzero(rounded == rounded.max()).tolist())


def check_logits(logits, jlogits, precision: str) -> None:
    np.testing.assert_allclose(to_np(logits), to_np(jlogits), **tol(precision))
    got = torch.argmax(logits, -1).tolist()
    if precision == "f32":
        assert got == np.asarray(jnp.argmax(jlogits, -1)).tolist()
    else:
        for b, tok in enumerate(got):
            assert tok in tie_set(jlogits[b]), b


def jax_leaf_specs(tree) -> dict:
    return {".".join(str(k.key) for k in path): (tuple(l.shape), jnp.dtype(l.dtype).name)
            for path, l in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def leaf_specs(tree) -> dict:
    return {name: (tuple(l.shape), str(l.dtype).removeprefix("torch."))
            for name, l in leaves(tree)}


@pytest.fixture(scope="module")
def weights():
    cfg = get_config(ARCH).reduced()
    jcfg = jax_get_config(ARCH).reduced()
    jmodel = JaxModel(jcfg)
    jparams = jax_materialize(jmodel.describe(), seed=0)
    return cfg, jcfg, jmodel, jparams


def pair(weights, precision: str):
    """The port's and the reference's model on the same weights, in bf16
    or cast to f32 exactly on both sides."""
    cfg, _, jmodel, jparams = weights
    params = load_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    if precision == "f32":
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
        params = jax.tree.map(lambda t: t.float(), params)
    return Model(cfg, params), jmodel, jparams


def tokens(seed: int, n: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (1, n)).astype(np.int32)


# ------------------------------------------------------------------ trees
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_parameter_and_cache_trees_match_reference(reduced):
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    model, jmodel = Model(cfg), JaxModel(jcfg)
    specs = leaf_specs(model.describe())
    assert specs == jax_leaf_specs(jmodel.describe())
    groups, period = cfg.num_layers // cfg.shared_attn_period, cfg.shared_attn_period
    assert specs["blocks.in_proj"][0][:2] == (groups, period)
    assert specs["shared.attn.wq"][0] == (2 * cfg.d_model, cfg.num_heads * cfg.hybrid_head_dim)
    cache = leaf_specs(model.describe_cache(2, 64))
    assert cache == jax_leaf_specs(jmodel.describe_cache(2, 64))
    assert sorted(cache) == sorted(CACHE_KEYS)


# ---------------------------------------------------------- shared block
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_shared_block_matches_reference_in_sequence_and_decode_mode(weights, precision):
    """Bit-equal inputs on both sides: hidden and embedding [2, 37, d] in
    sequence mode; in decode mode one token a row over random slot
    buffers of 48 at lengths 37 and 9."""
    cfg, jcfg, _, _ = weights
    model, _, jparams = pair(weights, precision)
    tdt, jdt = DTYPES[precision]
    rng = np.random.default_rng(2)
    h, x0 = (rng.standard_normal((2, 37, cfg.d_model), dtype=np.float32) for _ in range(2))
    pos = np.arange(37)[None, :]
    jy, (jk, jv) = jax_shared_block(jparams["shared"], jnp.asarray(h, jdt), jnp.asarray(x0, jdt),
                                    jcfg, positions=jnp.asarray(pos))
    y, (k, v) = apply_shared_block(model._shared, torch.from_numpy(h).to(tdt),
                                   torch.from_numpy(x0).to(tdt), cfg,
                                   positions=torch.from_numpy(pos))
    for got, want in ((y, jy), (k, jk), (v, jv)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(to_np(got), to_np(want), **tol(precision))

    shape = (2, 48, cfg.num_kv_heads, cfg.hybrid_head_dim)
    kc, vc = (rng.standard_normal(shape, dtype=np.float32) for _ in range(2))
    lens = np.asarray([37, 9], np.int32)
    h1, x01 = h[:, :1], x0[:, :1]
    jy, (jk, jv) = jax_shared_block(
        jparams["shared"], jnp.asarray(h1, jdt), jnp.asarray(x01, jdt), jcfg,
        positions=jnp.asarray(lens - 1)[:, None], cache=(jnp.asarray(kc, jdt),
                                                         jnp.asarray(vc, jdt)),
        lengths=jnp.asarray(lens))
    tk, tv = torch.from_numpy(kc).to(tdt), torch.from_numpy(vc).to(tdt)
    y, (k, v) = apply_shared_block(
        model._shared, torch.from_numpy(h1).to(tdt), torch.from_numpy(x01).to(tdt), cfg,
        positions=torch.from_numpy(lens - 1)[:, None], cache=(tk, tv),
        lengths=torch.from_numpy(lens))
    assert k is tk and v is tv                    # written in place
    for got, want in ((y, jy), (k, jk), (v, jv)):
        np.testing.assert_allclose(to_np(got), to_np(want), **tol(precision))


# ---------------------------------------------------------------- prefill
@pytest.fixture(scope="module", params=["f32", "bf16"])
def prefilled(request, weights):
    precision = request.param
    cfg = weights[0]
    model, jmodel, jparams = pair(weights, precision)
    toks = tokens(1, 29, cfg.vocab_size)
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks)})
    logits, cache = model.prefill({"tokens": torch.from_numpy(toks).long()})
    return precision, (model, jmodel, jparams), toks, (jlogits, jcache), (logits, cache)


def test_prefill_logits_and_caches_match_reference(prefilled):
    precision, _, _, (jlogits, jcache), (logits, cache) = prefilled
    check_logits(logits, jlogits, precision)
    assert set(cache) == set(CACHE_KEYS)
    assert cache["ssm"].dtype == torch.float32
    for name in CACHE_KEYS:
        assert tuple(cache[name].shape) == tuple(jcache[name].shape), name
        np.testing.assert_allclose(to_np(cache[name]), to_np(jcache[name]), **tol(precision),
                                   err_msg=name)


def pad_shared(cache: dict, max_seq: int, pad) -> dict:
    """The prefill's cache with the shared slots padded to ``max_seq``."""
    out = dict(cache)
    for name in ("shared_k", "shared_v"):
        out[name] = pad(cache[name], max_seq - cache[name].shape[2])
    return out


def test_teacher_forced_decode_matches_reference(prefilled):
    """8 steps from the prefill's caches, shared slots padded to 48."""
    precision, (model, jmodel, jparams), toks, (_, jcache), (_, cache) = prefilled
    cfg = model.cfg
    jcache = pad_shared(jcache, 48, lambda a, n: jnp.pad(a, ((0, 0), (0, 0), (0, n),
                                                              (0, 0), (0, 0))))
    cache = pad_shared(cache, 48, lambda t, n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n)))
    jdecode = jax.jit(jmodel.decode)
    feed = np.random.default_rng(5).integers(0, cfg.vocab_size, 8).astype(np.int32)
    for i, tok in enumerate(feed):
        length = np.asarray([toks.shape[1] + i + 1], np.int32)
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray([tok]), jnp.asarray(length))
        logits, cache = model.decode(cache, torch.tensor([int(tok)]), torch.from_numpy(length))
        check_logits(logits, jlogits, precision)
    for name in CACHE_KEYS:
        np.testing.assert_allclose(to_np(cache[name]), to_np(jcache[name]), **tol(precision),
                                   err_msg=name)


def test_decode_equals_prefill_of_the_longer_sequence(weights):
    """The port's own consistency, in f32: a 29-token prefill and 6 greedy
    steps give, at the last step, the logits of a prefill of all 35."""
    cfg = weights[0]
    model, _, _ = pair(weights, "f32")
    toks = torch.from_numpy(tokens(6, 29, cfg.vocab_size)).long()
    logits, cache = model.prefill({"tokens": toks})
    cache = pad_shared(cache, 48, lambda t, n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n)))
    seq = toks[0].tolist()
    for i in range(6):
        tok = int(torch.argmax(logits[0]))
        seq.append(tok)
        logits = model.decode_into(cache, torch.tensor([tok]),
                                   torch.tensor([len(seq)], dtype=torch.int32))
    want, _ = model.prefill({"tokens": torch.tensor([seq])})
    np.testing.assert_allclose(to_np(logits), to_np(want), **F32_TOL)
    with pytest.raises(ValueError, match="no prefix"):
        model.prefill({"tokens": toks}, prefix=cache)


# ---------------------------------------------------------------- serving
def test_engines_and_launcher_refuse_the_hybrid_family(weights):
    """Neither the paged ``Engine`` nor ``SsmEngine`` serves the hybrid, as
    in the reference; the launcher refuses it before it draws weights."""
    cfg, _, _, jparams = weights
    params = load_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    with pytest.raises(ValueError, match="dense-cache families"):
        Engine(cfg, params, device="cpu")
    with pytest.raises(ValueError, match="ssm family"):
        SsmEngine(cfg, params, device="cpu")
    with pytest.raises(ValueError, match="dense-cache families"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
