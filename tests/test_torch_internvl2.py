"""internvl2's image prefix (the ``vlm`` family) in the port against the JAX
reference.

Reduced internvl2-26b: 4 layers, d_model 256, 4 query heads over 1 KV
head of 64, 8 image tokens. Weights are the reference's
``materialize(seed=0)`` carried across with ``load_jax_params``, in bf16,
or cast to f32 exactly on both sides; ``image_embeds`` (the stub of the
InternViT front end) and the tokens are drawn with numpy from a seed.
What is held:

* the parameter and cache trees;
* ``prefill`` logits (also at a ``logit_index``, which counts from the
  first text token) and the cache, whose first 8 positions are the
  image's;
* 4 teacher-forced slot-cache ``decode`` steps, ``lengths`` counting the
  image tokens;
* ``decode_paged`` over pages filled from the prefill cache against the
  reference's ``decode_paged``, logits and pools;
* chunked prefill over a bucketed prefix, which prepends the image to the
  suffix as the reference's does;
* decode against a prefill of the longer sequence;
* the paged ``Engine`` admits the family, as the reference's does, and
  both fail alike at the first prefill: neither passes ``image_embeds``.

Bands: f32 within 1e-4 and equal greedy tokens; bf16 the model band
2**-4 + 2**-6·|x| (ROADMAP §3), greedy tokens in the reference's tie set.
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
from repro.models.params import is_leaf
from repro.serving import Engine as JaxEngine
from repro.serving import EngineRequest as JaxRequest
from repro_torch.configs import get_config
from repro_torch.models import Model, load_jax_params
from repro_torch.models.params import leaves
from repro_torch.serving import Engine, EngineRequest


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU: one intra-op thread per process keeps
    torch from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "internvl2-26b"
ATOL, RTOL = 2**-4, 2**-6
F32_TOL = dict(rtol=1e-4, atol=1e-4)
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
PROMPT, MAX_SEQ, STEPS, T = 13, 48, 4, 8


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


def inputs(seed: int, cfg, n: int = PROMPT):
    """A prompt of ``n`` tokens and its image embeddings [1, n_img, d]."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (1, n)).astype(np.int32)
    img = rng.standard_normal((1, cfg.num_image_tokens, cfg.d_model), dtype=np.float32)
    return toks, img


def batches(toks, img):
    """The same batch for the reference and for the port."""
    return ({"tokens": jnp.asarray(toks), "image_embeds": jnp.asarray(img)},
            {"tokens": torch.from_numpy(toks).long(), "image_embeds": torch.from_numpy(img)})


# ------------------------------------------------------------------ trees
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_parameter_and_cache_trees_match_reference(reduced):
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    model, jmodel = Model(cfg), JaxModel(jcfg)
    specs = leaf_specs(model.describe())
    assert specs == jax_leaf_specs(jmodel.describe())
    cache = leaf_specs(model.describe_cache(2, 64))
    assert cache == jax_leaf_specs(jmodel.describe_cache(2, 64))
    assert sorted(cache) == ["k", "v"]
    if not reduced:
        # 48 layers (attention, FFN, two norms), the embedding, the head and
        # the final norm: 19.86 B
        d, layer = 6144, 2 * 6144 * 6144 + 2 * 6144 * 1024 + 3 * 6144 * 16_384 + 2 * 6144
        n = sum(int(np.prod(shape)) for shape, _ in specs.values())
        assert n == 48 * layer + 2 * 92_553 * d + d == 19_861_260_288


# ---------------------------------------------------------------- prefill
@pytest.fixture(scope="module", params=["f32", "bf16"])
def prefilled(request, weights):
    precision = request.param
    model, jmodel, jparams = pair(weights, precision)
    toks, img = inputs(1, model.cfg)
    jbatch, batch = batches(toks, img)
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, jbatch)
    logits, cache = model.prefill(batch)
    return precision, (model, jmodel, jparams), (toks, img), (jlogits, jcache), (logits, cache)


def test_prefill_logits_and_cache_match_reference(prefilled):
    """The cache covers image and text, 8 + 13 positions, the image's
    first; ``logit_index`` names a text token."""
    precision, (model, jmodel, jparams), (toks, img), (jlogits, jcache), (logits, cache) = \
        prefilled
    check_logits(logits, jlogits, precision)
    n_img = model.cfg.num_image_tokens
    assert cache["k"].shape[2] == n_img + toks.shape[1]
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == tuple(jcache[name].shape)
        np.testing.assert_allclose(to_np(cache[name]), to_np(jcache[name]), **tol(precision),
                                   err_msg=name)
        # the image's positions alone
        np.testing.assert_allclose(to_np(cache[name][:, :, :n_img]),
                                   to_np(jcache[name][:, :, :n_img]), **tol(precision))
    jbatch, batch = batches(toks, img)
    jat, _ = jmodel.prefill(jparams, jbatch, logit_index=4)
    at, _ = model.prefill(batch, logit_index=4)
    check_logits(at, jat, precision)
    short, _ = model.prefill(batches(toks[:, :5], img)[1])
    np.testing.assert_allclose(to_np(at), to_np(short), **tol(precision))


def pad_slots(cache: dict, max_seq: int, pad) -> dict:
    return {name: pad(t, max_seq - t.shape[2]) for name, t in cache.items()}


def test_teacher_forced_decode_matches_reference(prefilled):
    """4 slot-cache steps from the prefill's cache padded to 48 slots;
    ``lengths`` count the image's 8 positions."""
    precision, (model, jmodel, jparams), (toks, _), (_, jcache), (_, cache) = prefilled
    cfg = model.cfg
    jcache = pad_slots(jcache, MAX_SEQ, lambda a, n: jnp.pad(a, ((0, 0), (0, 0), (0, n),
                                                                  (0, 0), (0, 0))))
    cache = pad_slots(cache, MAX_SEQ, lambda t, n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n)))
    jdecode = jax.jit(jmodel.decode)
    feed = np.random.default_rng(5).integers(0, cfg.vocab_size, STEPS).astype(np.int32)
    context = cfg.num_image_tokens + toks.shape[1]
    for i, tok in enumerate(feed):
        length = np.asarray([context + i + 1], np.int32)
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray([tok]), jnp.asarray(length))
        logits, cache = model.decode(cache, torch.tensor([int(tok)]), torch.from_numpy(length))
        check_logits(logits, jlogits, precision)
    for name in ("k", "v"):
        np.testing.assert_allclose(to_np(cache[name]), to_np(jcache[name]), **tol(precision),
                                   err_msg=name)


def test_decode_paged_matches_reference(prefilled):
    """The prefill's cache (image and text) scattered into a pool of
    8-token pages through a permuted block table, then 4 teacher-forced
    ``decode_paged`` steps on both sides: logits and the pools."""
    precision, (model, jmodel, jparams), (toks, _), (_, jcache), (_, cache) = prefilled
    cfg = model.cfg
    L, KH, HD = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    context = cfg.num_image_tokens + toks.shape[1]
    P, N = MAX_SEQ // T, MAX_SEQ // T + 3
    table = np.random.default_rng(8).permutation(N)[:P].astype(np.int32)[None, :]
    pool = {}
    for name in ("k", "v"):
        pages = np.zeros((L, N, T, KH, HD), np.float32)
        flat = np.zeros((L, P * T, KH, HD), np.float32)
        flat[:, :context] = to_np(cache[name][:, 0])
        pages[:, table[0]] = flat.reshape(L, P, T, KH, HD)
        pool[name] = pages
    tdt, jdt = DTYPES[precision]
    jk, jv = (jnp.asarray(pool[n], jdt) for n in ("k", "v"))
    tk, tv = (torch.from_numpy(pool[n]).to(tdt) for n in ("k", "v"))
    feed = np.random.default_rng(6).integers(0, cfg.vocab_size, STEPS).astype(np.int32)
    for i, tok in enumerate(feed):
        lens = np.asarray([context + i + 1], np.int32)
        pos = lens - 1
        tp, to = table[np.arange(1), pos // T], pos % T
        jlogits, jk, jv = jmodel.decode_paged(
            jparams, jk, jv, jnp.asarray([tok]), jnp.asarray(lens), jnp.asarray(table),
            jnp.asarray(tp), jnp.asarray(to))
        logits = model.decode_paged(
            tk, tv, torch.tensor([int(tok)]), torch.from_numpy(lens), torch.from_numpy(table),
            torch.from_numpy(tp), torch.from_numpy(to))
        check_logits(logits, jlogits, precision)
    np.testing.assert_allclose(to_np(tk), to_np(jk), **tol(precision))
    np.testing.assert_allclose(to_np(tv), to_np(jv), **tol(precision))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_chunked_prefill_prepends_the_image_to_the_suffix(weights, precision):
    """Chunked prefill of a 7-token suffix (padded to 10) over a prefix of
    21 real positions padded to 32 with garbage, as the reference runs it:
    the image goes before the suffix too, at positions after the prefix;
    logits at the last real suffix token and the suffix's cache."""
    model, jmodel, jparams = pair(weights, precision)
    cfg = model.cfg
    tdt, jdt = DTYPES[precision]
    toks, img = inputs(3, cfg, n=20)
    n_img = cfg.num_image_tokens
    jbatch, batch = batches(toks[:, :13], img)
    _, jpre = jmodel.prefill(jparams, jbatch)
    p_real, p_pad = n_img + 13, 32
    rng = np.random.default_rng(4)
    prefix = {}
    for name in ("k", "v"):
        a = np.zeros(jpre[name].shape[:2] + (p_pad,) + jpre[name].shape[3:], np.float32)
        a[:, :, :p_real] = to_np(jpre[name])
        a[:, :, p_real:] = rng.standard_normal(a[:, :, p_real:].shape)     # masked
        prefix[name] = a
    suffix = np.concatenate([toks[:, 13:], np.zeros((1, 3), np.int32)], axis=1)
    kw = dict(logit_index=6, positions_offset=p_real, prefix_valid=p_real)
    jbatch, batch = batches(suffix, img)
    jlogits, jcache = jmodel.prefill(
        jparams, jbatch, prefix={n: jnp.asarray(a, jdt) for n, a in prefix.items()}, **kw)
    logits, cache = model.prefill(
        batch, prefix={n: torch.from_numpy(a).to(tdt) for n, a in prefix.items()}, **kw)
    check_logits(logits, jlogits, precision)
    for name in ("k", "v"):
        assert cache[name].shape[2] == n_img + suffix.shape[1]
        np.testing.assert_allclose(to_np(cache[name]), to_np(jcache[name]), **tol(precision),
                                   err_msg=name)


def test_decode_equals_prefill_of_the_longer_sequence(weights):
    """The port's own consistency, in f32: after a prefill of image and
    13 tokens, 5 greedy steps over slots give, at the last step, the
    logits of a prefill of the image and all 18 tokens."""
    model, _, _ = pair(weights, "f32")
    cfg = model.cfg
    toks, img = inputs(7, cfg)
    logits, cache = model.prefill(batches(toks, img)[1])
    cache = pad_slots(cache, MAX_SEQ, lambda t, n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n)))
    seq = toks[0].tolist()
    for _ in range(5):
        tok = int(torch.argmax(logits[0]))
        seq.append(tok)
        lengths = torch.tensor([cfg.num_image_tokens + len(seq)], dtype=torch.int32)
        logits = model.decode_into(cache, torch.tensor([tok]), lengths)
    want, _ = model.prefill(batches(np.asarray([seq], np.int32), img)[1])
    np.testing.assert_allclose(to_np(logits), to_np(want), **F32_TOL)


# ---------------------------------------------------------------- serving
def test_engines_admit_the_family_and_fail_alike_without_image_embeds(weights):
    """The reference's ``Engine`` admits ``vlm`` but never passes
    ``image_embeds``: its first prefill raises ``KeyError``. The port's
    does the same, at the same point."""
    cfg, jcfg, jmodel, jparams = weights
    kw = dict(page_tokens=8, n_device_pages=48, n_host_pages=32, max_slots=2, max_seq=128)
    prompt = np.random.default_rng(9).integers(2, cfg.vocab_size, 20).tolist()
    jengine = JaxEngine(jcfg, jparams, **kw)
    engine = Engine(cfg, load_jax_params(jax.tree.map(np.asarray, jparams), cfg),
                    device="cpu", **kw)
    with pytest.raises(KeyError, match="image_embeds"):
        jengine.submit(JaxRequest("a", prompt, max_new_tokens=4))
    with pytest.raises(KeyError, match="image_embeds"):
        engine.submit(EngineRequest("a", prompt, max_new_tokens=4))
