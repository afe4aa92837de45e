"""gemma2's local/global alternation in the port against the JAX reference.

Reduced gemma2-9b (two (local, global) pairs, d_model 256, 4 heads over 2
KV heads of 64, a 64-token local window, attention softcap 50 and final
softcap 30). Weights are the reference's ``materialize(seed=0)`` carried
across with ``load_jax_params``, in bf16, or cast to f32 exactly on both
sides. What is held:

* the parameter and cache trees (names, shapes, dtypes) of gemma2-9b and
  gemma2-27b at full width and reduced;
* one (local, global) pair in sequence mode at S = 96, where the window
  binds;
* ``prefill`` logits and its local and global caches;
* teacher-forced ``decode`` over full-size local slots (the window binds)
  and over a 64-slot local ring (``ring_window``) at contexts 80-88 and
  60-68, one row crossing the ring's wrap; both sides start from one
  cache built from numpy;
* the port's ring decode against its full-cache decode, and decode
  against a prefill of the longer sequence;
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
from repro.models.layers import apply_dense_block as jax_block
from repro.models.params import is_leaf
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import Model, load_jax_params
from repro_torch.models.layers import apply_dense_block
from repro_torch.models.params import leaves
from repro_torch.serving import Engine


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU: one intra-op thread per process keeps
    torch from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "gemma2-9b"
ATOL, RTOL = 2**-4, 2**-6
F32_TOL = dict(rtol=1e-4, atol=1e-4)
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


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
@pytest.mark.parametrize("arch", ["gemma2-9b", "gemma2-27b"])
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_parameter_and_cache_trees_match_reference(arch, reduced):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    model, jmodel = Model(cfg), JaxModel(jcfg)
    assert leaf_specs(model.describe()) == jax_leaf_specs(jmodel.describe())
    for max_seq in (64, 4096):
        assert leaf_specs(model.describe_cache(2, max_seq)) == jax_leaf_specs(
            jmodel.describe_cache(2, max_seq))
    assert "blocks.local.attn.wq" in dict(leaves(model.describe()))


# ----------------------------------------------------------------- blocks
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_local_global_pair_in_sequence_mode_matches_reference(weights, precision):
    """Layer pair 0 at S = 96 > the 64-token window: the local block
    attends within the window, the global one over everything."""
    cfg, jcfg, _, _ = weights
    model, _, jparams = pair(weights, precision)
    tdt, jdt = DTYPES[precision]
    x = np.random.default_rng(2).standard_normal((2, 96, cfg.d_model), dtype=np.float32)
    pos = np.arange(96)[None, :]
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"])
    tp = model._layers[0]
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    for kind, window in (("local", cfg.sliding_window), ("global", None)):
        jx, (jk, jv), _ = jax_block(jp[kind], jx, jcfg, positions=jnp.asarray(pos),
                                    window=window)
        tx, (k, v) = apply_dense_block(tp[kind], tx, cfg, positions=torch.from_numpy(pos),
                                       window=window)
        np.testing.assert_allclose(to_np(tx), to_np(jx), **tol(precision))
        np.testing.assert_allclose(to_np(k), to_np(jk), **tol(precision))
        np.testing.assert_allclose(to_np(v), to_np(jv), **tol(precision))


# ---------------------------------------------------------------- prefill
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_prefill_logits_and_caches_match_reference(weights, precision):
    cfg = weights[0]
    model, jmodel, jparams = pair(weights, precision)
    toks = tokens(1, 90, cfg.vocab_size)
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks)})
    logits, cache = model.prefill({"tokens": torch.from_numpy(toks).long()})
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (1, cfg.vocab_size)
    check_logits(logits, jlogits, precision)
    assert set(cache) == {"local", "global"}
    for kind in ("local", "global"):
        for name in ("k", "v"):
            assert tuple(cache[kind][name].shape) == tuple(jcache[kind][name].shape)
            np.testing.assert_allclose(to_np(cache[kind][name]), to_np(jcache[kind][name]),
                                       **tol(precision))


def test_chunked_prefill_is_refused(weights):
    cfg = weights[0]
    model, _, _ = pair(weights, "bf16")
    toks = torch.from_numpy(tokens(2, 8, cfg.vocab_size)).long()
    _, cache = model.prefill({"tokens": toks})
    with pytest.raises(ValueError, match="no prefix"):
        model.prefill({"tokens": toks}, prefix=cache)


# ----------------------------------------------------------------- decode
def numpy_cache(cfg, seed: int, local_slots: int, global_slots: int) -> dict:
    """A decode cache {"local", "global"} of random slots, as numpy."""
    rng = np.random.default_rng(seed)
    half, KH, HD = cfg.num_layers // 2, cfg.num_kv_heads, cfg.head_dim
    return {kind: {name: rng.standard_normal((half, 2, slots, KH, HD), dtype=np.float32)
                   for name in ("k", "v")}
            for kind, slots in (("local", local_slots), ("global", global_slots))}


@pytest.mark.parametrize("local_slots,starts", [
    (96, (80, 60)),      # full-size local slots: the 64-token window binds
    (64, (80, 60)),      # a 64-slot ring; row 1 crosses its wrap at 64
], ids=["full-local-cache", "ring"])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_teacher_forced_decode_matches_reference(weights, precision, local_slots, starts):
    cfg = weights[0]
    model, jmodel, jparams = pair(weights, precision)
    tdt, jdt = DTYPES[precision]
    arrays = numpy_cache(cfg, 3, local_slots, 96)
    jcache = jax.tree.map(lambda a: jnp.asarray(a, jdt), arrays)
    cache = jax.tree.map(lambda a: torch.from_numpy(a).to(tdt), arrays)
    rng = np.random.default_rng(4)
    jdecode = jax.jit(jmodel.decode)
    for step in range(9):
        lens = np.asarray([s + step for s in starts], np.int32)
        toks = rng.integers(0, cfg.vocab_size, 2).astype(np.int32)
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(toks), jnp.asarray(lens))
        before = jax.tree.map(torch.clone, cache)
        logits, new = model.decode(cache, torch.from_numpy(toks).long(), torch.from_numpy(lens))
        # decode leaves its input cache, a nested tree, as it was
        assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(before),
                                                      jax.tree.leaves(cache)))
        cache = new
        check_logits(logits, jlogits, precision)
    for kind in ("local", "global"):
        for name in ("k", "v"):
            np.testing.assert_allclose(to_np(cache[kind][name]), to_np(jcache[kind][name]),
                                       **tol(precision))


def ring_from(full: torch.Tensor, length: int, slots: int) -> torch.Tensor:
    """A ring of ``slots`` slots holding the first ``length`` positions of a
    slot cache ``[..., S, KH, HD]``: position p in slot p % slots."""
    ring = torch.zeros(*full.shape[:2], slots, *full.shape[3:], dtype=full.dtype)
    for p in range(length):
        ring[:, :, p % slots] = full[:, :, p]
    return ring


def test_ring_decode_equals_full_cache_decode_and_prefill(weights):
    """From one 70-token prefill: 12 greedy steps over a 64-slot ring and
    over full-size local slots give the same logits and tokens, and the
    last step's logits equal a prefill of the 82-token sequence."""
    cfg = weights[0]
    model, _, _ = pair(weights, "f32")
    P, steps, S = 70, 12, 96
    toks = torch.from_numpy(tokens(5, P, cfg.vocab_size)).long()
    logits, pre = model.prefill({"tokens": toks})

    def padded(t):
        return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, S - P))

    full = {kind: {n: padded(t) for n, t in kv.items()} for kind, kv in pre.items()}
    ring = {"local": {n: ring_from(t, P, cfg.sliding_window) for n, t in pre["local"].items()},
            "global": {n: t.clone() for n, t in full["global"].items()}}
    seq = toks[0].tolist()
    tok = int(torch.argmax(logits[0]))
    for step in range(steps):
        seq.append(tok)
        lens = torch.tensor([P + step + 1], dtype=torch.int32)
        l_full = model.decode_into(full, torch.tensor([tok]), lens)
        l_ring = model.decode_into(ring, torch.tensor([tok]), lens)
        np.testing.assert_allclose(to_np(l_ring), to_np(l_full), **F32_TOL)
        assert int(torch.argmax(l_ring[0])) == int(torch.argmax(l_full[0]))
        tok = int(torch.argmax(l_ring[0]))
    want, _ = model.prefill({"tokens": torch.tensor([seq])})
    np.testing.assert_allclose(to_np(l_ring), to_np(want), **F32_TOL)


# ---------------------------------------------------------------- serving
def test_engine_and_launcher_refuse_the_alternating_family(weights):
    """The reference's ``Engine`` asserts dense-cache families without
    alternation; the port's raises, and so does its launcher, before it
    draws any weight."""
    cfg, _, _, jparams = weights
    params = load_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    with pytest.raises(ValueError, match="dense-cache families"):
        Engine(cfg, params, device="cpu")
    with pytest.raises(ValueError, match="dense-cache families"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
