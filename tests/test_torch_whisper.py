"""whisper's encoder-decoder in the port against the JAX reference.

Reduced whisper-medium: 2 encoder and 2 decoder layers, d_model 256, 4
heads of 64, 24 encoder positions (``encoder_seq``; the full model has
1500). Weights are the reference's ``materialize(seed=0)`` carried across
with ``load_jax_params``, in bf16, or cast to f32 exactly on both sides;
``frames`` (the stub of the convolutional front end) and the tokens are
drawn with numpy from a seed. What is held:

* the parameter and cache trees (names, shapes, dtypes), the encoder's
  blocks and the decoder's ``lnx``/``cross`` leaves and the ``ck``/``cv``
  cross caches included, and ``load_jax_params`` carrying them;
* the encoder's output, ``prefill`` logits and every cache leaf;
* 4 teacher-forced ``decode`` steps from the prefill's caches, the
  self-attention slots padded to ``max_seq``, the cross caches read and
  never written;
* decode against a prefill of the longer sequence, at batch 2;
* the page size the card reads the cross cache in, and the slot cache
  seen as such pages.

The reference casts ``frames`` to bf16 before its encoder whatever the
weights' type, and its encoder ``lax.scan`` then refuses f32 weights (the
carry goes in bf16 and comes out f32, which jnp's ``bf16 @ f32`` promotion
makes). The f32 tests therefore hold the port against the reference's own
functions with the scans written out as loops (``reference_prefill``), and
a bf16 test holds that written-out version to the reference's ``prefill``.

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
from repro.models.layers import NULL_CTX
from repro.models.layers import apply_dense_block as jax_block
from repro.models.layers import rmsnorm as jax_rmsnorm
from repro.models.layers import softcap as jax_softcap
from repro.models.params import is_leaf
from repro_torch.configs import get_config
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.models import Model, load_jax_params
from repro_torch.models.layers import decode_attention, dividing_page_tokens, slot_pages
from repro_torch.models.params import flatten_tree, leaves
from repro_torch.serving import Engine


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU: one intra-op thread per process keeps
    torch from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "whisper-medium"
#: the reduced config with 2 decoder layers beside its 2 encoder layers
REDUCED = dict(num_layers=2)
ATOL, RTOL = 2**-4, 2**-6
F32_TOL = dict(rtol=1e-4, atol=1e-4)
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
CACHE_KEYS = ("k", "v", "ck", "cv")
PROMPT, MAX_SEQ, STEPS = 13, 32, 4


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
    cfg = get_config(ARCH).reduced(**REDUCED)
    jcfg = jax_get_config(ARCH).reduced(**REDUCED)
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


def inputs(seed: int, cfg, n: int = PROMPT, rows: int = 1):
    """``rows`` prompts of ``n`` tokens and their frames [rows, S_enc, d]."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (rows, n)).astype(np.int32)
    frames = rng.standard_normal((rows, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
    return toks, frames


def _layer(tree, l: int):
    return jax.tree.map(lambda a: a[l], tree)


def reference_encode(jmodel, jparams, frames):
    """The reference's ``_encode`` with its layer scan written out."""
    jcfg = jmodel.cfg
    pos = jnp.arange(frames.shape[1])[None, :]
    h = frames.astype(jnp.bfloat16)
    for l in range(jcfg.encoder_layers):
        h, _, _ = jax_block(_layer(jparams["enc_blocks"], l), h, jcfg, positions=pos,
                            causal=False)
    return jax_rmsnorm(h, jparams["enc_ln_f"])


def reference_prefill(jmodel, jparams, tokens, frames):
    """The reference's ``prefill`` of the encdec family with its scans
    written out as loops over its own ``apply_dense_block`` and
    ``_decoder_block``: ``(encoder output, logits, cache)``."""
    jcfg = jmodel.cfg
    enc = reference_encode(jmodel, jparams, frames)
    x = jnp.take(jparams["embed"], tokens, axis=0)
    positions = jnp.arange(x.shape[1])[None, :]
    cache = {name: [] for name in CACHE_KEYS}
    for l in range(jcfg.num_layers):
        x, kv, ckv, _ = jmodel._decoder_block(_layer(jparams["blocks"], l), x, enc, positions,
                                              NULL_CTX, cache=None)
        for name, t in zip(CACHE_KEYS, (*kv, *ckv)):
            cache[name].append(t)
    h = jax_rmsnorm(x[:, -1, :], jparams["ln_f"])
    logits = jax_softcap((h @ jparams["head"]).astype(jnp.float32), jcfg.final_logit_softcap)
    return enc, logits, {name: jnp.stack(ts) for name, ts in cache.items()}


# ------------------------------------------------------------------ trees
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_parameter_and_cache_trees_match_reference(reduced):
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    if reduced:
        cfg, jcfg = cfg.reduced(**REDUCED), jcfg.reduced(**REDUCED)
    model, jmodel = Model(cfg), JaxModel(jcfg)
    specs = leaf_specs(model.describe())
    assert specs == jax_leaf_specs(jmodel.describe())
    d, L, E = cfg.d_model, cfg.num_layers, cfg.encoder_layers
    assert specs["enc_blocks.attn.wq"][0] == (E, d, cfg.num_heads * cfg.head_dim)
    assert specs["blocks.cross.wk"][0] == (L, d, cfg.num_kv_heads * cfg.head_dim)
    assert specs["blocks.lnx"][0] == (L, d) and specs["enc_ln_f"][0] == (d,)
    cache = leaf_specs(model.describe_cache(2, 64))
    assert cache == jax_leaf_specs(jmodel.describe_cache(2, 64))
    assert sorted(cache) == sorted(CACHE_KEYS)
    assert cache["ck"][0] == (L, 2, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
    if not reduced:
        # a sequence's cross caches: 24 layers x K and V x 1500 x 16 x 64 x 2 B
        assert 2 * 2 * np.prod(cache["ck"][0]) // 2 == 147_456_000


def test_load_jax_params_carries_the_encoder_and_cross_leaves(weights):
    cfg, _, _, jparams = weights
    numpy_tree = jax.tree.map(np.asarray, jparams)
    params = load_jax_params(numpy_tree, cfg)
    want = dict(flatten_tree(numpy_tree))
    new = [n for n in want if n.startswith(("enc_", "blocks.cross.", "blocks.lnx"))]
    assert len(new) == len(list(leaves(Model(cfg).describe()["enc_blocks"]))) + 1 + 4 + 1
    for name, t in flatten_tree(params):
        assert t.dtype == torch.bfloat16, name
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(want[name]).view(np.int16), err_msg=name)
    del numpy_tree["enc_ln_f"]
    with pytest.raises(ValueError, match="enc_ln_f"):
        load_jax_params(numpy_tree, cfg)


def test_written_out_reference_is_the_reference_prefill(weights):
    """In bf16 the loops of ``reference_prefill`` give the reference's
    ``prefill`` (its scans keep f32 between fused ops: the model band);
    with f32 weights the reference's own encoder scan refuses to trace."""
    _, _, jmodel, jparams = weights
    toks, frames = inputs(1, jmodel.cfg)
    batch = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, batch)
    enc, logits, cache = reference_prefill(jmodel, jparams, batch["tokens"], batch["frames"])
    np.testing.assert_allclose(to_np(logits), to_np(jlogits), **tol("bf16"))
    for name in CACHE_KEYS:
        np.testing.assert_allclose(to_np(cache[name]), to_np(jcache[name]), **tol("bf16"))
    np.testing.assert_allclose(to_np(enc), to_np(jmodel._encode(jparams, batch["frames"],
                                                                NULL_CTX)), **tol("bf16"))
    f32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    with pytest.raises(TypeError, match="carry"):
        jmodel.prefill(f32, batch)


# ------------------------------------------------------------- encoder
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_encoder_output_matches_reference(weights, precision):
    """The encoder over 24 bidirectional positions, frames cast to bf16
    first on both sides."""
    model, jmodel, jparams = pair(weights, precision)
    _, frames = inputs(2, model.cfg, rows=2)
    want = reference_encode(jmodel, jparams, jnp.asarray(frames))
    got = model._encode(torch.from_numpy(frames))
    assert got.dtype == DTYPES[precision][0]
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(to_np(got), to_np(want), **tol(precision))


# ---------------------------------------------------------------- prefill
@pytest.fixture(scope="module", params=["f32", "bf16"])
def prefilled(request, weights):
    precision = request.param
    model, jmodel, jparams = pair(weights, precision)
    toks, frames = inputs(1, model.cfg)
    _, jlogits, jcache = reference_prefill(jmodel, jparams, jnp.asarray(toks),
                                           jnp.asarray(frames))
    logits, cache = model.prefill({"tokens": torch.from_numpy(toks).long(),
                                   "frames": torch.from_numpy(frames)})
    return precision, (model, jmodel, jparams), toks, (jlogits, jcache), (logits, cache)


def test_prefill_logits_and_caches_match_reference(prefilled):
    precision, (model, _, _), toks, (jlogits, jcache), (logits, cache) = prefilled
    check_logits(logits, jlogits, precision)
    assert set(cache) == set(CACHE_KEYS)
    assert cache["ck"].shape[2] == model.cfg.encoder_seq
    assert cache["k"].shape[2] == toks.shape[1]
    for name in CACHE_KEYS:
        assert tuple(cache[name].shape) == tuple(jcache[name].shape), name
        np.testing.assert_allclose(to_np(cache[name]), to_np(jcache[name]), **tol(precision),
                                   err_msg=name)


def pad_slots(cache: dict, max_seq: int, pad) -> dict:
    """The prefill's cache with the self-attention slots padded to
    ``max_seq`` (the cross caches stay as they are)."""
    return {name: pad(t, max_seq - t.shape[2]) if name in ("k", "v") else t
            for name, t in cache.items()}


def test_teacher_forced_decode_matches_reference(prefilled):
    """4 steps from the prefill's caches, self slots padded to 32; the
    cross caches come back as the very tensors given, unchanged."""
    precision, (model, jmodel, jparams), toks, (_, jcache), (_, cache) = prefilled
    cfg = model.cfg
    jcache = pad_slots(jcache, MAX_SEQ, lambda a, n: jnp.pad(a, ((0, 0), (0, 0), (0, n),
                                                                  (0, 0), (0, 0))))
    cache = pad_slots(cache, MAX_SEQ, lambda t, n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n)))
    cross = {name: (cache[name], cache[name].clone()) for name in ("ck", "cv")}
    jdecode = jax.jit(jmodel.decode)
    feed = np.random.default_rng(5).integers(0, cfg.vocab_size, STEPS).astype(np.int32)
    for i, tok in enumerate(feed):
        length = np.asarray([toks.shape[1] + i + 1], np.int32)
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray([tok]), jnp.asarray(length))
        logits, cache = model.decode(cache, torch.tensor([int(tok)]), torch.from_numpy(length))
        check_logits(logits, jlogits, precision)
    for name in CACHE_KEYS:
        np.testing.assert_allclose(to_np(cache[name]), to_np(jcache[name]), **tol(precision),
                                   err_msg=name)
    for name, (given, before) in cross.items():
        assert cache[name] is given and torch.equal(given, before), name


def test_decode_equals_prefill_of_the_longer_sequence(weights):
    """The port's own consistency, in f32 at batch 2: prompts of 13 and 7
    tokens over their own frames, prefilled one at a time into one slot
    cache, then 5 greedy steps; the last step gives each row's logits of
    a prefill of its prompt and fed tokens."""
    model, _, _ = pair(weights, "f32")
    cfg = model.cfg
    toks, frames = inputs(6, cfg, rows=2)
    prompts = [toks[0], toks[1, :7]]
    cache = {name: torch.zeros(t.shape, dtype=torch.float32)
             for name, t in leaves(model.describe_cache(2, MAX_SEQ))}
    first = []
    for b, prompt in enumerate(prompts):
        logits, pre = model.prefill({"tokens": torch.from_numpy(prompt[None]).long(),
                                     "frames": torch.from_numpy(frames[b:b + 1])})
        for name in CACHE_KEYS:
            cache[name][:, b, :pre[name].shape[2]] = pre[name][:, 0]
        first.append(int(torch.argmax(logits[0])))
    seqs = [list(p) for p in prompts]
    tok = torch.tensor(first)
    for _ in range(5):
        for b in range(2):
            seqs[b].append(int(tok[b]))
        lengths = torch.tensor([len(s) for s in seqs], dtype=torch.int32)
        logits = model.decode_into(cache, tok, lengths)
        tok = torch.argmax(logits, -1)
    for b in range(2):
        want, _ = model.prefill({"tokens": torch.tensor([seqs[b]]),
                                 "frames": torch.from_numpy(frames[b:b + 1])})
        np.testing.assert_allclose(to_np(logits[b]), to_np(want[0]), **F32_TOL)
    with pytest.raises(ValueError, match="no prefix"):
        model.prefill({"tokens": torch.from_numpy(toks[:1]).long(),
                       "frames": torch.from_numpy(frames[:1])},
                      prefix={"k": cache["k"][:, :1], "v": cache["v"][:, :1]})
    with pytest.raises(ValueError, match="frames"):
        model.prefill({"tokens": torch.from_numpy(toks[:1]).long()})


# -------------------------------------------------------------- the pages
@pytest.mark.parametrize("seq,want", [(1500, 30), (24, 24), (448, 32), (7, 7), (37, 1)])
def test_dividing_page_tokens(seq, want):
    """The largest divisor of the encoder length not above 32."""
    assert dividing_page_tokens(seq) == want
    assert seq % want == 0


@pytest.mark.parametrize("seq", [24, 1500])
def test_cross_cache_read_as_pages_is_the_slot_attention(seq):
    """A cross cache of ``seq`` positions (no whole number of 16-token
    pages) seen as pages of ``dividing_page_tokens(seq)`` without a copy:
    the paged kernel's plain version over that view equals the slot
    attention the reference runs, every position visible."""
    B, H, KH, D = 2, 4, 4, 64
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((B, H, D), dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, seq, KH, D), dtype=np.float32))
            for _ in range(2))
    T = dividing_page_tokens(seq)
    with pytest.raises(ValueError, match="whole number"):
        slot_pages(k, 16)
    (kp, table), (vp, _) = slot_pages(k, T), slot_pages(v, T)
    assert kp.data_ptr() == k.data_ptr() and tuple(kp.shape) == (B * seq // T, T, KH, D)
    assert table.tolist() == np.arange(B * seq // T).reshape(B, seq // T).tolist()
    lengths = torch.full((B,), seq, dtype=torch.int32)
    got = paged_attention_ref(q, kp, vp, table, lengths).reshape(B, H * D)
    want = decode_attention(q, k, v, lengths=lengths, page_tokens=T)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_engine_refuses_the_encdec_family(weights):
    """The paged ``Engine`` serves no encoder-decoder, as the reference's
    asserts; ``Model`` runs it."""
    cfg, _, _, jparams = weights
    params = load_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    with pytest.raises(ValueError, match="dense-cache families"):
        Engine(cfg, params, device="cpu")
