"""The port's dense-slot decode path against the JAX reference.

``decode_attention`` is single-token attention over a slot cache
``[B, S, KH, D]``. On the CPU the port runs the reference's masked softmax
in plain PyTorch; on the card the same slots are read as pages by the
paged-attention kernel (:func:`repro_torch.models.layers.slot_pages`), so
the slot view through the paged kernel's plain version is held against it
too. ``Model.decode`` serves the dense and moe families over slot buffers,
and ``Engine(dense_slots=True)``, the reference's pre-block-table decode
path, must produce the token streams of the port's paged engine and of the
reference's dense-slot engine.

Bands: attention at the reference's kernel band (``tests/test_kernels.py``
``tol``); model logits in f32 to 1e-4, in bf16 to the model band
2**-4 + 2**-6·|x| (ROADMAP §3), with greedy tokens in the reference's tie
set. Decode is teacher-forced, so a near-tie never changes a context.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import materialize as jax_materialize
from repro.models.layers import decode_attention as jax_decode_attention
from repro.serving import Engine as JaxEngine
from repro.serving import EngineRequest as JaxRequest
from repro_torch.configs import get_config
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.models import Model, load_jax_params, materialize
from repro_torch.models.layers import decode_attention, slot_pages
from repro_torch.serving import Engine, EngineRequest, MoriRouter


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU: one intra-op thread per process keeps
    torch from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL, RTOL = 2**-4, 2**-6
KERNEL_TOL = {torch.bfloat16: dict(rtol=2e-2, atol=2e-2),
              torch.float32: dict(rtol=2e-3, atol=2e-3)}


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def tie_set(jlogits) -> set:
    """Tokens whose bf16-rounded logit equals the bf16-rounded maximum."""
    rounded = np.asarray(jnp.asarray(jlogits, jnp.bfloat16).astype(jnp.float32))
    return set(np.flatnonzero(rounded == rounded.max()).tolist())


# ------------------------------------------------------------- attention
ATTN_CASES = {
    # name: (H, KH, D, softcap, window)
    "gqa": (8, 2, 64, None, None),
    "softcap": (4, 4, 64, 30.0, None),
    "window": (8, 4, 128, None, 12),
}


def attn_inputs(case, dtype, seed=0):
    H, KH, D, cap, window = ATTN_CASES[case]
    B, S = 3, 48
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    k = rng.standard_normal((B, S, KH, D), dtype=np.float32)
    v = rng.standard_normal((B, S, KH, D), dtype=np.float32)
    lengths = np.asarray([48, 17, 1], np.int32)      # full, ragged, one token
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jargs = [jnp.asarray(a, jdt) for a in (q, k, v)]
    targs = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    return jargs, targs, lengths, dict(cap=cap, window=window)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_decode_attention_matches_reference(case, dtype):
    (jq, jk, jv), (q, k, v), lengths, kw = attn_inputs(case, dtype)
    want = jax_decode_attention(jq, jk, jv, lengths=jnp.asarray(lengths), **kw)
    got = decode_attention(q, k, v, lengths=torch.from_numpy(lengths), **kw)
    assert got.dtype == dtype and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(to_np(got), to_np(want), **KERNEL_TOL[dtype])


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_slot_view_through_the_paged_plain_version_matches(case):
    """What the card computes: the slot cache viewed (no copy) as pages of
    ``T`` tokens, row ``b`` reading pages ``b*S/T + arange(S/T)``, through
    the paged kernel's plain version."""
    _, (q, k, v), lengths, kw = attn_inputs(case, torch.bfloat16, seed=1)
    lens = torch.from_numpy(lengths)
    want = decode_attention(q, k, v, lengths=lens, **kw)
    for T in (8, 16):
        k_pages, table = slot_pages(k, T)
        v_pages, _ = slot_pages(v, T)
        assert k_pages.data_ptr() == k.data_ptr()      # a view, not a copy
        assert table.dtype == torch.int32 and tuple(table.shape) == (3, 48 // T)
        assert table[1].tolist() == list(range(48 // T, 2 * 48 // T))
        got = paged_attention_ref(q, k_pages, v_pages, table, lens,
                                  softcap=kw["cap"], window=kw["window"])
        np.testing.assert_allclose(to_np(got.reshape(3, -1)), to_np(want),
                                   **KERNEL_TOL[torch.bfloat16])


def test_slot_view_needs_whole_pages():
    with pytest.raises(ValueError, match="whole number"):
        slot_pages(torch.zeros(2, 40, 2, 64), 16)


# ----------------------------------------------------------------- model
def model_pair(arch, dtype):
    """The port's and the reference's model on byte-equal weights (cast to
    f32 exactly on both sides where ``dtype`` is f32). dbrx is held at its
    dropless capacity 8.0, as ``tests/test_torch_moe.py`` holds it in
    bf16."""
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    if jcfg.num_experts:
        jcfg = dataclasses.replace(jcfg, capacity_factor=8.0)
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    jmodel = JaxModel(jcfg)
    jparams = jax_materialize(jmodel.describe(), seed=0)
    params = load_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    if dtype == torch.float32:
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
        params = jax.tree.map(lambda t: t.float(), params)
    return cfg, Model(cfg, params), jmodel, jparams


@pytest.mark.parametrize("arch,dtype", [
    ("qwen1.5-0.5b", torch.float32), ("qwen1.5-0.5b", torch.bfloat16),
    ("dbrx-132b", torch.float32),
], ids=["qwen-f32", "qwen-bf16", "dbrx-f32"])
def test_model_decode_matches_reference(arch, dtype):
    """Teacher-forced slot-cache decode from the same random slot buffers:
    three rows at different lengths, the last a one-token row that stays
    put (a free slot's garbage write at position 0)."""
    cfg, model, jmodel, jparams = model_pair(arch, dtype)
    L, KH, HD, S = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, 64
    assert {k: l.shape for k, l in model.describe_cache(3, S).items()} == {
        k: l.shape for k, l in jmodel.describe_cache(3, S).items()}
    rng = np.random.default_rng(3)
    k0 = rng.standard_normal((L, 3, S, KH, HD), dtype=np.float32)
    v0 = rng.standard_normal((L, 3, S, KH, HD), dtype=np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jcache = {"k": jnp.asarray(k0, jdt), "v": jnp.asarray(v0, jdt)}
    cache = {"k": torch.from_numpy(k0).to(dtype), "v": torch.from_numpy(v0).to(dtype)}
    for step in range(4):
        lens = np.asarray([21 + step, 9 + step, 1], np.int32)
        toks = rng.integers(0, cfg.vocab_size, 3).astype(np.int32)
        jlogits, jcache = jmodel.decode(jparams, jcache, jnp.asarray(toks), jnp.asarray(lens))
        old, before = cache, {k: t.clone() for k, t in cache.items()}
        logits, cache = model.decode(cache, torch.from_numpy(toks).long(),
                                     torch.from_numpy(lens))
        # decode leaves its input cache as it was
        assert all(torch.equal(before[k], old[k]) for k in ("k", "v"))
        assert logits.dtype == torch.float32 and tuple(logits.shape) == (3, cfg.vocab_size)
        if dtype == torch.float32:
            np.testing.assert_allclose(to_np(logits), to_np(jlogits), rtol=1e-4, atol=1e-4)
            assert torch.argmax(logits, -1).tolist() == np.asarray(
                jnp.argmax(jlogits, -1)).tolist()
        else:
            np.testing.assert_allclose(to_np(logits), to_np(jlogits), rtol=RTOL, atol=ATOL)
            for b in range(3):
                assert int(torch.argmax(logits[b])) in tie_set(jlogits[b]), (step, b)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(to_np(cache["k"]), to_np(jcache["k"]), **tol)
    np.testing.assert_allclose(to_np(cache["v"]), to_np(jcache["v"]), **tol)


def test_decode_into_updates_the_slots_in_place():
    cfg = get_config("qwen1.5-0.5b").reduced()
    model = Model(cfg, materialize(Model(cfg).describe(), seed=0))
    rng = np.random.default_rng(4)
    shape = (cfg.num_layers, 2, 32, cfg.num_kv_heads, cfg.head_dim)
    cache = {k: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16()
             for k in ("k", "v")}
    toks, lens = torch.tensor([5, 9]), torch.tensor([7, 3], dtype=torch.int32)
    want, new = model.decode(cache, toks, lens)
    ptr = cache["k"].data_ptr()
    got = model.decode_into(cache, toks, lens)
    assert cache["k"].data_ptr() == ptr
    assert torch.equal(got, want)
    assert torch.equal(cache["k"], new["k"]) and torch.equal(cache["v"], new["v"])


# ---------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def weights():
    cfg = get_config("qwen1.5-0.5b").reduced()
    jcfg = jax_get_config("qwen1.5-0.5b").reduced()
    return (cfg, materialize(Model(cfg).describe(), seed=0),
            jcfg, jax_materialize(JaxModel(jcfg).describe(), seed=0))


ENGINE_KW = dict(page_tokens=8, n_device_pages=64, n_host_pages=64, max_slots=2, max_seq=256)


def replay_rounds(eng, request_cls, *, rounds=3, new_tokens=4, n_programs=2, seed=7):
    """``tests/test_paged_decode.py``'s agentic multi-round replay: each
    round extends every program's context with its previous outputs plus
    a few tool tokens, so later rounds hit the radix cache and decode
    crosses page boundaries."""
    rng = np.random.default_rng(seed)
    ctxs = {f"p{i}": [int(t) for t in rng.integers(2, 500, size=37 + 5 * i)]
            for i in range(n_programs)}
    streams: dict[str, list[int]] = {pid: [] for pid in ctxs}
    for _ in range(rounds):
        for pid in ctxs:
            eng.submit(request_cls(pid, list(ctxs[pid]), max_new_tokens=new_tokens))
            comp = eng.run_to_completion()[0]
            streams[pid].extend(int(t) for t in comp.output_tokens)
            ctxs[pid].extend(int(t) for t in comp.output_tokens[:-1])
            ctxs[pid].extend(int(t) for t in rng.integers(2, 500, size=3))
    return streams


def test_engine_replay_matches_paged_and_reference_dense_slots(weights):
    cfg, params, jcfg, jparams = weights
    paged = Engine(cfg, params, device="cpu", **ENGINE_KW)
    dense = Engine(cfg, params, device="cpu", dense_slots=True, **ENGINE_KW)
    jdense = JaxEngine(jcfg, jparams, dense_slots=True, **ENGINE_KW)
    assert dense.dense_slots and not paged.dense_slots
    assert dense.decode_reserve_pages == 0 == jdense.decode_reserve_pages
    s_dense = replay_rounds(dense, EngineRequest)
    assert s_dense == replay_rounds(paged, EngineRequest)
    assert s_dense == replay_rounds(jdense, JaxRequest)
    assert dense.steps == paged.steps == jdense.steps
    # later rounds were served from the radix cache the dense path fills
    assert dense.tree.stats() == jdense.tree.stats()
    assert dense.pool.device_free_count() == jdense.pool.device_free_count()


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_router_replay_matches_paged_and_reference(weights, precision):
    """The same corpus through MoriRouter on dense-slot engines, paged
    engines and the reference's dense-slot engines: every router metric
    equal and, with the weights in f32, equal output streams. In bf16 the
    three attention routes round differently, and this corpus holds a
    context whose top-2 logits are one bf16 ulp apart (the reference's own
    dense and paged engines part there too), so tokens are held in f32."""
    import dataclasses as dc

    from repro.serving import MoriRouter as JaxRouter
    from repro.traces import TraceGenConfig as JaxTG
    from repro.traces import generate_corpus as jax_corpus
    from repro_torch.traces import TraceGenConfig, generate_corpus

    cfg, _, jcfg, jparams = weights
    params = load_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    if precision == "f32":
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
        params = jax.tree.map(lambda t: t.float(), params)
    kw = dict(ENGINE_KW, n_device_pages=96, n_host_pages=96, max_seq=384)
    tg = dict(min_steps=3, mean_steps=4, max_steps=4, initial_context_mean=500,
              max_context=1600)
    runs = {}
    for name in ("dense", "paged", "reference"):
        if name == "reference":
            engines = [JaxEngine(jcfg, jparams, dense_slots=True, **kw) for _ in range(2)]
            router = JaxRouter(engines, scheduler="mori")
            corpus = jax_corpus(3, seed=1, cfg=JaxTG(**tg))
        else:
            engines = [Engine(cfg, params, device="cpu", dense_slots=name == "dense", **kw)
                       for _ in range(2)]
            router = MoriRouter(engines, scheduler="mori")
            corpus = generate_corpus(3, seed=1, cfg=TraceGenConfig(**tg))
        m = dc.asdict(router.replay(corpus, vocab_size=cfg.vocab_size, max_new_tokens=4,
                                    seed=1))
        m.pop("ttft_samples")                           # wall clock
        assert m["steps_completed"] >= 9
        runs[name] = (m, sum(e.steps for e in engines),
                      router.sched.replicas[0].capacity.gpu_kv_bytes,
                      {p: [int(t) for t in s] for p, s in router.output_log.items()})
    assert runs["dense"][:3] == runs["paged"][:3] == runs["reference"][:3]
    if precision == "f32":
        assert runs["dense"][3] == runs["paged"][3] == runs["reference"][3]


def test_dense_slots_graph_plane(weights):
    """One decode spec and one graph, named as the reference names its
    jit; warmup captures it and a replay captures nothing more."""
    cfg, params, _, _ = weights
    eng = Engine(cfg, params, device="cpu", dense_slots=True, **ENGINE_KW)
    specs = eng.warmup_specs(prefill_chunks=True)
    assert [(s.name, s.kind, s.bucket) for s in specs] == [
        ("decode_fn", "dense", {"max_slots": 2, "max_seq": 256})]
    assert list(eng.graph_functions()) == [f"engine{eng._audit_id}.decode_graphs"]
    eng.warmup()
    assert eng.graphs.keys() == ["dense"]
    eng.submit(EngineRequest("p", list(range(2, 30)), max_new_tokens=5))
    eng.run_to_completion()
    assert eng.graphs.cache_size() == 1 and eng.graphs.replays == 1 + eng.steps


def test_dense_slots_refusals(weights):
    cfg, params, _, _ = weights
    with pytest.raises(ValueError, match="multiple of page_tokens"):
        Engine(cfg, params, device="cpu", dense_slots=True,
               **dict(ENGINE_KW, max_seq=250))
    with pytest.raises(ValueError, match="int8"):
        Engine(cfg, params, device="cpu", dense_slots=True, device_format="int8",
               **ENGINE_KW)
    eng = Engine(cfg, params, device="cpu", dense_slots=True, **ENGINE_KW)
    with pytest.raises(RuntimeError, match="paged engine"):
        eng.begin_submit(EngineRequest("p", list(range(2, 30))))
    with pytest.raises(ValueError, match="paged engines"):
        MoriRouter([eng], scheduler="mori", chunked_prefill=True)
