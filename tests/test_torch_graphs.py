"""The port's compile plane against the JAX reference, on the CPU.

* ``Engine.warmup_specs`` lists the reference's specs: the same names,
  kinds and buckets, and the same probe groups with the engine's id set
  aside.
* ``warmup`` writes only the scratch pages, on a bf16 and an int8 pool.
* A warmed ``Engine`` and a warmed ``SsmEngine`` still give the
  reference's tokens (the token checks of ``test_torch_engine.py`` and
  ``test_torch_ssm_engine.py``: equal, or in the reference's bf16 tie set).
* The SSM decode that updates a static state in place gives bitwise the
  state of the stacked form, and leaves the bundle it started from alone.

On the CPU a step graph runs its step eagerly, so these hold the step the
card captures; ``tests/test_torch_graphs_on_card.py`` holds replays
against eager steps on the card.
"""
from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import materialize as jax_materialize
from repro.serving import Engine as JaxEngine
from repro.serving import EngineRequest as JaxRequest
from repro.serving.ssm_engine import SsmEngine as JaxSsmEngine
from repro_torch.configs import get_config
from repro_torch.models import Model, materialize
from repro_torch.models.layers import apply_mamba_block
from repro_torch.serving import Engine, EngineRequest, SsmEngine
from test_torch_engine import ENGINE_KW
from test_torch_engine import check_tokens as check_engine_tokens
from test_torch_ssm_engine import check_tokens as check_ssm_tokens


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU: one intra-op thread per process keeps
    torch from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def qwen():
    cfg = get_config("qwen1.5-0.5b").reduced()
    jcfg = jax_get_config("qwen1.5-0.5b").reduced()
    jmodel = JaxModel(jcfg)
    jparams = jax_materialize(jmodel.describe(), seed=0)
    params = materialize(Model(cfg).describe(), seed=0)
    return cfg, params, jcfg, jmodel, jparams


@pytest.fixture(scope="module")
def mamba():
    cfg = get_config("mamba2-2.7b").reduced()
    jcfg = jax_get_config("mamba2-2.7b").reduced()
    return (cfg, materialize(Model(cfg).describe(), seed=0), jcfg,
            jax_materialize(JaxModel(jcfg).describe(), seed=0))


#: the knobs of tests/test_jitaudit.py's make_engine, and a second set with
#: other buckets and a chunk budget that is not a page multiple
SPEC_KNOBS = {
    "jitaudit": dict(page_tokens=16, n_device_pages=96, n_host_pages=64, max_slots=2,
                     max_seq=128),
    "odd buckets": dict(page_tokens=8, n_device_pages=48, n_host_pages=16, max_slots=3,
                        max_seq=100, table_bucket_pages=3, prefill_bucket_tokens=24,
                        prefill_chunk_tokens=50),
}


def spec_key(spec):
    return (spec.name, spec.kind, spec.bucket, re.sub(r"^engine\d+", "", spec.probe_group))


@pytest.mark.parametrize("knobs", sorted(SPEC_KNOBS))
@pytest.mark.parametrize("prefill_chunks", [False, True])
def test_warmup_specs_match_reference(qwen, knobs, prefill_chunks):
    cfg, params, jcfg, _, jparams = qwen
    kw = SPEC_KNOBS[knobs]
    specs = Engine(cfg, params, device="cpu", **kw).warmup_specs(prefill_chunks=prefill_chunks)
    jspecs = JaxEngine(jcfg, jparams, **kw).warmup_specs(prefill_chunks=prefill_chunks)
    assert [spec_key(s) for s in specs] == [spec_key(s) for s in jspecs]
    assert any(s.kind == "chunk_prefill" for s in specs) == prefill_chunks


def pool_bytes(pool) -> dict:
    out = {"k": pool.k.clone(), "v": pool.v.clone()}
    if pool.quantized_device:
        out.update(k_scale=pool.k_scale.clone(), v_scale=pool.v_scale.clone())
    return out


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_warmup_writes_only_scratch_pages(qwen, fmt):
    cfg, params = qwen[:2]
    eng = Engine(cfg, params, device="cpu", **dict(ENGINE_KW, device_format=fmt,
                                                   offload_format=fmt))
    rng = np.random.default_rng(3)
    for pid, n in (("a", 37), ("b", 21)):
        eng.submit(EngineRequest(pid, rng.integers(2, cfg.vocab_size, n).tolist(),
                                 max_new_tokens=4))
    eng.run_to_completion()
    before = pool_bytes(eng.pool)
    eng.warmup(prefill_chunks=True)
    after = pool_bytes(eng.pool)
    scratch = eng._scratch_pages
    keep = [p for p in range(eng.pool.k.shape[1]) if p not in scratch]
    assert eng.tree.stats()["device_pages"] > 0
    for name, t in before.items():
        assert torch.equal(t[:, keep], after[name][:, keep]), name
    # the dummy steps did write: token 0's KV at offset 0 of each scratch page
    assert not torch.equal(before["k"][:, scratch], after["k"][:, scratch])


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_warmed_engine_gives_reference_tokens(qwen, fmt):
    """The submit + chunked follow-up of ``test_torch_engine.py`` on a
    warmed engine: every decode step replays a bucket warmup captured."""
    cfg, params, jcfg, _, jparams = qwen
    kw = dict(ENGINE_KW, offload_format=fmt, device_format=fmt)
    eng = Engine(cfg, params, device="cpu", **kw)
    eng.warmup(prefill_chunks=True)
    buckets = eng.graphs.keys()
    jeng = JaxEngine(jcfg, jparams, **kw)
    rng = np.random.default_rng(0)
    ctx_a = rng.integers(2, cfg.vocab_size, 37).tolist()
    ctx_b = rng.integers(2, cfg.vocab_size, 20).tolist()
    for e, req in ((eng, EngineRequest), (jeng, JaxRequest)):
        e.submit(req("a", ctx_a, max_new_tokens=5))
        e.submit(req("b", ctx_b, max_new_tokens=3))
    done = {c.program_id: c for c in eng.run_to_completion()}
    jdone = {c.program_id: c for c in jeng.run_to_completion()}
    for pid, ctx in (("a", ctx_a), ("b", ctx_b)):
        assert len(done[pid].output_tokens) == len(jdone[pid].output_tokens)
        check_engine_tokens(ctx, done[pid].output_tokens, jdone[pid].output_tokens, qwen, fmt)
    follow = ctx_a + done["a"].output_tokens[:-1] + rng.integers(2, cfg.vocab_size, 27).tolist()
    job = eng.begin_submit(EngineRequest("a", follow, max_new_tokens=4))
    jjob = jeng.begin_submit(JaxRequest("a", follow, max_new_tokens=4))
    while not eng.prefill_step(job):
        assert not jeng.prefill_step(jjob)
    assert jeng.prefill_step(jjob)
    c, jc = eng.run_to_completion()[0], jeng.run_to_completion()[0]
    assert (c.cached_tokens, c.prefilled_tokens) == (jc.cached_tokens, jc.prefilled_tokens)
    check_engine_tokens(follow, c.output_tokens, jc.output_tokens, qwen, fmt)
    # the steps used the warm buckets only, one replay each
    assert eng.graphs.keys() == buckets
    assert eng.graphs.replays == len(buckets) + eng.steps


def test_warmed_ssm_engine_gives_reference_tokens(mamba):
    """The requests of ``test_torch_ssm_engine.py``'s reference check on a
    warmed engine: prefill, continuation after an offload, divergence."""
    cfg, params, jcfg, jparams = mamba
    eng = SsmEngine(cfg, params, device="cpu", n_device_states=3, n_host_states=6,
                    max_seq=256)
    eng.warmup()
    assert eng.graphs.keys() == ["decode"] and eng.graphs.replays == 0
    jeng = JaxSsmEngine(jcfg, jparams, n_device_states=3, n_host_states=6, max_seq=256)
    rng = np.random.default_rng(9)
    fed = 0

    def serve(toks, cached_before):
        nonlocal fed
        eng.submit(EngineRequest("p0", toks, max_new_tokens=3))
        jeng.submit(JaxRequest("p0", toks, max_new_tokens=3))
        c, jc = eng.step()[0], jeng.step()[0]
        fed += (len(toks) - cached_before if cached_before else 0) + 2
        return c, jc, toks

    outs = [serve(rng.integers(2, cfg.vocab_size, 23).tolist(), 0)]
    assert eng.offload_program("p0") == jeng.offload_program("p0") == 1
    _, jc, toks = outs[0]
    cont = toks + jc.output_tokens + rng.integers(2, cfg.vocab_size, 9).tolist()
    outs.append(serve(cont, len(toks) + 2))
    outs.append(serve([1] + cont[1:], 0))
    for c, jc, toks in outs:
        assert (c.cached_tokens, c.prefilled_tokens, c.reloaded_pages) == (
            jc.cached_tokens, jc.prefilled_tokens, jc.reloaded_pages)
        check_ssm_tokens(jeng, toks, c.output_tokens, jc.output_tokens)
    # every fed token was one replay of the one graph
    assert eng.graphs.keys() == ["decode"] and eng.graphs.replays == fed


def stacked_decode(model, cache, tokens):
    """``Model.decode`` as it stood before the in-place form: each layer's
    new state stacked into new tensors."""
    x = model.params.embed[tokens][:, None, :]
    sts, cvs = [], []
    for l, p in enumerate(model._layers):
        x, (st, cv) = apply_mamba_block(p, x, model.cfg,
                                        cache=(cache["ssm"][l], cache["conv"][l]))
        sts.append(st)
        cvs.append(cv)
    return model._logits(x[:, 0, :]), {"ssm": torch.stack(sts), "conv": torch.stack(cvs)}


@torch.no_grad()
def test_in_place_ssm_decode_is_bitwise_the_stacked_decode(mamba):
    cfg, params = mamba[:2]
    model = Model(cfg, params)
    toks = torch.from_numpy(np.random.default_rng(4).integers(2, cfg.vocab_size, (1, 19)))
    _, cache = model.prefill({"tokens": toks})
    start = {k: t.clone() for k, t in cache.items()}
    state = {k: t.clone() for k, t in cache.items()}
    ptrs = {k: t.data_ptr() for k, t in state.items()}
    for tok in (7, 300, 11):
        tok = torch.tensor([tok])
        want_logits, cache_next = stacked_decode(model, cache, tok)
        logits = model.decode_into(state, tok)
        dec_logits, dec_cache = model.decode(cache, tok, torch.tensor([0]))
        for got_logits, got in ((logits, state), (dec_logits, dec_cache)):
            assert torch.equal(got_logits, want_logits)
            for k in ("ssm", "conv"):
                assert got[k].dtype == cache_next[k].dtype
                assert torch.equal(got[k], cache_next[k]), k
        cache = cache_next
    # in place: the static state kept its storage; decode left its input alone
    assert {k: t.data_ptr() for k, t in state.items()} == ptrs
    _, first = model.decode(start, torch.tensor([7]), torch.tensor([0]))
    assert not torch.equal(first["ssm"], start["ssm"])
    assert torch.equal(start["ssm"], model.prefill({"tokens": toks})[1]["ssm"])


def test_ssm_continuation_leaves_the_old_bundle_alone(mamba):
    cfg, params = mamba[:2]
    eng = SsmEngine(cfg, params, device="cpu", n_device_states=2, n_host_states=2)
    eng.submit(EngineRequest("p", [5, 6, 7, 8], max_new_tokens=3))
    out = eng.step()[0].output_tokens
    old = eng.device_states["p"].cache
    kept = {k: t.clone() for k, t in old.items()}
    eng.submit(EngineRequest("p", [5, 6, 7, 8] + out + [9, 10], max_new_tokens=3))
    assert eng.step()[0].cached_tokens == 6
    new = eng.device_states["p"].cache
    for k in kept:
        assert torch.equal(old[k], kept[k]), k
        # the new bundle is a copy of the static state, not the state itself
        assert new[k].data_ptr() != eng._state[k].data_ptr()
        assert torch.equal(new[k], eng._state[k])
        assert not torch.equal(new[k], kept[k])
