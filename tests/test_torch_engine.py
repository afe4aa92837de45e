"""The port's ``Engine`` against the reference's on the same requests.

Both engines get byte-equal weights (``materialize(seed=0)``) and the same
requests: monolithic ``submit``, then a radix-hit follow-up through
``begin_submit`` + ``prefill_step`` in page-aligned chunks. The radix
accounting (cached/prefilled tokens) must be equal. On bf16 pools each
greedy token must equal the reference engine's or lie in the tie set of
the reference's logits at the same context: the tokens whose
bf16-rounded logit equals the bf16-rounded maximum. The port's own
logits at those contexts are held to the model band of
``test_torch_model.py``. On int8 pools the reference's logits include
its quantization, which the plain model does not show, so tokens must be
equal.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import materialize as jax_materialize
from repro.serving import Engine as JaxEngine
from repro.serving import EngineRequest as JaxRequest
from repro_torch.configs import get_config
from repro_torch.models import Model, materialize
from repro_torch.serving import Engine, EngineRequest
from repro_torch.serving.engine import greedy_token, resolve_device


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU: one intra-op thread per process keeps
    torch from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: the model band of tests/test_torch_model.py
ATOL, RTOL = 2**-4, 2**-6
ENGINE_KW = dict(page_tokens=8, n_device_pages=48, n_host_pages=32, max_slots=2,
                 max_seq=128, prefill_bucket_tokens=16, prefill_chunk_tokens=16)


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("qwen1.5-0.5b").reduced()
    jcfg = jax_get_config("qwen1.5-0.5b").reduced()
    jmodel = JaxModel(jcfg)
    jparams = jax_materialize(jmodel.describe(), seed=0)
    params = materialize(Model(cfg).describe(), seed=0)
    return cfg, params, jcfg, jmodel, jparams


def check_tokens(ctx, tokens, ref_tokens, setup, fmt):
    """Every token equals the reference's or, on bf16 pools, is in its tie
    set at the port's own context; the port's logits there are in the band."""
    if fmt == "int8":
        assert tokens == ref_tokens
        return
    cfg, params, _, jmodel, jparams = setup
    model = Model(cfg, params)
    cur = list(ctx)
    for tok, ref_tok in zip(tokens, ref_tokens):
        if tok != ref_tok:
            jlogits, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray([cur], jnp.int32)})
            rounded = np.asarray(jnp.asarray(jlogits[0], jnp.bfloat16).astype(jnp.float32))
            ties = set(np.flatnonzero(rounded == rounded.max()).tolist())
            assert tok in ties, (tok, ref_tok, sorted(ties))
            logits, _ = model.prefill({"tokens": torch.tensor([cur])})
            np.testing.assert_allclose(logits[0].numpy(), np.asarray(jlogits[0]),
                                       rtol=RTOL, atol=ATOL)
        cur.append(tok)


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_submit_then_chunked_follow_up_matches_reference(setup, fmt):
    cfg, params, jcfg, _, jparams = setup
    kw = dict(ENGINE_KW, offload_format=fmt, device_format=fmt)
    eng = Engine(cfg, params, device="cpu", **kw)
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
        c, jc = done[pid], jdone[pid]
        assert (c.cached_tokens, c.prefilled_tokens) == (jc.cached_tokens, jc.prefilled_tokens)
        assert len(c.output_tokens) == len(jc.output_tokens)
        check_tokens(ctx, c.output_tokens, jc.output_tokens, setup, fmt)

    # follow-up of "a" over its cached prefix, prefilled in chunks; the
    # reference gets the port's context so both extend the same tokens
    follow = ctx_a + done["a"].output_tokens[:-1] + rng.integers(2, cfg.vocab_size, 27).tolist()
    job = eng.begin_submit(EngineRequest("a", follow, max_new_tokens=4))
    jjob = jeng.begin_submit(JaxRequest("a", follow, max_new_tokens=4))
    assert (job.cached_tokens, len(job.suffix)) == (jjob.cached_tokens, len(jjob.suffix))
    assert job.cached_tokens > 0
    chunks = 0
    while not eng.prefill_step(job):
        chunks += 1
        assert not jeng.prefill_step(jjob)
    assert jeng.prefill_step(jjob) and chunks >= 1
    c = eng.run_to_completion()[0]
    jc = jeng.run_to_completion()[0]
    assert (c.cached_tokens, c.prefilled_tokens) == (jc.cached_tokens, jc.prefilled_tokens)
    check_tokens(follow, c.output_tokens, jc.output_tokens, setup, fmt)
    assert eng.steps == jeng.steps
    assert eng.pool.stats().__dict__ == jeng.pool.stats().__dict__


def test_offload_reload_and_abort_follow_the_reference(setup):
    cfg, params, jcfg, _, jparams = setup
    eng = Engine(cfg, params, device="cpu", **ENGINE_KW)
    jeng = JaxEngine(jcfg, jparams, **ENGINE_KW)
    ctx = np.random.default_rng(1).integers(2, cfg.vocab_size, 30).tolist()
    for e, req in ((eng, EngineRequest), (jeng, JaxRequest)):
        e.submit(req("p", ctx, max_new_tokens=2))
        e.run_to_completion()
        assert e.offload_program("p") == 3
        assert e.reload_program("p") == 3
        e.submit(req("q", ctx[:20], max_new_tokens=4))
        e.step()
        assert e.abort_request("q") is not None
    assert eng.pool.stats().__dict__ == jeng.pool.stats().__dict__
    assert eng.tree.stats() == jeng.tree.stats()
    assert eng.free_slot_count() == jeng.free_slot_count() == 2


def test_greedy_token_takes_the_first_of_a_bf16_tie():
    logits = torch.tensor([[0.1, 2.0001, 2.0, -1.0]])  # equal once rounded to bf16
    assert greedy_token(logits).tolist() == [1]
    logits = torch.tensor([[0.1, 2.0, 2.0001, -1.0]])
    assert greedy_token(logits).tolist() == [1]


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
