"""The port's ``SsmEngine`` (MORI on attention-free state) against the JAX
reference.

The seven tests of ``tests/test_ssm_engine.py`` run against the port's
engine on the CPU: exact-continuation state reuse, bundle offload and
reload, typed eviction, and the full MORI router over the engine. Then the
two packages' engines, on byte-equal weights (``materialize(seed=0)``),
serve the same requests and the same replay: the radix-free accounting
(cached and prefilled tokens, steps, hit rate, evictions) must be equal.
A greedy token of a request must equal the reference's or lie in the tie
set of the reference's logits at that context (the tokens whose
bf16-rounded logit equals the bf16-rounded maximum), since the two
frameworks' bf16 arithmetic may break a near-tie differently; the
replays' token streams must be equal (none breaks a tie otherwise).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.scheduler import SchedulerConfig as JaxSchedulerConfig
from repro.models import Model as JaxModel
from repro.models import materialize as jax_materialize
from repro.serving import MoriRouter as JaxRouter
from repro.serving.engine import EngineRequest as JaxRequest
from repro.serving.ssm_engine import SsmEngine as JaxSsmEngine
from repro.traces import TraceGenConfig as JaxTraceGenConfig
from repro.traces import generate_corpus as jax_generate_corpus
from repro_torch.configs import get_config
from repro_torch.core.types import SchedulerConfig, TypeLabel
from repro_torch.models import Model, materialize
from repro_torch.serving import MoriRouter, SsmEngine
from repro_torch.serving.engine import EngineRequest
from repro_torch.traces import TraceGenConfig, generate_corpus


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU: one intra-op thread per process keeps
    torch from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("mamba2-2.7b").reduced()
    params = materialize(Model(cfg).describe(), seed=0)
    return cfg, params


def make_engine(cfg, params, **kw):
    kw.setdefault("n_device_states", 3)
    kw.setdefault("n_host_states", 6)
    kw.setdefault("max_seq", 256)
    return SsmEngine(cfg, params, device="cpu", **kw)


# ------------------------------------------- tests/test_ssm_engine.py, ported
def test_state_is_o1_and_bundle_bytes_constant(setup):
    cfg, params = setup
    eng = make_engine(cfg, params)
    assert eng.bundle_bytes > 0
    # bundle size is independent of max_seq — the SSM hallmark
    eng2 = SsmEngine(cfg, params, device="cpu", max_seq=4 * eng.max_seq)
    assert eng2.bundle_bytes == eng.bundle_bytes


def test_exact_continuation_reuses_state(setup):
    cfg, params = setup
    eng = make_engine(cfg, params)
    toks = [5, 6, 7, 8]
    eng.submit(EngineRequest("p0", toks, max_new_tokens=2))
    c1 = eng.step()[0]
    assert c1.cached_tokens == 0 and c1.prefilled_tokens == 4

    # continuation: old context + generated + tool-result tokens
    toks2 = toks + c1.output_tokens + [9, 10]
    eng.submit(EngineRequest("p0", toks2, max_new_tokens=2))
    c2 = eng.step()[0]
    # state summarizes everything except the final generated token
    assert c2.cached_tokens == len(toks) + len(c1.output_tokens) - 1
    assert c2.prefilled_tokens == 3          # final token + tool-result suffix


def test_continuation_matches_recompute(setup):
    """Resuming from saved state must produce the same tokens as
    recomputing the full context from scratch."""
    cfg, params = setup
    toks = [3, 4, 5, 6, 7]
    e1 = make_engine(cfg, params)
    e1.submit(EngineRequest("a", toks, max_new_tokens=2))
    first = e1.step()[0]
    full = toks + first.output_tokens + [11]
    e1.submit(EngineRequest("a", full, max_new_tokens=3))
    cont = e1.step()[0]
    assert cont.cached_tokens > 0

    e2 = make_engine(cfg, params)
    e2.submit(EngineRequest("b", full, max_new_tokens=3))
    scratch = e2.step()[0]
    assert scratch.cached_tokens == 0
    assert cont.output_tokens == scratch.output_tokens


def test_divergent_context_recomputes(setup):
    cfg, params = setup
    eng = make_engine(cfg, params)
    eng.submit(EngineRequest("p0", [1, 2, 3, 4], max_new_tokens=1))
    eng.step()
    eng.submit(EngineRequest("p0", [1, 2, 9, 9, 9], max_new_tokens=1))
    c = eng.step()[0]
    assert c.cached_tokens == 0              # lossy state: no partial reuse
    assert c.prefilled_tokens == 5


def test_offload_reload_roundtrip(setup):
    cfg, params = setup
    eng = make_engine(cfg, params)
    toks = [2, 3, 4]
    eng.submit(EngineRequest("p0", toks, max_new_tokens=1))
    out1 = eng.step()[0].output_tokens
    assert eng.offload_program("p0") == 1
    assert "p0" not in eng.device_states and "p0" in eng.host
    assert all(t.device.type == "cpu" for t in eng.host["p0"].cache.values())
    # continuation straight from host: reloads then reuses
    eng.submit(EngineRequest("p0", toks + out1 + [7], max_new_tokens=1))
    c = eng.step()[0]
    assert c.reloaded_pages == 1
    assert c.cached_tokens == len(toks) + len(out1) - 1


def test_typed_eviction_prefers_inactive_then_idle(setup):
    cfg, params = setup
    eng = make_engine(cfg, params, n_device_states=2)
    for i, label in enumerate([TypeLabel.BUSY, TypeLabel.IDLE,
                               TypeLabel.INACTIVE]):
        pid = f"p{i}"
        eng.submit(EngineRequest(pid, [i + 2, i + 3], max_new_tokens=1))
        eng.step()
        eng.set_label(pid, label)
    eng.submit(EngineRequest("p3", [9, 8], max_new_tokens=1))
    eng.step()
    # capacity 2: the INACTIVE and IDLE programs were pushed out first
    assert "p0" in eng.device_states
    assert "p2" not in eng.device_states     # inactive evicted first
    assert eng.evicted_pages["gpu"] >= 2


def test_router_drives_ssm_engine_end_to_end(setup):
    """The full MORI policy stack over the SSM engine, unchanged."""
    cfg, params = setup
    engines = [make_engine(cfg, params, n_device_states=3, n_host_states=8)]
    router = MoriRouter(
        engines,
        scheduler="mori",
        config=SchedulerConfig(tick_interval_s=2.0),
    )
    tg = TraceGenConfig(min_steps=3, mean_steps=4, max_steps=4,
                        initial_context_mean=120, max_context=240)
    corpus = generate_corpus(3, seed=0, cfg=tg)
    m = router.replay(corpus, vocab_size=cfg.vocab_size, max_new_tokens=2)
    assert m.steps_completed >= 9
    # continuation reuse gives a high hit rate without any radix tree
    assert m.cache_hit_rate > 0.4


# -------------------------------------------------- against the reference
@pytest.fixture(scope="module")
def jax_setup():
    jcfg = jax_get_config("mamba2-2.7b").reduced()
    jparams = jax_materialize(JaxModel(jcfg).describe(), seed=0)
    return jcfg, jparams


def tie_set(jax_engine, ctx: list[int]) -> set[int]:
    """Tokens whose bf16-rounded logit ties the bf16-rounded maximum of
    the reference's logits after ``ctx``."""
    logits, _ = jax_engine._prefill(jax_engine.params,
                                    {"tokens": jnp.asarray([ctx], jnp.int32)})
    lg = np.asarray(jnp.asarray(logits[0], jnp.bfloat16).astype(jnp.float32))
    return set(np.flatnonzero(lg == lg.max()).tolist())


def check_tokens(jax_engine, ctx, got, want):
    ctx = list(ctx)
    for g, w in zip(got, want, strict=True):
        if g != w:
            assert g in tie_set(jax_engine, ctx), (ctx, g, w)
        ctx.append(w)


def test_bundle_bytes_match_reference(setup, jax_setup):
    """The reference's count (every leaf at 2 bytes, though the ssm leaf is
    f32) is kept, so the router plans the same moves."""
    cfg, params = setup
    jcfg, jparams = jax_setup
    eng = make_engine(cfg, params)
    jeng = JaxSsmEngine(jcfg, jparams, n_device_states=3, n_host_states=6, max_seq=256)
    assert eng.bundle_bytes == jeng.bundle_bytes
    eng.submit(EngineRequest("p0", [2, 3, 4], max_new_tokens=1))
    real = sum(t.numel() * t.element_size() for t in eng.device_states["p0"].cache.values())
    assert eng.bundle_bytes < real


def test_engine_requests_match_reference(setup, jax_setup):
    """Prefill, continuation after an offload, divergence: same accounting,
    same tokens (or reference ties)."""
    cfg, params = setup
    jcfg, jparams = jax_setup
    eng = make_engine(cfg, params)
    jeng = JaxSsmEngine(jcfg, jparams, n_device_states=3, n_host_states=6, max_seq=256)
    rng = np.random.default_rng(9)

    def serve(toks):
        eng.submit(EngineRequest("p0", toks, max_new_tokens=3))
        jeng.submit(JaxRequest("p0", toks, max_new_tokens=3))
        return eng.step()[0], jeng.step()[0], toks

    outs = [serve(rng.integers(2, cfg.vocab_size, 23).tolist())]
    assert eng.offload_program("p0") == jeng.offload_program("p0") == 1
    _, jc, toks = outs[0]
    cont = toks + jc.output_tokens + rng.integers(2, cfg.vocab_size, 9).tolist()
    outs.append(serve(cont))
    outs.append(serve([1] + cont[1:]))            # diverges: recompute
    for c, jc, toks in outs:
        assert (c.cached_tokens, c.prefilled_tokens, c.reloaded_pages) == (
            jc.cached_tokens, jc.prefilled_tokens, jc.reloaded_pages)
        check_tokens(jeng, toks, c.output_tokens, jc.output_tokens)
    assert outs[1][0].reloaded_pages == 1 and outs[1][0].cached_tokens > 0
    assert outs[2][0].cached_tokens == 0


@pytest.mark.parametrize("n_device_states", [1, 3])
def test_router_replay_matches_reference(setup, jax_setup, n_device_states):
    """The MORI router over each package's engine, same corpus: equal
    steps, hit rate, token accounting and evictions; equal tokens or
    reference ties. With one device slot the bundles go to the host
    between a program's steps and come back."""
    cfg, params = setup
    jcfg, jparams = jax_setup
    tg = dict(min_steps=3, mean_steps=4, max_steps=4, initial_context_mean=120,
              max_context=240)
    eng = make_engine(cfg, params, n_device_states=n_device_states, n_host_states=8)
    router = MoriRouter([eng], scheduler="mori", config=SchedulerConfig(tick_interval_s=2.0))
    m = router.replay(generate_corpus(3, seed=0, cfg=TraceGenConfig(**tg)),
                      vocab_size=cfg.vocab_size, max_new_tokens=2)
    jeng = JaxSsmEngine(jcfg, jparams, n_device_states=n_device_states, n_host_states=8,
                        max_seq=256)
    jrouter = JaxRouter([jeng], scheduler="mori",
                        config=JaxSchedulerConfig(tick_interval_s=2.0))
    jm = jrouter.replay(jax_generate_corpus(3, seed=0, cfg=JaxTraceGenConfig(**tg)),
                        vocab_size=jcfg.vocab_size, max_new_tokens=2)
    for key in ("steps_completed", "tokens_generated", "cached_tokens", "prefilled_tokens",
                "cache_hit_rate", "offloaded_pages", "reloaded_pages"):
        assert getattr(m, key) == getattr(jm, key), key
    assert eng.evicted_pages == jeng.evicted_pages
    if n_device_states == 1:
        assert eng.evicted_pages["gpu"] > 0
    # the replay synthesizes its contexts from the outputs, so a near-tie
    # broken otherwise would change everything after it: none occurs on
    # these weights, and the token streams are equal
    assert router.output_log == jrouter.output_log


def test_entry_point_defaults_to_the_card(setup):
    """No device means the card: without one the engine raises rather
    than run on the CPU; and it serves only the ssm family."""
    cfg, params = setup
    with pytest.raises(ValueError, match="ssm"):
        SsmEngine(get_config("qwen1.5-0.5b").reduced(), params, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SsmEngine(cfg, params)
