"""The port's serving path on the ``moe`` family against the reference.

Reduced dbrx-132b and arctic-480b at the real ``capacity_factor`` 1.25
(set with ``dataclasses.replace`` on both sides), weights from the
reference's ``materialize(seed=0)``:

* ``Engine`` (warmed: its decode graphs, eager on the CPU) with monolithic
  and chunked prefill, and ``MoriRouter.replay`` in ``serial`` and
  ``pump`` mode: radix accounting, pool counters and every router metric
  equal with the weights in bf16 and in f32, and the reference's tokens
  in f32 (in bf16 a top-k near-tie may route a token to another expert:
  ``tests/test_torch_moe.py`` holds the model there);
* the serving launcher for ``--arch dbrx-132b --reduced --device cpu``.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.types import ProgramTrace as JaxTrace
from repro.core.types import RequestRecord as JaxRecord
from repro.core.types import SchedulerConfig as JaxSchedulerConfig
from repro.core.types import TransferCost as JaxTransferCost
from repro.models import Model as JaxModel
from repro.models import materialize as jax_materialize
from repro.serving import Engine as JaxEngine
from repro.serving import EngineRequest as JaxRequest
from repro.serving import MoriRouter as JaxRouter
from repro_torch.core.types import ProgramTrace, RequestRecord, SchedulerConfig, TransferCost
from repro_torch.kernels import kv_quant
from repro_torch.models import load_jax_params
from repro_torch.serving import Engine, EngineRequest, MoriRouter
from test_torch_engine import ENGINE_KW
from test_torch_moe import ARCHS, as_f32, configs
from test_torch_router import ENGINE_KW as ROUTER_ENGINE_KW
from test_torch_router import corpus

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU: one intra-op thread per process keeps
    torch from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def weights(arch: str, precision: str):
    """The reduced config at 1.25 and the reference's weights, carried
    across; in f32 both sides hold them as f32 (an exact cast)."""
    cfg, jcfg = configs(arch, 1.25)
    jparams = jax_materialize(JaxModel(jcfg).describe(), seed=0)
    params = load_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    if precision == "f32":
        params, jparams = as_f32(dict(params=params, jparams=jparams))
    return cfg, params, jcfg, jparams


# ----------------------------------------------------------------- engine
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_monolithic_and_chunked_prefill_match_reference(arch, precision):
    """Monolithic ``submit`` of two requests (each padded to the 16-token
    bucket, which sets the group and the capacity), then a follow-up over
    the cached prefix in page-aligned chunks, at 1.25, the port's engine
    warmed first. The radix accounting, the pool's counters and the steps
    always agree; in f32 so do the tokens (in bf16 a routing near-tie may
    pick another expert, see the bf16 model test, so tokens are held in
    f32)."""
    cfg, params, jcfg, jparams = weights(arch, precision)
    eng = Engine(cfg, params, device="cpu", **ENGINE_KW)
    eng.warmup()
    eng.graphs.replays = 0
    jeng = JaxEngine(jcfg, jparams, **ENGINE_KW)
    rng = np.random.default_rng(0)
    ctx_a = rng.integers(2, cfg.vocab_size, 37).tolist()
    ctx_b = rng.integers(2, cfg.vocab_size, 20).tolist()
    for e, req in ((eng, EngineRequest), (jeng, JaxRequest)):
        e.submit(req("a", ctx_a, max_new_tokens=5))
        e.submit(req("b", ctx_b, max_new_tokens=3))
    done = {c.program_id: c for c in eng.run_to_completion()}
    jdone = {c.program_id: c for c in jeng.run_to_completion()}
    for pid in ("a", "b"):
        c, jc = done[pid], jdone[pid]
        assert (c.cached_tokens, c.prefilled_tokens) == (jc.cached_tokens, jc.prefilled_tokens)
        assert len(c.output_tokens) == len(jc.output_tokens)
        if precision == "f32":
            assert c.output_tokens == jc.output_tokens

    # a follow-up of "a" over its cached prefix, prefilled in chunks; the
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
    if precision == "f32":
        assert c.output_tokens == jc.output_tokens
    assert eng.steps == jeng.steps
    assert eng.graphs.replays == eng.steps                 # every step went through a graph
    assert eng.pool.stats().__dict__ == jeng.pool.stats().__dict__


# ----------------------------------------------------------------- router
def replay(port: bool, mode: str, cfg, params, jcfg, jparams):
    kvb = kv_quant.token_wire_bytes(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, "bf16")
    pump = mode == "pump"
    if port:
        engines = [Engine(cfg, params, device="cpu", **ROUTER_ENGINE_KW)
                   for _ in range(2 if pump else 1)]
        router_cls, sched_cfg, cost = MoriRouter, SchedulerConfig, TransferCost
        traces = corpus(ProgramTrace, RequestRecord)
    else:
        engines = [JaxEngine(jcfg, jparams, **ROUTER_ENGINE_KW) for _ in range(2 if pump else 1)]
        router_cls, sched_cfg, cost = JaxRouter, JaxSchedulerConfig, JaxTransferCost
        traces = corpus(JaxTrace, JaxRecord)
    router = router_cls(
        engines, scheduler="mori",
        gpu_capacity_bytes=(100 if pump else 200) * kvb,
        config=sched_cfg(tick_interval_s=1.0),
        sync_transfers=not pump, serial_decode=not pump,
        xfer_cost=cost(pcie_bytes_per_s=64 * kvb / 12.0) if pump else None,
    )
    m = router.replay(traces, vocab_size=cfg.vocab_size, max_new_tokens=4)
    metrics = dataclasses.asdict(m)
    metrics.pop("ttft_samples")                     # wall clock
    return metrics, dict(router.output_log)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["serial", "pump"])
@pytest.mark.parametrize("arch", ARCHS)
def test_router_replay_matches_reference(arch, mode, precision):
    """The corpus of tests/test_torch_router.py at 1.25 through both
    routers: every ``RouterMetrics`` counter equal (the control plane does
    not read token values) and as many tokens per program; in f32 the
    tokens themselves are equal."""
    cfg, params, jcfg, jparams = weights(arch, precision)
    metrics, outputs = replay(True, mode, cfg, params, jcfg, jparams)
    jmetrics, joutputs = replay(False, mode, cfg, params, jcfg, jparams)
    assert metrics == jmetrics
    assert metrics["steps_completed"] == 8
    assert metrics["offloaded_pages"] + metrics["reloaded_pages"] > 0
    if mode == "pump":
        assert metrics["multi_slot_steps"] > 0
    assert {p: len(t) for p, t in outputs.items()} == {p: len(t) for p, t in joutputs.items()}
    if precision == "f32":
        assert outputs == joutputs


# ----------------------------------------------------------------- launch
def test_serve_launcher_serves_dbrx_on_cpu_reduced():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "dbrx-132b",
         "--device", "cpu", "--reduced", "--programs", "2"],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1"},
    )
    assert res.returncode == 0, res.stderr
    assert "serving 2 programs of dbrx-132b (4 layers, d_model 256)" in res.stdout
    steps = int(res.stdout.split("steps ")[1].split()[0])
    assert steps > 0
