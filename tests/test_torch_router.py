"""The port's ``MoriRouter`` against the reference's on the same corpus.

Both routers drive engines with byte-equal weights through the same
traces, once in the serialized synchronous mode
(``sync_transfers=True, serial_decode=True``) and once through the
clocked decode pump with async transfers over two replicas. What the
control plane decides does not depend on the generated token values, so
the scheduler's action streams (collected with ``tests/_plan_driver.py``)
and every ``RouterMetrics`` counter must be equal — steps, tokens,
cached/prefilled tokens, offloaded/reloaded pages and bytes, gated
events, pump occupancy. Only the wall-clock TTFT samples differ.
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from _plan_driver import Driver
from repro.configs import get_config as jax_get_config
from repro.core.actions import action_to_json as jax_action_to_json
from repro.core.types import ProgramTrace as JaxTrace
from repro.core.types import RequestRecord as JaxRecord
from repro.core.types import SchedulerConfig as JaxSchedulerConfig
from repro.core.types import TransferCost as JaxTransferCost
from repro.models import Model as JaxModel
from repro.models import materialize as jax_materialize
from repro.serving import Engine as JaxEngine
from repro.serving import MoriRouter as JaxRouter
from repro_torch.configs import get_config
from repro_torch.core.actions import action_to_json
from repro_torch.core.types import ProgramTrace, RequestRecord, SchedulerConfig, TransferCost
from repro_torch.kernels import kv_quant
from repro_torch.models import Model, materialize
from repro_torch.serving import Engine, MoriRouter


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU: one intra-op thread per process keeps
    torch from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ENGINE_KW = dict(page_tokens=8, n_device_pages=96, n_host_pages=64, max_slots=3,
                 max_seq=192)


def corpus(trace_cls, record_cls):
    """Three busy programs whose windows align (so the pump batches them)
    and one whose long tool call gets it demoted and reloaded."""
    busy = [
        trace_cls(f"p{i}", [
            record_cls(40 + 4 * i, 4, 1.0, reasoning_wall_s=2.0),
            record_cls(52 + 4 * i, 4, 0.0, reasoning_wall_s=2.0),
        ])
        for i in range(3)
    ]
    idle = trace_cls("p3", [
        record_cls(56, 4, 30.0, reasoning_wall_s=2.0),
        record_cls(72, 4, 0.0, reasoning_wall_s=2.0),
    ])
    return busy + [idle]


@pytest.fixture(scope="module")
def weights():
    cfg = get_config("qwen1.5-0.5b").reduced()
    jcfg = jax_get_config("qwen1.5-0.5b").reduced()
    return (cfg, materialize(Model(cfg).describe(), seed=0),
            jcfg, jax_materialize(JaxModel(jcfg).describe(), seed=0))


def replay(port: bool, mode: str, weights):
    cfg, params, jcfg, jparams = weights
    kvb = kv_quant.token_wire_bytes(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, "bf16")
    pump = mode == "pump"
    if port:
        engines = [Engine(cfg, params, device="cpu", **ENGINE_KW)
                   for _ in range(2 if pump else 1)]
        router_cls, sched_cfg, cost = MoriRouter, SchedulerConfig, TransferCost
        traces = corpus(ProgramTrace, RequestRecord)
        to_json = action_to_json
    else:
        engines = [JaxEngine(jcfg, jparams, **ENGINE_KW) for _ in range(2 if pump else 1)]
        router_cls, sched_cfg, cost = JaxRouter, JaxSchedulerConfig, JaxTransferCost
        traces = corpus(JaxTrace, JaxRecord)
        to_json = jax_action_to_json
    router = router_cls(
        engines, scheduler="mori",
        # tight: p3's 30 s tool call gets it offloaded, and it reloads
        gpu_capacity_bytes=(100 if pump else 200) * kvb,
        config=sched_cfg(tick_interval_s=1.0),
        sync_transfers=not pump, serial_decode=not pump,
        xfer_cost=cost(pcie_bytes_per_s=64 * kvb / 12.0) if pump else None,
    )
    router.sched = Driver(router.sched)
    m = router.replay(traces, vocab_size=cfg.vocab_size, max_new_tokens=4)
    metrics = dataclasses.asdict(m)
    metrics.pop("ttft_samples")                     # wall clock
    actions = [to_json(a) for a in router.sched.actions]
    lengths = {pid: len(toks) for pid, toks in router.output_log.items()}
    return metrics, actions, lengths, [e.steps for e in engines]


@pytest.mark.parametrize("mode", ["serial", "pump"])
def test_router_metrics_and_actions_match_reference(weights, mode):
    metrics, actions, lengths, steps = replay(True, mode, weights)
    jmetrics, jactions, jlengths, jsteps = replay(False, mode, weights)
    assert metrics == jmetrics
    assert actions == jactions
    assert lengths == jlengths and steps == jsteps
    assert metrics["steps_completed"] == 8
    assert metrics["offloaded_pages"] + metrics["reloaded_pages"] > 0
    if mode == "pump":
        assert metrics["multi_slot_steps"] > 0
