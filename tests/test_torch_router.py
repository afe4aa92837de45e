"""The port's ``MoriRouter`` against the reference's on the same corpus.

Both routers drive engines with byte-equal weights through the same
traces: in the serialized synchronous mode (``sync_transfers=True,
serial_decode=True``), and through the clocked decode pump over two
replicas with async and with sync transfers, with chunked prefill, with
int8 offload and int8 device pages, and with an NVMe tier in place of
host DRAM. What the
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


#: replay modes: (serial decode, sync transfers, chunked prefill, offload
#: format, device format, NVMe tier). ``serial`` is the synchronous
#: single-replica compatibility mode; every other mode runs the decode pump
#: over two replicas.
MODES = {
    "serial": (True, True, False, "bf16", "bf16", False),
    "pump": (False, False, False, "bf16", "bf16", False),
    "pump-sync": (False, True, False, "bf16", "bf16", False),
    "chunked": (False, False, True, "bf16", "bf16", False),
    "offload-int8": (False, False, False, "int8", "bf16", False),
    "device-int8": (False, False, False, "int8", "int8", False),
    "nvme": (False, False, False, "bf16", "bf16", True),
}


def replay(port: bool, mode: str, weights):
    cfg, params, jcfg, jparams = weights
    serial, sync, chunked, offload_fmt, device_fmt, nvme = MODES[mode]
    kvb = kv_quant.token_wire_bytes(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, "bf16")
    # the GPU budget is priced at the device format's size
    kvb_dev = kv_quant.token_wire_bytes(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
                                        device_fmt)
    kw = dict(ENGINE_KW, offload_format=offload_fmt, device_format=device_fmt)
    if port:
        engines = [Engine(cfg, params, device="cpu", **kw)
                   for _ in range(1 if serial else 2)]
        router_cls, sched_cfg, cost = MoriRouter, SchedulerConfig, TransferCost
        traces = corpus(ProgramTrace, RequestRecord)
        to_json = action_to_json
    else:
        engines = [JaxEngine(jcfg, jparams, **kw) for _ in range(1 if serial else 2)]
        router_cls, sched_cfg, cost = JaxRouter, JaxSchedulerConfig, JaxTransferCost
        traces = corpus(JaxTrace, JaxRecord)
        to_json = jax_action_to_json
    tiers = {}
    if nvme:
        # no DRAM tier: the demoted program sinks to the SSD tier and
        # reloads over the NVMe channel
        tiers = dict(cpu_capacity_bytes=0, ssd_capacity_bytes=400 * kvb)
    router = router_cls(
        engines, scheduler="mori",
        # tight: p3's 30 s tool call gets it offloaded, and it reloads
        gpu_capacity_bytes=(200 if serial else 100) * kvb_dev,
        config=sched_cfg(tick_interval_s=1.0),
        sync_transfers=sync, serial_decode=serial, chunked_prefill=chunked,
        xfer_cost=None if serial else cost(pcie_bytes_per_s=64 * kvb / 12.0,
                                           ssd_bytes_per_s=32 * kvb / 12.0),
        **tiers,
    )
    router.sched = Driver(router.sched)
    m = router.replay(traces, vocab_size=cfg.vocab_size, max_new_tokens=4)
    metrics = dataclasses.asdict(m)
    metrics.pop("ttft_samples")                     # wall clock
    actions = [to_json(a) for a in router.sched.actions]
    lengths = {pid: len(toks) for pid, toks in router.output_log.items()}
    return metrics, actions, lengths, [e.steps for e in engines]


@pytest.mark.parametrize("mode", list(MODES))
def test_router_metrics_and_actions_match_reference(weights, mode):
    metrics, actions, lengths, steps = replay(True, mode, weights)
    jmetrics, jactions, jlengths, jsteps = replay(False, mode, weights)
    assert metrics == jmetrics
    assert actions == jactions
    assert lengths == jlengths and steps == jsteps
    assert metrics["steps_completed"] == 8
    moved = metrics["offloaded_pages"] + metrics["reloaded_pages"]
    if mode == "nvme":
        assert metrics["nvme_reloaded_pages"] > 0 and metrics["reloaded_pages"] == 0
    else:
        assert moved > 0
    if mode != "serial":
        assert metrics["multi_slot_steps"] > 0
    if mode == "chunked":
        assert metrics["prefill_chunks"] > 0
    if mode in ("offload-int8", "device-int8"):
        # offloaded pages are billed at the int8 wire size, scales included
        cfg = weights[0]
        page_int8 = kv_quant.page_wire_bytes(cfg.num_layers, ENGINE_KW["page_tokens"],
                                             cfg.num_kv_heads, cfg.head_dim, "int8")
        assert metrics["offload_bytes"] == metrics["offloaded_pages"] * page_int8
