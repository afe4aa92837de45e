"""The port's simulator (``repro_torch.sim``) against the reference's.

``sim/`` is pure Python; the port keeps its own copy over its own
``core``. Each case replays one corpus of ``tests/test_sim.py`` or
``tests/test_ssd_tier.py`` through both simulators with plan recording on:
the ``SimResult`` dicts, the TTFT samples, the forward accounting and the
serialized action streams must be equal. Only the scheduler-tick timings
(``tick_avg_ms``, ``tick_p99_ms``) differ: they are wall clock.

The second half is ``tests/test_plan_protocol.py``'s cross-runtime gate on
the port: the port's simulator and the port's router replay the same
three programs and must emit byte-identical action streams, equal to the
reference simulator's.
"""
from __future__ import annotations

import json

import pytest
import torch

from repro.core import SchedulerConfig as JaxSchedulerConfig
from repro.core.actions import action_to_json as jax_action_to_json
from repro.core.types import ProgramTrace as JaxTrace
from repro.core.types import RequestRecord as JaxRecord
from repro.sim import CONFIGS as JAX_CONFIGS
from repro.sim import FaultPlan as JaxFaultPlan
from repro.sim import SimResult as JaxSimResult
from repro.sim import Simulation as JaxSimulation
from repro.sim import small_test_hw as jax_small_test_hw
from repro.traces import generate_corpus as jax_generate_corpus
from repro_torch.core import SchedulerConfig, Tier
from repro_torch.core.actions import Forward, action_to_json
from repro_torch.core.types import ProgramTrace, RequestRecord
from repro_torch.sim import CONFIGS, FaultPlan, HwConfig, SimResult, Simulation, small_test_hw
from repro_torch.traces import generate_corpus

#: wall-clock fields of SimResult
WALL_CLOCK = ("tick_avg_ms", "tick_p99_ms")

#: name -> (scheduler, corpus (n, seed), hw (config or small_test_hw
#: overrides), Simulation keywords): the runs of tests/test_sim.py and the
#: sim case of tests/test_ssd_tier.py
CASES = {
    "conservation": ("mori", (20, 1), {}, dict(concurrency_per_replica=10)),
    **{
        f"pressured-{s}": (s, (30, 2), {"hbm_bytes": 220_000_000},
                           dict(concurrency_per_replica=24, duration_s=400.0, cpu_ratio=1.0))
        for s in ("mori", "ta+o", "ta", "smg")
    },
    "no-pressure-ta+o": ("ta+o", (10, 3), {"hbm_bytes": 800_000_000},
                         dict(concurrency_per_replica=4)),
    "multi-replica": ("mori", (30, 4), {"hbm_bytes": 200_000_000},
                      dict(concurrency_per_replica=8, num_replicas=3, duration_s=400.0)),
    "failure-recovers": ("mori", (20, 5), {"hbm_bytes": 500_000_000},
                         dict(concurrency_per_replica=6, num_replicas=2, duration_s=400.0,
                              faults=[(1, 100.0, 150.0)])),
    "failure-permanent": ("mori", (20, 6), {},
                          dict(concurrency_per_replica=4, num_replicas=2, duration_s=300.0,
                               faults=[(0, 50.0, None)])),
    "straggler": ("mori", (30, 7), {},
                  dict(concurrency_per_replica=6, num_replicas=2, duration_s=300.0,
                       straggler=5.0)),
    **{
        f"ssd-tier-{name}-{ratio}": ("mori", (24, 0), name,
                                     dict(concurrency_per_replica=60, cpu_ratio=0.25,
                                          duration_s=420.0, warmup_s=60.0, ssd_ratio=ratio))
        for name in ("h200-80g-qwen2.5-7b", "h200-qwen3-30b-a3b") for ratio in (0.0, 4.0)
    },
}


def run_case(case: str, port: bool):
    sched, (n, seed), hw, kw = CASES[case]
    kw = dict(kw)
    mods = ((generate_corpus, small_test_hw, CONFIGS, FaultPlan, Simulation, SchedulerConfig,
             action_to_json) if port else
            (jax_generate_corpus, jax_small_test_hw, JAX_CONFIGS, JaxFaultPlan, JaxSimulation,
             JaxSchedulerConfig, jax_action_to_json))
    corpus_fn, small_hw, configs, fault_cls, sim_cls, sched_cfg, to_json = mods
    hw = configs[hw] if isinstance(hw, str) else small_hw(**hw)
    if "faults" in kw:
        kw["faults"] = [fault_cls(*f) for f in kw["faults"]]
    straggler = kw.pop("straggler", None)
    if straggler is not None:
        kw["sched_config"] = sched_cfg(straggler_penalty=straggler)
    kw.setdefault("warmup_s", 20.0)
    sim = sim_cls(sched, hw, corpus_fn(n, seed=seed), seed=0, record_plans=True, **kw)
    if straggler is not None:
        sim.sched.replicas[0].ewma_step_latency_s = 1.0     # replica 0 slow
        sim.sched.replicas[1].ewma_step_latency_s = 0.1
    result = sim.run().to_dict()
    for key in WALL_CLOCK:
        result.pop(key)
    return {
        "result": result,
        "ttfts": list(sim.ttfts),
        "forwards": (sim.warm_forwards, sim.reload_forwards, sim.recompute_forwards,
                     sim.forwards, sim.completed_steps),
        "busy": [rep.busy_accum for rep in sim.replicas],
        "actions": [to_json(a) for a in sim.action_log],
    }


@pytest.mark.parametrize("case", list(CASES))
def test_simulation_matches_reference(case):
    port, ref = run_case(case, True), run_case(case, False)
    assert port["actions"] and port["result"]["steps_completed"] > 0
    assert port == ref


def test_hardware_rows_are_the_reference_gpu_rows():
    """The port copies the GPU rows; the reference's TPU rows stay there."""
    assert set(CONFIGS) == {"h200-80g-qwen2.5-7b", "h200-qwen3-30b-a3b",
                            "b200-llama3.1-70b-tp2"}
    assert set(CONFIGS) < set(JAX_CONFIGS)
    for name, hw in CONFIGS.items():
        assert isinstance(hw, HwConfig)
        assert vars(hw) == vars(JAX_CONFIGS[name])
        assert hw.gpu_kv_bytes == JAX_CONFIGS[name].gpu_kv_bytes
        assert hw.with_cpu_ratio(0.5).cpu_kv_bytes == JAX_CONFIGS[name].with_cpu_ratio(
            0.5).cpu_kv_bytes
    assert vars(small_test_hw(hbm_bytes=5)) == vars(jax_small_test_hw(hbm_bytes=5))
    assert list(SimResult.__dataclass_fields__) == list(JaxSimResult.__dataclass_fields__)


# ------------------------------------------------ sim <-> router streams
def golden_traces(trace_cls, record_cls):
    """``tests/test_plan_protocol.py``'s three 2-step programs, tool
    windows far apart so both clocks order the events alike."""
    def tr(pid, ctx, tool):
        return trace_cls(pid, [
            record_cls(ctx, 4, tool, reasoning_wall_s=1.0),
            record_cls(ctx + 12, 4, 0.0, reasoning_wall_s=1.0),
        ])

    return [tr("p0", 48, 30.0), tr("p1", 56, 60.0), tr("p2", 64, 90.0)]


def sim_stream(port: bool, kv_bytes_per_token: int):
    sim_cls, small_hw, sched_cfg, to_json = (
        (Simulation, small_test_hw, SchedulerConfig, action_to_json) if port else
        (JaxSimulation, jax_small_test_hw, JaxSchedulerConfig, jax_action_to_json))
    traces = (golden_traces(ProgramTrace, RequestRecord) if port
              else golden_traces(JaxTrace, JaxRecord))
    hw = small_hw(kv_bytes_per_token=kv_bytes_per_token, hbm_bytes=1_000_000_000)
    sim = sim_cls("mori", hw, traces, num_replicas=1, concurrency_per_replica=3,
                  duration_s=200.0, warmup_s=0.0, seed=0, sched_config=sched_cfg(),
                  reuse_corpus=False, record_plans=True)
    sim.run()
    return [json.dumps(to_json(a), sort_keys=True) for a in sim.action_log], sim


def test_sim_and_router_emit_byte_identical_action_streams():
    from repro_torch.configs import get_config
    from repro_torch.models import Model, materialize
    from repro_torch.serving import Engine, MoriRouter

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = get_config("qwen1.5-0.5b").reduced()
        params = materialize(Model(cfg).describe(), seed=0)
        engine = Engine(cfg, params, device="cpu", page_tokens=8, n_device_pages=256,
                        n_host_pages=64, max_slots=4, max_seq=512)
        router = MoriRouter([engine], scheduler="mori", config=SchedulerConfig(),
                            record_plans=True, sync_transfers=True, serial_decode=True)
        router.replay(golden_traces(ProgramTrace, RequestRecord),
                      vocab_size=cfg.vocab_size, max_new_tokens=4)
    finally:
        torch.set_num_threads(n)
    router_stream = [json.dumps(action_to_json(a), sort_keys=True) for a in router.action_log]
    port_stream, sim = sim_stream(True, router.kv_bytes_per_token)
    ref_stream, _ = sim_stream(False, router.kv_bytes_per_token)
    assert port_stream == router_stream == ref_stream
    fwd = [a for a in sim.action_log if isinstance(a, Forward)]
    assert sorted(a.pid for a in fwd if a.recompute) == ["p0", "p1", "p2"]
    assert sorted(a.pid for a in fwd if a.source_tier is Tier.GPU) == ["p0", "p1", "p2"]


def finite_replay(port: bool):
    sim_cls, small_hw, trace_cls, record_cls = (
        (Simulation, small_test_hw, ProgramTrace, RequestRecord) if port else
        (JaxSimulation, jax_small_test_hw, JaxTrace, JaxRecord))
    traces = [trace_cls(f"q{i}", [record_cls(40 + 8 * i, 4, 2.0),
                                  record_cls(52 + 8 * i, 4, 0.0)]) for i in range(6)]
    sim = sim_cls("mori", small_hw(hbm_bytes=1_000_000_000), traces, num_replicas=1,
                  concurrency_per_replica=3, duration_s=400.0, warmup_s=0.0, seed=0,
                  reuse_corpus=False)
    result = sim.run().to_dict()
    for key in WALL_CLOCK:
        result.pop(key)
    return result, sorted(p["pid"] for p in sim.finished_programs)


def test_finite_replay_drains_a_corpus_larger_than_the_slots():
    """``tests/test_plan_protocol.py``'s finite replay: six traces on three
    slots each run once, as in the reference."""
    result, pids = finite_replay(True)
    assert (result["programs_finished"], result["steps_completed"]) == (6, 12)
    assert pids == [f"q{i}" for i in range(6)]
    assert (result, pids) == finite_replay(False)
