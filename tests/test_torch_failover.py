"""Multi-replica scale-out on the port: endpoint-addressed copies, live
cross-replica KV migration, and drain/failover through the port's router,
mirroring ``tests/test_failover.py`` and held against the reference.

* the endpoint-addressed transfer API lowers every copy-bearing action as
  the reference's does;
* ``_MigrateStream`` lands a byte-identical host chain on commit and
  rolls every import back on abort;
* pressure migration, drain migration on ``mark_failed``, a migrate
  cancelled mid-stream, and ``mark_failed`` aborting an in-flight offload;
* a replay with a replica failing mid-decode loses zero tokens, and on the
  same corpus and faults the port's ``RouterMetrics`` and action log equal
  the reference's.

The tests run with the page-lifetime sanitizer armed (``REPRO_KVSAN=1``):
a page alloc/free or ledger record out of place raises.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.actions import Forward as JaxForward
from repro.core.actions import Migrate as JaxMigrate
from repro.core.actions import Offload as JaxOffload
from repro.core.transfers import copy_request_for as jax_copy_request_for
from repro.core.types import Tier as JaxTier
from repro_torch.core.actions import Forward, Migrate, Offload, SetLabel, action_to_json
from repro_torch.core.ledger import Channel
from repro_torch.core.transfers import CopyRequest, Endpoint, copy_request_for
from repro_torch.core.types import Tier, TierCapacity


@pytest.fixture(autouse=True)
def _kvsan(monkeypatch):
    monkeypatch.setenv("REPRO_KVSAN", "1")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU: one intra-op thread per process keeps
    torch from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------- endpoint-addressed API
COPY_ACTIONS = {
    "offload": lambda m, T: m.Offload(pid="p", action_id=7, replica=1, nbytes=4096,
                                      src_tier=T.GPU, dst_tier=T.CPU),
    "reload-ssd": lambda m, T: m.Forward(pid="p", action_id=3, replica=0,
                                         source_tier=T.SSD, nbytes=100),
    "migrate": lambda m, T: m.Migrate(pid="p", action_id=9, src_replica=2, dst_replica=0,
                                      nbytes=512),
}


class _Mods:
    def __init__(self, **kw):
        self.__dict__.update(kw)


PORT = _Mods(Offload=Offload, Forward=Forward, Migrate=Migrate)
REF = _Mods(Offload=JaxOffload, Forward=JaxForward, Migrate=JaxMigrate)


def _lowered(creq) -> tuple:
    return (creq.src.replica, creq.src.tier.value, creq.dst.replica, creq.dst.tier.value,
            creq.pid, creq.nbytes, creq.action_id, creq.cross_replica, creq.kind,
            creq.channel.value, creq.exec_replica)


@pytest.mark.parametrize("action", list(COPY_ACTIONS))
def test_copy_request_lowering_matches_reference(action):
    creq = copy_request_for(COPY_ACTIONS[action](PORT, Tier))
    assert _lowered(creq) == _lowered(jax_copy_request_for(COPY_ACTIONS[action](REF, JaxTier)))
    if action == "offload":
        assert creq == CopyRequest(src=Endpoint(1, Tier.GPU), dst=Endpoint(1, Tier.CPU),
                                   pid="p", nbytes=4096, action_id=7)
        assert creq.channel is Channel.PCIE and not creq.cross_replica
    elif action == "reload-ssd":
        # billing follows the read side: SSD-sourced reloads are NVMe
        assert creq.kind == "reload" and creq.channel is Channel.NVME
    else:
        # the copy executes where it lands
        assert creq.cross_replica and creq.exec_replica == 0
        job = creq.job()
        assert (job.nbytes, job.pid, job.replica) == (512, "p", 0)


def test_non_copy_actions_are_rejected():
    with pytest.raises(TypeError, match="no bytes to copy"):
        copy_request_for(SetLabel(pid="p", action_id=1, replica=None))


# ----------------------------------------------------------- real engines
@pytest.fixture(scope="module")
def setup():
    from repro_torch.configs import get_config
    from repro_torch.models import Model, materialize

    cfg = get_config("qwen1.5-0.5b").reduced()
    return cfg, materialize(Model(cfg).describe(), seed=0)


def _engine(cfg, params, **kw):
    from repro_torch.serving import Engine

    kw = dict(dict(page_tokens=8, n_device_pages=64, n_host_pages=64, max_slots=2,
                   max_seq=256), **kw)
    return Engine(cfg, params, device="cpu", **kw)


def _offloaded_program(engine, pid: str, n_tokens: int = 64, *, offload: bool = True):
    """Run one request to completion (and, by default, push its KV to the
    host tier engine-side); returns the raw host bits per chain node."""
    from repro_torch.serving import EngineRequest

    rng = np.random.default_rng(sum(map(ord, pid)))
    tokens = [int(t) for t in rng.integers(2, engine.cfg.vocab_size, size=n_tokens)]
    engine.submit(EngineRequest(program_id=pid, tokens=tokens, max_new_tokens=4))
    engine.run_to_completion()
    if offload:
        assert engine.offload_program(pid) > 0
    return {
        node.tokens: (engine.pool.host_k[:, node.host_page].clone(),
                      engine.pool.host_v[:, node.host_page].clone())
        for node in engine.tree.program_nodes(pid) if node.host_page is not None
    }


@pytest.mark.parametrize("offload_format", ["bf16", "int8"])
def test_migrate_stream_commit_lands_byte_identical_host_chain(setup, offload_format):
    from repro_torch.serving.transfer_plane import _MigrateStream

    cfg, params = setup
    src, dst = (_engine(cfg, params, offload_format=offload_format) for _ in range(2))
    src_bits = _offloaded_program(src, "p")
    stream = _MigrateStream(src, dst, "p")
    assert stream.n_units > 0
    for _ in range(stream.n_units):
        stream.copy_unit()
    landed = stream.commit()
    assert landed == len(src_bits)
    dst_nodes = dst.tree.program_nodes("p")
    assert len(dst_nodes) == landed
    for node in dst_nodes:
        k, v = src_bits[node.tokens]
        assert torch.equal(dst.pool.host_k[:, node.host_page], k)
        assert torch.equal(dst.pool.host_v[:, node.host_page], v)
    # move semantics: the source copies are retired and the source tree
    # forgot the program; the landed chain reloads on the destination
    assert src.tree.program_nodes("p") == []
    assert src.pool.host_free_count() == src.pool.n_host_pages
    assert dst.reload_program("p") == landed


def test_migrate_stream_abort_rolls_back_imports(setup):
    from repro_torch.serving.transfer_plane import _MigrateStream

    cfg, params = setup
    src, dst = _engine(cfg, params), _engine(cfg, params)
    src_bits = _offloaded_program(src, "p")
    dst_free = dst.pool.host_free_count()
    stream = _MigrateStream(src, dst, "p")
    stream.copy_unit()
    stream.copy_unit()
    assert stream.abort() == 2
    assert dst.pool.host_free_count() == dst_free
    assert dst.tree.program_nodes("p") == []
    src_nodes = src.tree.program_nodes("p")
    assert len(src_nodes) == len(src_bits)
    assert all(n.host_page is not None for n in src_nodes)


def _two_replica_router(cfg, params, *, seconds_per_64_tokens=60.0,
                        migrate_on_pressure=False):
    from repro_torch.core import SchedulerConfig
    from repro_torch.core.types import TransferCost
    from repro_torch.kernels import kv_quant
    from repro_torch.serving import MoriRouter

    kvb = kv_quant.token_wire_bytes(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, "bf16")
    router = MoriRouter(
        [_engine(cfg, params) for _ in range(2)], scheduler="mori",
        gpu_capacity_bytes=200 * kvb, cpu_capacity_bytes=200 * kvb,
        config=SchedulerConfig(tick_interval_s=1.0, migrate_on_pressure=migrate_on_pressure),
        xfer_cost=TransferCost(pcie_bytes_per_s=64 * kvb / seconds_per_64_tokens),
    )
    router._push = lambda t, fn: None  # stand-in virtual clock
    return router, kvb


def _demoted_on_replica_1(router, kvb, *, land: bool = True):
    """Place program ``p`` (the tie-break picks replica 1), run one step of
    it there, then shrink replica 1's GPU tier so the tick demotes it to
    DRAM; with ``land`` the offload completes."""
    sched = router.sched
    sched.program_arrived("p", kvb, 0.0)
    router.apply_plan(sched.request_arrived("p", 60, 0.0))
    assert sched.replica_of("p") == 1
    _offloaded_program(router.engines[1], "p", offload=False)
    sched.notify_inference_started("p", 0.0)
    router.apply_plan(sched.request_completed("p", 4, 1.0))
    sched.replicas[1].capacity = TierCapacity(10 * kvb, 200 * kvb)
    router.apply_plan(sched.tick(2.0))
    if land:
        router._advance_planes(1000.0)
        assert len(sched.ledger) == 0
        assert sched.programs["p"].tier is Tier.CPU


def test_pressure_migration_moves_a_stuck_program(setup):
    """``migrate_on_pressure``: a DRAM-resident program with a pending
    request that its home GPU cannot take moves to the replica with room,
    and reloads there."""
    cfg, params = setup
    router, kvb = _two_replica_router(cfg, params, migrate_on_pressure=True)
    sched = router.sched
    assert sched.config.migrate_on_pressure
    _demoted_on_replica_1(router, kvb)
    sched.replicas[1].capacity = TierCapacity(0, 200 * kvb)   # home GPU full
    router.apply_plan(sched.request_arrived("p", 72, 1001.0))
    router.apply_plan(sched.tick(1002.0))
    assert router.metrics.migrations == 1
    assert sched.ledger.open_migrate("p") is not None
    router._advance_planes(5000.0)
    assert router.metrics.migrated_pages > 0
    assert sched.replica_of("p") == 0
    assert router.engines[0].tree.program_nodes("p") != []


def test_drain_migrates_resident_kv_to_healthy_replica(setup):
    cfg, params = setup
    router, kvb = _two_replica_router(cfg, params)
    sched = router.sched
    _demoted_on_replica_1(router, kvb)
    router.mark_failed(1, 1000.0)
    assert router.metrics.drain_events == 1
    # the migrate executes on the destination (replica 0) plane
    assert router.planes[0].in_flight()
    assert sched.ledger.open_migrate("p") is not None
    assert any("migrate" in d for d in router.planes[0].describe_jobs())
    assert sched.replica_of("p") == 0
    router._advance_planes(3000.0)
    assert len(sched.ledger) == 0
    assert router.metrics.migrated_pages > 0 and router.metrics.migrations == 1
    assert router.engines[0].tree.program_nodes("p") != []


def test_migrate_cancels_mid_stream(setup):
    cfg, params = setup
    router, kvb = _two_replica_router(cfg, params, seconds_per_64_tokens=600.0)
    sched = router.sched
    _demoted_on_replica_1(router, kvb)
    dst_free = router.engines[0].pool.host_free_count()
    router.mark_failed(1, 1000.0)
    router._advance_planes(1000.0 + 160.0)
    job = next(iter(router.planes[0].channels.jobs()))
    assert 0 < job.chunks_done < job.n_chunks
    router.apply_plan(sched.program_finished("p", 1200.0))
    assert not router.planes[0].in_flight()
    assert router.metrics.cancelled_pages > 0
    assert len(sched.ledger) == 0
    assert router.engines[0].pool.host_free_count() == dst_free
    assert router.engines[0].tree.program_nodes("p") == []


def test_mark_failed_aborts_inflight_offload_and_requeues(setup):
    cfg, params = setup
    router, kvb = _two_replica_router(cfg, params)
    sched = router.sched
    _demoted_on_replica_1(router, kvb, land=False)
    router._advance_planes(2.0 + 10.0)
    assert router.planes[1].in_flight()
    assert sched.ledger.open_offload("p") is not None
    router.mark_failed(1, 20.0)
    assert not router.planes[1].in_flight()
    assert len(sched.ledger) == 0
    assert router.metrics.cancelled_pages > 0
    # half-written DRAM copies are not trustworthy: no migrate
    assert router.metrics.migrations == 0
    assert sched.programs["p"].tier is Tier.WAITING


# ------------------------------------------------------------ failover
def failover_replay(port: bool, faults: bool, offload_format: str):
    """``tests/test_failover.py``'s replay: four programs over two
    replicas, replica 1 failing at t = 5 (live decode slots) and
    recovering at t = 65. Returns the router's metrics (wall clock
    dropped), serialized action log and output log."""
    from repro.configs import get_config as jax_get_config
    from repro.core import SchedulerConfig as JaxSchedulerConfig
    from repro.core.actions import action_to_json as jax_action_to_json
    from repro.core.types import TransferCost as JaxTransferCost
    from repro.models import Model as JaxModel
    from repro.models import materialize as jax_materialize
    from repro.serving import Engine as JaxEngine
    from repro.serving import MoriRouter as JaxRouter
    from repro.sim.engine import FaultPlan as JaxFaultPlan
    from repro.traces import TraceGenConfig as JaxTG
    from repro.traces import generate_corpus as jax_corpus
    from repro_torch.configs import get_config
    from repro_torch.core import SchedulerConfig
    from repro_torch.core.types import TransferCost
    from repro_torch.models import Model, materialize
    from repro_torch.serving import Engine, MoriRouter
    from repro_torch.sim import FaultPlan
    from repro_torch.traces import TraceGenConfig, generate_corpus

    tg = dict(min_steps=3, mean_steps=4, max_steps=4, initial_context_mean=700,
              max_context=1800, long_median_s=20.0, busy_calls_mean=2.0, idle_calls_mean=2.0)
    kw = dict(page_tokens=8, n_device_pages=96, n_host_pages=96, max_slots=2, max_seq=320,
              offload_format=offload_format)
    if port:
        cfg = get_config("qwen1.5-0.5b").reduced()
        params = materialize(Model(cfg).describe(), seed=0)
        engines = [Engine(cfg, params, device="cpu", **kw) for _ in range(2)]
        mods = (MoriRouter, SchedulerConfig, TransferCost, FaultPlan, action_to_json)
        corpus = generate_corpus(4, seed=5, cfg=TraceGenConfig(**tg))
    else:
        cfg = jax_get_config("qwen1.5-0.5b").reduced()
        params = jax_materialize(JaxModel(cfg).describe(), seed=0)
        engines = [JaxEngine(cfg, params, **kw) for _ in range(2)]
        mods = (JaxRouter, JaxSchedulerConfig, JaxTransferCost, JaxFaultPlan,
                jax_action_to_json)
        corpus = jax_corpus(4, seed=5, cfg=JaxTG(**tg))
    router_cls, sched_cfg, cost, fault_cls, to_json = mods
    router = router_cls(
        engines, scheduler="mori", gpu_capacity_bytes=500_000,
        config=sched_cfg(tick_interval_s=2.0),
        xfer_cost=cost(pcie_bytes_per_s=2e5), record_plans=True,
    )
    m = router.replay(corpus, vocab_size=cfg.vocab_size, max_new_tokens=4,
                      faults=[fault_cls(replica=1, fail_at=5.0, recover_at=65.0)]
                      if faults else None)
    metrics = dataclasses.asdict(m)
    metrics.pop("ttft_samples")                     # wall clock
    assert len(router.sched.ledger) == 0            # nothing left open
    return (metrics, [to_json(a) for a in router.action_log],
            {p: [int(t) for t in s] for p, s in router.output_log.items()})


@pytest.mark.parametrize("offload_format", ["bf16", "int8"])
def test_mid_decode_failover_loses_zero_tokens_and_matches_reference(offload_format):
    """Fail replica 1 mid-replay, recover it later: every program still
    completes every step with the token stream of an undisturbed run (the
    requeued steps re-prefilled the same context on the surviving
    replica), and the control plane decided exactly what the reference's
    did."""
    base, base_actions, base_out = failover_replay(True, False, offload_format)
    m, actions, out = failover_replay(True, True, offload_format)
    assert m["drain_events"] == 1 and m["requeued_slots"] > 0
    assert m["steps_completed"] == base["steps_completed"]
    assert out == base_out
    assert sum(m["placement_reasons"].values()) > 0 and base["placement_reasons"]
    jm, jactions, _ = failover_replay(False, True, offload_format)
    assert m == jm
    assert actions == jactions


# ------------------------------------------- the checker's host-tier sizes
def _int8_demotion(port: bool):
    """Program ``p`` served on replica 1 of two int8-offload engines, then
    demoted to DRAM by a shrunken GPU tier, with the sanitizer's
    control-plane checker sweeping every applied plan."""
    if port:
        from repro_torch.configs import get_config
        from repro_torch.core import SchedulerConfig
        from repro_torch.kernels import kv_quant
        from repro_torch.models import Model, materialize
        from repro_torch.serving import Engine, EngineRequest, MoriRouter
        tier_cap, ekw = TierCapacity, dict(device="cpu")
    else:
        from repro.configs import get_config
        from repro.core import SchedulerConfig
        from repro.core.types import TierCapacity as tier_cap
        from repro.kernels import kv_quant
        from repro.models import Model, materialize
        from repro.serving import Engine, EngineRequest, MoriRouter
        ekw = {}
    cfg = get_config("qwen1.5-0.5b").reduced()
    params = materialize(Model(cfg).describe(), seed=0)
    engines = [Engine(cfg, params, page_tokens=8, n_device_pages=64, n_host_pages=64,
                      max_slots=2, max_seq=256, offload_format="int8", **ekw)
               for _ in range(2)]
    kvb = kv_quant.token_wire_bytes(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, "bf16")
    router = MoriRouter(engines, scheduler="mori", gpu_capacity_bytes=200 * kvb,
                        cpu_capacity_bytes=200 * kvb,
                        config=SchedulerConfig(tick_interval_s=1.0), sync_transfers=True)
    assert router._checker is not None
    sched = router.sched
    sched.program_arrived("p", kvb, 0.0, router.wire_bytes_per_token)
    router.apply_plan(sched.request_arrived("p", 60, 0.0))
    engines[1].submit(EngineRequest("p", list(range(2, 62)), max_new_tokens=4))
    engines[1].run_to_completion()
    sched.notify_inference_started("p", 0.0)
    router.apply_plan(sched.request_completed("p", 4, 1.0))
    sched.replicas[1].capacity = tier_cap(10 * kvb, 200 * kvb)
    router.apply_plan(sched.tick(2.0))
    return sched


def test_checker_counts_host_tiers_at_the_offload_size():
    """With int8 offload a DRAM copy holds ``host_kv_bytes``, about half
    of ``kv_bytes``, and the scheduler accounts it so. The reference's
    checker sums ``kv_bytes`` on every tier and fails the first int8
    demotion; the port's sums each tier at its own size."""
    from repro.analysis.invariants import InvariantError as JaxInvariantError

    sched = _int8_demotion(True)
    prog = sched.programs["p"]
    assert prog.tier is Tier.CPU and prog.host_kv_bytes < prog.kv_bytes
    assert sched.replicas[1].cpu_used == prog.host_kv_bytes
    with pytest.raises(JaxInvariantError, match="cpu occupancy conservation broken"):
        _int8_demotion(False)
