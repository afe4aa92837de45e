"""MORI router over real engine replicas (the paper's Fig. 6 front door).

The router is the real-engine executor of the scheduler's
:class:`~repro_torch.core.actions.PlacementPlan` protocol: every lifecycle event
returns a plan and :meth:`MoriRouter.apply_plan` turns its actions into
real page movements in each engine's two-tier pool. Workload replay runs
on a *virtual clock* (tool-call sleeps advance time instantly; inference
advances it by the trace's recorded reasoning wall-time) while the engine
compute itself is real PyTorch execution — so policy behaviour is timed
faithfully and the data plane actually runs.

Replay executes decode through a clocked **decode pump**: every replica
holds a queue of resident program slots, and at each virtual-clock quantum
every replica with due slots takes ONE batched ``Engine.step`` that
advances all of them together. New ``Forward``s submit into free engine
slots while other slots are mid-decode, each program's decode steps are
paced across its own recorded ``reasoning_wall_s`` window (a slow program
never monopolizes the replica), completions retire per-slot when their
window ends, and transfer-plane chunks interleave with pump steps — so
the measured compute/transfer overlap is against genuinely batched
decode. The scheduler reads *real* engine occupancy through its slot
probe and is poked via ``on_slot_freed`` the moment a batch slot opens,
so gated programs join a running batch mid-flight.
``MoriRouter(serial_decode=True)`` keeps the pre-pump serialized
replay — each dispatched request runs to completion before the next
event — pinned token-identical by ``tests/test_decode_pump.py``'s golden
corpus.

``MoriRouter(chunked_prefill=True)`` makes prefill itself preemptible:
admission goes through the engine's two-phase ``begin_submit`` /
``prefill_step`` API, the ``_PumpSlot`` sits in a *prefilling* state
(owning its engine slot, visible to occupancy probes, never stepping)
while the pump runs one ``prefill_token_budget``-bounded chunk per settle
visit, and due decode steps interleave between chunks instead of stalling
behind a whole prefill (``RouterMetrics.prefill_interleaved_steps``).
This module is the PyTorch port's copy of the reference router. It
differs only where the port has no counterpart: its compile-budget gate
counts the engines' step-graph captures where the reference counted jit
compiles.

Transfers execute in one of two modes:

* **async (default)** — an ``Offload`` or reloading ``Forward`` becomes a
  chunked, page-granular copy job on the replica's
  :class:`~repro_torch.serving.transfer_plane.ReplicaTransferPlane` (PCIe and
  NVMe channel queues, bandwidths from
  :class:`~repro_torch.core.types.TransferCost` or a
  :class:`~repro_torch.sim.hardware.HwConfig`). Copy chunks interleave with
  engine decode steps on the virtual clock, ``on_transfer_complete`` acks
  only when the last page lands, and a tool call that returns early finds
  its offload still pending — the scheduler's ``CancelTransfer`` path
  aborts the partially-streamed copy and the program re-admits warm
  (``RouterMetrics.cancelled_offloads``). Decode steps taken while a
  transfer was in flight are counted in
  ``RouterMetrics.overlap_decode_steps`` — the paper's idle-window
  overlap, measured on the real path.
* **sync (``sync_transfers=True``)** — the pre-async compatibility mode:
  every transfer-bearing action executes and acks inside ``apply_plan``,
  keeping the ledger empty between events. Together with
  ``serial_decode=True`` this reproduces the golden byte-identical
  sim↔router action streams of ``tests/test_plan_protocol.py``.

Action semantics on the real path:

* ``Forward(source_tier=GPU)`` — warm: submit against the cached pages.
* ``Forward(source_tier=CPU)`` — reload host pages over PCIe, then submit.
* ``Forward(source_tier=SSD)`` — reload billed to the NVMe channel
  (``RouterMetrics.nvme_reloaded_pages``).
* ``Forward(recompute=True)`` — Waiting-tier re-admission: the program's
  stale pages (if any survived) are dropped so the engine genuinely
  re-prefills the full context.
* ``Migrate`` — cross-replica KV move, executed on the *destination*
  replica's plane as a page-granular host→host copy
  (:class:`~repro_torch.serving.transfer_plane._MigrateStream`, raw-bits
  byte-identical via ``PagePool.import_host_page``), cancellable
  mid-stream like any offload. Requires paged engines; the router raises
  at construction naming ``migrate_on_pressure`` otherwise.

Live drain/failover: :meth:`MoriRouter.mark_failed` mid-replay aborts the
failed replica's in-flight copies (and migrates sourced from it), tears
down its mid-decode slots (``Engine.abort_request``) and requeues them —
the requeued step re-prefills the identical context on a healthy replica,
so no tokens are lost — then hands the scheduler the failure event, whose
``drain_migrate`` pass moves host-resident KV to the healthy replica with
the most DRAM headroom. :meth:`MoriRouter.mark_recovered` re-admits the
replica for placement. ``replay(faults=[...])`` injects both on the
virtual clock (same :class:`~repro_torch.sim.engine.FaultPlan` shape the
simulator takes).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import time
from dataclasses import dataclass, field

from repro_torch.analysis import compile_tracker, kvsan
from repro_torch.analysis.invariants import ControlPlaneChecker
from repro_torch.core import SCHEDULERS, SchedulerConfig, TierCapacity
from repro_torch.core.actions import (
    Action,
    CancelTransfer,
    Discard,
    Forward,
    Migrate,
    Offload,
    PlacementPlan,
    SetLabel,
)
from repro_torch.core.transfers import CopyJob, copy_request_for
from repro_torch.kernels import kv_quant
from repro_torch.core.types import ProgramTrace, Tier, TransferCost
from repro_torch.serving.engine import Completion, Engine, EngineRequest
from repro_torch.serving.transfer_plane import ReplicaTransferPlane, _MigrateStream

#: float slack for virtual-clock due/retire comparisons
_EPS = 1e-9
#: smallest synthesized context the replay will accept after reserving
#: per-step headroom — below this the trace cannot express prefix growth
_MIN_SYNTH_CTX = 16


@dataclass
class RouterMetrics:
    steps_completed: int = 0
    tokens_generated: int = 0
    cached_tokens: int = 0
    prefilled_tokens: int = 0
    offloaded_pages: int = 0
    reloaded_pages: int = 0          # PCIe-billed (CPU-tier) reloads
    nvme_reloaded_pages: int = 0     # NVMe-billed (SSD-tier) reloads
    # wire bytes actually moved, priced at the offload format (int8 pages
    # bill their int8 payload + scale sidecars, not the bf16 device size)
    offload_bytes: int = 0
    reload_bytes: int = 0
    recompute_submits: int = 0
    gated_events: int = 0
    # async transfer plane (zero in sync_transfers mode)
    overlap_decode_steps: int = 0    # decode steps with a transfer in flight
    cancelled_offloads: int = 0      # offloads aborted by early tool return
    cancelled_pages: int = 0         # staged pages rolled back by aborts
    peak_inflight_bytes: int = 0     # high-water mark of the transfer ledger
    # decode pump (batch occupancy; serial_decode replay pins these at one
    # live slot per step by construction)
    pump_steps: int = 0              # batched decode steps taken by replay
    sum_live_slots: int = 0          # Σ slots advanced across pump steps
    peak_live_slots: int = 0         # most slots one step ever advanced
    multi_slot_steps: int = 0        # steps that advanced ≥ 2 slots
    slot_wait_s: float = 0.0         # Forward release → engine-submit wait
    slot_waits: int = 0              # submits that waited on a full batch
    # chunked prefill (zero when chunked_prefill is off)
    prefill_chunks: int = 0          # prefill_step calls executed by the pump
    prefill_interleaved_steps: int = 0  # decode steps with a prefill in flight
    # multi-replica scale-out: cross-replica migration and drain/failover
    migrations: int = 0              # Migrate actions executed
    migrated_pages: int = 0          # pages landed on a migrate destination
    drain_events: int = 0            # mark_failed calls (drain/failover)
    requeued_slots: int = 0          # mid-flight slots requeued by failover
    makespan_s: float = 0.0          # virtual time at which replay drained
    # why the balancer placed where it did (copied from
    # ReplicaBalancer.reason_counts at end of replay)
    placement_reasons: dict = field(default_factory=dict)
    # real (wall-clock) submit-event → first-token latency per program step —
    # the paper's headline TTFT, measured on the actual execution path
    ttft_samples: list = field(default_factory=list)

    @property
    def cache_hit_rate(self) -> float:
        total = self.cached_tokens + self.prefilled_tokens
        return self.cached_tokens / total if total else 0.0

    @property
    def ttft_s(self) -> dict:
        """Summary of real time-to-first-token: ``{n, mean, p50, p95}``
        (seconds, nearest-rank percentiles; zeros when nothing retired)."""
        xs = sorted(self.ttft_samples)
        if not xs:
            return {"n": 0, "mean": 0.0, "p50": 0.0, "p95": 0.0}

        def pct(p: float) -> float:
            return xs[min(len(xs) - 1, max(0, math.ceil(p * len(xs)) - 1))]

        return {
            "n": len(xs),
            "mean": sum(xs) / len(xs),
            "p50": pct(0.50),
            "p95": pct(0.95),
        }

    @property
    def mean_batch_occupancy(self) -> float:
        """Mean live slots advanced per decode step (the continuous-batching
        payoff: > 1.0 means programs genuinely decoded together)."""
        return self.sum_live_slots / self.pump_steps if self.pump_steps else 0.0


@dataclass
class _PumpSlot:
    """One resident program in a replica's decode batch."""

    pid: str
    replica: int
    engine_slot: int
    req: EngineRequest
    step_idx: int
    start: float                 # virtual submit time
    wall: float                  # recorded reasoning_wall_s for this step
    dt: float                    # virtual seconds between decode steps
    seq: int                     # join order, for deterministic iteration
    steps_taken: int = 0
    next_due: float = 0.0
    done: Completion | None = None
    # chunked prefill: the resumable engine job while the slot is still
    # prefilling (None once the first token lands / in monolithic mode).
    # A prefilling slot owns its engine slot — occupancy probes count it —
    # but never steps decode and never retires until the pipeline drains.
    prefill: "object | None" = None

    @property
    def end(self) -> float:
        return self.start + self.wall

    @property
    def prefilling(self) -> bool:
        return self.prefill is not None


@dataclass
class _ReplayState:
    """Replay-scoped context shared by issue/submit/retire."""

    state: dict[str, dict]
    vocab_size: int
    max_new_tokens: int
    traces: list[ProgramTrace] = field(default_factory=list)


class MoriRouter:
    """Front door: program-aware routing + placement over real engines."""

    def __init__(
        self,
        engines: list[Engine],
        *,
        scheduler: str = "mori",
        gpu_capacity_bytes: int | None = None,
        cpu_capacity_bytes: int | None = None,
        ssd_capacity_bytes: int = 0,
        config: SchedulerConfig | None = None,
        record_plans: bool = False,
        sync_transfers: bool = False,
        serial_decode: bool = False,
        pump_quantum_s: float | None = None,
        chunked_prefill: bool = False,
        prefill_token_budget: int | None = None,
        xfer_cost: TransferCost | None = None,
        hw: "object | None" = None,   # repro_torch.sim.hardware.HwConfig
    ):
        self.engines = engines
        cfg0 = engines[0].cfg
        pool = engines[0].pool
        # per-token sizes come from the pool's tier formats: the device
        # size prices GPU budgets, the wire size prices transfers and host
        # tiers (kv_quant.token_wire_bytes is the format-aware sizing
        # helper; see docs/architecture.md "tier formats")
        self.kv_bytes_per_token = kv_quant.token_wire_bytes(
            cfg0.num_layers, cfg0.num_kv_heads, cfg0.head_dim,
            getattr(pool, "device_format", "bf16"),
        )
        wire_bpt = kv_quant.token_wire_bytes(
            cfg0.num_layers, cfg0.num_kv_heads, cfg0.head_dim,
            getattr(pool, "offload_format", "bf16"),
        )
        # None = same format everywhere -> byte-identical legacy accounting
        self.wire_bytes_per_token = (
            None if wire_bpt == self.kv_bytes_per_token else wire_bpt
        )
        # default GPU budget = the pool's *cache* capacity: the block-table
        # engine provisions extra pages as decode state (the HBM its dense
        # slot buffers used to occupy) and the scheduler must not place
        # programs into that reserve
        reserve = getattr(engines[0], "decode_reserve_pages", 0)
        gpu_cap = (
            gpu_capacity_bytes
            if gpu_capacity_bytes is not None
            else (pool.n_device_pages - reserve) * pool.page_bytes
        )
        cpu_cap = (
            cpu_capacity_bytes
            if cpu_capacity_bytes is not None
            else pool.n_host_pages * getattr(  # lint: kv008-ok (page_bytes is only the stub-pool fallback)
                pool, "host_page_bytes", pool.page_bytes
            )
        )
        config = config or SchedulerConfig(tick_interval_s=5.0)
        # cross-replica migration (pressure-driven or drain-driven) copies
        # KV at page granularity through the pools' host staging, so it
        # needs paged engines on both ends
        paged = all(
            hasattr(e, "tree")
            and hasattr(getattr(e, "pool", None), "import_host_page")
            for e in engines
        )
        if config.migrate_on_pressure and not paged:
            raise ValueError(
                "migrate_on_pressure=True requires paged engine replicas: "
                "cross-replica migration streams KV page-by-page through "
                "PagePool.import_host_page, which these engines lack — "
                "construct the router with paged Engine replicas or set "
                "migrate_on_pressure=False"
            )
        if config.drain_migrate and not paged:
            # drain_migrate defaults on; degrade unpaged fleets to the
            # discard-and-recompute failure path instead of erroring
            config = dataclasses.replace(config, drain_migrate=False)
        self.sched = SCHEDULERS[scheduler](
            len(engines),
            TierCapacity(gpu_cap, cpu_cap, ssd_capacity_bytes),
            config,
        )
        # control-plane invariant checker (REPRO_KVSAN=1 only): audits the
        # ledger's record lifecycle inline and sweeps scheduler occupancy /
        # placement consistency at every tick
        self._checker = (
            ControlPlaneChecker(self.sched) if kvsan.enabled() else None
        )
        self.metrics = RouterMetrics()
        self.record_plans = record_plans
        self.action_log: list[Action] = []
        self.output_log: dict[str, list[int]] = {}
        self._pending: dict[str, tuple[EngineRequest, int]] = {}
        self._dispatched: dict[str, Forward] = {}
        self._dispatch_time: dict[str, float] = {}

        self.serial_decode = serial_decode
        self.pump_quantum_s = pump_quantum_s
        if chunked_prefill:
            if serial_decode:
                raise ValueError(
                    "chunked_prefill needs the decode pump; serial_decode "
                    "replay keeps the monolithic golden path"
                )
            if any(getattr(e, "dense_slots", True) for e in engines):
                raise ValueError(
                    "chunked_prefill requires paged engines "
                    "(dense_slots=False)"
                )
        self.chunked_prefill = chunked_prefill
        self.prefill_token_budget = prefill_token_budget
        self._ttft_start: dict[tuple[str, int], float] = {}
        # per-replica decode batches (pid -> _PumpSlot); always empty in
        # serial_decode mode
        self._pump_slots: list[dict[str, _PumpSlot]] = [{} for _ in engines]
        self._slot_seq = itertools.count()
        if not serial_decode:
            # the scheduler's slot gate reads real engine occupancy (minus
            # requests released but not yet submitted) instead of its own
            # shadow running set
            self.sched.attach_slot_probe(self._probe_slots)

        self.sync_transfers = sync_transfers
        if xfer_cost is None:
            # channel bandwidths from the hardware model when one is given
            # (mirrors Simulation.__init__), else the TransferCost defaults
            xfer_cost = (
                TransferCost(pcie_bytes_per_s=hw.pcie_bw)
                if hw is not None
                else TransferCost()
            )
        self.xfer_cost = xfer_cost
        # set only while replay() runs; without a virtual clock (direct
        # apply_plan use) transfers fall back to synchronous execution
        self._push = None
        self._rs: _ReplayState | None = None
        self.planes: list[ReplicaTransferPlane] = [
            ReplicaTransferPlane(
                i, eng, xfer_cost,
                wake=self._wake, on_committed=self._plane_committed,
                peer_engine=lambda r: self.engines[r],
            )
            for i, eng in enumerate(engines)
        ]

    # -------------------------------------------------------------- helpers
    @property
    def _async(self) -> bool:
        """Async execution needs both the knob and a live virtual clock."""
        return not self.sync_transfers and self._push is not None

    def _wake(self, eta: float) -> None:
        """A plane or pump slot scheduled work at ``eta``: make sure the
        replay loop visits that timestamp even if no trace event falls on
        it (the drain after every event runs the pump/planes)."""
        if self._push is not None:
            self._push(eta, lambda t: None)

    def _advance_planes(self, now: float) -> None:
        for plane in self.planes:
            plane.advance(now)

    def _planes_busy(self) -> bool:
        return any(p.in_flight() for p in self.planes)

    def _probe_slots(self, replica: int) -> tuple[int, int]:
        """Scheduler slot probe: (free, live) decode slots on ``replica``.

        Requests the scheduler already released but the pump has not yet
        submitted count against the free side (they own a slot the moment
        one opens) and toward the live side, so the gate can never
        over-release into a batch that is already spoken for.
        """
        queued = sum(
            1
            for pid, act in self._dispatched.items()
            if act.replica == replica and pid in self._pending
        )
        free = self.engines[replica].free_slot_count()
        return max(0, free - queued), len(self._pump_slots[replica]) + queued

    def _kvsan_check(self, now: float) -> None:
        """Tick-granularity sanity sweep (no-op unless REPRO_KVSAN=1):
        control-plane occupancy/placement plus each pool's structural
        page invariants."""
        if self._checker is not None:
            self._checker.check(now)
        for i, eng in enumerate(self.engines):
            san = getattr(eng.pool, "_san", None)
            if san is not None:
                san.verify(f"router tick t={now:.3f}, replica {i}")

    def _kvsan_end_of_replay(self) -> None:
        """Replay drained: the ledger must be empty and every allocated
        page reachable (anything else is a leak)."""
        if self._checker is not None:
            self._checker.assert_drained()
        for i, eng in enumerate(self.engines):
            san = getattr(eng.pool, "_san", None)
            if san is not None:
                san.verify(f"end of replay, replica {i}")
                san.check_leaks(f"end of replay, replica {i}")

    def _jitaudit_end_of_replay(self) -> None:
        """Capture-budget gate (no-op unless ``REPRO_JITAUDIT=1`` and some
        engine ran ``warmup()``): a replay that captured a step graph past
        an engine's warm snapshot (a decode bucket, or a chunk-prefill
        bucket first met by a prefill chunk) stalled the pump for an eager
        run and a capture — fail it loudly with the per-cache counts."""
        if not compile_tracker.enabled():
            return
        tracker = compile_tracker.get_tracker()
        if not tracker.marked():
            return                      # no warm baseline, nothing to gate
        grew = tracker.post_warmup_compiles()
        if grew:
            detail = ", ".join(
                f"{name}: {warm} warm -> {cur}"
                for name, (warm, cur) in sorted(grew.items())
            )
            phases = {
                ph: len(tracker.events_in(ph))
                for ph in sorted({e.phase for e in tracker.events})
            }
            raise RuntimeError(
                f"compile budget violated: {len(grew)} hot-path graph cache(s) "
                f"captured after warmup ({detail}); captures by phase: "
                f"{phases} — a shape escaped the warmup buckets"
            )

    def _record_ttft(self, pid: str, step_idx: int) -> None:
        """First token just landed for (pid, step): close its TTFT sample."""
        t0 = self._ttft_start.pop((pid, step_idx), None)
        if t0 is not None:
            self.metrics.ttft_samples.append(time.perf_counter() - t0)

    # ------------------------------------------------------- plan executor
    def apply_plan(self, plan: PlacementPlan) -> None:
        """Execute a scheduler plan as real page movements — queueing
        transfer-bearing actions on the async planes, or executing and
        acknowledging them synchronously in ``sync_transfers`` mode."""
        if self.record_plans and plan.actions:
            self.action_log.extend(plan.actions)
        for act in plan:
            if isinstance(act, Forward):
                self._exec_forward(act, plan.now)
            elif isinstance(act, Offload):
                self._exec_offload(act, plan.now)
            elif isinstance(act, Discard):
                if act.replica is not None:
                    # abort any copy still streaming this program's pages.
                    # On program teardown the ledger already dropped the
                    # records; on a live-program eviction (CPU/SSD overflow
                    # passes) they are still open, and must be closed here —
                    # a stale open offload would later match
                    # _cancel_inflight_offload and cancel the wrong transfer
                    if not self.sync_transfers:
                        for job, rolled in self.planes[act.replica].abort_pid(
                            act.pid, plan.now
                        ):
                            self.metrics.cancelled_pages += rolled
                            if self.sched.ledger.is_open(job.action_id):
                                self.sched.ledger.cancel(job.action_id)
                    # the logical SSD tier is backed by the host pool on the
                    # real path — freeing it frees host pages
                    tier = Tier.CPU if act.tier is Tier.SSD else act.tier
                    self.engines[act.replica].discard_program(act.pid, tier)
            elif isinstance(act, SetLabel):
                if act.replica is not None:
                    self.engines[act.replica].set_label(act.pid, act.label)
            elif isinstance(act, CancelTransfer):
                self._exec_cancel(act, plan.now)
            elif isinstance(act, Migrate):
                self._exec_migrate(act, plan.now)
        self.metrics.peak_inflight_bytes = max(
            self.metrics.peak_inflight_bytes, self.sched.ledger.in_flight_bytes()
        )
        if self._checker is not None:
            self._checker.check(plan.now)

    def _exec_forward(self, act: Forward, now: float) -> None:
        if act.source_tier in (Tier.CPU, Tier.SSD):
            if self._async:
                # queue the reload; the program dispatches only when the
                # last page lands (_plane_committed)
                self.planes[act.replica].enqueue(act, now)
                return
            eng = self.engines[act.replica]
            pages = eng.reload_program(act.pid)
            if act.source_tier is Tier.SSD:
                self.metrics.nvme_reloaded_pages += pages
            else:
                self.metrics.reloaded_pages += pages
            self.metrics.reload_bytes += pages * eng.pool.host_page_bytes
            self._ack(act.pid, act.action_id, now)
        elif act.recompute:
            # Waiting-tier re-admission: drop any pages that survived
            # engine-side eviction so the full context is re-prefilled —
            # what the scheduler billed is what the engine now does
            eng = self.engines[act.replica]
            eng.discard_program(act.pid, Tier.GPU)
            eng.discard_program(act.pid, Tier.CPU)
            self.metrics.recompute_submits += 1
        self._dispatched[act.pid] = act
        self._dispatch_time[act.pid] = now

    def _exec_offload(self, act: Offload, now: float) -> None:
        if self._async and act.nbytes > 0:
            self.planes[act.replica].enqueue(act, now)
            return
        eng = self.engines[act.replica]
        pages = eng.offload_program(act.pid)
        self.metrics.offloaded_pages += pages
        self.metrics.offload_bytes += pages * eng.pool.host_page_bytes
        self._ack(act.pid, act.action_id, now)

    def _exec_migrate(self, act: Migrate, now: float) -> None:
        """Cross-replica KV move. Async: a chunked copy job on the
        *destination* replica's plane (the copy executes where it lands),
        cancellable mid-stream like any offload. Sync: the stream runs
        inline and acks immediately."""
        self.metrics.migrations += 1
        if self._async and act.nbytes > 0:
            creq = copy_request_for(act)
            self.planes[creq.exec_replica].enqueue_request(creq, now, act=act)
            return
        stream = _MigrateStream(
            self.engines[act.src_replica], self.engines[act.dst_replica],
            act.pid,
        )
        for _ in range(stream.n_units):
            stream.copy_unit()
        self.metrics.migrated_pages += stream.commit()
        self._ack(act.pid, act.action_id, now)

    def _exec_cancel(self, act: CancelTransfer, now: float) -> None:
        if self.sync_transfers:
            return  # transfers are synchronous: never still queued
        res = self.planes[act.replica].abort(act.target_action_id, now)
        if res is not None:
            job, rolled = res
            self.metrics.cancelled_offloads += 1
            self.metrics.cancelled_pages += rolled

    def _plane_committed(
        self, job: CopyJob, kind: str, pages: int, now: float
    ) -> None:
        """Async transfer fully landed: bill it, release any gated forward,
        and acknowledge the scheduler's ledger record."""
        page_wire = (
            self.engines[job.payload.creq.exec_replica].pool.host_page_bytes
        )
        if kind == "offload":
            self.metrics.offloaded_pages += pages
            self.metrics.offload_bytes += pages * page_wire
        elif kind == "migrate":
            self.metrics.migrated_pages += pages
        else:
            act: Forward = job.payload.act
            if act.source_tier is Tier.SSD:
                self.metrics.nvme_reloaded_pages += pages
            else:
                self.metrics.reloaded_pages += pages
            self.metrics.reload_bytes += pages * page_wire
            self._dispatched[act.pid] = act
            self._dispatch_time[act.pid] = now
        self._ack(job.pid, job.action_id, now)

    def _ack(self, pid: str, action_id: int, now: float) -> None:
        self.apply_plan(self.sched.on_transfer_complete(pid, action_id, now))

    # ------------------------------------------------------ drain/failover
    def mark_failed(self, replica: int, now: float) -> None:
        """Live failover: the replica's GPU is gone, its host DRAM is still
        readable (the drain model). In order:

        1. abort every copy job this replica executes, plus any
           cross-replica migrate elsewhere that *reads* from it, closing
           their ledger records (staged pages roll back);
        2. tear down its mid-flight decode/prefill slots and requeue the
           requests (:func:`repro_torch.serving.state_io.requeue_resident_slots`)
           — the requeued step re-prefills the identical context on a
           healthy replica, so the token stream loses nothing;
        3. hand the scheduler the failure event: its ``drain_migrate``
           pass migrates host-resident KV to healthy replicas and drops
           the rest to the Waiting tier.
        """
        from repro_torch.serving.state_io import requeue_resident_slots

        self.metrics.drain_events += 1
        if not self.sync_transfers:
            # jobs executing on the failed plane: abort the streams (staged
            # pages roll back) but leave their ledger records — they are
            # billed to the failed replica, so ``replica_failed``'s
            # drop_replica closes them, and until then a half-offloaded
            # program still shows an *open* offload, which is exactly what
            # makes the drain pass skip its untrustworthy DRAM copy
            for job in list(self.planes[replica].channels.jobs()):
                res = self.planes[replica].abort(job.action_id, now)
                if res is not None:
                    self.metrics.cancelled_pages += res[1]
            # migrates elsewhere that *read* from the failed replica: abort
            # and cancel explicitly (their records bill to the destination,
            # which drop_replica will not touch)
            for r, plane in enumerate(self.planes):
                if r == replica:
                    continue
                for job in list(plane.channels.jobs()):
                    task = job.payload
                    if (
                        task.kind == "migrate"
                        and task.creq is not None
                        and task.creq.src.replica == replica
                    ):
                        res = plane.abort(job.action_id, now)
                        if res is not None:
                            self.metrics.cancelled_pages += res[1]
                            self.sched.ledger.cancel(job.action_id)
        self.metrics.requeued_slots += requeue_resident_slots(
            self, replica, now
        )
        # dispatched-but-not-yet-submitted work targeting the dead replica
        # goes back to pending; the scheduler re-places it after the drain
        for pid in [
            p for p, a in self._dispatched.items() if a.replica == replica
        ]:
            self._dispatched.pop(pid)
            self._dispatch_time.pop(pid, None)
        self.apply_plan(self.sched.replica_failed(replica, now))

    def mark_recovered(self, replica: int, now: float) -> None:
        """Re-admit a recovered replica for placement. Its pools were lost
        with the node; programs return through the normal Waiting-tier
        recompute path as the balancer starts placing onto it again."""
        self.sched.replica_recovered(replica)
        self.apply_plan(self.sched.tick(now))

    # ------------------------------------------------------------- replay
    def replay(
        self,
        traces: list[ProgramTrace],
        *,
        vocab_size: int,
        max_new_tokens: int = 8,
        seed: int = 0,
        faults: "list | None" = None,
    ) -> RouterMetrics:
        """Replay traces concurrently on the virtual clock.

        Default mode runs the clocked decode pump (batched multi-program
        decode); ``serial_decode=True`` reproduces the pre-pump serialized
        order, running each dispatched request to completion before the
        next event.

        ``faults`` injects live drain/failover on the virtual clock: each
        entry (duck-typed like :class:`~repro_torch.sim.engine.FaultPlan` —
        ``replica`` / ``fail_at`` / optional ``recover_at``) triggers
        :meth:`mark_failed` and :meth:`mark_recovered` at those times.
        """
        with compile_tracker.get_tracker().phase("replay"):
            return self._replay(traces, vocab_size=vocab_size, max_new_tokens=max_new_tokens,
                                seed=seed, faults=faults)

    def _replay(self, traces, *, vocab_size, max_new_tokens, seed, faults) -> RouterMetrics:
        """:meth:`replay`'s body; graph captures in it are tagged ``replay``
        in the compile tracker's log."""
        import random

        self._ttft_start.clear()
        q: list[tuple[float, int, object]] = []
        seq = itertools.count()

        def push(t, fn):
            heapq.heappush(q, (t, next(seq), fn))

        self._push = push

        # register programs (validating that each trace's synthesized
        # context can grow for its whole lifetime without hitting max_seq)
        max_seq = self.engines[0].max_seq
        state: dict[str, dict] = {}
        for tr in traces:
            pid = tr.program_id
            scale = max(1, tr.steps[0].input_tokens // 48)
            reserved = (max_new_tokens + 2) * len(tr.steps) + 8
            max_ctx = max_seq - reserved
            if max_ctx < _MIN_SYNTH_CTX:
                raise ValueError(
                    f"trace {pid!r} cannot replay on this engine: "
                    f"{len(tr.steps)} steps reserve "
                    f"(max_new_tokens={max_new_tokens} + 2) * steps + 8 = "
                    f"{reserved} tokens of growth headroom, but "
                    f"max_seq={max_seq} leaves max_ctx={max_ctx} "
                    f"(< {_MIN_SYNTH_CTX}) for the synthesized context — "
                    "shorten the trace, lower max_new_tokens, or raise the "
                    "engine's max_seq"
                )
            state[pid] = {
                "trace": tr,
                "tokens": [],
                "ctx_len": 0,
                "scale": scale,
                "max_ctx": max_ctx,
                "max_steps": len(tr.steps),
                "completed_steps": 0,
                # per-program stream (string seeding is hash-stable): the
                # synthesized context is a pure function of the program's
                # own history, never of cross-program admission order —
                # so a drained-and-requeued step regrows the *identical*
                # context, which is what makes failover token-preserving
                # and testable (output_log equality vs an undisturbed run)
                "rng": random.Random(f"{seed}:{pid}"),
            }
            self.sched.program_arrived(
                pid, self.kv_bytes_per_token, 0.0,
                wire_bytes_per_token=self.wire_bytes_per_token,
            )
            push(0.0, lambda t, p=pid: self._issue(p, 0, t))

        for f in faults or []:
            push(f.fail_at, lambda t, fr=f: self.mark_failed(fr.replica, t))
            if getattr(f, "recover_at", None) is not None:
                push(
                    f.recover_at,
                    lambda t, fr=f: self.mark_recovered(fr.replica, t),
                )

        self._rs = _ReplayState(
            state=state, vocab_size=vocab_size,
            max_new_tokens=max_new_tokens, traces=list(traces),
        )
        drain = self._drain_serial if self.serial_decode else self._pump_all

        def can_step(t: float) -> bool:
            """Step only when no other event shares this virtual instant —
            same-time admissions then batch into one decode step."""
            return not (q and q[0][0] <= t + _EPS)

        tick = self.sched.config.tick_interval_s
        next_tick = tick
        now = 0.0
        # stall guard derived from the workload: an event is allowed to make
        # no progress (stale wakes, gated arrivals already counted) only so
        # many times in a row before the replay is declared wedged
        total_steps = sum(len(tr.steps) for tr in traces)
        stall_cap = max(1_000, 64 * len(traces) + 8 * total_steps)
        stalled, last_progress = 0, self._progress_vector()
        # once the trace event heap runs dry with work still outstanding
        # (requests gated on capacity, transfers mid-stream), the loop
        # injects drain ticks until everything resolves — bounded by a
        # deadline derived from the outstanding work itself (remaining
        # virtual trace time + worst-case transfer time), not a fixed
        # tick count
        drain_deadline: float | None = None
        while q or self._outstanding_work():
            if not q:
                if drain_deadline is None:
                    drain_deadline = (
                        now + self._drain_budget_s(state) + 32 * tick
                    )
                if now > drain_deadline:
                    raise RuntimeError(
                        "router replay did not drain by its derived "
                        f"deadline (t={now:.3f} > {drain_deadline:.3f}); "
                        + self._stall_report()
                    )
                now += tick
                next_tick = now + tick
                self._advance_planes(now)
                self.apply_plan(self.sched.tick(now))
                drain(now, can_step(now))
                self._kvsan_check(now)
                continue
            # a live event heap means new work (and new transfers) can
            # still start: any prior drain deadline is stale, re-derive it
            # at the next empty-heap episode from the work outstanding then
            drain_deadline = None
            t, _, fn = heapq.heappop(q)
            now = max(now, t)
            while next_tick <= now:
                self._advance_planes(next_tick)
                self.apply_plan(self.sched.tick(next_tick))
                drain(next_tick, can_step(next_tick))
                self._kvsan_check(next_tick)
                next_tick += tick
            self._advance_planes(now)
            fn(now)
            drain(now, can_step(now))
            cur = self._progress_vector()
            if cur == last_progress:
                stalled += 1
                if stalled > stall_cap:
                    raise RuntimeError(
                        f"router replay stalled: {stall_cap} consecutive "
                        f"events without progress at t={now:.3f}; "
                        + self._stall_report()
                    )
            else:
                stalled, last_progress = 0, cur
        self._kvsan_end_of_replay()
        self._jitaudit_end_of_replay()
        self._push = None
        self._rs = None
        self.metrics.makespan_s = now
        self.metrics.placement_reasons = dict(self.sched.balancer.reason_counts)
        return self.metrics

    # --------------------------------------------------- replay event hooks
    def _issue(self, pid: str, step_idx: int, now: float) -> None:
        rs = self._rs
        st = rs.state[pid]
        trace: ProgramTrace = st["trace"]
        rec = trace.steps[step_idx]
        # synthesize a token context of the recorded length (prefix-stable)
        want = max(
            st["ctx_len"] + 1,
            min(rec.input_tokens // st["scale"], st["max_ctx"]),
        )
        grow = want - st["ctx_len"]
        st["tokens"].extend(
            st["rng"].randrange(2, rs.vocab_size) for _ in range(grow)
        )
        st["ctx_len"] = want
        req = EngineRequest(
            program_id=pid,
            tokens=list(st["tokens"]),
            max_new_tokens=rs.max_new_tokens,
        )
        self._pending[pid] = (req, step_idx)
        # TTFT clock starts at the submit event (real time): scheduler
        # gating and slot waits are part of the latency a caller sees
        self._ttft_start[(pid, step_idx)] = time.perf_counter()
        self.apply_plan(self.sched.request_arrived(pid, want, now))
        if pid not in self._dispatched:
            self.metrics.gated_events += 1

    def _complete_step(
        self, pid: str, step_idx: int, comp: Completion, end: float
    ) -> None:
        """Shared retire bookkeeping: metrics, context growth, the
        ``request_completed`` plan, and the next issue (or teardown)."""
        rs = self._rs
        st = rs.state[pid]
        self.metrics.steps_completed += 1
        self.metrics.tokens_generated += len(comp.output_tokens)
        self.metrics.cached_tokens += comp.cached_tokens
        self.metrics.prefilled_tokens += comp.prefilled_tokens
        self.output_log.setdefault(pid, []).extend(comp.output_tokens)
        st["tokens"].extend(comp.output_tokens[:-1])
        st["ctx_len"] = len(st["tokens"])
        st["completed_steps"] = step_idx + 1
        trace: ProgramTrace = st["trace"]
        rec = trace.steps[step_idx]
        self.apply_plan(
            self.sched.request_completed(pid, len(comp.output_tokens), end)
        )
        nxt = step_idx + 1
        if nxt < len(trace.steps) and nxt < st["max_steps"]:
            self._push(
                end + rec.tool_duration_s,
                lambda t, p=pid, n=nxt: self._issue(p, n, t),
            )
        else:
            self.apply_plan(self.sched.program_finished(pid, end))

    # ------------------------------------------------------ serialized mode
    def _drain_serial(self, now: float, allow_step: bool = True) -> None:
        """Pre-pump compatibility drain: run each released request to
        completion before touching the next event (``allow_step`` is a
        pump-signature stand-in; serialized replay never defers)."""
        del allow_step
        progress = True
        while progress:
            progress = False
            for pid in list(self._pending):
                if pid in self._dispatched:
                    self._finish_step_serial(pid, now)
                    progress = True

    def _finish_step_serial(self, pid: str, now: float) -> None:
        rs = self._rs
        st = rs.state[pid]
        req, step_idx = self._pending.pop(pid)
        act = self._dispatched.pop(pid)
        self._dispatch_time.pop(pid, None)
        eng = self.engines[act.replica]
        eng.submit(req)
        self._record_ttft(pid, step_idx)
        self.sched.notify_inference_started(pid, now)
        trace: ProgramTrace = st["trace"]
        rec = trace.steps[step_idx]
        before = eng.steps
        done = self._run_decode_serial(
            eng, act.replica, pid, req, rec.reasoning_wall_s, now
        )
        delta = eng.steps - before
        m = self.metrics
        m.pump_steps += delta
        m.sum_live_slots += delta     # serialized: one live slot per step
        if delta:
            m.peak_live_slots = max(m.peak_live_slots, 1)
        comp = next(c for c in done if c.program_id == pid)
        end = now + rec.reasoning_wall_s
        if self._async:
            self._advance_planes(end)
        self._complete_step(pid, step_idx, comp, end)

    def _run_decode_serial(
        self, eng, replica: int, pid: str, req, wall_s: float, now: float
    ):
        """Run the submitted request to completion. In async mode the
        decode steps spread over the virtual window [now, now+wall] and
        the transfer planes advance between steps — a copy chunk lands
        *during* decode exactly as the paper's overlap requires."""
        if not self._async:
            return eng.run_to_completion()
        n_est = max(1, req.max_new_tokens - 1)
        dt = wall_s / n_est if wall_s > 0 else 0.0
        t, done = now, []
        for _ in range(20_000):
            busy = self.planes[replica].in_flight()
            done.extend(eng.step())
            if busy:
                self.metrics.overlap_decode_steps += 1
            t = min(now + wall_s, t + dt)
            self._advance_planes(t)
            if any(c.program_id == pid for c in done):
                return done
        raise RuntimeError("decode did not complete")

    # --------------------------------------------------------- decode pump
    def _pump_all(self, now: float, allow_step: bool = True) -> None:
        """Advance every replica's decode batch at virtual time ``now``
        until the whole system settles (retires can release slots that
        admit gated programs on other replicas, so iterate to fixpoint).

        ``allow_step=False`` defers decode steps while another event at
        the same virtual instant is still pending in the replay heap —
        programs admitted by *separate* same-time events then share one
        batched step at the instant's final visit (the wake pushed at
        submit time guarantees that visit happens) instead of each
        stepping solo as its admission event drains. Retires and
        admissions always run; only stepping waits.
        """
        for _ in range(100_000):
            progress = False
            for r in range(len(self.engines)):
                progress |= self._pump_replica(r, now, allow_step)
            if not progress:
                return
        raise RuntimeError(
            f"decode pump did not settle at t={now:.3f}; "
            + self._stall_report()
        )

    def _pump_replica(self, r: int, now: float, allow_step: bool = True) -> bool:
        eng = self.engines[r]
        slots = self._pump_slots[r]
        acted = False

        # 1. retire slots whose virtual reasoning window has ended —
        #    deterministic order: window end, then batch-join sequence
        ready = sorted(
            (s for s in slots.values()
             if s.done is not None and s.end <= now + _EPS),
            key=lambda s: (s.end, s.seq),
        )
        for slot in ready:
            slots.pop(slot.pid, None)
            self._complete_step(slot.pid, slot.step_idx, slot.done, slot.end)
            acted = True

        # 2. admit released requests into free engine slots (release order)
        #    while other slots keep decoding — continuous batching's join
        for pid in list(self._dispatched):
            if pid not in self._pending:
                continue
            act = self._dispatched[pid]
            if act.replica != r:
                continue
            if eng.free_slot_count() <= 0:
                break
            self._submit_into_slot(pid, r, now)
            acted = True

        # 2b. advance chunked prefills — ONE budgeted chunk per slot per
        #     visit, so the settle loop interleaves due decode steps between
        #     chunks instead of stalling the batch behind a whole prefill.
        #     The pipeline drains within the admission instant (prefill is
        #     virtually instantaneous, like monolithic submit), and the slot
        #     only becomes step-eligible — and ``on_slot_freed``-relevant —
        #     once its final chunk lands.
        prefilling = sorted(
            (s for s in slots.values() if s.prefilling), key=lambda s: s.seq
        )
        for slot in prefilling:
            finished = eng.prefill_step(slot.prefill, self.prefill_token_budget)
            self.metrics.prefill_chunks += 1
            acted = True
            if finished:
                slot.prefill = None
                self._record_ttft(slot.pid, slot.step_idx)

        # 3. one batched decode step advancing every due slot together
        if not allow_step:
            return acted
        due = sorted(
            (s for s in slots.values()
             if s.done is None and not s.prefilling
             and s.next_due <= now + _EPS),
            key=lambda s: s.seq,
        )
        if due:
            busy = self.planes[r].in_flight()
            completions = eng.step(active=[s.engine_slot for s in due])
            m = self.metrics
            m.pump_steps += 1
            m.sum_live_slots += len(due)
            m.peak_live_slots = max(m.peak_live_slots, len(due))
            if len(due) >= 2:
                m.multi_slot_steps += 1
            if any(s.prefilling for s in slots.values()):
                # the chunked-prefill payoff: decode kept running while a
                # join was still mid-prefill on this replica
                m.prefill_interleaved_steps += 1
            if busy:
                m.overlap_decode_steps += 1
            for s in due:
                s.steps_taken += 1
                if s.dt > 0:
                    s.next_due = self._quantize(
                        s.start + s.steps_taken * s.dt, s.end
                    )
                    if s.next_due > now + _EPS:
                        self._wake(s.next_due)
                # dt == 0 (zero recorded wall): keep stepping this quantum
                # until the engine finishes the request
            freed = False
            for comp in completions:
                s = slots.get(comp.program_id)
                if s is not None and s.done is None:
                    s.done = comp
                    freed = True
                    if s.end > now + _EPS:
                        self._wake(s.end)
            if freed:
                # the engine slot opened mid-batch: let the scheduler
                # forward gated work into it right now, not at next tick
                self.apply_plan(self.sched.on_slot_freed(r, now))
            acted = True
        return acted

    def _submit_into_slot(self, pid: str, r: int, now: float) -> None:
        rs = self._rs
        req, step_idx = self._pending.pop(pid)
        self._dispatched.pop(pid)
        job = None
        if self.chunked_prefill:
            # two-phase admission: reserve the slot now, prefill in budgeted
            # chunks from the pump (stage 2b) while other slots keep decoding
            job = self.engines[r].begin_submit(req)
            sid = job.slot_id
        else:
            sid = self.engines[r].submit(req)
            self._record_ttft(pid, step_idx)
        self.sched.notify_inference_started(pid, now)
        rec = rs.state[pid]["trace"].steps[step_idx]
        wall = rec.reasoning_wall_s
        n_est = max(1, req.max_new_tokens - 1)
        dt = wall / n_est if wall > 0 else 0.0
        self._pump_slots[r][pid] = _PumpSlot(
            pid=pid, replica=r, engine_slot=sid, req=req, step_idx=step_idx,
            start=now, wall=wall, dt=dt, seq=next(self._slot_seq),
            next_due=now, prefill=job,
        )
        # guarantee a final same-instant pump visit: if stepping is being
        # deferred for same-time batching, this wake is where it happens
        self._wake(now)
        released = self._dispatch_time.pop(pid, now)
        wait = now - released
        if wait > _EPS:
            self.metrics.slot_wait_s += wait
            self.metrics.slot_waits += 1

    def _quantize(self, t: float, end: float) -> float:
        """Snap a due time up to the pump quantum grid (when configured) so
        co-resident slots with near-equal pacing share batched steps; never
        past the slot's window end, so retires stay on schedule."""
        q = self.pump_quantum_s
        if not q:
            return t
        return min(end, math.ceil(t / q - _EPS) * q)

    # -------------------------------------------------- stall/drain guards
    def _progress_vector(self) -> tuple:
        """Monotone counters that move whenever replay does real work."""
        m = self.metrics
        return (
            m.steps_completed, m.tokens_generated, m.pump_steps,
            m.offloaded_pages, m.reloaded_pages, m.nvme_reloaded_pages,
            m.cancelled_pages, m.cancelled_offloads, m.gated_events,
            m.recompute_submits, m.prefill_chunks,
            m.migrations, m.migrated_pages, m.requeued_slots,
            sum(e.steps for e in self.engines),
            sum(p.chunks_executed for p in self.planes),
        )

    def _outstanding_work(self) -> bool:
        return (
            bool(self._pending)
            or bool(self._dispatched)
            or any(self._pump_slots)
            or self._planes_busy()
        )

    def _drain_budget_s(self, state: dict[str, dict]) -> float:
        """Upper bound on the virtual time the outstanding work needs:
        every un-replayed trace step's reasoning + tool window, plus the
        pending transfer bytes over the slowest configured channel."""
        remaining = 0.0
        for st in state.values():
            tr: ProgramTrace = st["trace"]
            for rec in tr.steps[st["completed_steps"]:]:
                remaining += rec.reasoning_wall_s + rec.tool_duration_s
        pend = sum(p.pending_bytes() for p in self.planes)
        bw = min(
            self.xfer_cost.pcie_bytes_per_s, self.xfer_cost.ssd_bytes_per_s
        )
        xfer_s = (pend / bw + self.xfer_cost.fixed_latency_s) if pend else 0.0
        return remaining + xfer_s

    def _stall_report(self) -> str:
        """Name exactly what is still pending (for termination errors)."""
        parts = []
        if self._pending:
            gated = sorted(p for p in self._pending if p not in self._dispatched)
            if gated:
                parts.append(f"requests gated by the scheduler: {gated}")
            released = sorted(p for p in self._pending if p in self._dispatched)
            if released:
                parts.append(
                    f"requests released but awaiting an engine slot: {released}"
                )
        for r, slots in enumerate(self._pump_slots):
            if slots:
                desc = [
                    f"{s.pid}(step {s.step_idx}, {s.steps_taken} decode steps,"
                    + (" prefilling," if s.prefilling else "")
                    + f" window ends t={s.end:.3f})"
                    for s in sorted(slots.values(), key=lambda s: s.seq)
                ]
                parts.append(f"replica {r} resident slots: {desc}")
        for r, plane in enumerate(self.planes):
            jobs = plane.describe_jobs()
            if jobs:
                parts.append(f"replica {r} transfers in flight: {jobs}")
        return "; ".join(parts) if parts else "no outstanding work recorded"


def snapshot_state(router: MoriRouter) -> dict:
    """Serializable control-plane snapshot (fault tolerance / restart).

    Delegates to :func:`repro_torch.serving.state_io.control_plane_state` — the
    single source of truth for the snapshot schema (program table, per-
    replica tier usage, live decode-slot occupancy)."""
    from repro_torch.serving.state_io import control_plane_state

    return control_plane_state(router)
