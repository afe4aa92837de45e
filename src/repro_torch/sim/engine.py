"""Discrete-event simulator replaying agentic traces against a scheduler.

The port's copy of ``repro/sim/engine.py`` (pure Python: the port keeps
its own copy, as it keeps ``core/``), importing the port's ``core`` and
``sim`` modules.

Reproduces the paper's evaluation methodology (§6.1): each concurrency slot
is a closed-loop client that replays one trace — send a request, wait for the
response, sleep the recorded tool-call duration, repeat; when a trace ends the
slot immediately starts the next one. The serving side models each replica
with a roofline decode-step cost (``repro_torch.sim.hardware``), a FIFO prefill
queue with chunked-prefill interference, and full-duplex PCIe + NVMe transfer
channels that overlap compute.

The scheduler under test is *real* policy code from ``repro_torch.core``: every
lifecycle event returns a :class:`~repro_torch.core.actions.PlacementPlan`, the
simulator executes it through :meth:`Simulation.apply_plan`, and each
finished transfer is acknowledged back via
``scheduler.on_transfer_complete`` — the same plan/ack protocol the real
serving router speaks, so MORI and every baseline run identical code in both
worlds. Every transfer-bearing action (``Offload``, reloading ``Forward``,
``Migrate``) is lowered through the endpoint-addressed
:class:`~repro_torch.core.transfers.CopyRequest` API, so sizing, channel choice
and the executing replica come from the copy's *endpoints*, not from
per-action-kind simulator code.

The PCIe/NVMe queue model itself lives in ``repro_torch.core.transfers``
(:class:`TransferChannels`) and is shared with the real serving path's
:class:`~repro_torch.serving.transfer_plane.ReplicaTransferPlane`: here each
transfer is one single-chunk (fluid) job whose completion event lands in
the simulator's heap; the real plane runs the same queues chunked at page
granularity.
"""
from __future__ import annotations

import heapq
import itertools
import random
import time as _time
from collections import deque
from dataclasses import dataclass

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
from repro_torch.core.transfers import CopyJob, TransferChannels, copy_request_for
from repro_torch.core.types import ProgramTrace, Tier, TransferCost
from repro_torch.sim.hardware import HwConfig
from repro_torch.sim.metrics import SimResult, percentile


@dataclass
class _Request:
    pid: str
    slot: int
    step_idx: int
    input_tokens: int
    output_tokens: int
    tool_duration_s: float
    arrival: float
    prefill_tokens: int = 0
    reload_bytes: int = 0
    kv_context_tokens: int = 0   # tokens whose KV must be read during decode
    remaining: float = 0.0
    first_token_at: float | None = None


class _Replica:
    """Fluid-rate model of one engine replica."""

    def __init__(self, rid: int, hw: HwConfig, sim: "Simulation"):
        self.rid = rid
        self.hw = hw
        self.sim = sim
        self.alive = True
        self.decode: dict[str, _Request] = {}
        self.prefill_active: _Request | None = None
        self.prefill_remaining = 0.0
        self.prefill_q: deque[_Request] = deque()
        # PCIe + NVMe copy queues: the shared single-chunk (fluid) model;
        # completions land straight in the simulator's event heap
        self.channels = TransferChannels(
            cost=sim.xfer_cost, schedule=sim.at, on_done=self._transfer_done
        )
        self.version = 0
        self.last_settle = 0.0
        self.busy_accum = 0.0
        self.overlap_accum = 0.0
        self.step_samples = 0

    # --------------------------------------------------------------- decode
    def step_time(self) -> float:
        kv_bytes = sum(
            r.kv_context_tokens * self.hw.kv_bytes_per_token
            for r in self.decode.values()
        )
        t = self.hw.decode_step_time(len(self.decode), kv_bytes)
        if self.prefill_active is not None:
            t *= self.hw.prefill_interference
        return t

    def settle(self, now: float) -> None:
        dt = now - self.last_settle
        if dt < 0:
            return
        if self.decode or self.prefill_active is not None:
            self.busy_accum += dt
            if self.channels.in_flight():
                # paper §6.2 "masked by GPU-CPU overlap": compute time
                # during which a KV transfer was concurrently in flight
                self.overlap_accum += dt
        if self.decode and dt > 0:
            tokens = dt / self.step_time()
            for r in self.decode.values():
                r.remaining -= tokens
                r.kv_context_tokens += tokens  # KV grows as tokens generate
        self.last_settle = now

    def reschedule(self, now: float) -> None:
        """Schedule the next decode completion (versioned against staleness)."""
        self.version += 1
        if not self.decode:
            return
        v = self.version
        min_rem = min(r.remaining for r in self.decode.values())
        eta = now + max(0.0, min_rem) * self.step_time()
        self.sim.at(eta, lambda t: self.on_decode_event(t, v))

    def on_decode_event(self, now: float, version: int) -> None:
        if version != self.version or not self.alive:
            return
        self.settle(now)
        done = [r for r in self.decode.values() if r.remaining <= 1e-9]
        for r in done:
            del self.decode[r.pid]
            self.sim.complete_request(r, now)
        self.reschedule(now)

    def add_decode(self, req: _Request, now: float) -> None:
        self.settle(now)
        req.remaining = float(req.output_tokens)
        if req.first_token_at is None:
            req.first_token_at = now
        self.decode[req.pid] = req
        self.reschedule(now)

    # -------------------------------------------------------------- prefill
    def enqueue_prefill(self, req: _Request, now: float) -> None:
        self.prefill_q.append(req)
        if self.prefill_active is None:
            self.start_next_prefill(now)

    def start_next_prefill(self, now: float) -> None:
        self.settle(now)
        if self.prefill_active is not None or not self.prefill_q:
            self.reschedule(now)
            return
        req = self.prefill_q.popleft()
        self.sim.sched.notify_inference_started(req.pid, now)
        if req.prefill_tokens <= 0:
            self.prefill_active = None
            self.finish_prefill(req, now)
            return
        self.prefill_active = req
        dur = req.prefill_tokens / self.hw.prefill_rate
        self.reschedule(now)  # decode slows down under interference
        self.sim.at(now + dur, lambda t: self.on_prefill_done(req, t))

    def on_prefill_done(self, req: _Request, now: float) -> None:
        if not self.alive or self.prefill_active is not req:
            return
        self.settle(now)
        self.prefill_active = None
        self.finish_prefill(req, now)
        self.start_next_prefill(now)

    def finish_prefill(self, req: _Request, now: float) -> None:
        req.first_token_at = now
        self.sim.record_ttft(req, now)
        self.add_decode(req, now)

    # ------------------------------------------------------------ transfers
    # which channel a given action bills is decided once, by
    # core.ledger.channel_for; the FIFO/serialization model itself lives in
    # core.transfers (shared with the real serving transfer plane)
    def _transfer_done(self, job: CopyJob, now: float) -> None:
        if not self.alive:
            return
        # acknowledge the ledger record; the scheduler may emit follow-ups
        self.sim.apply_plan(
            self.sim.sched.on_transfer_complete(job.pid, job.action_id, now)
        )
        if job.payload is not None:  # reload completed -> proceed to prefill
            self.enqueue_prefill(job.payload, now)

    def cancel_transfer(self, target_action_id: int) -> bool:
        """Drop a still-queued transfer. An already-active transfer is left
        to finish: offloads copy rather than move, so the late completion
        is wasted bandwidth, not a correctness problem (the scheduler has
        already closed the ledger record and ignores the stale ack)."""
        return self.channels.cancel_queued(target_action_id) is not None

    def fail(self, now: float) -> None:
        self.settle(now)
        self.alive = False
        self.decode.clear()
        self.prefill_active = None
        self.prefill_q.clear()
        self.channels.reset()
        self.version += 1

    def recover(self, now: float) -> None:
        self.settle(now)
        self.alive = True


@dataclass
class FaultPlan:
    """Inject a replica failure at ``fail_at`` and recover at ``recover_at``."""

    replica: int
    fail_at: float
    recover_at: float | None = None


class Simulation:
    """Closed-loop trace replay against one scheduler policy."""

    def __init__(
        self,
        scheduler: str,
        hw: HwConfig,
        corpus: list[ProgramTrace],
        *,
        num_replicas: int = 1,
        placement: "object | None" = None,   # repro_torch.dist.ReplicaSet
        concurrency_per_replica: int = 20,
        cpu_ratio: float = 1.0,
        ssd_ratio: float = 0.0,
        duration_s: float = 600.0,
        warmup_s: float = 60.0,
        seed: int = 0,
        sched_config: SchedulerConfig | None = None,
        faults: list[FaultPlan] | None = None,
        reuse_corpus: bool = True,
        record_plans: bool = False,
    ):
        # a ReplicaSet pins the simulated fleet to a concrete device layout:
        # replica count comes from the placement; the set stays on the
        # Simulation so callers can read layout provenance (e.g.
        # sim.placement.rules.fallbacks) alongside the SimResult
        self.placement = placement
        if placement is not None:
            num_replicas = placement.num_replicas
        self.hw = hw
        self.corpus = corpus
        self.duration = duration_s
        self.warmup = warmup_s
        self.rng = random.Random(seed)
        self.xfer_cost = TransferCost(pcie_bytes_per_s=hw.pcie_bw)
        cap = TierCapacity(
            hw.gpu_kv_bytes,
            int(hw.gpu_kv_bytes * cpu_ratio),
            int(hw.gpu_kv_bytes * ssd_ratio),
        )
        self.sched_config = sched_config or SchedulerConfig()
        if ssd_ratio > 0 and not self.sched_config.ssd_bytes_per_s:
            # calibrate the cost-aware SSD guard from the hardware model
            self.sched_config.ssd_bytes_per_s = self.xfer_cost.ssd_bytes_per_s
            self.sched_config.recompute_tok_per_s = hw.prefill_rate
        self.sched = SCHEDULERS[scheduler](num_replicas, cap, self.sched_config)
        self.scheduler_name = scheduler
        self.replicas = [_Replica(i, hw, self) for i in range(num_replicas)]
        self.n_slots = num_replicas * concurrency_per_replica
        self.faults = faults or []
        # reuse_corpus=False runs each trace exactly once under its own
        # program id — finite-replay mode for golden cross-runtime tests;
        # freed slots pick up the next unplayed trace until the corpus drains
        self.reuse_corpus = reuse_corpus
        self._finite_next = 0
        self.record_plans = record_plans
        self.action_log: list[Action] = []

        # event queue
        self._q: list[tuple[float, int, object]] = []
        self._seq = itertools.count()
        self.now = 0.0

        # per-program replay state
        self._pending: dict[str, _Request] = {}
        self._last_ctx: dict[str, int] = {}
        self._slot_trace: dict[int, int] = {}
        self._slot_gen: dict[int, int] = {}

        # metrics
        self.completed_tokens = 0
        self.completed_tokens_measured = 0
        self.completed_steps = 0
        self.completed_steps_measured = 0
        self.ttfts: list[float] = []
        self.forwards = 0
        self.warm_forwards = 0
        self.reload_forwards = 0
        self.recompute_forwards = 0
        self.cancelled_transfers = 0
        self.migrations = 0
        self.tick_overhead_s: list[float] = []
        self.tick_actions: list[int] = []
        self.finished_programs: list[dict] = []

    # ------------------------------------------------------------ EventQ
    def at(self, t: float, fn) -> None:
        heapq.heappush(self._q, (t, next(self._seq), fn))

    # ------------------------------------------------------- plan executor
    def apply_plan(self, plan: PlacementPlan) -> None:
        """Execute a scheduler-emitted plan against the modeled hardware.

        ``SetLabel`` is a no-op here (no block level to restamp), and
        ``Discard`` carries no byte accounting (that lives in the
        scheduler) — but it does cancel the program's still-queued
        transfers, mirroring the real router's Discard path.
        """
        if self.record_plans and plan.actions:
            self.action_log.extend(plan.actions)
        for act in plan:
            if isinstance(act, Forward):
                self._exec_forward(act)
            elif isinstance(act, Offload):
                self._exec_offload(act)
            elif isinstance(act, Discard):
                self._exec_discard(act)
            elif isinstance(act, CancelTransfer):
                self._exec_cancel(act)
            elif isinstance(act, Migrate):
                self._exec_migrate(act)
            elif isinstance(act, SetLabel):
                pass  # no block level to restamp in the simulator
            else:
                raise ValueError(f"unhandled plan action: {act!r}")

    def _exec_forward(self, act: Forward) -> None:
        req = self._pending.get(act.pid)
        if req is None:
            return
        rep = self.replicas[act.replica]
        if not rep.alive:
            return  # scheduler will re-place after replica_failed
        prior = 0 if act.recompute else self._last_ctx.get(act.pid, 0)
        req.prefill_tokens = max(0, req.input_tokens - prior)
        req.kv_context_tokens = req.input_tokens
        self.forwards += 1
        if act.recompute:
            self.recompute_forwards += 1
            rep.enqueue_prefill(req, self.now)
        elif act.source_tier in (Tier.CPU, Tier.SSD):
            self.reload_forwards += 1
            req.reload_bytes = act.nbytes
            # SSD-sourced reloads (§7.1 extension) bill the NVMe channel
            # (CopyRequest.channel reads it off the source endpoint)
            self._exec_copy(act, payload=req)
        else:
            self.warm_forwards += 1
            rep.enqueue_prefill(req, self.now)

    def _exec_copy(self, act, payload: object = None) -> None:
        """One executor for every transfer-bearing action: lower to the
        endpoint-addressed :class:`CopyRequest` and enqueue on the replica
        whose channel serializes the copy — the channel billed and the
        executing side are derived from the endpoints, not the action
        class."""
        creq = copy_request_for(act)
        self.replicas[creq.exec_replica].channels.enqueue(
            creq.job(payload), self.now
        )

    def _exec_offload(self, act: Offload) -> None:
        if not self.replicas[act.replica].alive or act.nbytes <= 0:
            return
        self._exec_copy(act)

    def _exec_discard(self, act: Discard) -> None:
        """An evicted program's still-queued transfers must not outlive
        its KV: drop them and close their ledger records, so a later
        ``open_offload`` cannot match a stale record from a previous
        residency (parity with the real router's Discard path). A
        transfer already *on the wire* is left to finish — its ack closes
        the record as usual."""
        if act.replica is None:
            return
        rep = self.replicas[act.replica]
        for rec in self.sched.ledger.in_flight(replica=act.replica):
            if rec.pid == act.pid and rep.cancel_transfer(rec.action_id):
                self.sched.ledger.cancel(rec.action_id)

    def _exec_cancel(self, act: CancelTransfer) -> None:
        if self.replicas[act.replica].cancel_transfer(act.target_action_id):
            self.cancelled_transfers += 1

    def _exec_migrate(self, act: Migrate) -> None:
        """Cross-replica DRAM move: serialized on the destination replica's
        PCIe/ingest channel (``CopyRequest.exec_replica``)."""
        if not self.replicas[act.dst_replica].alive or act.nbytes <= 0:
            return
        self.migrations += 1
        self._exec_copy(act)

    # ------------------------------------------------------------ clients
    def _start_trace(self, slot: int, now: float) -> None:
        if not self.reuse_corpus:
            if self._finite_next >= len(self.corpus):
                return  # corpus drained: every trace ran exactly once
            trace = self.corpus[self._finite_next]
            self._finite_next += 1
            pid = trace.program_id
        else:
            idx = self._slot_trace.setdefault(slot, slot % len(self.corpus))
            gen = self._slot_gen.get(slot, 0)
            trace = self.corpus[idx % len(self.corpus)]
            pid = f"s{slot}g{gen}-{trace.program_id}"
            self._slot_trace[slot] = idx + self.n_slots  # stride through corpus
            self._slot_gen[slot] = gen + 1
        self.sched.program_arrived(
            pid, self.hw.kv_bytes_per_token, now,
            wire_bytes_per_token=self.hw.kv_wire_bytes_per_token,
        )
        self._issue(pid, trace, 0, slot, now)

    def _issue(
        self, pid: str, trace: ProgramTrace, step_idx: int, slot: int, now: float
    ) -> None:
        rec = trace.steps[step_idx]
        req = _Request(
            pid=pid,
            slot=slot,
            step_idx=step_idx,
            input_tokens=rec.input_tokens,
            output_tokens=rec.output_tokens,
            tool_duration_s=rec.tool_duration_s,
            arrival=now,
        )
        req.trace = trace  # type: ignore[attr-defined]
        self._pending[pid] = req
        self.apply_plan(self.sched.request_arrived(pid, rec.input_tokens, now))

    def complete_request(self, req: _Request, now: float) -> None:
        self._pending.pop(req.pid, None)
        self._last_ctx[req.pid] = req.input_tokens + req.output_tokens
        self.completed_tokens += req.output_tokens
        self.completed_steps += 1
        if now >= self.warmup:
            self.completed_tokens_measured += req.output_tokens
            self.completed_steps_measured += 1
        self.apply_plan(self.sched.request_completed(req.pid, req.output_tokens, now))
        trace: ProgramTrace = req.trace  # type: ignore[attr-defined]
        nxt = req.step_idx + 1
        if nxt < len(trace.steps):
            self.at(
                now + req.tool_duration_s,
                lambda t, p=req.pid, tr=trace, n=nxt, s=req.slot: self._issue(
                    p, tr, n, s, t
                ),
            )
        else:
            prog = self.sched.programs.get(req.pid)
            if prog is not None:
                self.finished_programs.append(
                    {
                        "pid": req.pid,
                        "switches": prog.metrics.replica_switches,
                        "evictions": prog.metrics.evictions,
                        "gated_s": prog.metrics.gated_time_s,
                    }
                )
            self.apply_plan(self.sched.program_finished(req.pid, now))
            self._last_ctx.pop(req.pid, None)
            if now < self.duration:
                self.at(now + 1.0, lambda t, s=req.slot: self._start_trace(s, t))

    def record_ttft(self, req: _Request, now: float) -> None:
        if now >= self.warmup:
            self.ttfts.append(now - req.arrival)

    # ---------------------------------------------------------------- run
    def run(self) -> SimResult:
        stagger = 2.0 / max(1, self.n_slots)
        for slot in range(self.n_slots):
            self.at(slot * stagger, lambda t, s=slot: self._start_trace(s, t))

        def tick(t: float) -> None:
            w0 = _time.perf_counter()
            plan = self.sched.tick(t)
            self.tick_overhead_s.append(_time.perf_counter() - w0)
            self.tick_actions.append(len(plan))
            self.apply_plan(plan)
            if t + self.sched_config.tick_interval_s <= self.duration:
                self.at(t + self.sched_config.tick_interval_s, tick)

        self.at(self.sched_config.tick_interval_s, tick)

        for f in self.faults:
            self.at(f.fail_at, lambda t, f=f: self._fail(f.replica, t))
            if f.recover_at is not None:
                self.at(f.recover_at, lambda t, f=f: self._recover(f.replica, t))

        while self._q:
            t, _, fn = heapq.heappop(self._q)
            if t > self.duration:
                break
            self.now = t
            fn(t)
        for rep in self.replicas:
            rep.settle(min(self.duration, self.now))
        return self._result()

    def _fail(self, rid: int, now: float) -> None:
        self.replicas[rid].fail(now)
        self.apply_plan(self.sched.replica_failed(rid, now))

    def _recover(self, rid: int, now: float) -> None:
        self.replicas[rid].recover(now)
        self.sched.replica_recovered(rid)

    # ------------------------------------------------------------- metrics
    def _result(self) -> SimResult:
        span = max(1e-9, self.duration - self.warmup)
        switched = [p for p in self.finished_programs if p["switches"] > 0]
        nprog = max(1, len(self.finished_programs))
        util = [
            rep.busy_accum / max(1e-9, min(self.duration, self.now))
            for rep in self.replicas
        ]
        resumes = self.warm_forwards + self.reload_forwards + self.recompute_forwards
        return SimResult(
            scheduler=self.scheduler_name,
            hw=self.hw.name,
            duration_s=self.duration,
            output_tok_per_s=self.completed_tokens_measured / span,
            steps_per_s=self.completed_steps_measured / span,
            ttft_avg_s=sum(self.ttfts) / max(1, len(self.ttfts)),
            ttft_p50_s=percentile(self.ttfts, 0.5),
            ttft_p90_s=percentile(self.ttfts, 0.9),
            ttft_p99_s=percentile(self.ttfts, 0.99),
            gpu_util=sum(util) / max(1, len(util)),
            cache_hit_rate=(
                (self.warm_forwards + self.reload_forwards) / resumes if resumes else 0.0
            ),
            churn_frac=len(switched) / nprog,
            switches_per_program=(
                sum(p["switches"] for p in self.finished_programs) / nprog
            ),
            programs_finished=len(self.finished_programs),
            steps_completed=self.completed_steps,
            tick_avg_ms=(
                1e3 * sum(self.tick_overhead_s) / max(1, len(self.tick_overhead_s))
            ),
            tick_p99_ms=1e3 * percentile(self.tick_overhead_s, 0.99),
            xfer_overlap_frac=(
                sum(r.overlap_accum for r in self.replicas)
                / max(1e-9, sum(r.busy_accum for r in self.replicas))
            ),
        )
