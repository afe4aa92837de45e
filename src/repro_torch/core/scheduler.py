"""MORI scheduling policy (paper §4.3): sticky rebalancing over three tiers.

The scheduler is runtime-agnostic and *declarative*: it consumes program
lifecycle events and every event returns a :class:`PlacementPlan` — an
ordered, immutable batch of typed actions (``Forward`` / ``Offload`` /
``Discard`` / ``Migrate`` / ``SetLabel`` / ``CancelTransfer``) that the
runtime executes through its own ``apply_plan`` executor. The
discrete-event simulator (``repro.sim``) and the real JAX serving engine
(``repro_torch.serving``) both drive *this exact code* — the policy is
implemented once, and because plans are data, tests can assert exact
action sequences from both runtimes on the same trace.

Event flow (runtime -> scheduler; every call returns a PlacementPlan
unless noted):
    program_arrived -> request_arrived -> notify_inference_started
      -> request_completed -> [tool call] -> request_arrived -> ...
      -> program_finished
    tick(now) runs the periodic control loop (default every 5 s).
    replica_failed / replica_recovered track fleet membership.
    on_transfer_complete(pid, action_id, now) acknowledges a transfer the
      runtime finished executing; the scheduler closes the matching
      :class:`TransferLedger` record.

Transfers are asynchronous: when the scheduler emits an ``Offload``, a
reloading ``Forward``, or a ``Migrate``, it opens a ledger record for the
bytes on the PCIe or NVMe channel and the runtime acknowledges completion
later. Until that acknowledgement the scheduler *knows* the source copy is
still intact — which is how an offload gets cancelled (``CancelTransfer``)
when a tool call returns early, re-admitting the program warm instead of
paying a host round trip.
"""
from __future__ import annotations

import abc

from repro_torch.core.actions import (
    Action,
    CancelTransfer,
    Discard,
    Forward,
    Migrate,
    Offload,
    PlacementPlan,
    SetLabel,
    _coalesce,
)
from repro_torch.core.balancer import ReplicaBalancer
from repro_torch.core.ledger import TransferLedger, TransferRecord, channel_for
from repro_torch.core.program import ProgramState
from repro_torch.core.tiers import ReplicaTiers, WaitingQueue
from repro_torch.core.types import (
    SchedulerConfig,
    Status,
    Tier,
    TierCapacity,
    TypeLabel,
)


class AgentScheduler(abc.ABC):
    """Shared event API for MORI and all baselines (SMG / TA / TA+O).

    Subclasses implement the ``_on_*`` hooks and emit actions through the
    ``_emit_*`` helpers; the public event methods wrap each hook and drain
    the staged actions into the returned :class:`PlacementPlan`.
    """

    name: str = "base"

    def __init__(
        self,
        num_replicas: int,
        capacity: TierCapacity,
        config: SchedulerConfig | None = None,
    ):
        self.config = config or SchedulerConfig()
        self.replicas = [
            ReplicaTiers(replica_id=i, capacity=capacity) for i in range(num_replicas)
        ]
        self.waiting = WaitingQueue()
        self.programs: dict[str, ProgramState] = {}
        self.balancer = ReplicaBalancer(self.replicas, self.config)
        self.ledger = TransferLedger()
        self._running: dict[int, set[str]] = {i: set() for i in range(num_replicas)}
        self._staged: list[Action] = []
        self._next_action_id = 1
        self._now = 0.0
        # optional runtime occupancy probe: replica -> (free_slots, live
        # slots) read straight from the engine. When attached (the real
        # router's decode pump), _has_slot/running_count reflect *actual*
        # engine batch occupancy instead of the scheduler's shadow
        # bookkeeping; when absent (simulator, serial replay) behavior is
        # unchanged.
        self._slot_probe: "object | None" = None
        # programs admitted to the GPU queue whose KV has *not* been moved
        # yet (no free engine slot at admission time): maps pid -> the tier
        # the bytes still physically occupy, so the eventual Forward carries
        # the true source instead of pretending the KV is warm.
        self._pending_source: dict[str, Tier] = {}

    # -------------------------------------------------------------- events
    def program_arrived(
        self,
        pid: str,
        kv_bytes_per_token: int,
        now: float,
        wire_bytes_per_token: int | None = None,
    ) -> ProgramState:
        """Register a new program (emits no actions).

        ``wire_bytes_per_token`` is the per-token size in the *offload*
        format — what transfers and host tiers actually carry when pages
        quantize on offload. ``None`` (the default) means the offload
        format equals the device format and every byte figure collapses
        to ``kv_bytes_per_token``, reproducing pre-format accounting
        exactly."""
        prog = ProgramState(pid, kv_bytes_per_token, arrived_at=now)
        prog.wire_bytes_per_token = wire_bytes_per_token
        prog.set_window(self.config.idleness_window)
        self.programs[pid] = prog
        self.waiting.add(prog)
        return prog

    def request_arrived(self, pid: str, input_tokens: int, now: float) -> PlacementPlan:
        self._now = now
        self._on_request_arrived(pid, input_tokens, now)
        return self._drain(now)

    def notify_inference_started(self, pid: str, now: float) -> None:
        """The runtime started executing a forwarded request (no actions)."""
        prog = self.programs[pid]
        prog.begin_reasoning(now)
        if prog.replica is not None:
            self._running[prog.replica].add(pid)

    def request_completed(self, pid: str, output_tokens: int, now: float) -> PlacementPlan:
        self._now = now
        self._on_request_completed(pid, output_tokens, now)
        return self._drain(now)

    def program_finished(self, pid: str, now: float) -> PlacementPlan:
        self._now = now
        prog = self.programs.pop(pid, None)
        if prog is not None:
            prog.finished = True
            if prog.replica is not None:
                self._running[prog.replica].discard(pid)
            self._release(prog)
            self.ledger.drop_pid(pid)
        return self._drain(now)

    def tick(self, now: float) -> PlacementPlan:
        self._now = now
        self._on_tick(now)
        return self._drain(now)

    def on_transfer_complete(self, pid: str, action_id: int, now: float) -> PlacementPlan:
        """Runtime acknowledgement that a transfer finished. Closes the
        ledger record; unknown ids (cancelled, or dropped with a failed
        replica) are tolerated. Policies react to landed bytes through the
        ``_on_transfer_complete`` hook (e.g. promoting a migrated program
        only once its DRAM copy physically exists on the destination)."""
        self._now = now
        rec = self.ledger.complete(action_id)
        if rec is not None:
            self._on_transfer_complete(rec, now)
        return self._drain(now)

    def _on_transfer_complete(self, rec: TransferRecord, now: float) -> None:
        """Policy hook: the transfer behind ``rec`` has fully landed."""

    def on_slot_freed(self, replica: int, now: float) -> PlacementPlan:
        """Runtime notification that an engine decode slot freed mid-batch
        (a resident program finished its step while others keep decoding).
        Policies use the hook to forward gated work into the freed slot
        immediately instead of waiting for the next tick."""
        self._now = now
        self._on_slot_freed(replica, now)
        return self._drain(now)

    def _on_slot_freed(self, replica: int, now: float) -> None:
        """Policy hook: a decode slot on ``replica`` is free again."""

    @abc.abstractmethod
    def _on_request_arrived(self, pid: str, input_tokens: int, now: float) -> None:
        ...

    @abc.abstractmethod
    def _on_request_completed(self, pid: str, output_tokens: int, now: float) -> None:
        ...

    @abc.abstractmethod
    def _on_tick(self, now: float) -> None:
        ...

    # ------------------------------------------------------- fault handling
    def replica_failed(self, replica_id: int, now: float) -> PlacementPlan:
        """Replica failure / drain: the GPU is gone but host DRAM is still
        readable (the drain model — a dying node's device is what failed).

        With ``drain_migrate`` (default on), DRAM-resident programs whose
        bytes have fully landed (no open offload or migrate) are *migrated*
        to the healthy replica with the most host headroom
        (:meth:`ReplicaBalancer.place_drain`) instead of being discarded —
        they re-admit with a reload instead of a full recompute. Everything
        else (GPU-resident KV, half-written offloads) drops to the Waiting
        queue via the normal recompute path — MORI's Waiting-tier
        semantics, which is what makes the design restart-tolerant. The
        returned plan carries the ``Migrate`` per drained program and a
        ``Discard`` per lost KV copy (one per program and tier)."""
        self._now = now
        rep = self.replicas[replica_id]
        self.balancer.mark_failed(replica_id)
        if self.config.drain_migrate:
            for prog in list(rep.cpu.values()):
                if prog.finished:
                    continue
                if (
                    self.ledger.open_offload(prog.program_id) is not None
                    or self.ledger.open_migrate(prog.program_id) is not None
                ):
                    # bytes still in flight toward (or away from) this DRAM
                    # copy die with the node: not trustworthy to migrate
                    continue
                decision = self.balancer.place_drain(prog, now)
                if not decision:
                    continue
                dst = self.replicas[decision.replica]
                rep.cpu_remove(prog)
                self._emit_migrate(prog, replica_id, dst.replica_id)
                dst.cpu_admit(prog)
                prog.metrics.replica_switches += 1
                prog.dispatched = False
                prog.lazy_demote = False
                self._pending_source.pop(prog.program_id, None)
        for tier, prog in rep.evict_all():
            self._emit_discard(prog.program_id, replica_id, tier)
            self.waiting.add(prog)
            prog.metrics.evictions += 1
            prog.dispatched = False  # any in-flight forward died with the node
            prog.lazy_demote = False
            self._pending_source.pop(prog.program_id, None)
        for pid in list(self._running[replica_id]):
            self._running[replica_id].discard(pid)
            prog = self.programs.get(pid)
            if prog is not None and not prog.finished:
                prog.gate(now)  # in-flight request will be re-issued
        self.ledger.drop_replica(replica_id)
        return self._drain(now)

    def replica_recovered(self, replica_id: int) -> None:
        self.balancer.mark_recovered(replica_id)

    # ------------------------------------------------------------- queries
    def replica_of(self, pid: str) -> int | None:
        prog = self.programs.get(pid)
        return prog.replica if prog else None

    def attach_slot_probe(self, probe) -> None:
        """Install ``probe(replica) -> (free_slots, live_slots)`` so slot
        gating and ``running_count`` read real engine occupancy. Pass
        ``None`` to detach and fall back to shadow bookkeeping.

        Occupancy contract: the live side counts every slot a program
        *owns*, including slots still mid-prefill under the router's
        chunked-prefill mode (``Engine.begin_submit`` reserves the slot
        before any chunk runs) — a prefilling program must gate further
        admissions exactly like a decoding one, and the probe owner only
        reports a slot free again once the chunk pipeline drained and the
        program retired."""
        self._slot_probe = probe

    def running_count(self, replica: int) -> int:
        if self._slot_probe is not None:
            return self._slot_probe(replica)[1]
        return len(self._running[replica])

    def _has_slot(self, replica: int | None) -> bool:
        """Can ``replica`` take one more forwarded request right now?

        With a slot probe attached the answer is the engine's own free-slot
        count (minus requests already released but not yet submitted — the
        probe owner accounts for those); otherwise the optional
        ``max_running`` cap against the shadow running set, and unbounded
        when no cap is configured (the pre-probe behavior every scheduler
        shared)."""
        if replica is None:
            return False
        cap = self.config.max_running
        if cap is not None and self.running_count(replica) >= cap:
            return False
        if self._slot_probe is not None:
            free, _ = self._slot_probe(replica)
            return free > 0
        return True

    # ----------------------------------------------------------- emission
    def _drain(self, now: float) -> PlacementPlan:
        actions, self._staged = _coalesce(self._staged), []
        return PlacementPlan(now=now, actions=tuple(actions))

    def _next_id(self) -> int:
        aid = self._next_action_id
        self._next_action_id += 1
        return aid

    def _emit_forward(
        self, prog: ProgramState, source_tier: Tier, recompute: bool = False
    ) -> None:
        prog.dispatched = True
        # a reload moves only the KV that was actually materialized before
        # the offload — not the new input tokens the engine has yet to see —
        # and it moves it in the offload format (wire bytes, not device bytes)
        nbytes = (
            prog.materialized_wire_bytes
            if source_tier in (Tier.CPU, Tier.SSD) else 0
        )
        act = Forward(
            self._next_id(), prog.program_id, prog.replica,
            source_tier, recompute, nbytes,
        )
        if nbytes:
            prog.metrics.reloaded_bytes += nbytes
            self.ledger.open(TransferRecord(
                act.action_id, prog.program_id, prog.replica, "reload",
                channel_for(source_tier), nbytes, source_tier, Tier.GPU,
                self._now,
            ))
        self._staged.append(act)

    def _emit_offload(self, prog: ProgramState, src_tier: Tier, dst_tier: Tier) -> None:
        # like reloads, offloads move only the KV that physically exists —
        # context growth from a not-yet-prefilled input has no pages to copy —
        # and the copy on the wire carries the offload format's payload
        act = Offload(
            self._next_id(), prog.program_id, prog.replica,
            src_tier, dst_tier, prog.materialized_wire_bytes,
        )
        if act.nbytes:
            # offloads bill the channel the bytes are *read* from: SSD-bound
            # writes are staged through host DRAM, so the device/host DMA is
            # the contended resource, while the NVMe channel is reserved for
            # latency-critical reads (reloading Forwards)
            self.ledger.open(TransferRecord(
                act.action_id, prog.program_id, prog.replica, "offload",
                channel_for(src_tier), act.nbytes, src_tier, dst_tier,
                self._now,
            ))
        self._staged.append(act)

    def _emit_discard(self, pid: str, replica: int | None, tier: Tier) -> None:
        self._staged.append(Discard(self._next_id(), pid, replica, tier))

    def _emit_migrate(self, prog: ProgramState, src: int, dst: int) -> None:
        # a migrate ships the DRAM copy, which is stored in offload format
        act = Migrate(
            self._next_id(), prog.program_id, src, dst,
            prog.materialized_wire_bytes,
        )
        if act.nbytes:
            self.ledger.open(TransferRecord(
                act.action_id, prog.program_id, dst, "migrate",
                channel_for(Tier.CPU), act.nbytes, Tier.CPU, Tier.CPU,
                self._now,
            ))
        self._staged.append(act)

    def _emit_cancel(self, pid: str, rec: TransferRecord) -> None:
        self.ledger.cancel(rec.action_id)
        self._staged.append(
            CancelTransfer(self._next_id(), pid, rec.replica, rec.action_id)
        )

    def _set_label(self, prog: ProgramState, label: TypeLabel) -> None:
        if prog.label is not label:
            prog.label = label
            self._staged.append(
                SetLabel(self._next_id(), prog.program_id, prog.replica, label)
            )

    # ------------------------------------------------------------ plumbing
    def _release(self, prog: ProgramState) -> None:
        """Drop a program's KV from wherever it lives."""
        for rep in self.replicas:
            tier = rep.evict(prog)
            if tier is not None:
                self._emit_discard(prog.program_id, rep.replica_id, tier)
        self.waiting.remove(prog)
        self._pending_source.pop(prog.program_id, None)
        prog.tier = Tier.NONE
        prog.replica = None

    def _account_growth(self, prog: ProgramState, new_tokens: int) -> None:
        if new_tokens <= 0:
            return
        if prog.replica is not None:
            self.replicas[prog.replica].grow(prog, new_tokens)
        prog.context_tokens += new_tokens

    def _mark_not_running(self, prog: ProgramState) -> None:
        if prog.replica is not None:
            self._running[prog.replica].discard(prog.program_id)


class MoriScheduler(AgentScheduler):
    """The paper's scheduler: windowed idleness + sticky three-tier placement."""

    name = "mori"

    # ------------------------------------------------------------- events
    def _on_request_arrived(self, pid: str, input_tokens: int, now: float) -> None:
        prog = self.programs[pid]
        new_tokens = max(0, input_tokens - prog.context_tokens)
        self._account_growth(prog, new_tokens)
        prog.gate(now)
        if prog.tier is Tier.GPU and self._has_slot(prog.replica):
            self._dispatch(prog)
        elif not self._cancel_inflight_offload(prog) and self.config.eager_promote:
            self._promote_pass(now)

    def _on_request_completed(self, pid: str, output_tokens: int, now: float) -> None:
        prog = self.programs[pid]
        self._mark_not_running(prog)
        self._account_growth(prog, 0)  # growth applied below via begin_acting
        if prog.replica is not None:
            self.replicas[prog.replica].grow(prog, output_tokens)
        prog.begin_acting(now, new_tokens=output_tokens)
        if prog.lazy_demote and prog.tier is Tier.GPU:
            prog.lazy_demote = False
            self._demote(prog, now)
        if self.config.eager_promote:
            self._promote_pass(now)

    def _on_tick(self, now: float) -> None:
        for rep in self.replicas:
            self._demote_pass(rep, now)
            self._cpu_overflow_pass(rep, now)
            self._ssd_overflow_pass(rep, now)
        self._promote_pass(now)
        if self.config.migrate_on_pressure:
            self._migrate_pass(now)
        self._sync_labels()

    def _on_slot_freed(self, replica: int, now: float) -> None:
        """A decode slot opened mid-batch: run the promotion/forward pass so
        a gated program claims it immediately — the batch dimension never
        idles waiting for the next control tick."""
        del replica  # the promote pass is global and affinity-aware
        self._promote_pass(now)

    def _on_transfer_complete(self, rec: TransferRecord, now: float) -> None:
        """A migrate ack means the program's DRAM copy now physically
        exists on the destination replica — the promotion that was
        deferred when the ``Migrate`` was emitted can finally open its
        reload ``Forward`` (billing the PCIe channel once, after the
        cross-replica move, instead of concurrently with it)."""
        if rec.kind != "migrate":
            return
        prog = self.programs.get(rec.pid)
        if (
            prog is not None
            and not prog.finished
            and prog.tier is Tier.CPU
            and prog.has_pending
            and not prog.dispatched
        ):
            self._try_promote_cpu(prog, now)

    # ------------------------------------------------------ cancel on return
    def _cancel_inflight_offload(self, prog: ProgramState) -> bool:
        """Early tool return: the program's offload is still sitting in the
        runtime's transfer queue, so its KV never actually left the GPU.
        Cancel the transfer and re-admit warm — no reload, no recompute.
        Only offloads sourced from the GPU qualify (a CPU→SSD sink's bytes
        were never on the GPU in the first place)."""
        if prog.tier not in (Tier.CPU, Tier.SSD):
            return False
        rec = self.ledger.open_offload(prog.program_id)
        if rec is None or rec.src_tier is not Tier.GPU:
            return False
        rep = self.replicas[prog.replica]
        if rep.gpu_free() < prog.kv_bytes:
            return False
        rep.remove(prog.tier, prog)
        self._emit_cancel(prog.program_id, rec)
        rep.gpu_admit(prog)
        prog.metrics.cancelled_offloads += 1
        self._set_label(prog, TypeLabel.BUSY)
        if self._has_slot(rep.replica_id):
            self._dispatch(prog)
        return True

    # ---------------------------------------------------------- demotions
    def _demote_pass(self, rep: ReplicaTiers, now: float) -> None:
        """Shrink the GPU queue until it fits (paper §4.3.1 'Demotion')."""
        overflow = rep.gpu_overflow()
        if overflow <= 0:
            return
        # Acting (and gated) programs first, then Reasoning; within a status
        # class, highest idleness first.
        order = {Status.ACTING: 0, Status.GATED: 1, Status.REASONING: 2}
        victims = sorted(
            rep.gpu.values(),
            key=lambda p: (order[p.status], -p.idleness(now)),
        )
        # bytes already promised by victims marked on an *earlier* pass
        # whose in-flight step has not finished yet: without seeding the
        # running total with them, a second tick re-counts the same
        # overflow and demotes extra Acting programs that the pending lazy
        # demotions would already have freed
        pending_free = sum(p.kv_bytes for p in rep.gpu.values() if p.lazy_demote)
        for victim in victims:
            if rep.gpu_used - pending_free <= rep.capacity.gpu_kv_bytes:
                break
            if victim.lazy_demote:
                continue  # already counted in the seed above
            if victim.status is Status.REASONING or victim.dispatched:
                # lazy demotion: finish the in-flight step first. A
                # dispatched-but-not-started program is in the same boat —
                # its reload/recompute Forward is already executing, so
                # demoting it now would move KV out from under the runtime
                # and double-bill the transfer channel.
                victim.lazy_demote = True
                pending_free += victim.kv_bytes
            else:
                self._demote(victim, now)

    def _demote(self, prog: ProgramState, now: float) -> None:
        """GPU -> CPU if DRAM permits, else SSD (§7.1 extension, when
        enabled), else GPU -> Waiting.

        If the program was admitted to the GPU queue but its KV was never
        actually moved (``_pending_source``), the bytes still sit at their
        old tier: demoting back there is free (no transfer emitted), and
        demoting a never-recomputed Waiting re-admission is a pure
        accounting rollback."""
        rep = self.replicas[prog.replica]
        src = self._pending_source.pop(prog.program_id, Tier.GPU)
        rep.gpu_remove(prog)
        prog.metrics.demotions += 1
        if src is Tier.WAITING:
            # recompute never ran: nothing resident anywhere
            self.waiting.add(prog)
            self._set_label(prog, TypeLabel.INACTIVE)
            return
        if src is not Tier.GPU:
            # deferred promotion rolled back: the bytes still sit at their
            # old tier, so re-admitting there is free (no transfer emitted)
            free = rep.cpu_free if src is Tier.CPU else rep.ssd_free
            admit = rep.cpu_admit if src is Tier.CPU else rep.ssd_admit
            if free() >= prog.host_kv_bytes:
                admit(prog)
                self._set_label(prog, TypeLabel.IDLE)
                return
        if rep.cpu_free() >= prog.host_kv_bytes:
            rep.cpu_admit(prog)
            self._emit_offload(prog, src, Tier.CPU)
            self._set_label(prog, TypeLabel.IDLE)
        elif rep.ssd_free() >= prog.host_kv_bytes and self._ssd_worthwhile(prog):
            rep.ssd_admit(prog)
            self._emit_offload(prog, src, Tier.SSD)
            self._set_label(prog, TypeLabel.IDLE)
        else:
            self._emit_discard(prog.program_id, rep.replica_id, src)
            self.waiting.add(prog)
            prog.metrics.evictions += 1
            self._set_label(prog, TypeLabel.INACTIVE)

    def _cpu_overflow_pass(self, rep: ReplicaTiers, now: float) -> None:
        """CPU-side admission control (paper §3.4).

        With the SSD tier enabled (§7.1 extension), the *most idle* CPU
        programs sink to NVMe first — they tolerate the slower reload and
        continue the idleness spectrum downward. Whatever still overflows
        is evicted to Waiting, busiest first, mirroring the typed block
        order (the CPU tier preferentially *retains idle* programs).
        """
        if rep.cpu_overflow() <= 0:
            return
        if rep.capacity.ssd_kv_bytes:
            sinkable = sorted(rep.cpu.values(), key=lambda p: -p.idleness(now))
            for victim in sinkable:
                if rep.cpu_overflow() <= 0:
                    return
                if rep.ssd_free() < victim.host_kv_bytes:
                    break
                if not self._ssd_worthwhile(victim):
                    continue
                rep.cpu_remove(victim)
                rep.ssd_admit(victim)
                self._emit_offload(victim, Tier.CPU, Tier.SSD)
                self._set_label(victim, TypeLabel.IDLE)
        victims = sorted(rep.cpu.values(), key=lambda p: p.idleness(now))
        for victim in victims:
            if rep.cpu_overflow() <= 0:
                break
            rep.cpu_remove(victim)
            self._emit_discard(victim.program_id, rep.replica_id, Tier.CPU)
            self.waiting.add(victim)
            victim.metrics.evictions += 1
            self._set_label(victim, TypeLabel.INACTIVE)

    def _ssd_worthwhile(self, prog: ProgramState) -> bool:
        """Cost-aware SSD guard (beyond §7.1's threshold proposal): keep
        the bytes only if an NVMe reload would beat recomputing them.
        Without configured rates, always sink (the paper-naive policy)."""
        cfg = self.config
        if not cfg.ssd_bytes_per_s or not cfg.recompute_tok_per_s:
            return True
        # the NVMe read moves wire-format bytes: an int8 offload format
        # halves reload_s, widening the band where keeping bytes beats
        # recomputing them — format is a placement decision
        reload_s = prog.host_kv_bytes / cfg.ssd_bytes_per_s
        recompute_s = prog.context_tokens / cfg.recompute_tok_per_s
        return reload_s < cfg.ssd_guard_factor * recompute_s

    def _ssd_overflow_pass(self, rep: ReplicaTiers, now: float) -> None:
        """SSD-side admission control (§7.1 extension): evict to Waiting,
        busiest first (they will be recomputed soon regardless; the most
        idle keep their bytes where idleness is cheapest)."""
        if rep.ssd_overflow() <= 0:
            return
        victims = sorted(rep.ssd.values(), key=lambda p: p.idleness(now))
        for victim in victims:
            if rep.ssd_overflow() <= 0:
                break
            rep.ssd_remove(victim)
            self._emit_discard(victim.program_id, rep.replica_id, Tier.SSD)
            self.waiting.add(victim)
            victim.metrics.evictions += 1
            self._set_label(victim, TypeLabel.INACTIVE)

    # ---------------------------------------------------------- promotions
    def _promote_pass(self, now: float) -> None:
        """Fill free GPU capacity in priority order (paper §4.3.1).

        (1) CPU-queue programs whose tool call has completed (gated), with
            replica affinity; (2) Waiting-queue gated programs, returning
            before new, via most-available-capacity placement; (3) new
            arrivals, smallest context first. Lowest idleness first within
            (1) and (2).
        """
        # --- P1: CPU -> GPU, affinity-preserving. A program whose DRAM
        #     copy is still migrating between replicas is skipped: its
        #     bytes have not landed, so a reload Forward now would ship KV
        #     that does not exist on the destination yet (the promotion
        #     fires from the migrate's on_transfer_complete ack instead).
        #     Migrate records exist under migrate_on_pressure *or* after a
        #     drain_migrate failover; only with both off is the ledger scan
        #     skipped.
        p1 = [
            p
            for rep in self.replicas
            for p in rep.cpu.values()
            if p.has_pending
            and not p.dispatched
            and (
                not (self.config.migrate_on_pressure or self.config.drain_migrate)
                or self.ledger.open_migrate(p.program_id) is None
            )
        ]
        p1.sort(key=lambda p: p.idleness(now))
        for prog in p1:
            self._try_promote_cpu(prog, now)

        # --- P1b: SSD -> GPU (§7.1 extension), affinity-preserving; the
        #     Forward's source_tier bills the reload to the NVMe channel
        p1b = [
            p
            for rep in self.replicas
            for p in rep.ssd.values()
            if p.has_pending and not p.dispatched
        ]
        p1b.sort(key=lambda p: p.idleness(now))
        for prog in p1b:
            self._try_promote_ssd(prog, now)

        # --- P2: Waiting (returning) -> some replica
        p2 = [
            p
            for p in self.waiting.programs.values()
            if p.has_pending and not p.is_new and not p.dispatched
        ]
        p2.sort(key=lambda p: p.idleness(now))
        for prog in p2:
            self._try_admit_waiting(prog, now)

        # --- P3: new arrivals, smallest context first
        p3 = [
            p
            for p in self.waiting.programs.values()
            if p.has_pending and p.is_new and not p.dispatched
        ]
        p3.sort(key=lambda p: p.context_tokens)
        for prog in p3:
            self._try_admit_waiting(prog, now)

        # forward GPU-resident gated programs when slots free (busy first)
        for rep in self.replicas:
            gated = [
                p
                for p in rep.gpu.values()
                if p.status is Status.GATED and p.has_pending and not p.dispatched
            ]
            gated.sort(key=lambda p: p.idleness(now))
            for prog in gated:
                if not self._has_slot(rep.replica_id):
                    break
                self._dispatch(prog)

    def _try_promote_cpu(self, prog: ProgramState, now: float) -> bool:
        rep = self.replicas[prog.replica]
        if not self._make_room(rep, prog, now):
            return False
        rep.cpu_remove(prog)
        rep.gpu_admit(prog)
        prog.metrics.promotions += 1
        self._set_label(prog, TypeLabel.BUSY)
        if self._has_slot(rep.replica_id):
            self._emit_forward(prog, Tier.CPU)
        else:
            self._pending_source[prog.program_id] = Tier.CPU
        return True

    def _try_promote_ssd(self, prog: ProgramState, now: float) -> bool:
        rep = self.replicas[prog.replica]
        if not self._make_room(rep, prog, now):
            return False
        rep.ssd_remove(prog)
        rep.gpu_admit(prog)
        prog.metrics.promotions += 1
        self._set_label(prog, TypeLabel.BUSY)
        if self._has_slot(rep.replica_id):
            self._emit_forward(prog, Tier.SSD)
        else:
            self._pending_source[prog.program_id] = Tier.SSD
        return True

    def _try_admit_waiting(self, prog: ProgramState, now: float) -> bool:
        decision = self.balancer.place(prog, now)
        if not decision:
            return False
        rep = self.replicas[decision.replica]
        if not self._make_room(rep, prog, now, allow_swap=not prog.is_new):
            return False
        self.waiting.remove(prog)
        if prog.home_replica is not None and prog.home_replica != decision.replica:
            prog.metrics.replica_switches += 1
        rep.gpu_admit(prog)
        prog.metrics.promotions += 1
        self._set_label(prog, TypeLabel.BUSY)
        # recomputed_tokens is billed at dispatch time (_dispatch): a
        # deferred admission can still be rolled back by a demotion before
        # any prefill happens, and must not count twice on re-admission
        self._pending_source[prog.program_id] = Tier.WAITING
        if self._has_slot(rep.replica_id):
            self._dispatch(prog)
        return True

    def _make_room(
        self,
        rep: ReplicaTiers,
        prog: ProgramState,
        now: float,
        allow_swap: bool = True,
    ) -> bool:
        """Ensure ``prog.kv_bytes`` fit on ``rep``'s GPU tier.

        Sticky placement: only displaces *Acting* GPU programs that are more
        idle than the candidate by at least the hysteresis margin — the
        'actual mismatch' rule of paper §4.3.
        """
        need = prog.kv_bytes - rep.gpu_free()
        if need <= 0:
            return True
        if not allow_swap:
            return False
        margin = self.config.swap_hysteresis
        cand_iota = prog.idleness(now)
        displaceable = sorted(
            (
                p
                for p in rep.gpu.values()
                if p.status is Status.ACTING
                and not p.lazy_demote
                and p.idleness(now) > cand_iota + margin
            ),
            key=lambda p: -p.idleness(now),
        )
        freed = 0
        chosen: list[ProgramState] = []
        for victim in displaceable:
            if freed >= need:
                break
            chosen.append(victim)
            freed += victim.kv_bytes
        if freed < need:
            return False
        for victim in chosen:
            self._demote(victim, now)
        return True

    # ----------------------------------------------------------- migration
    def _migrate_pass(self, now: float) -> None:
        """Beyond-paper: when a pending CPU-resident program cannot fit its
        home GPU but another healthy replica has abundant room, move the
        DRAM copy there (``Migrate``) and promote on arrival — a reload on
        the new replica instead of a full recompute. Off by default
        (``migrate_on_pressure``); paper-faithful benchmarks keep affinity
        strictly sticky."""
        for rep in self.replicas:
            stuck = [
                p for p in list(rep.cpu.values())
                if p.has_pending and not p.dispatched
                and rep.gpu_free() < p.kv_bytes
            ]
            for prog in stuck:
                if self.ledger.open_offload(prog.program_id) is not None:
                    # its DRAM copy hasn't physically landed yet — migrating
                    # now would ship bytes that are still on the source GPU
                    continue
                if self.ledger.open_migrate(prog.program_id) is not None:
                    continue  # one move at a time
                others = [
                    r for r in self.balancer.healthy()
                    if r.replica_id != rep.replica_id
                    and r.gpu_free() >= prog.kv_bytes
                    and r.cpu_free() >= prog.host_kv_bytes
                ]
                if not others:
                    continue
                dst = max(others, key=lambda r: r.gpu_free())
                rep.cpu_remove(prog)
                self._emit_migrate(prog, rep.replica_id, dst.replica_id)
                dst.cpu_admit(prog)
                prog.metrics.replica_switches += 1
                # promotion is deferred to the migrate's ack
                # (_on_transfer_complete): opening the reload Forward now
                # would double-bill the PCIe channel for the same bytes and
                # forward KV that has not landed on the destination

    # ------------------------------------------------------------ dispatch
    def _dispatch(self, prog: ProgramState) -> None:
        """Forward a GPU-queue program, sourcing the KV from wherever it
        physically still lives (a deferred promotion keeps its true source
        in ``_pending_source``)."""
        src = self._pending_source.pop(prog.program_id, Tier.GPU)
        if src is Tier.WAITING:
            prog.metrics.recomputed_tokens += prog.context_tokens
        self._emit_forward(prog, src, recompute=src is Tier.WAITING)

    def _sync_labels(self) -> None:
        for rep in self.replicas:
            for p in rep.gpu.values():
                self._set_label(p, TypeLabel.BUSY)
            for p in rep.cpu.values():
                self._set_label(p, TypeLabel.IDLE)
            for p in rep.ssd.values():
                self._set_label(p, TypeLabel.IDLE)
        for p in self.waiting.programs.values():
            self._set_label(p, TypeLabel.INACTIVE)
