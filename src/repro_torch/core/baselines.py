"""Baseline schedulers from the paper's evaluation (§6.1).

* :class:`SMGScheduler` — SGLang Model Gateway: request-level, prefix-aware
  routing, engine-side LRU eviction, **no** program pinning, **no** offload.
* :class:`TAScheduler` — ThunderAgent: program-aware pinning across tool
  calls, context-length-based GPU eviction, **no** CPU tier; evicted programs
  are rerouted to the lightest-loaded replica (breaks affinity, §6.2.2).
* :class:`TAOScheduler` — ThunderAgent+Offloading: TA's scheduler on top of
  an engine whose HiCache layer independently spills GPU-evicted KV to CPU
  DRAM under plain LRU, *without scheduler coordination*: routing still
  treats evicted programs as stateless, so a reload only happens if the
  lightest-loaded replica coincidentally holds the CPU copy.

All implement the same :class:`repro_torch.core.scheduler.AgentScheduler` event
API — events in, :class:`~repro_torch.core.actions.PlacementPlan` out — so the
simulator and benchmarks are policy-agnostic.
"""
from __future__ import annotations

from collections import OrderedDict

from repro_torch.core.program import ProgramState
from repro_torch.core.scheduler import AgentScheduler
from repro_torch.core.types import Status, Tier


class SMGScheduler(AgentScheduler):
    """Prefix-aware request gateway; engine LRU; no pinning, no offload."""

    name = "smg"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._last_active: dict[str, float] = {}
        self._fifo: list[str] = []  # gated request order

    # ------------------------------------------------------------- events
    def _on_request_arrived(self, pid: str, input_tokens: int, now: float) -> None:
        prog = self.programs[pid]
        self._account_growth(prog, max(0, input_tokens - prog.context_tokens))
        prog.gate(now)
        self._last_active[pid] = now
        if pid not in self._fifo:
            self._fifo.append(pid)
        self._admit(now)

    def _on_request_completed(self, pid: str, output_tokens: int, now: float) -> None:
        prog = self.programs[pid]
        self._mark_not_running(prog)
        if prog.replica is not None:
            self.replicas[prog.replica].grow(prog, output_tokens)
        prog.begin_acting(now, new_tokens=output_tokens)
        self._last_active[pid] = now
        self._admit(now)

    def _on_tick(self, now: float) -> None:
        self._admit(now)

    def _on_slot_freed(self, replica: int, now: float) -> None:
        del replica
        self._admit(now)

    # ----------------------------------------------------------- admission
    def _admit(self, now: float) -> None:
        still_gated: list[str] = []
        for pid in self._fifo:
            prog = self.programs.get(pid)
            if prog is None or not prog.has_pending:
                continue
            if not self._admit_one(prog, now):
                still_gated.append(pid)
        self._fifo = still_gated

    def _admit_one(self, prog: ProgramState, now: float) -> bool:
        # prefix-aware routing: prefer the replica already caching this
        # program's KV (the longest-matching-prefix proxy at program grain)
        target = prog.replica if prog.tier is Tier.GPU else None
        cached = target is not None
        if target is None:
            reps = self.balancer.healthy()
            if not reps:
                return False
            target = max(reps, key=lambda r: r.gpu_free()).replica_id
        rep = self.replicas[target]
        if not self._has_slot(target):
            return False
        need = 0 if cached else prog.kv_bytes
        # growth overflow can leave gpu_free() negative even for a cached
        # candidate; never let the LRU pass evict the program being admitted
        if need > rep.gpu_free() and not self._lru_evict(
            rep, need - rep.gpu_free(), now, keep=prog.program_id
        ):
            return False
        if not cached:
            if prog.tier is Tier.GPU:  # resident elsewhere: drop old copy
                old = self.replicas[prog.replica]
                old.gpu_remove(prog)
                self._emit_discard(prog.program_id, old.replica_id, Tier.GPU)
            if prog.home_replica is not None and prog.home_replica != target:
                prog.metrics.replica_switches += 1
            self.waiting.remove(prog)
            rep.gpu_admit(prog)
            prog.metrics.recomputed_tokens += prog.context_tokens
        if cached:
            self._emit_forward(prog, Tier.GPU)
        else:
            self._emit_forward(prog, Tier.WAITING, recompute=True)
        return True

    # _has_slot comes from AgentScheduler (max_running cap / runtime probe)

    def _lru_evict(self, rep, need: int, now: float, keep: str | None = None) -> bool:
        """Engine-level LRU: evict least-recently-active non-running KV."""
        victims = sorted(
            (
                p
                for p in rep.gpu.values()
                if p.status is not Status.REASONING and p.program_id != keep
            ),
            key=lambda p: self._last_active.get(p.program_id, 0.0),
        )
        freed = 0
        for v in victims:
            if freed >= need:
                break
            freed += v.kv_bytes
            rep.gpu_remove(v)
            self._emit_discard(v.program_id, rep.replica_id, Tier.GPU)
            self.waiting.add(v)
            v.metrics.evictions += 1
        return freed >= need


class TAScheduler(AgentScheduler):
    """Program-aware pinning; context-length GPU eviction; no CPU tier."""

    name = "ta"
    offloading = False

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._fifo: list[str] = []

    # ------------------------------------------------------------- events
    def _on_request_arrived(self, pid: str, input_tokens: int, now: float) -> None:
        prog = self.programs[pid]
        self._account_growth(prog, max(0, input_tokens - prog.context_tokens))
        prog.gate(now)
        if prog.tier is Tier.GPU and self._has_slot(prog.replica):
            self._emit_forward(prog, Tier.GPU)
            return
        if pid not in self._fifo:
            self._fifo.append(pid)
        self._admit(now)

    def _on_request_completed(self, pid: str, output_tokens: int, now: float) -> None:
        prog = self.programs[pid]
        self._mark_not_running(prog)
        if prog.replica is not None:
            self.replicas[prog.replica].grow(prog, output_tokens)
        prog.begin_acting(now, new_tokens=output_tokens)
        for rep in self.replicas:  # growth may overflow: evict by ctx length
            self._shrink_to_fit(rep, now)
        self._admit(now)

    def _on_tick(self, now: float) -> None:
        for rep in self.replicas:
            self._shrink_to_fit(rep, now)
        self._admit(now)

    def _on_slot_freed(self, replica: int, now: float) -> None:
        del replica
        self._admit(now)

    # ----------------------------------------------------------- policies
    def _shrink_to_fit(self, rep, now: float) -> None:
        while rep.gpu_overflow() > 0:
            acting = [p for p in rep.gpu.values() if p.status is not Status.REASONING]
            if not acting:
                break
            victim = max(acting, key=lambda p: p.context_tokens)
            self._evict_gpu(rep, victim)

    def _evict_gpu(self, rep, victim: ProgramState) -> None:
        rep.gpu_remove(victim)
        self._spill(rep, victim)
        self.waiting.add(victim)
        victim.metrics.evictions += 1

    def _spill(self, rep, victim: ProgramState) -> None:
        """TA discards outright; TA+O overrides to spill into HiCache."""
        self._emit_discard(victim.program_id, rep.replica_id, Tier.GPU)

    def _admit(self, now: float) -> None:
        still: list[str] = []
        for pid in self._fifo:
            prog = self.programs.get(pid)
            if prog is None or not prog.has_pending:
                continue
            if prog.tier is Tier.GPU:
                if self._has_slot(prog.replica):
                    self._emit_forward(prog, Tier.GPU)
                else:
                    still.append(pid)
                continue
            if not self._admit_one(prog, now):
                still.append(pid)
        self._fifo = still

    def _admit_one(self, prog: ProgramState, now: float) -> bool:
        # offloading-agnostic routing: lightest load (paper §6.2.2)
        reps = self.balancer.healthy()
        if not reps:
            return False
        rep = max(reps, key=lambda r: r.gpu_free())
        if not self._has_slot(rep.replica_id):
            return False
        need = prog.kv_bytes - rep.gpu_free()
        if need > 0:
            # context-length eviction, blind to phase (the §3.4 pathology)
            acting = sorted(
                (p for p in rep.gpu.values() if p.status is not Status.REASONING),
                key=lambda p: -p.context_tokens,
            )
            freed, chosen = 0, []
            for v in acting:
                if freed >= need:
                    break
                if v.context_tokens <= prog.context_tokens:
                    break  # don't evict smaller programs to fit a bigger one
                chosen.append(v)
                freed += v.kv_bytes
            if freed < need:
                return False
            for v in chosen:
                self._evict_gpu(rep, v)
        if prog.home_replica is not None and prog.home_replica != rep.replica_id:
            prog.metrics.replica_switches += 1
        self.waiting.remove(prog)
        rep.gpu_admit(prog)
        if self._try_reload(rep, prog):
            self._emit_forward(prog, Tier.CPU)
        else:
            prog.metrics.recomputed_tokens += prog.context_tokens
            self._emit_forward(prog, Tier.WAITING, recompute=True)
        return True

    def _try_reload(self, rep, prog: ProgramState) -> bool:
        return False  # TA has no CPU tier


class TAOScheduler(TAScheduler):
    """TA + uncoordinated HiCache-style CPU spill (engine-level plain LRU)."""

    name = "ta+o"
    offloading = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # per-replica LRU of spilled KV: pid -> bytes (OrderedDict = LRU)
        self._hicache: dict[int, OrderedDict[str, int]] = {
            r.replica_id: OrderedDict() for r in self.replicas
        }
        self._hicache_used: dict[int, int] = {r.replica_id: 0 for r in self.replicas}

    def _spill(self, rep, victim: ProgramState) -> None:
        cache = self._hicache[rep.replica_id]
        cap = rep.capacity.cpu_kv_bytes
        size = victim.host_kv_bytes   # the spilled copy is in offload format
        if size > cap:
            self._emit_discard(victim.program_id, rep.replica_id, Tier.GPU)
            return
        while self._hicache_used[rep.replica_id] + size > cap and cache:
            old_pid, old_size = cache.popitem(last=False)  # plain LRU
            self._hicache_used[rep.replica_id] -= old_size
            self._emit_discard(old_pid, rep.replica_id, Tier.CPU)
        cache[victim.program_id] = size
        self._hicache_used[rep.replica_id] += size
        self._emit_offload(victim, Tier.GPU, Tier.CPU)

    def _try_reload(self, rep, prog: ProgramState) -> bool:
        cache = self._hicache[rep.replica_id]
        size = cache.pop(prog.program_id, None)
        if size is None:
            # the CPU copy (if any) lives on another replica -> wasted
            for rid, other in self._hicache.items():
                if prog.program_id in other:
                    self._hicache_used[rid] -= other.pop(prog.program_id)
                    self._emit_discard(prog.program_id, rid, Tier.CPU)
            return False
        self._hicache_used[rep.replica_id] -= size
        return True
