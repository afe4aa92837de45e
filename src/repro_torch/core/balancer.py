"""Affinity-aware multi-replica placement (paper §4.1, §6.2.2).

Affinity itself is structural in MORI: CPU-queue promotions go back to the
replica whose DRAM holds the cache (enforced in the scheduler), so the
balancer only places programs with *no* resident state — Waiting-queue
returns and new arrivals — using the paper's most-available-capacity
(Best-Fit-Decreasing style) rule.

Every :meth:`ReplicaBalancer.place` call returns a typed
:class:`PlacementDecision` that carries the *reason* the replica won (or
why no replica could take the program); the router surfaces the reason
counts in ``RouterMetrics.placement_reasons`` so a replay explains its own
load distribution.

Beyond-paper (off by default): straggler mitigation. Replicas report an EWMA
of step latency; with ``straggler_penalty > 0`` the effective free capacity
of slow replicas is discounted, biasing new placements away from them.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

from repro_torch.core.program import ProgramState
from repro_torch.core.tiers import ReplicaTiers
from repro_torch.core.types import SchedulerConfig

#: Why a placement decision came out the way it did.
#: ``most-available``      the replica had strictly the most effective free HBM
#: ``tie-break``           top replicas tied on effective free; highest id wins
#: ``straggler-discount``  the straggler EWMA discount changed the winner
#: ``drain-target``        chosen to receive a draining replica's DRAM copy
#: ``no-capacity``         a healthy replica exists but none fits the program
#: ``no-healthy-replica``  every replica is marked failed
PLACEMENT_REASONS = (
    "most-available",
    "tie-break",
    "straggler-discount",
    "drain-target",
    "no-capacity",
    "no-healthy-replica",
)


@dataclass(frozen=True)
class PlacementDecision:
    """Typed result of :meth:`ReplicaBalancer.place`.

    ``replica`` is None when no healthy replica can take the program;
    ``reason`` always explains the outcome (one of
    :data:`PLACEMENT_REASONS`). Truthiness follows placement success, so
    ``if decision:`` reads like the old ``if target is not None:``.
    """

    replica: int | None
    reason: str

    def __bool__(self) -> bool:
        return self.replica is not None


class ReplicaBalancer:
    def __init__(self, replicas: list[ReplicaTiers], config: SchedulerConfig):
        self.replicas = replicas
        self.config = config
        self._healthy: set[int] = {r.replica_id for r in replicas}
        self.reason_counts: Counter[str] = Counter()

    # ------------------------------------------------------------- health
    def mark_failed(self, replica_id: int) -> None:
        self._healthy.discard(replica_id)

    def mark_recovered(self, replica_id: int) -> None:
        self._healthy.add(replica_id)

    def healthy(self) -> list[ReplicaTiers]:
        return [r for r in self.replicas if r.replica_id in self._healthy]

    # ---------------------------------------------------------- placement
    def place(self, prog: ProgramState, now: float) -> PlacementDecision:
        """Pick a replica for a program with no resident KV state.

        Paper: 'Waiting-queue promotions use Best-Fit-Decreasing bin packing
        across replicas, selecting the replica with the most available
        capacity first.'
        """
        candidates = self.healthy()
        if not candidates:
            return self._decide(None, "no-healthy-replica")
        scored = sorted(
            ((self._effective_free(r), r.replica_id) for r in candidates),
            reverse=True,
        )
        best_free, best_id = scored[0]
        if best_free < prog.kv_bytes:
            return self._decide(None, "no-capacity")
        reason = "most-available"
        if len(scored) > 1 and scored[1][0] == best_free:
            reason = "tie-break"
        elif self.config.straggler_penalty > 0.0:
            raw = max(candidates, key=lambda r: (float(r.gpu_free()), r.replica_id))
            if raw.replica_id != best_id:
                reason = "straggler-discount"
        return self._decide(best_id, reason)

    def place_drain(self, prog: ProgramState, now: float) -> PlacementDecision:
        """Pick a replica to *receive* a draining replica's DRAM-resident KV.

        A drain target needs host DRAM headroom (the migrate lands in the
        destination's CPU queue), so the score is cpu_free, not gpu_free —
        the subsequent promotion competes for HBM through the normal passes.
        """
        candidates = self.healthy()
        if not candidates:
            return self._decide(None, "no-healthy-replica")
        best = max(candidates, key=lambda r: (r.cpu_free(), r.replica_id))
        if best.cpu_free() < prog.host_kv_bytes:
            return self._decide(None, "no-capacity")
        return self._decide(best.replica_id, "drain-target")

    def _decide(self, replica: int | None, reason: str) -> PlacementDecision:
        self.reason_counts[reason] += 1
        return PlacementDecision(replica, reason)

    def _effective_free(self, rep: ReplicaTiers) -> float:
        free = float(rep.gpu_free())
        penalty = self.config.straggler_penalty
        if penalty > 0.0:
            lat = [r.ewma_step_latency_s for r in self.healthy()]
            med = sorted(lat)[len(lat) // 2] if lat else 0.0
            if med > 0 and rep.ewma_step_latency_s > med:
                slowdown = rep.ewma_step_latency_s / med - 1.0
                free *= max(0.0, 1.0 - penalty * slowdown)
        return free
