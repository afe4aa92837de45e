"""Three-tier queue structure (paper §4.1, Fig. 6).

Each replica owns a GPU queue (HBM-resident programs) and a CPU queue
(DRAM-offloaded programs); a single Waiting queue is global. Queues here are
*capacity-accounted sets* — ordering decisions live in the scheduler policy,
not in the container.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator

from repro_torch.core.program import ProgramState
from repro_torch.core.types import Tier, TierCapacity


@dataclass
class ReplicaTiers:
    """Byte-accounted GPU + CPU queues for one inference-engine replica.

    Tier formats: the GPU queue accounts programs at their device-resident
    size (``kv_bytes``); the CPU and SSD queues account them at the offload
    format's size (``host_kv_bytes``) — with an int8 offload format a host
    tier holds roughly twice the contexts per byte of budget.
    """

    replica_id: int
    capacity: TierCapacity
    gpu: dict[str, ProgramState] = field(default_factory=dict)
    cpu: dict[str, ProgramState] = field(default_factory=dict)
    ssd: dict[str, ProgramState] = field(default_factory=dict)
    gpu_used: int = 0
    cpu_used: int = 0
    ssd_used: int = 0
    # straggler signal: EWMA of observed step latency (updated by the runtime)
    ewma_step_latency_s: float = 0.0

    # ------------------------------------------------------------------ GPU
    def gpu_free(self) -> int:
        return self.capacity.gpu_kv_bytes - self.gpu_used

    def gpu_admit(self, prog: ProgramState) -> None:
        assert prog.program_id not in self.gpu
        self.gpu[prog.program_id] = prog
        self.gpu_used += prog.kv_bytes
        prog.tier = Tier.GPU
        prog.replica = self.replica_id
        prog.home_replica = self.replica_id

    def gpu_remove(self, prog: ProgramState) -> None:
        del self.gpu[prog.program_id]
        self.gpu_used -= prog.kv_bytes

    def gpu_overflow(self) -> int:
        return max(0, self.gpu_used - self.capacity.gpu_kv_bytes)

    # ------------------------------------------------------------------ CPU
    def cpu_free(self) -> int:
        return self.capacity.cpu_kv_bytes - self.cpu_used

    def cpu_admit(self, prog: ProgramState) -> None:
        assert prog.program_id not in self.cpu
        self.cpu[prog.program_id] = prog
        self.cpu_used += prog.host_kv_bytes
        prog.tier = Tier.CPU
        prog.replica = self.replica_id

    def cpu_remove(self, prog: ProgramState) -> None:
        del self.cpu[prog.program_id]
        self.cpu_used -= prog.host_kv_bytes

    def cpu_overflow(self) -> int:
        return max(0, self.cpu_used - self.capacity.cpu_kv_bytes)

    # ------------------------------------------------------------------ SSD
    # beyond-paper (§7.1): a third, NVMe-backed tier below CPU DRAM.
    def ssd_free(self) -> int:
        return self.capacity.ssd_kv_bytes - self.ssd_used

    def ssd_admit(self, prog: ProgramState) -> None:
        assert prog.program_id not in self.ssd
        self.ssd[prog.program_id] = prog
        self.ssd_used += prog.host_kv_bytes
        prog.tier = Tier.SSD
        prog.replica = self.replica_id

    def ssd_remove(self, prog: ProgramState) -> None:
        del self.ssd[prog.program_id]
        self.ssd_used -= prog.host_kv_bytes

    def ssd_overflow(self) -> int:
        return max(0, self.ssd_used - self.capacity.ssd_kv_bytes)

    # --------------------------------------------------- tier-generic views
    def queues(self) -> Iterator[tuple[Tier, dict[str, ProgramState]]]:
        """The hardware-backed queues in demotion order. Adding a tier means
        adding one entry here — every tier-generic loop picks it up."""
        yield Tier.GPU, self.gpu
        yield Tier.CPU, self.cpu
        yield Tier.SSD, self.ssd

    def remove(self, tier: Tier, prog: ProgramState) -> None:
        """Remove ``prog`` from the named tier's queue (byte-accounted)."""
        if tier is Tier.GPU:
            self.gpu_remove(prog)
        elif tier is Tier.CPU:
            self.cpu_remove(prog)
        else:
            self.ssd_remove(prog)

    def evict(self, prog: ProgramState) -> Tier | None:
        """Remove ``prog`` from whichever queue holds it; returns the tier
        it occupied, or None if it was not resident on this replica."""
        for tier, q in self.queues():
            if prog.program_id in q:
                self.remove(tier, prog)
                return tier
        return None

    def evict_all(self) -> Iterator[tuple[Tier, ProgramState]]:
        """Drain every resident program, yielding ``(tier, prog)`` pairs
        after removal — the single code path for whole-replica teardown
        (node failure), replacing three copy-pasted per-tier loops."""
        for tier, q in self.queues():
            for prog in list(q.values()):
                self.remove(tier, prog)
                yield tier, prog

    # ------------------------------------------------------------- growth
    def grow(self, prog: ProgramState, new_tokens: int) -> None:
        """Account for context growth of a resident program.

        May push the tier into overflow; the next scheduler pass resolves it
        (paper: capacity violations *force* demotion).
        """
        if prog.program_id in self.gpu:
            self.gpu_used += new_tokens * prog.kv_bytes_per_token
        elif prog.program_id in self.cpu:
            self.cpu_used += new_tokens * prog.host_bytes_per_token
        elif prog.program_id in self.ssd:
            self.ssd_used += new_tokens * prog.host_bytes_per_token

    def check(self) -> None:
        """Invariant check used by property tests."""
        assert self.gpu_used == sum(p.kv_bytes for p in self.gpu.values())
        assert self.cpu_used == sum(p.host_kv_bytes for p in self.cpu.values())
        assert self.ssd_used == sum(p.host_kv_bytes for p in self.ssd.values())
        assert not (set(self.gpu) & set(self.cpu))
        assert not (set(self.gpu) & set(self.ssd))
        assert not (set(self.cpu) & set(self.ssd))


@dataclass
class WaitingQueue:
    """Global queue of programs whose KV has been discarded (paper §4.1)."""

    programs: dict[str, ProgramState] = field(default_factory=dict)

    def add(self, prog: ProgramState) -> None:
        self.programs[prog.program_id] = prog
        prog.tier = Tier.WAITING
        prog.replica = None

    def remove(self, prog: ProgramState) -> None:
        self.programs.pop(prog.program_id, None)

    def __len__(self) -> int:
        return len(self.programs)
