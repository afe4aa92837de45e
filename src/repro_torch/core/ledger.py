"""Per-replica, per-channel accounting of in-flight KV transfers.

The ledger is the scheduler's view of what it has *asked* runtimes to move
but not yet heard back about. A record opens when the scheduler emits a
transfer-bearing action (``Offload``, ``Forward`` with a CPU/SSD source,
``Migrate``) and closes when the runtime acknowledges completion via
``scheduler.on_transfer_complete(pid, action_id, now)`` — or when the
scheduler cancels it (early tool return) or the owning replica fails.

Two channels are modeled, matching the hardware in ``repro.sim.hardware``:

* ``pcie`` — host ↔ device DMA (GPU↔CPU offload/reload, migration ingest);
* ``nvme`` — the §7.1 SSD tier's drive bandwidth (anything touching SSD).

With the ledger the scheduler can see pending bytes per channel before
queueing more work behind them, and can recognise that a program whose
offload is still queued has never actually left the GPU — the fact the
cancel path exploits.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

from repro_torch.core.types import Tier


class Channel(enum.Enum):
    """Physical transfer channel a record occupies."""

    PCIE = "pcie"
    NVME = "nvme"


def channel_for(tier: Tier) -> Channel:
    """The channel a transfer *reading from* ``tier`` is billed to: SSD
    reads serialize on the drive; everything else is host↔device DMA.
    Callers pass the source tier — writes are staged through host DRAM, so
    the read side is the contended resource for offloads too."""
    return Channel.NVME if tier is Tier.SSD else Channel.PCIE


@dataclass(frozen=True)
class TransferRecord:
    """One in-flight KV movement, keyed by the action that requested it."""

    action_id: int
    pid: str
    replica: int
    kind: str               # "offload" | "reload" | "migrate"
    channel: Channel
    nbytes: int
    src_tier: Tier
    dst_tier: Tier
    opened_at: float


class TransferLedger:
    """Open-transfer table with per-replica / per-channel rollups."""

    def __init__(self) -> None:
        self._open: dict[int, TransferRecord] = {}
        self.completed = 0
        self.cancelled = 0
        self.dropped = 0
        self.completed_bytes: dict[Channel, int] = {c: 0 for c in Channel}
        # optional lifecycle observer (repro_torch.analysis.invariants wires its
        # LedgerAuditor here under REPRO_KVSAN=1); None costs nothing
        self.observer = None

    # ------------------------------------------------------------ lifecycle
    def open(self, rec: TransferRecord) -> TransferRecord:
        assert rec.action_id not in self._open, rec.action_id
        self._open[rec.action_id] = rec
        if self.observer is not None:
            self.observer.on_open(rec)
        return rec

    def complete(self, action_id: int) -> TransferRecord | None:
        """Close a record on runtime acknowledgement. Unknown ids are
        tolerated (the record may have been cancelled, or dropped with a
        failed replica, while the runtime's completion was in flight)."""
        rec = self._open.pop(action_id, None)
        if self.observer is not None:
            self.observer.on_complete(action_id, rec)
        if rec is not None:
            self.completed += 1
            self.completed_bytes[rec.channel] += rec.nbytes
        return rec

    def cancel(self, action_id: int) -> TransferRecord | None:
        rec = self._open.pop(action_id, None)
        if self.observer is not None:
            self.observer.on_cancel(action_id, rec)
        if rec is not None:
            self.cancelled += 1
        return rec

    def drop_pid(self, pid: str) -> list[TransferRecord]:
        """Forget every open transfer for ``pid`` (program finished)."""
        drop = [r for r in self._open.values() if r.pid == pid]
        for r in drop:
            del self._open[r.action_id]
        self.dropped += len(drop)
        if drop and self.observer is not None:
            self.observer.on_drop(drop)
        return drop

    def drop_replica(self, replica: int) -> list[TransferRecord]:
        """Forget every open transfer on ``replica`` (node failure)."""
        drop = [r for r in self._open.values() if r.replica == replica]
        for r in drop:
            del self._open[r.action_id]
        self.dropped += len(drop)
        if drop and self.observer is not None:
            self.observer.on_drop(drop)
        return drop

    # -------------------------------------------------------------- queries
    def in_flight(
        self,
        replica: int | None = None,
        channel: Channel | None = None,
        kind: str | None = None,
    ) -> list[TransferRecord]:
        return [
            r
            for r in self._open.values()
            if (replica is None or r.replica == replica)
            and (channel is None or r.channel is channel)
            and (kind is None or r.kind == kind)
        ]

    def in_flight_bytes(
        self,
        replica: int | None = None,
        channel: Channel | None = None,
        kind: str | None = None,
    ) -> int:
        """Bytes the scheduler has asked to move but not heard back about —
        per replica / channel / kind, the backlog gauge the serving
        transfer plane exports (``RouterMetrics.peak_inflight_bytes``)."""
        return sum(r.nbytes for r in self.in_flight(replica, channel, kind))

    def is_open(self, action_id: int) -> bool:
        """Whether ``action_id`` still has an open record (it may have been
        dropped by program teardown or replica failure in the meantime)."""
        return action_id in self._open

    def open_for(self, pid: str, kind: str) -> TransferRecord | None:
        """The still-pending transfer of ``kind`` for ``pid``, if any."""
        for r in self._open.values():
            if r.pid == pid and r.kind == kind:
                return r
        return None

    def open_offload(self, pid: str) -> TransferRecord | None:
        """The still-pending offload of ``pid``'s KV, if any — the handle
        the early-return cancel path needs."""
        return self.open_for(pid, "offload")

    def open_migrate(self, pid: str) -> TransferRecord | None:
        """The still-pending cross-replica move of ``pid``'s DRAM copy —
        while it is open the bytes have not landed on the destination, so
        promotion (a reload ``Forward`` of the same bytes) must wait."""
        return self.open_for(pid, "migrate")

    def __len__(self) -> int:
        return len(self._open)
