"""Shared transfer-queue model: per-replica PCIe + NVMe copy channels.

One KV movement (an ``Offload``, a reloading ``Forward``, a ``Migrate``)
becomes one :class:`CopyJob` on one :class:`~repro_torch.core.ledger.Channel`.
Jobs on a channel serialize FIFO — the channel is a physical wire — and a
job's duration is ``fixed_latency + nbytes / channel_bandwidth``
(:class:`~repro_torch.core.types.TransferCost`). Completion callbacks fire on
the *runtime's* clock through a caller-supplied ``schedule(eta, fn)``
hook, so the same queue model drives both executors of the plan/ack
protocol:

* the discrete-event simulator schedules straight into its event heap
  (``repro_torch.sim.engine._Replica``), one single-chunk job per transfer —
  the fluid model the paper's evaluation uses;
* the real serving path (``repro_torch.serving.transfer_plane``) splits a job
  into page-granular chunks (``n_chunks``), copying one page per chunk
  tick, which is what lets a :class:`~repro_torch.core.actions.CancelTransfer`
  abort a copy *mid-stream* with only the already-copied pages to roll
  back.

The model is pure control plane: it never touches pages itself. Runtimes
observe job progress through the ``on_start`` / ``on_chunk`` / ``on_done``
callbacks and do their own data movement there.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable

from repro_torch.core.ledger import Channel, channel_for
from repro_torch.core.types import Tier, TransferCost


@dataclass(frozen=True)
class Endpoint:
    """One side of a KV copy: a tier on a replica."""

    replica: int
    tier: Tier


@dataclass(frozen=True)
class CopyRequest:
    """Endpoint-addressed KV copy — the one shape every transfer-bearing
    action lowers to.

    ``Offload``, reloading ``Forward`` and ``Migrate`` differ only in their
    endpoints (same-replica down-tier, same-replica up-tier, cross-replica
    host-to-host), so executors dispatch on the *geometry* instead of the
    action class: :attr:`kind` and :attr:`channel` are derived, and both
    runtimes bill the channel the bytes are read from. ``nbytes`` sizes the
    wire time; the concrete page set is bound by the executor when the job
    reaches its channel head (a copy queued behind an offload of the same
    program must see the pages that offload is about to produce).
    """

    src: Endpoint
    dst: Endpoint
    pid: str
    nbytes: int
    action_id: int

    @property
    def cross_replica(self) -> bool:
        return self.src.replica != self.dst.replica

    @property
    def kind(self) -> str:
        """Ledger record kind: ``offload`` | ``reload`` | ``migrate``."""
        if self.cross_replica:
            return "migrate"
        return "reload" if self.dst.tier is Tier.GPU else "offload"

    @property
    def channel(self) -> Channel:
        """Bill the channel the bytes are *read* from (writes are staged
        through host DRAM, so the read side is the contended resource)."""
        return channel_for(self.src.tier)

    @property
    def exec_replica(self) -> int:
        """The replica whose channel queues serialize this copy — always
        the receiving side (for a same-replica copy there is only one side;
        a migrate contends on the destination's ingest channel)."""
        return self.dst.replica

    def job(self, payload: object = None) -> CopyJob:
        """Lower to the queued-transfer representation."""
        return CopyJob(
            self.nbytes, self.action_id, self.pid, self.exec_replica,
            self.channel, payload=payload,
        )


def copy_request_for(act) -> CopyRequest:
    """Thin adapter from the action IR to the endpoint-addressed API."""
    from repro_torch.core.actions import Forward, Migrate, Offload

    if isinstance(act, Offload):
        src = Endpoint(act.replica, act.src_tier)
        dst = Endpoint(act.replica, act.dst_tier)
    elif isinstance(act, Forward):
        # only CPU/SSD-sourced Forwards carry bytes; GPU/recompute Forwards
        # never reach a transfer executor
        src = Endpoint(act.replica, act.source_tier)
        dst = Endpoint(act.replica, Tier.GPU)
    elif isinstance(act, Migrate):
        src = Endpoint(act.src_replica, Tier.CPU)
        dst = Endpoint(act.dst_replica, Tier.CPU)
    else:
        raise TypeError(f"{type(act).__name__} carries no bytes to copy")
    return CopyRequest(
        src=src, dst=dst, pid=act.pid, nbytes=act.nbytes,
        action_id=act.action_id,
    )


@dataclass
class CopyJob:
    """One queued KV movement, executing a ledger-tracked action.

    ``n_chunks`` is the streaming granularity: 1 = fluid (the simulator),
    N = page-granular (the real transfer plane). ``payload`` is runtime
    state riding along (the simulator hangs the gated request a reload
    unblocks; the real plane hangs its page-copy stream)."""

    nbytes: int
    action_id: int
    pid: str
    replica: int = 0
    channel: Channel = Channel.PCIE
    n_chunks: int = 1
    payload: object = None
    # progress, owned by the lane
    chunks_done: int = 0
    started: bool = False
    cancelled: bool = False


class _Lane:
    """FIFO of :class:`CopyJob` serialized on one physical channel."""

    def __init__(
        self,
        channel: Channel,
        bytes_per_s: float,
        fixed_latency_s: float,
        schedule: Callable[[float, Callable[[float], None]], None],
        on_done: Callable[[CopyJob, float], None],
        on_start: Callable[[CopyJob, float], None] | None = None,
        on_chunk: Callable[[CopyJob, float], None] | None = None,
    ):
        self.channel = channel
        self.bytes_per_s = bytes_per_s
        self.fixed_latency_s = fixed_latency_s
        self.schedule = schedule
        self.on_done = on_done
        self.on_start = on_start
        self.on_chunk = on_chunk
        self.active: CopyJob | None = None
        self.q: deque[CopyJob] = deque()

    # ------------------------------------------------------------ lifecycle
    def enqueue(self, job: CopyJob, now: float) -> None:
        self.q.append(job)
        if self.active is None:
            self._start_next(now)

    def _start_next(self, now: float) -> None:
        if self.active is not None or not self.q:
            return
        job = self.q.popleft()
        self.active = job
        job.started = True
        if self.on_start is not None:
            self.on_start(job, now)  # may (re)size job.n_chunks
        self._schedule_chunk(job, now)

    def _schedule_chunk(self, job: CopyJob, now: float) -> None:
        per_chunk = job.nbytes / max(1, job.n_chunks) / self.bytes_per_s
        dur = per_chunk + (self.fixed_latency_s if job.chunks_done == 0 else 0.0)
        self.schedule(now + dur, lambda t: self._on_chunk_event(job, t))

    def _on_chunk_event(self, job: CopyJob, now: float) -> None:
        # stale completions are dropped: the job was cancelled mid-stream,
        # or the owning replica failed and the lane was reset
        if self.active is not job or job.cancelled:
            return
        job.chunks_done += 1
        if self.on_chunk is not None:
            self.on_chunk(job, now)
        if job.chunks_done < max(1, job.n_chunks):
            self._schedule_chunk(job, now)
            return
        self.active = None
        self.on_done(job, now)
        self._start_next(now)

    # -------------------------------------------------------- cancellation
    def cancel_queued(self, action_id: int) -> CopyJob | None:
        """Drop a still-queued job (never started: nothing to roll back)."""
        for job in self.q:
            if job.action_id == action_id:
                self.q.remove(job)
                job.cancelled = True
                return job
        return None

    def abort(self, action_id: int, now: float) -> CopyJob | None:
        """Cancel queued *or* abort the active job mid-stream. Returns the
        job (``chunks_done`` tells the runtime how much to roll back) or
        None if the id is not pending on this lane."""
        job = self.cancel_queued(action_id)
        if job is not None:
            return job
        if self.active is not None and self.active.action_id == action_id:
            job, self.active = self.active, None
            job.cancelled = True
            self._start_next(now)
            return job
        return None

    def reset(self) -> None:
        """Replica failure: drop everything; in-flight chunk events go stale."""
        if self.active is not None:
            self.active.cancelled = True
            self.active = None
        for job in self.q:
            job.cancelled = True
        self.q.clear()

    # -------------------------------------------------------------- queries
    def jobs(self) -> list[CopyJob]:
        return ([self.active] if self.active is not None else []) + list(self.q)

    def pending_bytes(self) -> int:
        return sum(j.nbytes for j in self.jobs())


@dataclass
class TransferChannels:
    """The two per-replica copy channels (paper §2.2 PCIe + §7.1 NVMe)."""

    cost: TransferCost
    schedule: Callable[[float, Callable[[float], None]], None]
    on_done: Callable[[CopyJob, float], None]
    on_start: Callable[[CopyJob, float], None] | None = None
    on_chunk: Callable[[CopyJob, float], None] | None = None
    lanes: dict[Channel, _Lane] = field(init=False)

    def __post_init__(self) -> None:
        self.lanes = {
            Channel.PCIE: _Lane(
                Channel.PCIE, self.cost.pcie_bytes_per_s,
                self.cost.fixed_latency_s, self.schedule,
                self.on_done, self.on_start, self.on_chunk,
            ),
            Channel.NVME: _Lane(
                Channel.NVME, self.cost.ssd_bytes_per_s,
                self.cost.fixed_latency_s, self.schedule,
                self.on_done, self.on_start, self.on_chunk,
            ),
        }

    def enqueue(self, job: CopyJob, now: float) -> None:
        self.lanes[job.channel].enqueue(job, now)

    def cancel_queued(self, action_id: int) -> CopyJob | None:
        for lane in self.lanes.values():
            job = lane.cancel_queued(action_id)
            if job is not None:
                return job
        return None

    def abort(self, action_id: int, now: float) -> CopyJob | None:
        for lane in self.lanes.values():
            job = lane.abort(action_id, now)
            if job is not None:
                return job
        return None

    def reset(self) -> None:
        for lane in self.lanes.values():
            lane.reset()

    # -------------------------------------------------------------- queries
    def in_flight(self) -> bool:
        return any(lane.jobs() for lane in self.lanes.values())

    def jobs(self) -> list[CopyJob]:
        return [j for lane in self.lanes.values() for j in lane.jobs()]

    def pending_bytes(self, channel: Channel | None = None) -> int:
        lanes = self.lanes.values() if channel is None else [self.lanes[channel]]
        return sum(lane.pending_bytes() for lane in lanes)
