"""Per-replica asynchronous transfer executor for the real serving path.

This is what makes the paper's thesis *true on the real engine*: an
``Offload`` or reloading ``Forward`` no longer executes (and acks)
synchronously inside ``MoriRouter.apply_plan`` — it becomes a
:class:`~repro_torch.core.transfers.CopyJob` on the replica's PCIe/NVMe channel
queues (:class:`~repro_torch.core.transfers.TransferChannels`, the same FIFO
model the simulator runs), chunked at *page granularity* on the router's
virtual clock. Pages stream one per chunk tick while the engine keeps
decoding; ``scheduler.on_transfer_complete`` fires only when the last
page lands. Until then the scheduler's ledger shows the transfer open —
so a tool call that returns early finds its offload still pending and the
scheduler's ``CancelTransfer`` path genuinely aborts a partially-streamed
copy: staged host pages are rolled back and the program re-admits warm
off its untouched device pages.

Admission is *endpoint-addressed*: every transfer-bearing action lowers
to a :class:`~repro_torch.core.transfers.CopyRequest` (``src``/``dst`` =
``Endpoint(replica, tier)``), and the plane dispatches on the copy's
geometry — same-replica down-tier (offload), same-replica up-tier
(reload), cross-replica (migrate) — instead of on the action class.

Three streaming strategies cover the engines and copy shapes:

* :class:`_PagedStream` (dense :class:`~repro_torch.serving.engine.Engine`) —
  copies one radix page per chunk through the pool's copy-without-free
  primitives; the *move* commits atomically at job completion (free
  device pages / flip node pointers), so an abort at chunk *k* only has
  *k* staged host pages to discard.
* :class:`_MigrateStream` — the cross-replica shape: one page per chunk
  from the source replica's host tier (device-only pages are first
  staged through the source host) into the destination pool via
  :meth:`~repro_torch.serving.kvpool.PagePool.import_host_page`
  (format-tagged verbatim payload — bf16 raw bits or int8 payload plus
  scale sidecars, matching the pools' shared ``offload_format`` — so
  the landed KV is byte-identical). Commit installs the imported pages
  as a host-resident radix chain on the destination
  (:meth:`~repro_torch.core.radix_tree.TypedRadixTree.insert_host_chain`) and
  retires the source copies; an abort discards the imports and leaves
  the source replica untouched.
* :class:`_AtomicStream` (:class:`~repro_torch.serving.ssm_engine.SsmEngine`
  and anything else bundle-granular) — the whole verb executes at job
  completion; an abort before that moved nothing and rolls back nothing.

Provisioning note: copy-then-commit means both copies of an in-flight
transfer exist simultaneously and the source pages are pinned against
engine-level eviction until commit/abort. Size the physical pools with
headroom above the scheduler's tier budgets for the largest expected
in-flight transfer (real systems reserve staging buffers the same way);
a reload that finds the device pool exhausted mid-stream degrades
gracefully by committing the pages it has staged so far.
"""
from __future__ import annotations

import contextlib
import heapq
import itertools
from typing import Callable

from repro_torch.core.transfers import (
    CopyJob,
    CopyRequest,
    TransferChannels,
    copy_request_for,
)
from repro_torch.core.types import Tier, TransferCost, TypeLabel


class _PagedStream:
    """Page-granular streamed copy against the dense engine's PagePool."""

    def __init__(self, engine, pid: str, kind: str):
        self.engine = engine
        self.pid = pid
        self.kind = kind
        tree, nodes = engine.tree, engine.tree.program_nodes(pid)
        if kind == "offload":
            # leaves first, matching Engine.offload_program; shared-prefix
            # nodes pinned by another running program are left in place
            self.nodes = [
                n for n in reversed(nodes)
                if n.device_page is not None and n.refcount == 0
            ]
        else:
            self.nodes = [
                n for n in nodes
                if n.device_page is None and n.host_page is not None
            ]
        self.copied: list[tuple[object, int]] = []
        self._next = 0
        # protect the nodes from engine-level eviction while the copy is
        # in flight (balanced by unpin in commit/abort)
        tree.pin(pid)
        # kvsan: the source pages of an in-flight CopyJob must stay valid
        # until commit/abort — hold them (and each staged page as it is
        # copied) so a buggy free mid-stream is caught at the free site
        self._san = engine.pool._san
        self._holds: list[int] = []
        if self._san is not None:
            src_tier = "dev" if kind == "offload" else "host"
            src_pages = [
                n.device_page if kind == "offload" else n.host_page
                for n in self.nodes
            ]
            self._holds.append(
                self._san.add_hold(src_tier, src_pages, f"{kind} src:{pid}")
            )

    @property
    def n_units(self) -> int:
        return len(self.nodes)

    def copy_unit(self) -> None:
        """Stage the next page across the wire (source stays valid)."""
        if self._next >= len(self.nodes):
            return
        node = self.nodes[self._next]
        self._next += 1
        pool = self.engine.pool
        if self.kind == "offload":
            if node.device_page is None:
                return  # evicted out from under us before the pin landed
            self.engine._ensure_host_page()
            hp = pool.copy_page_to_host(node.device_page)
            if hp is not None:
                self.copied.append((node, hp))
                if self._san is not None:
                    self._holds.append(self._san.add_hold(
                        "host", [hp], f"offload staging:{self.pid}"
                    ))
        else:
            if node.host_page is None:
                return
            try:
                self.engine._ensure_device_page()
            except RuntimeError:
                # device pool exhausted with nothing evictable (everything
                # pinned): stop staging — the commit lands what was copied
                # and Engine.submit's _reload_prefix retries the rest once
                # decode slots release their pins
                return
            dp = pool.copy_page_to_device(node.host_page)
            if dp is not None:
                self.copied.append((node, dp))
                if self._san is not None:
                    self._holds.append(self._san.add_hold(
                        "dev", [dp], f"reload staging:{self.pid}"
                    ))

    def _settle_holds(self) -> None:
        """The stream is settling (commit or abort): its frees below are
        legitimate, so release every sanitizer hold first."""
        if self._san is not None:
            self._san.set_scope(f"{self.kind} settle:{self.pid}")
            for tok in self._holds:
                self._san.drop_hold(tok)
            self._holds = []

    def commit(self) -> int:
        """All pages landed: atomically retire the source copies."""
        self._settle_holds()
        pool = self.engine.pool
        n = 0
        # the sources retired below are pinned by *this stream's own*
        # tree.pin (released right after the loop) — tell the sanitizer
        # these frees are the pin owner's custody transfer, not eviction
        own = (
            self._san.owned_pin_frees(f"{self.kind} commit:{self.pid}")
            if self._san is not None
            else contextlib.nullcontext()
        )
        with own:
            n = self._commit_pages(pool)
        self.engine.tree.unpin(self.pid)
        return n

    def _commit_pages(self, pool) -> int:
        n = 0
        for node, page in self.copied:
            if self.kind == "offload":
                if node.refcount > 1:
                    # another program pinned this shared-prefix page while
                    # the copy streamed (our own pin accounts for 1):
                    # retiring the device page now would yank warm KV out
                    # from under an active decode — keep it, drop the
                    # staged host copy (mirrors offload_program skipping
                    # pinned nodes)
                    pool.free_host(page)
                    continue
                if node.device_page is not None:
                    pool.free_device(node.device_page)
                    node.device_page = None
                if node.host_page is None:
                    node.host_page = page
                    pool.bill_offload()
                    n += 1
                else:           # engine spilled it itself mid-stream
                    pool.free_host(page)
            else:
                if node.host_page is not None:
                    pool.free_host(node.host_page)
                    node.host_page = None
                if node.device_page is None:
                    node.device_page = page
                    pool.bill_reload()
                    n += 1
                else:
                    pool.free_device(page)
        return n

    def abort(self) -> int:
        """Mid-stream cancel: discard the staged partial page set. The
        source pages were never freed, so the program's KV is intact
        exactly where it was."""
        self._settle_holds()
        pool = self.engine.pool
        for _node, page in self.copied:
            if self.kind == "offload":
                pool.free_host(page)
            else:
                pool.free_device(page)
        self.engine.tree.unpin(self.pid)
        return len(self.copied)


class _AtomicStream:
    """Whole-bundle move at commit time (SSM engine & friends)."""

    def __init__(self, engine, pid: str, kind: str):
        self.engine = engine
        self.pid = pid
        self.kind = kind

    @property
    def n_units(self) -> int:
        return 1

    def copy_unit(self) -> None:
        pass

    def commit(self) -> int:
        if self.kind == "offload":
            return self.engine.offload_program(self.pid)
        return self.engine.reload_program(self.pid)

    def abort(self) -> int:
        return 0  # nothing moved before commit


class _MigrateStream:
    """Page-granular cross-replica move: source host tier → destination
    host tier, one page per chunk, through the pools'
    copy-without-free primitives (format-tagged: the payload moves
    verbatim in the shared ``offload_format``, scale sidecars included). Device-only pages on the source (e.g. a
    shared prefix that was never offloaded) are first staged through the
    source host tier. Commit installs the imported pages as a
    host-resident radix chain on the destination and retires the source
    copies (move semantics); an abort discards the imports and staging
    and leaves the source replica untouched — the same
    cancellable-mid-stream contract as :class:`_PagedStream`."""

    kind = "migrate"

    def __init__(self, src_engine, dst_engine, pid: str):
        self.src = src_engine
        self.dst = dst_engine
        self.pid = pid
        self.nodes = list(src_engine.tree.program_nodes(pid))
        # (src node, imported dst host page, src staging page or None)
        self.copied: list[tuple[object, int, int | None]] = []
        self._next = 0
        self._stopped = False
        # protect the source chain from engine-level eviction while the
        # copy is in flight (balanced by unpin in commit/abort)
        src_engine.tree.pin(pid)
        # kvsan: two pools, two sanitizers — hold the source pages on the
        # source sanitizer and each imported/staged page as it appears
        self._src_san = src_engine.pool._san
        self._dst_san = dst_engine.pool._san
        self._src_holds: list[int] = []
        self._dst_holds: list[int] = []
        if self._src_san is not None:
            host_src = [n.host_page for n in self.nodes if n.host_page is not None]
            dev_src = [
                n.device_page for n in self.nodes
                if n.host_page is None and n.device_page is not None
            ]
            if host_src:
                self._src_holds.append(
                    self._src_san.add_hold("host", host_src, f"migrate src:{pid}")
                )
            if dev_src:
                self._src_holds.append(
                    self._src_san.add_hold("dev", dev_src, f"migrate src:{pid}")
                )

    @property
    def n_units(self) -> int:
        return len(self.nodes)

    def copy_unit(self) -> None:
        """Import the next page into the destination pool. The landed
        chain must stay contiguous from the prefix root, so the first
        page that cannot be sourced or imported stops the stream — commit
        lands the contiguous prefix copied so far."""
        if self._stopped or self._next >= len(self.nodes):
            return
        node = self.nodes[self._next]
        self._next += 1
        staging = None
        src_hp = node.host_page
        if src_hp is None:
            if node.device_page is None:
                self._stopped = True
                return
            # device-only page: stage through the source host tier first
            self.src._ensure_host_page()
            staging = self.src.pool.copy_page_to_host(node.device_page)
            if staging is None:
                self._stopped = True
                return
            if self._src_san is not None:
                self._src_holds.append(self._src_san.add_hold(
                    "host", [staging], f"migrate staging:{self.pid}"
                ))
            src_hp = staging
        self.dst._ensure_host_page()
        hp = self.dst.pool.import_host_page(self.src.pool, src_hp)
        if hp is None:
            self._stopped = True
            return
        if self._dst_san is not None:
            self._dst_holds.append(self._dst_san.add_hold(
                "host", [hp], f"migrate import:{self.pid}"
            ))
        self.copied.append((node, hp, staging))

    def _settle_holds(self) -> None:
        if self._src_san is not None:
            self._src_san.set_scope(f"migrate settle:{self.pid}")
            for tok in self._src_holds:
                self._src_san.drop_hold(tok)
            self._src_holds = []
        if self._dst_san is not None:
            self._dst_san.set_scope(f"migrate settle:{self.pid}")
            for tok in self._dst_holds:
                self._dst_san.drop_hold(tok)
            self._dst_holds = []

    def commit(self) -> int:
        """Install the imported chain on the destination and retire the
        source copies."""
        self._settle_holds()
        for _node, _hp, staging in self.copied:
            if staging is not None:
                self.src.pool.free_host(staging)
        tokens = [t for node, _, _ in self.copied for t in node.tokens]
        pages = [hp for _, hp, _ in self.copied]
        if pages:
            _nodes, duplicates = self.dst.tree.insert_host_chain(
                tokens, pages, self.pid, TypeLabel.IDLE
            )
            for hp in duplicates:
                self.dst.pool.free_host(hp)
        self.src.tree.unpin(self.pid)
        # retire the source copies: frees refcount-0 pages on either tier
        # and releases the program entry once nothing is resident. Pages a
        # live decode on the source still pins are left alone — for those
        # the migrate degrades to a copy, exactly like a shared-prefix
        # offload keeping its device page.
        self.src.discard_program(self.pid, Tier.CPU)
        self.src.discard_program(self.pid, Tier.GPU)
        return len(pages)

    def abort(self) -> int:
        """Mid-stream cancel: drop the imports and staging; the source
        replica's KV is intact exactly where it was."""
        self._settle_holds()
        for _node, hp, staging in self.copied:
            self.dst.pool.free_host(hp)
            if staging is not None:
                self.src.pool.free_host(staging)
        self.src.tree.unpin(self.pid)
        return len(self.copied)


class _PlaneTask:
    """Runtime payload riding on a CopyJob."""

    __slots__ = ("kind", "act", "creq", "stream")

    def __init__(self, kind: str, act, creq: CopyRequest | None = None):
        self.kind = kind
        self.act = act
        self.creq = creq
        self.stream: _PagedStream | _AtomicStream | _MigrateStream | None = None


class ReplicaTransferPlane:
    """Chunked async executor of one replica's Offload / reload jobs.

    Completions run on the router's virtual clock: ``schedule`` targets an
    internal eta-ordered heap, :meth:`advance` drains everything due, and
    the ``wake`` hook tells the router's replay loop to revisit that
    timestamp so no completion is stranded between trace events.
    """

    def __init__(
        self,
        replica_id: int,
        engine,
        cost: TransferCost,
        *,
        wake: Callable[[float], None],
        on_committed: Callable[[CopyJob, str, int, float], None],
        peer_engine: Callable[[int], object] | None = None,
    ):
        self.replica_id = replica_id
        self.engine = engine
        self.wake = wake
        self.on_committed = on_committed
        # resolver for cross-replica copies: replica id -> that replica's
        # engine (installed by the router; a single-replica plane has none)
        self.peer_engine = peer_engine
        # monotone progress counter the router's stall guard reads: every
        # executed chunk tick counts, whether or not its job ever commits
        self.chunks_executed = 0
        self._heap: list[tuple[float, int, Callable[[float], None]]] = []
        self._seq = itertools.count()
        self.channels = TransferChannels(
            cost=cost,
            schedule=self._schedule,
            on_start=self._job_start,
            on_chunk=self._job_chunk,
            on_done=self._job_done,
        )

    # ---------------------------------------------------------- virtual clock
    def _schedule(self, eta: float, fn: Callable[[float], None]) -> None:
        heapq.heappush(self._heap, (eta, next(self._seq), fn))
        self.wake(eta)

    def advance(self, now: float) -> None:
        """Run every due chunk/completion, in eta order, stamping each with
        its own eta (not ``now``) so ledger acks carry faithful times."""
        while self._heap and self._heap[0][0] <= now:
            eta, _, fn = heapq.heappop(self._heap)
            fn(eta)

    # ------------------------------------------------------------ admission
    def enqueue(self, act, now: float) -> None:
        """Thin adapter from the action IR: lower to a CopyRequest."""
        self.enqueue_request(copy_request_for(act), now, act=act)

    def enqueue_request(self, creq: CopyRequest, now: float, act=None) -> None:
        """Endpoint-addressed admission: the request's geometry picks the
        kind and channel; this plane must be the executing (destination)
        replica."""
        assert creq.exec_replica == self.replica_id, (
            f"copy executes on replica {creq.exec_replica}, "
            f"enqueued on plane {self.replica_id}"
        )
        task = _PlaneTask(creq.kind, act, creq)
        self.channels.enqueue(creq.job(payload=task), now)

    # ------------------------------------------------------- job lifecycle
    def _job_start(self, job: CopyJob, now: float) -> None:
        """Bind the page set when the job reaches the channel head — not at
        enqueue: a reload queued behind the same program's offload must see
        the host pages that offload's commit is about to produce."""
        task: _PlaneTask = job.payload
        if task.kind == "migrate":
            if self.peer_engine is None:
                raise RuntimeError(
                    "cross-replica copy enqueued on a plane with no "
                    "peer_engine resolver"
                )
            src_engine = self.peer_engine(task.creq.src.replica)
            task.stream = _MigrateStream(src_engine, self.engine, job.pid)
        elif hasattr(self.engine, "tree") and hasattr(
            getattr(self.engine, "pool", None), "copy_page_to_host"
        ):
            task.stream = _PagedStream(self.engine, job.pid, task.kind)
        else:
            task.stream = _AtomicStream(self.engine, job.pid, task.kind)
        job.n_chunks = max(1, task.stream.n_units)

    def _job_chunk(self, job: CopyJob, now: float) -> None:
        task: _PlaneTask = job.payload
        self.chunks_executed += 1
        task.stream.copy_unit()

    def _job_done(self, job: CopyJob, now: float) -> None:
        task: _PlaneTask = job.payload
        pages = task.stream.commit()
        self.on_committed(job, task.kind, pages, now)

    # ---------------------------------------------------------- cancellation
    def abort(self, action_id: int, now: float) -> tuple[CopyJob, int] | None:
        """Cancel a queued job or abort an in-stream one; returns the job
        and the number of staged pages rolled back."""
        job = self.channels.abort(action_id, now)
        if job is None:
            return None
        task: _PlaneTask = job.payload
        rolled = task.stream.abort() if task.stream is not None else 0
        return job, rolled

    def abort_pid(self, pid: str, now: float) -> list[tuple[CopyJob, int]]:
        out = []
        for job in list(self.channels.jobs()):
            if job.pid == pid:
                res = self.abort(job.action_id, now)
                if res is not None:
                    out.append(res)
        return out

    # -------------------------------------------------------------- queries
    def in_flight(self) -> bool:
        return self.channels.in_flight()

    def pending_bytes(self) -> int:
        return self.channels.pending_bytes()

    def describe_jobs(self) -> list[str]:
        """Human-readable in-flight/queued jobs, for stall diagnostics."""
        return [
            f"{j.pid}#{j.action_id} {j.payload.kind} "
            f"({j.chunks_done}/{max(1, j.n_chunks)} chunks, {j.nbytes}B)"
            for j in self.channels.jobs()
        ]
