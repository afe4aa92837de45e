"""kvsan — runtime page-lifetime sanitizer for the two-tier ``PagePool``.

Every page in the pool moves through a small lifecycle::

    FREE -> STAGED -> RESIDENT -> OFFLOADING -> HOST -> RELOADING -> ...

* **FREE** — on the pool's free list, owned by nobody.
* **STAGED** — allocated but not yet attached to a radix node, a slot's
  block table, or an explicit hold (suffix pages mid-``submit``, prefill
  staging, transfer-plane staging).
* **RESIDENT** — a device page reachable from a radix node or a live
  block table.
* **OFFLOADING / RELOADING** — the source side of an in-flight
  ``CopyJob`` (held by a transfer stream; must stay valid until commit).
* **HOST** — a host page attached to a radix node.

The sanitizer shadows the real pool: every ``alloc``/``free``/``read``/
``write`` verb reports here, the radix tree and engine register
*reachability* (nodes, block tables, scratch pages), and in-flight work
registers explicit *holds*.  From that shadow state it detects, as hard
errors (:class:`KvsanError`):

* double-free (free of a FREE page) and alloc of a non-free page
  (free-list corruption — the downstream symptom of a double-free),
* free of a page while a pinned radix node (refcount > 0) still points
  at it, or while any hold — live block table, prefill job, in-flight
  copy — covers it (eviction out from under a live decode),
* read / write / append against a FREE page, and appends past the tail
  page of a block table,
* structural corruption on demand via :meth:`verify` (free-list
  duplicates, allocation-count conservation, two nodes sharing a page),
* end-of-replay leaks via :meth:`check_leaks` (allocated pages
  unreachable from any radix node, block table, or hold).

Enabled by exporting ``REPRO_KVSAN=1`` before pools/trees are
constructed.  When off, :func:`maybe_sanitizer` returns ``None`` and the
instrumented seams reduce to one ``is None`` test — zero overhead on the
hot path.
"""
from __future__ import annotations

import contextlib
import os
from collections import deque

#: environment variable gating the sanitizer (read at construction time)
ENV_VAR = "REPRO_KVSAN"

_FREE = 0
_ALLOC = 1

# derived lifecycle states reported by :meth:`PageSanitizer.state_of`
FREE = "FREE"
STAGED = "STAGED"
RESIDENT = "RESIDENT"
OFFLOADING = "OFFLOADING"
HOST = "HOST"
RELOADING = "RELOADING"


def enabled() -> bool:
    """Is kvsan requested for newly constructed pools/trees?"""
    return os.environ.get(ENV_VAR, "").strip().lower() not in (
        "", "0", "false", "off",
    )


class KvsanError(AssertionError):
    """A page-lifetime invariant was violated.

    Subclasses ``AssertionError`` so test harnesses and the repo's
    existing invariant checks treat it uniformly; carries the
    sanitizer's recent event ring for post-mortem."""

    def __init__(self, msg: str, trace=()):
        self.trace = list(trace)
        if self.trace:
            msg += "\n  recent page events (oldest first):\n" + "\n".join(
                f"    {e}" for e in self.trace
            )
        super().__init__(msg)


def maybe_sanitizer(
    *, n_device_pages: int, n_host_pages: int, page_tokens: int
) -> "PageSanitizer | None":
    """The pool-construction entry point: a sanitizer when ``REPRO_KVSAN``
    is set, ``None`` (→ zero instrumentation cost) otherwise."""
    if not enabled():
        return None
    return PageSanitizer(
        n_device_pages=n_device_pages,
        n_host_pages=n_host_pages,
        page_tokens=page_tokens,
    )


class PageSanitizer:
    """Shadow state machine over one ``PagePool``'s pages."""

    def __init__(
        self,
        *,
        n_device_pages: int,
        n_host_pages: int,
        page_tokens: int,
        trace_len: int = 128,
    ):
        self.page_tokens = page_tokens
        self._state = {
            "dev": [_FREE] * n_device_pages,
            "host": [_FREE] * n_host_pages,
        }
        self._trace: deque[str] = deque(maxlen=trace_len)
        self._last: dict[tuple[str, int], str] = {}
        self._scope = "init"
        # wired up by the owning pool / engine
        self.pool = None              # PagePool (free-list introspection)
        self.tree = None              # TypedRadixTree (pin / reachability)
        self._reachable_cbs: list = []   # () -> iterable[(tier, page, tag)]
        # explicit holds: token -> (tier, (pages...), tag)
        self._holds: dict[int, tuple[str, tuple[int, ...], str]] = {}
        self._next_hold = 0
        # >0 inside an owned_pin_frees() region (see below)
        self._pin_free_depth = 0

    # ------------------------------------------------------------- wiring
    def set_scope(self, tag: str) -> None:
        """Name the operation in flight; stamped onto every event."""
        self._scope = tag

    def add_reachable_cb(self, fn) -> None:
        """Register a callback enumerating live page references as
        ``(tier, page, tag)`` triples (block tables, scratch pages)."""
        self._reachable_cbs.append(fn)

    def add_hold(self, tier: str, pages, tag: str) -> int:
        """Mark ``pages`` as held (in-flight copy source/staging, prefill
        staging): freeing a held page is a hard error until
        :meth:`drop_hold`. Returns an opaque token."""
        tok = self._next_hold
        self._next_hold += 1
        self._holds[tok] = (tier, tuple(pages), tag)
        self._event(f"hold[{tag}] {tier}:{list(pages)}")
        return tok

    def drop_hold(self, token: int) -> None:
        tier, pages, tag = self._holds.pop(token)
        self._event(f"drop-hold[{tag}] {tier}:{list(pages)}")

    @contextlib.contextmanager
    def owned_pin_frees(self, tag: str):
        """Custody-transfer region: the caller holds the pin on the nodes
        whose pages it is about to free (a transfer stream committing its
        own offload retires the device copies *before* it unpins).  The
        free-while-pinned check is suspended inside; every other check
        (double-free, holds, block-table reachability) stays armed."""
        self._event(f"owned-pin-frees[{tag}] begin")
        self._pin_free_depth += 1
        try:
            yield
        finally:
            self._pin_free_depth -= 1
            self._event(f"owned-pin-frees[{tag}] end")

    # ------------------------------------------------------------- events
    def _event(self, msg: str) -> str:
        line = f"[{self._scope}] {msg}"
        self._trace.append(line)
        return line

    def _page_event(self, tier: str, page: int, verb: str) -> None:
        self._last[(tier, page)] = self._event(f"{verb} {tier}:{page}")

    def _last_event(self, tier: str, page: int) -> str:
        return self._last.get((tier, page), "<no event recorded>")

    def _raise(self, msg: str) -> None:
        raise KvsanError(msg, self._trace)

    # ------------------------------------------------- pool verb hooks
    def on_alloc(self, tier: str, page: int) -> None:
        st = self._state[tier]
        if st[page] != _FREE:
            self._raise(
                f"allocator returned {tier} page {page} which is already "
                f"allocated — free-list corruption (typically the echo of "
                f"an earlier double-free); last event: "
                f"{self._last_event(tier, page)}"
            )
        st[page] = _ALLOC
        self._page_event(tier, page, "alloc")

    def on_free(self, tier: str, page: int) -> None:
        st = self._state[tier]
        if not (0 <= page < len(st)):
            self._raise(f"free of out-of-range {tier} page {page}")
        if st[page] == _FREE:
            self._raise(
                f"double-free of {tier} page {page}; "
                f"last event: {self._last_event(tier, page)}"
            )
        # free-while-pinned: a refcount-held radix node still points here.
        # Device side only — host pages of pinned nodes are legitimately
        # freed while streaming a reload (the pin protects the KV, which
        # at that moment lives in the freshly-staged device copy).
        if tier == "dev" and self.tree is not None and not self._pin_free_depth:
            for node in self.tree._iter_nodes():
                if node.device_page == page and node.refcount > 0:
                    self._raise(
                        f"free of dev page {page} while radix node "
                        f"{node.node_id} still pins it "
                        f"(refcount={node.refcount})"
                    )
        for _tok, (htier, pages, tag) in self._holds.items():
            if htier == tier and page in pages:
                self._raise(
                    f"free of {tier} page {page} while held by [{tag}]"
                )
        for fn in self._reachable_cbs:
            for rtier, rpage, tag in fn():
                if rtier == tier and rpage == page:
                    self._raise(
                        f"free of {tier} page {page} while referenced by "
                        f"[{tag}] — eviction out from under a live decode"
                    )
        st[page] = _FREE
        self._page_event(tier, page, "free")

    def on_read(self, tier: str, page: int) -> None:
        if self._state[tier][page] == _FREE:
            self._raise(
                f"read-after-free of {tier} page {page}; "
                f"last event: {self._last_event(tier, page)}"
            )

    def on_write(self, tier: str, page: int) -> None:
        if self._state[tier][page] == _FREE:
            self._raise(
                f"write-after-free of {tier} page {page}; "
                f"last event: {self._last_event(tier, page)}"
            )
        self._page_event(tier, page, "write")

    def on_format(self, tier: str, page: int, fmt: str) -> None:
        """A page was (re)written in a declared tier format — a lifecycle
        event like alloc/write: format transitions (bf16→int8 on offload,
        int8→bf16 on reload to a full-precision pool) land in the event
        ring so a post-mortem shows *what representation* a corrupted page
        last held, and writing a format into a FREE page is the same hard
        error as any other write-after-free."""
        if self._state[tier][page] == _FREE:
            self._raise(
                f"format write ({fmt}) to FREE {tier} page {page}; "
                f"last event: {self._last_event(tier, page)}"
            )
        self._page_event(tier, page, f"format[{fmt}]")

    def on_append(self, tier: str, page: int, offset: int) -> None:
        if not (0 <= offset < self.page_tokens):
            self._raise(
                f"append past the tail page: offset {offset} outside "
                f"[0, {self.page_tokens}) on {tier} page {page}"
            )
        self.on_write(tier, page)

    # --------------------------------------------------- engine-side checks
    def check_table(self, table, pos: int, pid: str) -> None:
        """Validate one slot's block table before a decode step: the write
        position must land inside the table and every referenced page must
        be live."""
        T = self.page_tokens
        if pos // T >= len(table):
            self._raise(
                f"decode for {pid} would append past the tail page: "
                f"position {pos} needs table entry {pos // T} but the "
                f"block table has only {len(table)} pages"
            )
        for p in table:
            if self._state["dev"][p] == _FREE:
                self._raise(
                    f"block table of {pid} references freed dev page {p}; "
                    f"last event: {self._last_event('dev', p)}"
                )

    # ------------------------------------------------------- derived state
    def state_of(self, tier: str, page: int) -> str:
        """The page's lifecycle state, derived from the shadow tables."""
        if self._state[tier][page] == _FREE:
            return FREE
        held_tag = None
        for _tok, (htier, pages, tag) in self._holds.items():
            if htier == tier and page in pages:
                held_tag = tag
                break
        if held_tag is not None and held_tag.startswith("offload"):
            return OFFLOADING if tier == "dev" else STAGED
        if held_tag is not None and held_tag.startswith("reload"):
            return RELOADING if tier == "host" else STAGED
        if self.tree is not None:
            attr = "device_page" if tier == "dev" else "host_page"
            for node in self.tree._iter_nodes():
                if getattr(node, attr) == page:
                    return RESIDENT if tier == "dev" else HOST
        for fn in self._reachable_cbs:
            for rtier, rpage, _tag in fn():
                if rtier == tier and rpage == page:
                    return RESIDENT
        return STAGED

    def _reachable(self, tier: str) -> dict[int, str]:
        """page -> tag for every live reference on ``tier``."""
        out: dict[int, str] = {}
        if self.tree is not None:
            attr = "device_page" if tier == "dev" else "host_page"
            for node in self.tree._iter_nodes():
                p = getattr(node, attr)
                if p is not None:
                    out[p] = f"radix node {node.node_id}"
        for _tok, (htier, pages, tag) in self._holds.items():
            if htier == tier:
                for p in pages:
                    out[p] = f"hold[{tag}]"
        for fn in self._reachable_cbs:
            for rtier, rpage, tag in fn():
                if rtier == tier:
                    out[rpage] = tag
        return out

    # -------------------------------------------------- structural checks
    def verify(self, context: str = "") -> None:
        """Structural invariants over the whole pool — free-list integrity,
        allocation conservation, no two radix nodes sharing a page, no
        node referencing a freed page. O(pages + nodes); call at seam
        points (router ticks, end of replay), not per token."""
        where = f" ({context})" if context else ""
        if self.pool is not None:
            lists = (
                ("dev", self.pool._free_dev), ("host", self.pool._free_host),
            )
            for tier, free_list in lists:
                st = self._state[tier]
                if len(set(free_list)) != len(free_list):
                    dupes = sorted(
                        p for p in set(free_list) if free_list.count(p) > 1
                    )
                    self._raise(
                        f"{tier} free list contains duplicates {dupes}{where}"
                    )
                for p in free_list:
                    if not (0 <= p < len(st)):
                        self._raise(
                            f"{tier} free list holds out-of-range page "
                            f"{p}{where}"
                        )
                    if st[p] != _FREE:
                        self._raise(
                            f"{tier} free list holds page {p} the shadow "
                            f"state says is allocated{where}; last event: "
                            f"{self._last_event(tier, p)}"
                        )
                n_alloc = sum(1 for s in st if s == _ALLOC)
                if len(free_list) + n_alloc != len(st):
                    self._raise(
                        f"{tier} page conservation broken{where}: "
                        f"{len(free_list)} free + {n_alloc} allocated != "
                        f"{len(st)} total"
                    )
        if self.tree is not None:
            for tier, attr in (("dev", "device_page"), ("host", "host_page")):
                owner: dict[int, int] = {}
                for node in self.tree._iter_nodes():
                    if node.refcount < 0:
                        self._raise(
                            f"radix node {node.node_id} refcount underflow "
                            f"({node.refcount}){where}"
                        )
                    p = getattr(node, attr)
                    if p is None:
                        continue
                    if self._state[tier][p] == _FREE:
                        self._raise(
                            f"radix node {node.node_id} references freed "
                            f"{tier} page {p}{where}; last event: "
                            f"{self._last_event(tier, p)}"
                        )
                    if p in owner:
                        self._raise(
                            f"{tier} page {p} referenced by two radix nodes "
                            f"({owner[p]} and {node.node_id}){where}"
                        )
                    owner[p] = node.node_id

    def check_leaks(self, context: str = "") -> None:
        """Every allocated page must be reachable from a radix node, a
        block table / scratch registration, or an explicit hold."""
        where = f" ({context})" if context else ""
        for tier in ("dev", "host"):
            reach = self._reachable(tier)
            leaked = [
                p
                for p, s in enumerate(self._state[tier])
                if s == _ALLOC and p not in reach
            ]
            if leaked:
                detail = "; ".join(
                    f"{tier}:{p} last event: {self._last_event(tier, p)}"
                    for p in leaked[:8]
                )
                self._raise(
                    f"{len(leaked)} leaked {tier} page(s){where}: "
                    f"{leaked[:16]} — allocated but unreachable from any "
                    f"radix node, block table, or hold. {detail}"
                )
