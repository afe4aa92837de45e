"""Typed radix tree over paged KV blocks (paper §4.3.2).

The real engine (``repro_torch.serving``) stores KV in fixed-size pages; this tree
maps token-block chains to page ids so programs sharing a prefix share pages
(RadixAttention-style reuse). Each node carries:

* a *type label* (busy / idle / inactive) stamped from its program's tier —
  the scheduler's program-level placement propagated to block granularity;
* a *location* per tier (device page id and/or host page id);
* an LRU timestamp and a refcount.

Eviction is LRU at its core but uses the type label as the higher-priority
sort key, with the priority order **reversed** between tiers
(``GPU_EVICTION_ORDER`` vs ``CPU_EVICTION_ORDER``) so each tier preferentially
retains the programs assigned to it.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

from repro_torch.analysis import kvsan
from repro_torch.core.types import (
    CPU_EVICTION_ORDER,
    GPU_EVICTION_ORDER,
    TypeLabel,
)

_counter = itertools.count()


@dataclass
class RadixNode:
    """One KV page worth of tokens."""

    tokens: tuple[int, ...]
    parent: "RadixNode | None"
    children: dict[tuple[int, ...], "RadixNode"] = field(default_factory=dict)
    device_page: int | None = None
    host_page: int | None = None
    label: TypeLabel = TypeLabel.BUSY
    last_access: int = 0
    refcount: int = 0
    node_id: int = field(default_factory=lambda: next(_counter))

    @property
    def depth(self) -> int:
        d, n = 0, self.parent
        while n is not None:
            d, n = d + 1, n.parent
        return d

    def is_leaf_on(self, tier: str) -> bool:
        attr = "device_page" if tier == "gpu" else "host_page"
        return not any(getattr(c, attr) is not None for c in self.children.values())


class TypedRadixTree:
    """Prefix tree at page (block) granularity with typed two-tier eviction."""

    def __init__(self, page_tokens: int):
        self.page_tokens = page_tokens
        self.root = RadixNode(tokens=(), parent=None)
        self._clock = itertools.count(1)
        # program_id -> list of nodes along its path (for label re-stamping)
        self._program_nodes: dict[str, list[RadixNode]] = {}
        # kvsan strict mode: refcount underflow and unbalanced pin/unpin
        # become hard errors instead of being clamped away silently
        self._strict = kvsan.enabled()
        self._pin_depth: dict[str, int] = {}

    # ------------------------------------------------------------- lookup
    def match_prefix(self, tokens: list[int]) -> list[RadixNode]:
        """Longest chain of *device-resident* full pages matching ``tokens``."""
        out: list[RadixNode] = []
        node = self.root
        t = next(self._clock)
        for i in range(0, len(tokens) - self.page_tokens + 1, self.page_tokens):
            key = tuple(tokens[i : i + self.page_tokens])
            child = node.children.get(key)
            if child is None or child.device_page is None:
                break
            child.last_access = t
            out.append(child)
            node = child
        return out

    def match_prefix_any_tier(self, tokens: list[int]) -> list[RadixNode]:
        """Longest chain resident on *either* tier (device or host)."""
        out: list[RadixNode] = []
        node = self.root
        for i in range(0, len(tokens) - self.page_tokens + 1, self.page_tokens):
            key = tuple(tokens[i : i + self.page_tokens])
            child = node.children.get(key)
            if child is None or (child.device_page is None and child.host_page is None):
                break
            out.append(child)
            node = child
        return out

    # ------------------------------------------------------------- insert
    def insert_chain(
        self,
        tokens: list[int],
        page_ids: list[int],
        program_id: str,
        label: TypeLabel,
    ) -> list[RadixNode]:
        """Insert/extend a path of full pages; stamp with the program's type."""
        node = self.root
        nodes: list[RadixNode] = []
        t = next(self._clock)
        pi = 0
        for i in range(0, len(tokens) - self.page_tokens + 1, self.page_tokens):
            key = tuple(tokens[i : i + self.page_tokens])
            child = node.children.get(key)
            if child is None:
                child = RadixNode(tokens=key, parent=node)
                node.children[key] = child
            if child.device_page is None:
                if pi >= len(page_ids):
                    raise ValueError("not enough pages supplied for new nodes")
                child.device_page = page_ids[pi]
                pi += 1
            child.label = label
            child.last_access = t
            nodes.append(child)
            node = child
        if pi != len(page_ids):
            raise ValueError(f"supplied {len(page_ids)} pages, consumed {pi}")
        self._program_nodes[program_id] = nodes
        return nodes

    def insert_host_chain(
        self,
        tokens: list[int],
        host_page_ids: list[int],
        program_id: str,
        label: TypeLabel,
    ) -> tuple[list[RadixNode], list[int]]:
        """Insert/extend a path of full pages resident on the *host* tier —
        the landing verb for a cross-replica migrate: imported DRAM pages
        become a host-resident prefix chain, reloadable to the GPU by the
        normal reload path. One page id is consumed per chain node; a node
        that already holds a host copy keeps it and the supplied duplicate
        is returned for the caller to free (share-on-match at the host
        tier, mirroring :meth:`insert_chain`'s device-side semantics)."""
        node = self.root
        nodes: list[RadixNode] = []
        duplicates: list[int] = []
        t = next(self._clock)
        pi = 0
        for i in range(0, len(tokens) - self.page_tokens + 1, self.page_tokens):
            key = tuple(tokens[i : i + self.page_tokens])
            child = node.children.get(key)
            if child is None:
                child = RadixNode(tokens=key, parent=node)
                node.children[key] = child
            if pi >= len(host_page_ids):
                raise ValueError("not enough host pages supplied for new nodes")
            if child.host_page is None:
                child.host_page = host_page_ids[pi]
            else:
                duplicates.append(host_page_ids[pi])
            pi += 1
            child.label = label
            child.last_access = t
            nodes.append(child)
            node = child
        if pi != len(host_page_ids):
            raise ValueError(f"supplied {len(host_page_ids)} pages, consumed {pi}")
        self._program_nodes[program_id] = nodes
        return nodes, duplicates

    # -------------------------------------------------------------- labels
    def restamp(self, program_id: str, label: TypeLabel) -> None:
        """Propagate a scheduler label change onto the program's blocks."""
        for node in self._program_nodes.get(program_id, []):
            node.label = label

    def pin(self, program_id: str) -> None:
        self._pin_depth[program_id] = self._pin_depth.get(program_id, 0) + 1
        self.acquire_nodes(self._program_nodes.get(program_id, []))

    def unpin(self, program_id: str) -> None:
        depth = self._pin_depth.get(program_id, 0)
        if depth <= 0:
            if self._strict:
                raise kvsan.KvsanError(
                    f"unpin({program_id!r}) without a matching pin — "
                    f"refcount underflow hidden by the clamp"
                )
        else:
            self._pin_depth[program_id] = depth - 1
        self.release_nodes(self._program_nodes.get(program_id, []))

    def acquire_nodes(self, nodes) -> None:
        """Refcount-hold a node chain (a block table, an in-flight reload).
        Must be balanced by :meth:`release_nodes` on every path."""
        for node in nodes:
            node.refcount += 1

    def release_nodes(self, nodes) -> None:
        """Drop a :meth:`acquire_nodes` hold. Under kvsan an underflow is a
        hard error; otherwise it clamps at zero (the historical, silently
        forgiving behaviour)."""
        for node in nodes:
            if node.refcount <= 0 and self._strict:
                raise kvsan.KvsanError(
                    f"refcount underflow releasing radix node "
                    f"{node.node_id} (device_page={node.device_page}, "
                    f"host_page={node.host_page}) — release without a "
                    f"matching acquire"
                )
            node.refcount = max(0, node.refcount - 1)

    def release_program(self, program_id: str) -> None:
        if self._strict and self._pin_depth.get(program_id, 0) > 0:
            raise kvsan.KvsanError(
                f"release_program({program_id!r}) with "
                f"{self._pin_depth[program_id]} outstanding pin(s) — an "
                f"in-flight hold still references the program's chain"
            )
        self._pin_depth.pop(program_id, None)
        self._program_nodes.pop(program_id, None)

    def program_nodes(self, program_id: str) -> list[RadixNode]:
        return self._program_nodes.get(program_id, [])

    # ------------------------------------------------------------ eviction
    def evictable(self, tier: str) -> list[RadixNode]:
        """Eviction candidates on a tier, best-victim-first.

        Sort key = (type priority for that tier, LRU time, -depth): the type
        label dominates, LRU breaks ties within a type (paper §4.3.2), and
        deeper nodes go first so parents never lose pages before children.
        """
        order = GPU_EVICTION_ORDER if tier == "gpu" else CPU_EVICTION_ORDER
        attr = "device_page" if tier == "gpu" else "host_page"
        nodes = [
            n
            for n in self._iter_nodes()
            if getattr(n, attr) is not None and n.refcount == 0 and n.is_leaf_on(tier)
        ]
        nodes.sort(key=lambda n: (order[n.label], n.last_access, -n.depth))
        return nodes

    def evict(self, node: RadixNode, tier: str) -> int:
        attr = "device_page" if tier == "gpu" else "host_page"
        page = getattr(node, attr)
        assert page is not None and node.refcount == 0
        setattr(node, attr, None)
        self._gc(node)
        return page

    # ------------------------------------------------------------ plumbing
    def _gc(self, node: RadixNode) -> None:
        while (
            node is not self.root
            and node.device_page is None
            and node.host_page is None
            and not node.children
            and node.refcount == 0
        ):
            parent = node.parent
            parent.children.pop(node.tokens, None)
            node = parent

    def _iter_nodes(self):
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    def stats(self) -> dict:
        dev = host = 0
        for n in self._iter_nodes():
            dev += n.device_page is not None
            host += n.host_page is not None
        return {"device_pages": dev, "host_pages": host}
