"""Capture budgets for the hot-path step graphs.

The port's counterpart of ``repro/analysis/compile_tracker.py``. The
reference compiles one jit per shape bucket and counts lowerings; the port
captures one CUDA graph per bucket (:class:`repro_torch.serving.graphs.StepGraphs`)
and counts captures. The serving fast path holds its latency numbers only
while every decode step and every prefill chunk replays a graph captured
before traffic: a capture mid-replay stalls the pump for an eager run and
a capture, and the tokens come out right all the same, so nothing else
would notice. This module makes "the replay captured nothing new" a
checkable property:

* every hot-path graph cache registers here by name (``Engine.__init__``
  does this when the tracker is armed: a paged engine's decode and
  chunk-prefill caches, ``Engine.graph_functions``);
* ``Engine.warmup()`` calls :meth:`CompileTracker.mark_warm` once it has
  run every bucket, snapshotting each cache's size (``cache_size()``: the
  number of buckets it holds, where the reference read jit's
  ``fn._cache_size()``);
* at end of replay the router asks :meth:`post_warmup_compiles`; any
  registered cache that grew past its warm snapshot captured a bucket
  warmup missed, and the replay fails loudly with the count.

Where the reference listened for backend compiles through
``jax.monitoring``, each graph cache reports its captures here, and the
armed tracker keeps a phase-tagged log of them (see :meth:`phase`;
the engines' ``warmup`` tags theirs ``warmup``, ``MoriRouter.replay``
``replay``): the log says *when* a capture happened, the cache sizes say
*which* cache.

Armed via ``REPRO_JITAUDIT=1`` (mirrors kvsan's ``REPRO_KVSAN``) or
programmatically with ``get_tracker().arm()``. Unarmed, the only cost an
engine pays is one ``enabled()`` check in ``__init__``. The tracker holds
registered caches weakly, so an engine's graphs are freed with the engine.
"""
from __future__ import annotations

import contextlib
import os
import weakref
from dataclasses import dataclass

ENV_VAR = "REPRO_JITAUDIT"


def enabled() -> bool:
    """True when the compile tracker is armed via the environment."""
    return os.environ.get(ENV_VAR, "0") not in ("", "0")


@dataclass
class _Entry:
    ref: weakref.ref
    #: cache size snapshotted by mark_warm (None until warmed)
    warm: int | None = None


@dataclass
class CompileEvent:
    """One capture reported by a registered graph cache."""

    phase: str
    event: str
    duration_s: float


class CompileTracker:
    """Process-wide registry of hot-path graph caches and their budgets."""

    def __init__(self) -> None:
        self._entries: dict[str, _Entry] = {}
        self._armed = False
        self._phase = "startup"
        self.events: list[CompileEvent] = []

    # ------------------------------------------------------------- arming
    def arm(self) -> None:
        self._armed = True

    def disarm(self) -> None:
        self._armed = False

    @property
    def armed(self) -> bool:
        return self._armed

    def record(self, event: str, duration_s: float) -> None:
        """Log one capture under the current phase (armed only)."""
        if self._armed:
            self.events.append(CompileEvent(self._phase, event, duration_s))

    # ------------------------------------------------------- registration
    def register(self, name: str, cache) -> None:
        """Track ``cache`` (anything with ``cache_size()``) under ``name``.

        Re-registering a name replaces the entry (replays rebuild engines;
        the previous engine's cache is dead). Registering the same object
        twice is a no-op so an earlier warm snapshot survives.
        """
        prev = self._entries.get(name)
        if prev is not None and prev.ref() is cache:
            return
        self._entries[name] = _Entry(weakref.ref(cache))

    def registered(self) -> tuple[str, ...]:
        return tuple(name for name, e in self._entries.items() if e.ref() is not None)

    # ------------------------------------------------------------ budgets
    def _live(self):
        for name, e in self._entries.items():
            cache = e.ref()
            if cache is not None:
                yield name, e, cache

    def cache_sizes(self) -> dict[str, int]:
        """Current per-cache bucket counts."""
        return {name: cache.cache_size() for name, _, cache in self._live()}

    def mark_warm(self, names: tuple[str, ...] | None = None) -> dict[str, int]:
        """Snapshot cache sizes as the warm baseline (all entries, or just
        ``names``); returns the snapshot. Captures past this baseline are
        budget violations."""
        snap: dict[str, int] = {}
        for name, e, cache in self._live():
            if names is not None and name not in names:
                continue
            e.warm = cache.cache_size()
            snap[name] = e.warm
        return snap

    def post_warmup_compiles(self) -> dict[str, tuple[int, int]]:
        """``{name: (warm_size, current_size)}`` for every registered cache
        that grew after its warm snapshot. Empty dict == budget held.
        Caches never marked warm are skipped (no baseline to compare
        against), and so are caches whose engine is gone."""
        out: dict[str, tuple[int, int]] = {}
        for name, e, cache in self._live():
            if e.warm is None:
                continue
            cur = cache.cache_size()
            if cur > e.warm:
                out[name] = (e.warm, cur)
        return out

    def marked(self) -> bool:
        """True once any live registered cache has a warm baseline."""
        return any(e.warm is not None for _, e, _ in self._live())

    # ------------------------------------------------------------- phases
    @contextlib.contextmanager
    def phase(self, label: str):
        """Tag capture events with ``label`` for attribution."""
        prev, self._phase = self._phase, label
        try:
            yield
        finally:
            self._phase = prev

    def events_in(self, label: str) -> list[CompileEvent]:
        return [e for e in self.events if e.phase == label]

    # -------------------------------------------------------------- reset
    def reset(self) -> None:
        """Drop registrations, baselines and the event log (tests)."""
        self._entries.clear()
        self.events.clear()
        self._phase = "startup"


_TRACKER: CompileTracker | None = None


def get_tracker() -> CompileTracker:
    """The process-wide tracker (created on first use; armed from the
    environment so ``REPRO_JITAUDIT=1`` needs no other plumbing)."""
    global _TRACKER
    if _TRACKER is None:
        _TRACKER = CompileTracker()
    if enabled() and not _TRACKER.armed:
        _TRACKER.arm()
    return _TRACKER
