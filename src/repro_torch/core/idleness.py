"""Windowed relative-idleness metric (paper §4.2, Eq. 1).

    iota = T_acting^(k) / (T_reasoning^(k) + T_acting^(k))

over the last ``k`` inference/tool-call cycles, where the *in-progress*
interval contributes its elapsed time. This gives the two properties the
paper claims:

* responsive: an ongoing long tool call keeps growing inside the window, so
  iota of a program entering an idle phase rises quickly without needing to
  predict the call's duration;
* robust: one outlier long call amid a busy phase is diluted by the k-1
  surrounding short cycles.

Gated time (scheduler-imposed waiting) is excluded from both terms.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from repro_torch.core.types import Status


@dataclass
class _Cycle:
    reasoning_s: float = 0.0
    acting_s: float = 0.0


class IdlenessTracker:
    """Tracks Reasoning/Acting intervals and computes windowed idleness.

    Usage: call :meth:`transition` on every status change with the wall-clock
    timestamp; query :meth:`idleness` at any time. One *cycle* is one
    Reasoning interval plus the Acting interval that follows it.
    """

    def __init__(self, window: int = 5):
        if window < 1:
            raise ValueError("idleness window must be >= 1")
        self.window = window
        self._cycles: deque[_Cycle] = deque(maxlen=window)
        self._status: Status = Status.ACTING  # programs are born "acting"
        self._since: float | None = None
        self._current = _Cycle()

    # ------------------------------------------------------------------ API
    @property
    def status(self) -> Status:
        return self._status

    def transition(self, status: Status, now: float) -> None:
        """Record a status change at time ``now``."""
        if self._since is not None:
            self._accumulate(now)
        if self._status is Status.ACTING and status is not Status.ACTING:
            # an Acting interval just closed -> the cycle is complete
            if self._current.reasoning_s > 0 or self._current.acting_s > 0:
                self._cycles.append(self._current)
                self._current = _Cycle()
        self._status = status
        self._since = now

    def idleness(self, now: float) -> float:
        """Eq. (1) including the elapsed part of the in-progress interval.

        A program with no observed reasoning time yet defaults to 0.5
        (unknown phase); this only affects a program's very first step.
        """
        # the in-progress cycle counts as one of the k window slots
        cur_r = self._current.reasoning_s
        cur_a = self._current.acting_s
        if self._since is not None:  # open interval (GATED adds to neither)
            elapsed = max(0.0, now - self._since)
            if self._status is Status.REASONING:
                cur_r += elapsed
            elif self._status is Status.ACTING:
                cur_a += elapsed
        closed = list(self._cycles)
        if cur_r > 0 or cur_a > 0:
            closed = closed[-(self.window - 1) :] if self.window > 1 else []
            closed.append(_Cycle(cur_r, cur_a))
        reasoning = sum(c.reasoning_s for c in closed)
        acting = sum(c.acting_s for c in closed)
        total = reasoning + acting
        if total <= 0.0:
            return 0.5
        return acting / total

    # -------------------------------------------------------- persistence
    def window_dump(self) -> list[list[float]]:
        """Serializable window contents (state_io snapshots)."""
        cycles = list(self._cycles) + [self._current]
        return [[c.reasoning_s, c.acting_s] for c in cycles]

    def window_load(self, dump: list[list[float]]) -> None:
        """Rebuild the window from :meth:`window_dump` output. The restored
        tracker starts a fresh Acting interval (restart semantics)."""
        self._cycles.clear()
        for r, a in dump[: self.window]:
            self._cycles.append(_Cycle(reasoning_s=r, acting_s=a))
        self._current = _Cycle()
        self._status = Status.ACTING
        self._since = None

    # ------------------------------------------------------------ internals
    def _accumulate(self, now: float) -> None:
        if self._since is None:
            return
        dt = max(0.0, now - self._since)
        if self._status is Status.REASONING:
            self._current.reasoning_s += dt
        elif self._status is Status.ACTING:
            self._current.acting_s += dt
        # GATED: excluded from both terms (paper §4.2)
