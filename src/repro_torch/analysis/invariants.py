"""Control-plane invariant checker for the scheduler / router seam.

Two cooperating pieces, both constructed only when ``REPRO_KVSAN=1``:

* :class:`LedgerAuditor` — an observer installed on the scheduler's
  :class:`~repro_torch.core.ledger.TransferLedger`. It sees every ``open`` /
  ``complete`` / ``cancel`` / ``drop`` as it happens and raises
  :class:`InvariantError` the moment a record's lifecycle goes wrong:
  an action id reopened after closing, a completion ack for a record
  that never opened, a record completed twice, or a ``CancelTransfer``
  landing on a record that is not open.  The one tolerated race is a
  *completion after cancel/drop*: the runtime's ack may already be in
  flight when the scheduler cancels, and the ledger documents that
  unknown-id completions are dropped on the floor.

* :class:`ControlPlaneChecker` — the router-tick sweep.  After every
  applied plan and at every scheduler tick it re-derives tier occupancy
  from the resident program sets and cross-checks the placement table
  (``prog.tier`` / ``prog.replica``) against actual queue membership;
  at end of replay :meth:`assert_drained` demands the ledger be empty
  (every emitted transfer was acked, cancelled, or dropped — i.e. every
  ``PlacementPlan`` action reached a terminal state).

Violations carry the auditor's recent ledger-operation trace so the
offending pid / action id is one read away.
"""
from __future__ import annotations

from collections import deque

from repro_torch.core.types import Tier


class InvariantError(AssertionError):
    """A control-plane invariant was violated; carries the recent
    ledger-operation trace for post-mortem."""

    def __init__(self, msg: str, trace=()):
        self.trace = list(trace)
        if self.trace:
            msg += "\n  recent ledger ops (oldest first):\n" + "\n".join(
                f"    {e}" for e in self.trace
            )
        super().__init__(msg)


class LedgerAuditor:
    """Observer on ``TransferLedger``: every record opens once and reaches
    exactly one terminal state (completed / cancelled / dropped)."""

    def __init__(self, trace_len: int = 128):
        self.ops: deque[str] = deque(maxlen=trace_len)
        self._closed: dict[int, str] = {}   # action_id -> terminal state

    # -------------------------------------------------- observer protocol
    def on_open(self, rec) -> None:
        self.ops.append(
            f"open #{rec.action_id} {rec.kind} pid={rec.pid} "
            f"r={rec.replica} {rec.nbytes}B @{rec.opened_at:.3f}"
        )
        prior = self._closed.get(rec.action_id)
        if prior is not None:
            raise InvariantError(
                f"transfer record #{rec.action_id} (pid={rec.pid}) "
                f"reopened after being {prior} — action ids must be "
                f"single-use",
                self.ops,
            )

    def on_complete(self, action_id: int, rec) -> None:
        self.ops.append(
            f"complete #{action_id}"
            + (f" pid={rec.pid}" if rec is not None else " (not open)")
        )
        if rec is not None:
            self._closed[action_id] = "completed"
            return
        prior = self._closed.get(action_id)
        if prior is None:
            raise InvariantError(
                f"completion ack for action #{action_id} that was never "
                f"opened in the ledger",
                self.ops,
            )
        if prior == "completed":
            raise InvariantError(
                f"transfer record #{action_id} completed twice",
                self.ops,
            )
        # completed after cancel/drop: the documented benign race — the
        # runtime's ack was already in flight when the scheduler closed
        # the record.

    def on_cancel(self, action_id: int, rec) -> None:
        self.ops.append(
            f"cancel #{action_id}"
            + (f" pid={rec.pid}" if rec is not None else " (not open)")
        )
        if rec is None:
            prior = self._closed.get(action_id, "never opened")
            raise InvariantError(
                f"CancelTransfer targeted action #{action_id} which is not "
                f"open (prior state: {prior})",
                self.ops,
            )
        self._closed[action_id] = "cancelled"

    def on_drop(self, recs) -> None:
        for rec in recs:
            self.ops.append(f"drop #{rec.action_id} pid={rec.pid}")
            self._closed[rec.action_id] = "dropped"


class ControlPlaneChecker:
    """Scheduler-state sweep run from the router's tick / apply_plan."""

    def __init__(self, sched):
        self.sched = sched
        self.auditor = LedgerAuditor()
        sched.ledger.observer = self.auditor

    def check(self, now: float = 0.0) -> None:
        """Re-derive tier occupancy and placement consistency from scratch
        and compare against the scheduler's accounting."""
        sched = self.sched
        trace = self.auditor.ops
        for rep in sched.replicas:
            # a host-tier copy is stored in the offload format, so the
            # host tiers hold ``host_kv_bytes`` a program (the accounting
            # of ``core.tiers``); the reference sums ``kv_bytes`` on every
            # tier and so fails every int8-offload replay here
            named = (
                ("gpu", rep.gpu, rep.gpu_used, "kv_bytes"),
                ("cpu", rep.cpu, rep.cpu_used, "host_kv_bytes"),
                ("ssd", rep.ssd, rep.ssd_used, "host_kv_bytes"),
            )
            for name, q, used, size in named:
                want = sum(getattr(p, size) for p in q.values())
                if used != want:
                    raise InvariantError(
                        f"replica {rep.replica_id} {name} occupancy "
                        f"conservation broken at t={now:.3f}: accounted "
                        f"{used}B != Σ resident {want}B over pids "
                        f"{sorted(q)}",
                        trace,
                    )
            for i in range(len(named)):
                for j in range(i + 1, len(named)):
                    both = set(named[i][1]) & set(named[j][1])
                    if both:
                        raise InvariantError(
                            f"replica {rep.replica_id}: programs resident "
                            f"on both {named[i][0]} and {named[j][0]} at "
                            f"t={now:.3f}: {sorted(both)}",
                            trace,
                        )
        for pid, prog in sched.programs.items():
            if prog.tier is Tier.WAITING:
                if pid not in sched.waiting.programs:
                    raise InvariantError(
                        f"program {pid} claims tier=waiting but is not in "
                        f"the waiting queue at t={now:.3f}",
                        trace,
                    )
            elif prog.tier in (Tier.GPU, Tier.CPU, Tier.SSD):
                if prog.replica is None:
                    raise InvariantError(
                        f"program {pid} claims tier={prog.tier.value} with "
                        f"no replica at t={now:.3f}",
                        trace,
                    )
                q = getattr(sched.replicas[prog.replica], prog.tier.value)
                if pid not in q:
                    raise InvariantError(
                        f"program {pid} claims tier={prog.tier.value} on "
                        f"replica {prog.replica} but is not in that queue "
                        f"at t={now:.3f}",
                        trace,
                    )
        for rec in sched.ledger.in_flight():
            if rec.pid not in sched.programs:
                raise InvariantError(
                    f"open transfer #{rec.action_id} references unknown "
                    f"program {rec.pid} at t={now:.3f} (drop_pid missed "
                    f"it on teardown)",
                    trace,
                )

    def assert_drained(self) -> None:
        """End of replay: every opened record must have closed."""
        recs = self.sched.ledger.in_flight()
        if recs:
            desc = ", ".join(
                f"#{r.action_id} {r.kind} pid={r.pid} r={r.replica}"
                for r in recs
            )
            raise InvariantError(
                f"{len(recs)} transfer record(s) still open at end of "
                f"replay: {desc}",
                self.auditor.ops,
            )
