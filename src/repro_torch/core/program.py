"""Program-level state tracked by the scheduler (paper §4.1).

For each active agentic program the scheduler maintains: (i) the current
status, (ii) the estimated KV context size, (iii) recent Reasoning/Acting
durations (via :class:`IdlenessTracker`), plus placement bookkeeping
(tier, home replica, typed label) and churn metrics.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.idleness import IdlenessTracker
from repro_torch.core.types import ProgramMetrics, Status, Tier, TypeLabel


@dataclass
class ProgramState:
    program_id: str
    kv_bytes_per_token: int
    context_tokens: int = 0
    tier: Tier = Tier.NONE
    replica: int | None = None          # home replica while GPU/CPU-resident
    # last replica that ever held this program's state; NOT cleared on
    # eviction — the churn metric (paper §6.2.2) compares re-admission
    # targets against it
    home_replica: int | None = None
    label: TypeLabel = TypeLabel.INACTIVE
    tracker: IdlenessTracker = field(default_factory=IdlenessTracker)
    metrics: ProgramMetrics = field(default_factory=ProgramMetrics)
    # tokens whose KV has actually been materialized by a completed step —
    # context_tokens may run ahead of it when a new request's input arrives
    # before the engine has prefilled it, so transfer sizing (Forward.nbytes)
    # uses this, not kv_bytes
    materialized_tokens: int = 0
    # pending request the scheduler is gating (None = no pending work)
    pending_since: float | None = None
    # set once the request was released to the engine; cleared when inference
    # actually starts (prevents double-forwarding a promoted program)
    dispatched: bool = False
    # set when a Reasoning program must be demoted after its current step
    # finishes (paper §4.3.1 "lazy demotion")
    lazy_demote: bool = False
    arrived_at: float = 0.0
    steps_completed: int = 0
    finished: bool = False
    # per-token size of the program's KV *as it crosses a link or sits in a
    # host tier* — differs from ``kv_bytes_per_token`` (the device-resident
    # size) when pages quantize on offload (int8 offload format). None means
    # "same format everywhere" and falls back to the device size, so bf16
    # deployments are byte-identical to the pre-format-layer accounting.
    wire_bytes_per_token: int | None = None

    # ------------------------------------------------------------ properties
    @property
    def status(self) -> Status:
        return self.tracker.status

    @property
    def kv_bytes(self) -> int:
        return self.context_tokens * self.kv_bytes_per_token

    @property
    def host_bytes_per_token(self) -> int:
        """Per-token size in the offload format (what CPU/SSD copies and
        link transfers actually carry)."""
        return (
            self.kv_bytes_per_token
            if self.wire_bytes_per_token is None
            else self.wire_bytes_per_token
        )

    @property
    def host_kv_bytes(self) -> int:
        """Full-context size in the offload format — what the program
        occupies in a host tier (CPU/SSD budget accounting)."""
        return self.context_tokens * self.host_bytes_per_token

    @property
    def materialized_bytes(self) -> int:
        """Bytes of KV that physically exist somewhere (≤ ``kv_bytes``)."""
        return min(self.materialized_tokens, self.context_tokens) * self.kv_bytes_per_token

    @property
    def materialized_wire_bytes(self) -> int:
        """Materialized KV priced at the *offload* format — the bytes a
        transfer of this program actually puts on the wire (offload copies
        carry the host-format payload; reloads move the same bytes back)."""
        return (
            min(self.materialized_tokens, self.context_tokens)
            * self.host_bytes_per_token
        )

    @property
    def has_pending(self) -> bool:
        return self.pending_since is not None

    @property
    def is_new(self) -> bool:
        return self.steps_completed == 0

    def idleness(self, now: float) -> float:
        return self.tracker.idleness(now)

    # ------------------------------------------------------------ transitions
    def begin_reasoning(self, now: float) -> None:
        if self.pending_since is not None:
            self.metrics.gated_time_s += max(0.0, now - self.pending_since)
        self.pending_since = None
        self.dispatched = False
        self.tracker.transition(Status.REASONING, now)

    def begin_acting(self, now: float, new_tokens: int = 0) -> None:
        self.context_tokens += new_tokens
        self.materialized_tokens = self.context_tokens
        self.steps_completed += 1
        self.tracker.transition(Status.ACTING, now)

    def gate(self, now: float) -> None:
        """Request arrived but cannot run: hold it, excluded from idleness."""
        if self.pending_since is None:
            self.pending_since = now
        self.dispatched = False
        self.tracker.transition(Status.GATED, now)

    def set_window(self, k: int) -> None:
        self.tracker = IdlenessTracker(window=k)
