"""Typed action IR for the scheduler ↔ runtime boundary.

The scheduler never *calls into* a runtime. Every lifecycle event
(``request_arrived``, ``request_completed``, ``tick``, ...) returns a
:class:`PlacementPlan` — an ordered, immutable, serializable sequence of
placement actions — and the runtime executes it through its own
``apply_plan`` executor. Transfers (offload / reload / migrate) are
acknowledged asynchronously via ``scheduler.on_transfer_complete``, with
in-flight bytes tracked per replica and channel by
:class:`repro_torch.core.ledger.TransferLedger`.

Why an IR instead of callbacks: KV movement under transfer cost is the
paper's whole subject (§4.3), so movements must be *inspectable data* —
the scheduler can see what is still in flight (and cancel an offload when
a tool call returns early), tests can assert exact action sequences
instead of mock call orders, and the simulator and the real router can be
checked action-for-action against each other on the same trace.

Action vocabulary:

``Forward``   release a gated request on ``replica``; ``source_tier`` says
              where the program's KV currently lives (GPU = warm decode,
              CPU/SSD = reload ``nbytes`` over PCIe/NVMe first,
              WAITING/NONE with ``recompute`` = re-prefill from scratch).
``Offload``   copy KV ``src_tier`` → ``dst_tier`` on ``replica``.
``Discard``   drop the KV copy held by ``tier``.
``Migrate``   move a host-resident KV copy ``src_replica`` → ``dst_replica``.
``SetLabel``  typed-offloading hint (paper §4.3.2).
``CancelTransfer``  abort a still-queued transfer (early tool return).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, fields
from typing import Iterator

from repro_torch.core.types import Tier, TypeLabel


@dataclass(frozen=True)
class Action:
    """One placement instruction. ``action_id`` is unique and monotonically
    increasing per scheduler instance; transfer completions are acknowledged
    against it."""

    action_id: int
    pid: str


@dataclass(frozen=True)
class Forward(Action):
    """Release a gated request. ``source_tier`` replaces the old
    ``reload``/``recompute`` flag pair *and* the mutable
    ``ProgramState.reload_src`` side-channel: GPU means the KV is warm,
    CPU/SSD mean the runtime must first reload ``nbytes`` over the
    corresponding channel, WAITING (with ``recompute=True``) means the KV
    was discarded and the full context must be re-prefilled."""

    replica: int
    source_tier: Tier = Tier.GPU
    recompute: bool = False
    nbytes: int = 0


@dataclass(frozen=True)
class Offload(Action):
    """Copy a program's KV ``src_tier`` → ``dst_tier`` on ``replica``.
    The source copy stays valid until the transfer completes, which is what
    makes :class:`CancelTransfer` safe."""

    replica: int
    src_tier: Tier = Tier.GPU
    dst_tier: Tier = Tier.CPU
    nbytes: int = 0


@dataclass(frozen=True)
class Discard(Action):
    """Drop the program's KV copy held by ``tier`` (``replica`` None =
    wherever the runtime tracks it)."""

    replica: int | None
    tier: Tier = Tier.GPU


@dataclass(frozen=True)
class Migrate(Action):
    """Move a host-resident KV copy between replicas. Emitted under
    pressure rebalance (``SchedulerConfig.migrate_on_pressure``,
    beyond-paper, off by default) and replica drain
    (``SchedulerConfig.drain_migrate``, on by default). Both runtimes
    execute it through the endpoint-addressed copy API
    (:func:`repro_torch.core.transfers.copy_request_for`); the real transfer
    plane streams it page-by-page through host staging, cancellable
    mid-flight like any other transfer."""

    src_replica: int
    dst_replica: int
    nbytes: int = 0


@dataclass(frozen=True)
class SetLabel(Action):
    """Typed-offloading stamp consulted by engine-level eviction."""

    replica: int | None
    label: TypeLabel = TypeLabel.BUSY


@dataclass(frozen=True)
class CancelTransfer(Action):
    """Abort the still-pending transfer ``target_action_id`` on
    ``replica``. Emitted when a tool call returns before an offload left
    the queue: the GPU copy is still intact, so the program is re-admitted
    warm instead of paying a host round trip. Runtimes that already
    started (or finished) the transfer treat this as a no-op — offloads
    copy rather than move, so the race is benign."""

    replica: int
    target_action_id: int = 0


_ACTION_TYPES: dict[str, type[Action]] = {
    cls.__name__: cls
    for cls in (Forward, Offload, Discard, Migrate, SetLabel, CancelTransfer)
}


def _coalesce(actions: list[Action]) -> list[Action]:
    """Plan-level coalescing: collapse same-kind movements that supersede
    each other inside one plan. Today that is label restamps — only the
    last ``SetLabel`` per program survives (labels are idempotent
    overwrites, so earlier stamps in the same plan are dead weight for the
    runtime). Transfers are never merged here: batching same-channel
    transfers is a *runtime* choice, and the plan keeps them distinct so
    each can be acknowledged (or cancelled) individually."""
    last_label: dict[str, int] = {}
    for i, act in enumerate(actions):
        if isinstance(act, SetLabel):
            last_label[act.pid] = i
    out = []
    for i, act in enumerate(actions):
        if isinstance(act, SetLabel) and last_label[act.pid] != i:
            continue
        out.append(act)
    return out


@dataclass(frozen=True)
class PlacementPlan:
    """An ordered batch of actions emitted by one scheduler event.

    Plans are immutable and JSON-serializable; equality is structural, so
    golden tests can compare entire streams across runtimes.
    """

    now: float
    actions: tuple[Action, ...] = ()

    def __iter__(self) -> Iterator[Action]:
        return iter(self.actions)

    def __len__(self) -> int:
        return len(self.actions)

    def __bool__(self) -> bool:
        return bool(self.actions)

    def of_kind(self, kind: type[Action]) -> list[Action]:
        return [a for a in self.actions if isinstance(a, kind)]

    def to_json(self) -> list[dict]:
        return [action_to_json(a) for a in self.actions]


def action_to_json(action: Action) -> dict:
    d = asdict(action)
    for k, v in d.items():
        if isinstance(v, (Tier, TypeLabel)):
            d[k] = v.value
    d["kind"] = type(action).__name__
    return d


def action_from_json(d: dict) -> Action:
    d = dict(d)
    cls = _ACTION_TYPES[d.pop("kind")]
    for f in fields(cls):
        if f.name in d and isinstance(d[f.name], str):
            if f.name in ("source_tier", "src_tier", "dst_tier", "tier"):
                d[f.name] = Tier(d[f.name])
            elif f.name == "label":
                d[f.name] = TypeLabel(d[f.name])
    return cls(**d)


def plan_from_json(now: float, items: list[dict]) -> PlacementPlan:
    return PlacementPlan(now, tuple(action_from_json(d) for d in items))
