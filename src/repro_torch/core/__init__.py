"""MORI control plane: idleness metric, three-tier placement, typed eviction.

This package is the paper's primary contribution (§4), implemented once and
shared by the discrete-event simulator and the real JAX serving engine. The
scheduler ↔ runtime contract is the typed action IR in ``repro_torch.core.actions``:
events in, :class:`PlacementPlan` out, transfers acknowledged through the
:class:`TransferLedger`.
"""
from repro_torch.core.actions import (
    Action,
    CancelTransfer,
    Discard,
    Forward,
    Migrate,
    Offload,
    PlacementPlan,
    SetLabel,
    action_from_json,
    action_to_json,
    plan_from_json,
)
from repro_torch.core.baselines import SMGScheduler, TAOScheduler, TAScheduler
from repro_torch.core.idleness import IdlenessTracker
from repro_torch.core.ledger import Channel, TransferLedger, TransferRecord, channel_for
from repro_torch.core.program import ProgramState
from repro_torch.core.radix_tree import TypedRadixTree
from repro_torch.core.scheduler import AgentScheduler, MoriScheduler
from repro_torch.core.tiers import ReplicaTiers, WaitingQueue
from repro_torch.core.transfers import CopyJob, TransferChannels
from repro_torch.core.types import (
    ProgramTrace,
    RequestRecord,
    SchedulerConfig,
    Status,
    Tier,
    TierCapacity,
    TypeLabel,
)

SCHEDULERS = {
    "mori": MoriScheduler,
    "ta": TAScheduler,
    "ta+o": TAOScheduler,
    "smg": SMGScheduler,
}

__all__ = [
    "Action",
    "AgentScheduler",
    "CancelTransfer",
    "Channel",
    "CopyJob",
    "Discard",
    "Forward",
    "IdlenessTracker",
    "Migrate",
    "MoriScheduler",
    "Offload",
    "PlacementPlan",
    "ProgramState",
    "ProgramTrace",
    "ReplicaTiers",
    "RequestRecord",
    "SCHEDULERS",
    "SMGScheduler",
    "SchedulerConfig",
    "SetLabel",
    "Status",
    "TAOScheduler",
    "TAScheduler",
    "Tier",
    "TierCapacity",
    "TransferChannels",
    "TransferLedger",
    "TransferRecord",
    "TypeLabel",
    "TypedRadixTree",
    "WaitingQueue",
    "action_from_json",
    "action_to_json",
    "channel_for",
    "plan_from_json",
]
