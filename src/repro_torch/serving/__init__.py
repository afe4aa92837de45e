"""Serving plane of the port: paged KV pool, engine, async transfer plane,
MORI router (multi-replica, with live cross-replica migration and
drain/failover)."""
from repro_torch.core.balancer import PlacementDecision
from repro_torch.core.transfers import CopyRequest, Endpoint
from repro_torch.serving.engine import Completion, Engine, EngineRequest, PrefillJob
from repro_torch.serving.kvpool import PagePool
from repro_torch.serving.router import MoriRouter, RouterMetrics, snapshot_state
from repro_torch.serving.state_io import requeue_resident_slots
from repro_torch.serving.transfer_plane import ReplicaTransferPlane

__all__ = [
    "Completion",
    "CopyRequest",
    "Endpoint",
    "Engine",
    "EngineRequest",
    "MoriRouter",
    "PagePool",
    "PlacementDecision",
    "PrefillJob",
    "ReplicaTransferPlane",
    "RouterMetrics",
    "requeue_resident_slots",
    "snapshot_state",
]
