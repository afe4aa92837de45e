"""Distribution layer of the port: logical-axis sharding rules and replica
placement (the counterpart of ``repro.dist``)."""
from repro_torch.dist.placement import ReplicaPlacement, ReplicaSet, make_replica_set
from repro_torch.dist.sharding import (
    LOGICAL_AXES,
    ShardingRules,
    make_decode_rules,
    make_train_rules,
)

__all__ = [
    "LOGICAL_AXES",
    "ReplicaPlacement",
    "ReplicaSet",
    "ShardingRules",
    "make_decode_rules",
    "make_replica_set",
    "make_train_rules",
]
