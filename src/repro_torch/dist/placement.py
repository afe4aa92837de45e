"""Replica-aware placement: one rules object shared by every replica.

The counterpart of ``repro/dist/placement.py``. A serving deployment runs
N data-parallel *replicas* of the engine, each on its own slice of the
device fleet. The invariants this module keeps:

* every replica gets a mesh of the same shape and axis names, so one
  :class:`~repro_torch.dist.sharding.ShardingRules` object is shared by
  all replicas: a program migrated between replicas by the MORI balancer
  lands on identical layouts;
* replica device groups are disjoint slices of the fleet when enough
  devices exist, and alias the first group otherwise: on one card, N
  replicas share ``cuda:0`` (and one copy of the weights), as the
  reference's replicas share its one CPU device. Aliasing replicas share
  one :class:`~repro_torch.launch.mesh.Mesh` object.

Consumers: :class:`repro_torch.serving.engine.Engine` (one placement a
replica), :mod:`repro_torch.launch.serve` (builds the set),
:class:`repro_torch.sim.Simulation` (replica count and layout provenance)
and the examples.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.dist.sharding import Axes, ShardingRules, make_decode_rules
from repro_torch.launch.mesh import Mesh, the_cards


@dataclass(frozen=True)
class ReplicaPlacement:
    """One replica's slice of the fleet: its mesh and the shared rules."""

    replica_id: int
    mesh: Mesh
    rules: ShardingRules

    def spec(self, axes: Axes, shape=None):
        return self.rules.spec(self.mesh, axes, shape)

    def sharding(self, axes: Axes, shape=None):
        return self.rules.sharding(self.mesh, axes, shape)


class ReplicaSet:
    """All replicas of one deployment; iterable of :class:`ReplicaPlacement`."""

    def __init__(self, meshes: list, rules: ShardingRules):
        if not meshes:
            raise ValueError("a replica set needs at least one mesh")
        shape0 = dict(meshes[0].shape)
        for m in meshes[1:]:
            if dict(m.shape) != shape0:
                raise ValueError(f"replica meshes must match: {dict(m.shape)} != {shape0}")
        self.meshes = meshes
        self.rules = rules

    @property
    def num_replicas(self) -> int:
        return len(self.meshes)

    def placement(self, replica_id: int) -> ReplicaPlacement:
        return ReplicaPlacement(replica_id, self.meshes[replica_id], self.rules)

    def __len__(self) -> int:
        return len(self.meshes)

    def __iter__(self):
        return (self.placement(i) for i in range(len(self.meshes)))


def make_replica_set(
    num_replicas: int,
    *,
    mesh_shape: tuple[int, ...] = (1, 1),
    axis_names: tuple[str, ...] = ("data", "model"),
    devices: list | None = None,
    rules: ShardingRules | None = None,
    num_kv_heads: int = 1,
) -> ReplicaSet:
    """Partition the fleet into ``num_replicas`` same-shape meshes.

    ``devices`` defaults to the cards (raises with none). With fewer than
    ``num_replicas * prod(mesh_shape)`` devices every replica aliases the
    first ``prod(mesh_shape)``. ``rules`` defaults to decode rules for
    ``num_kv_heads`` built against the (identical) replica mesh.
    """
    if len(mesh_shape) != len(axis_names):
        raise ValueError(f"mesh shape {mesh_shape} and axes {axis_names} differ in rank")
    devices = the_cards() if devices is None else list(devices)
    per = int(np.prod(mesh_shape))
    if len(devices) >= num_replicas * per:
        starts = [i * per for i in range(num_replicas)]
    elif len(devices) >= per:
        starts = [0] * num_replicas
    else:
        raise ValueError(f"need {per} devices for mesh {mesh_shape}, have {len(devices)}")
    # replicas that alias one device group share its Mesh (and so its
    # DeviceMesh, built once, and the DTensors placed on it)
    by_start: dict[int, Mesh] = {}
    for s in starts:
        if s not in by_start:
            grid = np.empty(per, dtype=object)
            grid[:] = devices[s:s + per]
            by_start[s] = Mesh(axis_names, grid.reshape(mesh_shape),
                               ranks=np.arange(s, s + per))
    meshes = [by_start[s] for s in starts]
    if rules is None:
        rules = make_decode_rules(meshes[0], num_kv_heads)
    return ReplicaSet(meshes, rules)
