"""Meshes of the port: the host mesh and the production layouts.

The counterpart of ``repro/launch/mesh.py``. torch has no device mesh
that stands without a process group, so :class:`Mesh` is the port's own:
axis names, their sizes, and the devices behind them (or none, for a
layout the rules are resolved on without a fleet). ``Mesh.shape`` maps
each axis name to its size, as the reference's meshes do, and that is all
:class:`~repro_torch.dist.sharding.ShardingRules` reads.
:meth:`Mesh.device_mesh` builds a ``torch.distributed.DeviceMesh`` over
the same layout, once and only when asked.

A mesh of more than one device is stepped SPMD: one process a device,
each started by the caller with a process group (its rank names its
position through ``Mesh.ranks``). :func:`mesh_device` gives the device
this process steps on (a trainer's and a serving engine's).

The reference's production meshes are TPU pods (16 x 16 chips, and 2 x 16
x 16). The port's production layout is an H100 fleet: ``("data",
"model")`` = (32, 8), and ``("pod", "data", "model")`` = (2, 32, 8), with
the 8-way model axis inside one 8-GPU NVLink node, so tensor-parallel
collectives never leave a node. The model axis is half the reference's,
so some dimensions that fall back to replication there shard here.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

#: the production layouts: axis names -> sizes
PRODUCTION = {False: (("data", "model"), (32, 8)),
              True: (("pod", "data", "model"), (2, 32, 8))}


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. A CUDA device with no GPU present raises:
    nothing here carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def concrete_device(device=None) -> torch.device:
    """:func:`resolve_device` with the index filled in (``cuda`` -> the
    current card), so two names of one device compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def the_cards() -> list[torch.device]:
    """Every card this process sees; raises when there is none."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def devices_for(device: str = "cuda") -> list[torch.device]:
    """The fleet a ``--device`` flag names: ``cuda`` means every card,
    anything else that one device."""
    return the_cards() if device == "cuda" else [concrete_device(device)]


class Mesh:
    """A named grid of devices. ``devices`` is an array of
    ``torch.device`` shaped like the mesh, or ``None`` for a layout with
    no devices behind it (then ``sizes`` gives the shape). ``ranks`` are
    the processes' ranks in a process group, one a device (default: the
    mesh's positions in row-major order)."""

    def __init__(self, axis_names, devices=None, *, sizes=None, ranks=None,
                 device_type: str = "cuda"):
        self.axis_names = tuple(axis_names)
        if devices is not None:
            devices = np.asarray(devices, dtype=object)
            sizes = devices.shape
            types = {d.type for d in devices.flat}
            if len(types) != 1:
                raise ValueError(f"a mesh holds one device type, got {sorted(types)}")
            device_type = types.pop()
        if sizes is None or len(sizes) != len(self.axis_names):
            raise ValueError(f"mesh of axes {self.axis_names} needs one size each, got {sizes}")
        self.devices = devices
        self.device_type = device_type
        self.shape = OrderedDict(zip(self.axis_names, (int(s) for s in sizes)))
        self.size = int(np.prod(tuple(self.shape.values())))
        self.ranks = (np.arange(self.size) if ranks is None
                      else np.asarray(ranks)).reshape(tuple(self.shape.values()))
        self._device_mesh = None

    def __repr__(self) -> str:
        where = "no devices" if self.devices is None else str(self.devices.flat[0])
        return f"Mesh({dict(self.shape)}, {where}{'...' if self.size > 1 else ''})"

    def device(self) -> torch.device:
        """The one device of a one-device mesh."""
        if self.devices is None or self.size != 1:
            raise ValueError(f"{self} is not a mesh of one device")
        return self.devices.flat[0]

    def device_mesh(self):
        """The ``torch.distributed.DeviceMesh`` of this layout, over the
        process group that must already be up (one rank a device). Built
        at the first call and kept: each of its dimensions is a process
        sub-group, which is not free to make."""
        if self._device_mesh is None:
            _process_group(self)
            from torch.distributed.device_mesh import DeviceMesh

            self._device_mesh = DeviceMesh(self.device_type, torch.as_tensor(self.ranks),
                                           mesh_dim_names=self.axis_names)
        return self._device_mesh

    def coordinates(self) -> tuple[int, ...]:
        """This process's position on the mesh, one index an axis, from its
        rank in the process group (which must be up)."""
        rank = _process_group(self).get_rank()
        where = np.argwhere(self.ranks == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not on {self} (ranks {self.ranks.tolist()})")
        return tuple(int(i) for i in where[0])

    def rank_device(self) -> torch.device:
        """The device of this process's rank on the mesh."""
        if self.devices is None:
            raise ValueError(f"{self} has no devices behind it")
        return self.devices[self.coordinates()]


def _process_group(mesh: Mesh):
    """``torch.distributed``, which must have a process group up for
    ``mesh``."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"{mesh} as a DeviceMesh needs a process group: call "
            "torch.distributed.init_process_group (one rank a device) first")
    return dist


def _check_names(dev: torch.device, device, what: str) -> torch.device:
    """``dev``, which ``device`` (when given) must name: a name with no
    index names any device of its type."""
    want = None if device is None else torch.device(device)
    if want is not None and not (want.type == dev.type and want.index in (None, dev.index)):
        raise ValueError(f"device {device} is not {what} {dev}")
    return dev


def mesh_device(mesh: Mesh, device=None) -> torch.device:
    """The device this process steps ``mesh`` on: the one device of a
    one-device mesh, else the device of this process's rank (which needs
    the process group up). ``device``, when given, must name it."""
    if mesh.size == 1:
        return _check_names(mesh.device(), device, "the mesh's device")
    return _check_names(mesh.rank_device(), device, "this rank's device on the mesh,")


def make_host_mesh(device=None) -> Mesh:
    """A 1 x 1 ``("data", "model")`` mesh on the card, unless the caller
    asks for the CPU (``device="cpu"``); a CUDA device with no card
    raises."""
    return Mesh(("data", "model"), np.array([[concrete_device(device)]], dtype=object))


def production_layout(multi_pod: bool = False) -> Mesh:
    """The production mesh's layout with no devices behind it: the rules
    resolve on it anywhere."""
    axes, sizes = PRODUCTION[multi_pod]
    return Mesh(axes, sizes=sizes)


def make_production_mesh(multi_pod: bool = False, devices=None) -> Mesh:
    """The H100 fleet's mesh: 32 x 8 = 256 cards, ``multi_pod`` adds a
    leading 2-pod axis (512). ``devices`` defaults to the cards this
    process sees; with fewer than the layout needs it raises, as the
    reference does with fewer than its 256 chips."""
    layout = production_layout(multi_pod)
    devices = the_cards() if devices is None else list(devices)
    if len(devices) < layout.size:
        raise RuntimeError(
            f"the production mesh {dict(layout.shape)} needs {layout.size} devices, "
            f"{len(devices)} present")
    grid = np.empty(layout.size, dtype=object)
    grid[:] = devices[:layout.size]
    return Mesh(layout.axis_names, grid.reshape(tuple(layout.shape.values())))
