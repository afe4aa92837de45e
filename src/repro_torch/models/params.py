"""Parameter descriptors and their materialization, in PyTorch.

Model code builds a nested dict of :class:`Leaf` descriptors (no
allocation). :func:`materialize` turns it into real tensors from a seed,
reproducing the reference's stream (``repro/models/params.py``) byte for
byte: leaves in sorted-key order (the order ``jax.tree.flatten`` visits a
dict tree), one ``np.random.default_rng(seed)``, ``standard_normal`` in
float32 times the leaf's std, then a round-to-nearest-even cast to the
leaf's dtype. Both packages therefore hold identical weights with no
checkpoint. :func:`load_jax_params` carries a tree of numpy arrays (the
reference's parameters after ``np.asarray``) across leaf for leaf.
:func:`spec_tree` and :func:`sharding_tree` resolve a descriptor tree
under :mod:`repro_torch.dist` rules on a mesh, :func:`device_put_tree`
places a tensor tree by a sharding tree (each rank keeping its block) and
:func:`gather_tree` gathers a placed tree whole onto the host.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Leaf:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    dtype: torch.dtype = torch.bfloat16
    scale: float | None = None   # None -> 1/sqrt(fan_in); 0.0 -> zeros; else stddev
    init: str = "normal"         # normal | zeros | ones

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def leaves(tree, prefix: str = ""):
    """``(dotted_name, Leaf)`` pairs in sorted-key order, recursively."""
    for key in sorted(tree):
        node = tree[key]
        name = f"{prefix}{key}"
        if isinstance(node, Leaf):
            yield name, node
        else:
            yield from leaves(node, name + ".")


def _unflatten(pairs) -> dict:
    out: dict = {}
    for name, value in pairs:
        *path, last = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[last] = value
    return out


def _map(fn, tree) -> dict:
    """``fn`` over every :class:`Leaf` of a nested dict, in sorted-key
    order (the reference's ``jax.tree.map`` order, so fallbacks are
    recorded alike)."""
    return {k: fn(tree[k]) if isinstance(tree[k], Leaf) else _map(fn, tree[k])
            for k in sorted(tree)}


def spec_tree(tree, mesh, rules) -> dict:
    """Each leaf's :class:`~repro_torch.dist.sharding.PartitionSpec`."""
    return _map(lambda l: rules.spec(mesh, l.axes, l.shape), tree)


def sharding_tree(tree, mesh, rules) -> dict:
    """Each leaf's :class:`~repro_torch.dist.sharding.NamedSharding`."""
    return _map(lambda l: rules.sharding(mesh, l.axes, l.shape), tree)


def device_put_tree(values: dict, shardings: dict) -> dict:
    """Place a nested dict of tensors by a sharding tree of the same keys.
    On a mesh of one device a tensor is moved there (``.to``: a tensor
    already there is returned as it is, so replicas that alias one device
    share one copy). On a larger mesh each rank holds the same full tensor
    (drawn from the same seed, or loaded alike) and keeps its own block:
    the tensor becomes a DTensor over ``mesh.device_mesh()`` (which needs
    a process group) through ``DTensor.from_local``, with no collective.
    A DTensor already on that mesh with those placements is returned as
    it is, so aliased replicas share one copy there too."""
    if set(values) != set(shardings):
        raise ValueError(f"tree keys differ: {sorted(set(values) ^ set(shardings))}")
    out = {}
    for k, v in values.items():
        sh = shardings[k]
        out[k] = device_put_tree(v, sh) if isinstance(v, dict) else put_block(v, sh)
    return out


def put_block(v: torch.Tensor, sh) -> torch.Tensor:
    """The full tensor ``v`` placed by the sharding ``sh``: on a mesh of
    one device moved there (``.to``), else this rank's block as a DTensor
    on ``sh.mesh``, on the rank's device (on ``v``'s own for a layout with
    no devices behind it). Train rules shard a weight's "embed" dimension
    over "data" (FSDP) as well as its heads over "model"."""
    if sh.mesh.size == 1:
        return v.to(sh.mesh.device())
    from repro_torch.dist.local import is_dtensor, place_block

    mesh, placements = sh.mesh.device_mesh(), sh.placements()
    if is_dtensor(v):
        if v.device_mesh is mesh and tuple(v.placements) == placements:
            return v
        raise ValueError(f"a DTensor on {v.device_mesh} {v.placements} is placed "
                         f"by {sh.spec} on {sh.mesh}")
    dev = v.device if sh.mesh.devices is None else sh.mesh.rank_device()
    # a copy, so that the whole tensor is not held through a view of it
    local = v[sh.local_slices(v.shape, sh.mesh.coordinates())].to(dev, copy=True)
    local = local.contiguous()
    return place_block(local, mesh, placements, v.shape)


def gather_tree(tree: dict) -> dict:
    """A nested dict of tensors with every DTensor gathered whole (an
    all-gather on every rank of its mesh, leaf by leaf in sorted-key
    order), each leaf on the host: what a checkpoint writes and a test
    compares."""
    from repro_torch.dist.local import full, is_dtensor

    with torch.no_grad():
        return {k: gather_tree(v) if isinstance(v, dict)
                else (full(v) if is_dtensor(v) else v).detach().cpu()
                for k, v in sorted(tree.items())}


def materialize(tree, seed: int = 0, device="cpu", keep=None) -> dict:
    """Initialize real parameter values: a nested dict of tensors on
    ``device`` with the same keys as ``tree``. ``keep(name, t)`` (a rank
    on a mesh: its own block, :func:`put_block`) replaces each leaf as
    soon as it is drawn, so no more than one whole leaf is held at a
    time; the stream is the same whatever it keeps."""
    rng = np.random.default_rng(seed)
    out = []
    for name, l in leaves(tree):
        if l.init == "zeros" or l.scale == 0.0:
            t = torch.zeros(l.shape, dtype=l.dtype)
        elif l.init == "ones":
            t = torch.ones(l.shape, dtype=l.dtype)
        else:
            # the reference's fan-in quirk, kept as is: shape[-2] for any
            # rank >= 2, so stacked [L, d, f] leaves use d
            fan_in = l.shape[-2] if len(l.shape) >= 2 else max(1, l.shape[-1])
            std = l.scale if l.scale is not None else 1.0 / np.sqrt(fan_in)
            # a stacked leaf is drawn one layer slice at a time: the same
            # stream in C order, without a transient f32 copy of the whole
            # leaf (mamba2-2.7b's in_proj alone would be 6.9 GB)
            t = torch.empty(l.shape, dtype=l.dtype)
            for out_slice in t if len(l.shape) >= 3 else t[None]:
                vals = rng.standard_normal(tuple(out_slice.shape), dtype=np.float32) * std
                out_slice.copy_(torch.from_numpy(np.asarray(vals, np.float32)))
        t = t.to(device)
        out.append((name, t if keep is None else keep(name, t)))
    return _unflatten(out)


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)             # an owned, writable, contiguous copy
    if a.dtype.name == "bfloat16":
        # numpy has no native bf16: reinterpret the raw bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def load_jax_params(tree_of_numpy: dict, cfg, device="cpu") -> dict:
    """Carry the reference's parameters (a nested dict of numpy arrays)
    into the port: every leaf of ``Model(cfg).describe()`` must be present
    with its shape and dtype, and nothing else may be."""
    from repro_torch.models.model import Model

    want = dict(leaves(Model(cfg).describe()))
    got = dict(flatten_tree(tree_of_numpy))
    if set(want) != set(got):
        raise ValueError(
            f"parameter names differ: missing {sorted(set(want) - set(got))}, "
            f"unexpected {sorted(set(got) - set(want))}"
        )
    out = []
    for name, l in want.items():
        t = _from_numpy(got[name])
        if tuple(t.shape) != tuple(l.shape) or t.dtype != l.dtype:
            raise ValueError(
                f"{name}: got {tuple(t.shape)} {t.dtype}, want {tuple(l.shape)} {l.dtype}"
            )
        out.append((name, t.to(device)))
    return _unflatten(out)


def flatten_tree(tree, prefix: str = ""):
    """``(dotted_name, value)`` pairs of a nested dict of arrays or
    tensors, in sorted-key order."""
    for key in sorted(tree):
        node = tree[key]
        if isinstance(node, dict):
            yield from flatten_tree(node, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", node

