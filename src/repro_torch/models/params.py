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


def materialize(tree, seed: int = 0, device="cpu") -> dict:
    """Initialize real parameter values: a nested dict of tensors on
    ``device`` with the same keys as ``tree``."""
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
            vals = rng.standard_normal(l.shape, dtype=np.float32) * std
            t = torch.from_numpy(np.asarray(vals, np.float32)).to(l.dtype)
        out.append((name, t.to(device)))
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

