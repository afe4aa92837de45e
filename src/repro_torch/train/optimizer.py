"""AdamW for the port, the reference's (``repro/train/optimizer.py``) in
PyTorch: the same update in f32 arithmetic, op for op, applied in place
under ``torch.no_grad()`` (the reference returns new arrays). Not
``torch.optim.AdamW``, which applies the weight decay and eps elsewhere.
Optional bf16 moments, as the reference keeps them for the giant MoEs."""
from __future__ import annotations

import torch

from repro_torch.models.params import Leaf

F32 = torch.float32


def describe_opt_state(param_tree, bf16_moments: bool = False) -> dict:
    """Leaf descriptors for the optimizer state: first and second moments
    shaped like the parameters (f32, or bf16 with ``bf16_moments``) and
    an int32 step ``count``."""
    mdtype = torch.bfloat16 if bf16_moments else F32

    def mom(tree):
        if isinstance(tree, Leaf):
            return Leaf(tree.shape, tree.axes, mdtype, init="zeros")
        return {k: mom(v) for k, v in tree.items()}

    return {"m": mom(param_tree), "v": mom(param_tree),
            "count": Leaf((), (), torch.int32, init="zeros")}


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant as an f32 scalar on ``like``'s device: jnp rounds a
    weak-typed constant to f32 before the operation, and so must this."""
    return torch.tensor(x, dtype=F32, device=like.device)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as XLA computes it. On the
    card torch's f32 ``sqrt`` rounds correctly already; its vectorised f32
    ``sqrt`` on the CPU is off by an ulp in some elements, so there the
    f64 root is rounded to f32, which is exact (53 >= 2·24 + 2 bits)."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(F32)


#: elements of a leaf one pass of the update takes. The update makes about
#: six f32 temporaries the size of what it is given: over the whole of
#: mamba2-2.7b's stacked ``in_proj`` (1.7 G elements) that is ~40 GB at
#: once, which took a full-width training step on an 80 GB card to 77 GiB
_CHUNK_ELEMENTS = 1 << 27


def _chunks(t: torch.Tensor) -> list:
    """``t`` as views of whole slices along its first dimension, each of
    at most ``_CHUNK_ELEMENTS`` elements where a slice allows. The update
    is elementwise, so it gives the same bits over the pieces as over the
    whole."""
    if t.dim() == 0 or t.numel() <= _CHUNK_ELEMENTS:
        return [t]
    per = max(1, _CHUNK_ELEMENTS // (t.numel() // t.shape[0]))
    return [t[i:i + per] for i in range(0, t.shape[0], per)]


def _pairs(tree, other):
    """``(a, b)`` leaf pairs of two trees of one structure, sorted keys."""
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _pairs(tree[key], other[key])
        else:
            yield tree[key], other[key]


@torch.no_grad()
def adamw_update(grads, opt_state, params, *, lr: float = 3e-4, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1):
    """One AdamW step over nested dicts of tensors, in place: ``params``,
    ``opt_state["m"]``, ``opt_state["v"]`` and ``opt_state["count"]`` are
    overwritten. ``grads`` is shaped like ``params`` (any float type). The
    arithmetic is the reference's, in f32, with its rounding: bias
    corrections ``1 - b ** count``, moments, then
    ``p - lr * (m̂ / (sqrt(v̂) + eps) + weight_decay * p)`` cast back to
    the parameter's type, a large leaf a piece at a time (``_chunks``).
    Returns ``(params, opt_state)``."""
    count = opt_state["count"]
    count += 1
    c = count.to(F32)
    one = _f32(1.0, c)
    bc1 = one - torch.pow(_f32(b1, c), c)
    bc2 = one - torch.pow(_f32(b2, c), c)
    k = {name: _f32(val, c) for name, val in (
        ("b1", b1), ("b2", b2), ("1-b1", 1 - b1), ("1-b2", 1 - b2), ("eps", eps),
        ("lr", lr), ("wd", weight_decay))}
    for (leaf, grad), (first, second) in zip(_pairs(params, grads),
                                             _pairs(opt_state["m"], opt_state["v"])):
        for p, g, m, v in zip(*map(_chunks, (leaf.detach(), grad, first, second))):
            gf = g.to(F32)
            m_new = k["b1"] * m.to(F32) + k["1-b1"] * gf
            v_new = k["b2"] * v.to(F32) + k["1-b2"] * gf * gf
            step = (m_new / bc1) / (_sqrt(v_new / bc2) + k["eps"])
            pf = p.to(F32)
            p.copy_(pf - k["lr"] * (step + k["wd"] * pf))
            m.copy_(m_new)
            v.copy_(v_new)
    return params, opt_state
