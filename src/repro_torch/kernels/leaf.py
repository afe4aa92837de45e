"""Kernel entry points as leaves of a traced step.

:func:`entry` marks a public kernel entry point (``paged_attention``,
``flash_attention``, ``ssd`` and their siblings) with its ``cost``
function. While an auditor has installed a recorder (:func:`recording`),
a call of a marked entry point is handed to it whole: the recorder runs
the call and sees it as one op, costed by ``cost`` from the same
arguments, instead of the aten ops inside it (the plain version on the
CPU, the wrapper's allocations on the card). So one step gives the same
account on either device. With no recorder installed, a marked entry
point costs one global read.

``host_operands`` names the keyword arguments that the entry point reads
on the host (flash's ``q_offset`` and ``kv_hole``): values a captured
graph would freeze. ``shape_derived`` claims, for some of them (by name,
an element of a tuple as ``name[i]``), that the operands' shapes fix
their value, so that a graph captured per shape bucket may freeze it
(flash's ``q_offset`` and the hole's upper end, the padded prefix
``Skv - Sq``). :func:`host_values` gives a call's host values that no
claim covers, each claim checked against the call's shapes: what the
auditor reports. A tensor among them is a device operand, read on the
device, and no host value.
"""
from __future__ import annotations

import contextlib
import functools

import torch

#: the installed recorder: ``(leaf, fn, args, kwargs) -> result``
_RECORDER = None


@contextlib.contextmanager
def recording(recorder):
    """Hand every marked entry point's calls to ``recorder`` inside the
    block."""
    global _RECORDER
    prev, _RECORDER = _RECORDER, recorder
    try:
        yield recorder
    finally:
        _RECORDER = prev


def entry(name: str, cost, host_operands: tuple = (), shape_derived=None):
    """Mark ``fn`` as the kernel entry point ``name`` costed by ``cost``
    (called with ``fn``'s arguments); ``host_operands`` and
    ``shape_derived`` (``{name: fn of the call's arguments -> the value its
    shapes give}``) as the module docstring says."""
    def mark(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _RECORDER is None:
                return fn(*args, **kwargs)
            return _RECORDER(call, fn, args, kwargs)

        call.leaf_name = name
        call.cost = cost
        call.host_operands = host_operands
        call.shape_derived = dict(shape_derived or {})
        return call

    return mark


def host_values(call, args, kwargs) -> dict:
    """The host values a call of the marked entry point ``call`` reads that
    its shapes do not fix: ``{name: value}`` over its ``host_operands``
    (a tuple's elements as ``name[i]``), leaving out None, 0, tensors and
    each value equal to what its ``shape_derived`` claim gives at this
    call's operands. A claim that the shapes contradict leaves the value
    in."""
    out = {}
    for key in call.host_operands:
        value = kwargs.get(key)
        items = ([(f"{key}[{i}]", x) for i, x in enumerate(value)]
                 if isinstance(value, (tuple, list)) else [(key, value)])
        for name, x in items:
            if x is None or x is False or isinstance(x, torch.Tensor) or x == 0:
                continue
            derive = call.shape_derived.get(name)
            if derive is not None and x == derive(*args, **kwargs):
                continue
            out[name] = x
    return out
