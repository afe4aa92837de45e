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
graph would freeze, which the auditor reports.
"""
from __future__ import annotations

import contextlib
import functools

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


def entry(name: str, cost, host_operands: tuple = ()):
    """Mark ``fn`` as the kernel entry point ``name`` costed by ``cost``
    (called with ``fn``'s arguments)."""
    def mark(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _RECORDER is None:
                return fn(*args, **kwargs)
            return _RECORDER(call, fn, args, kwargs)

        call.leaf_name = name
        call.cost = cost
        call.host_operands = host_operands
        return call

    return mark
