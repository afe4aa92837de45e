"""The card's peaks and the least time a piece of work can take on it.

One account for every kernel: each ops module's ``cost`` functions return
``{"flops", "bytes", "op_type"}`` for one call from its operands' shapes
and dtypes (and, where the work depends on them, host values such as the
paged kernel's lengths); :func:`bound` turns such a count into the least
time the card could take. ``chip_smoke.py`` prints every kernel's bound
from it and :mod:`repro_torch.analysis.jitaudit` sums it over a step.

The peaks are the NVIDIA H100 SXM's data sheet figures (dense), the card
every timing of the port was taken on (``nvidia-smi`` names it
:data:`CARD`).
"""
from __future__ import annotations

#: the card the peaks below describe, as ``nvidia-smi`` names it
CARD = "NVIDIA H100 80GB HBM3"
#: HBM bytes a second
HBM_BYTES_PER_S = 3.35e12
#: operations a second by the type of the operands (tensor cores, dense)
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}


def op_type(dtype) -> str:
    """The peak table's key for operands of ``dtype`` (a torch dtype or
    its name)."""
    return str(dtype).removeprefix("torch.")


def bound(n_bytes: int, n_ops: int, op_type: str) -> dict:
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the peak for their type, whichever is larger."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_OPS_PER_S[op_type] * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=n_bytes, operations=n_ops, bytes_ms=bytes_ms, ops_ms=ops_ms)


def bound_of(cost: dict) -> dict:
    """:func:`bound` of one ``cost`` record."""
    return bound(cost["bytes"], cost["flops"], cost["op_type"])
