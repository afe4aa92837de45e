"""JITAUDIT of the port: the auditor of the engines' hot-path steps.

The counterpart of ``repro/analysis/jitaudit.py``. The serving numbers
hold only while three properties of the step graphs do, none of which a
token-equivalence test observes:

1. **in place** — a decode step is captured once per bucket as a CUDA
   graph (:class:`repro_torch.serving.graphs.StepGraphs`) over static
   buffers: the pool's pages and scales, the dense slots, the bucket's
   staged input vector. The graph writes them where they were at capture.
   A step that rebinds one (a new tensor in its place) or builds a copy of
   one is a step whose replay writes a buffer nobody reads, or that copies
   the pool every step. The reference got this from buffer donation.
2. **capture hazards** — a captured graph freezes every host value its
   step read at capture and cannot wait on the host: a device-to-host read
   inside the step, or host data copied in, is wrong at the next replay
   (or breaks the capture), and a step whose op sequence depends on the
   bucket's shape is a different program in every bucket.
3. **static roofline** — the step's products and each kernel's cost, the
   least time the card could take for the step.

This module checks all three on a real run of each step, traced op by op
under a :class:`~torch.utils._python_dispatch.TorchDispatchMode`:

* :func:`trace_target` runs a target's step once (on the engine's scratch
  pages, as ``Engine.warmup`` runs it) and records every aten op with its
  operands' and results' shapes, dtypes, devices and storages. A call of a
  kernel's public entry point (:mod:`repro_torch.kernels.leaf`) is one
  **leaf**, costed by its ops module's ``cost``; the ops inside it are not
  recorded, so a step gives the same account on the CPU (plain versions)
  and on the card (kernels).
* **in place** (:func:`check_in_place`, for the reference's donation
  verifier) — every static buffer keeps its ``data_ptr`` across the step,
  and no op allocates, in storage of its own, a result of a static
  buffer's shape and dtype or, for a buffer with a leading layer
  dimension (the pool's pages and scales, the dense slots), a result of
  as many elements as the whole buffer or as one layer of it: a copy of
  one layer repeated over the layers copies the pool every step.
* **capture hazards** (:func:`capture_hazards`, for ``retrace_hazards``) —
  *structural probe*: the specs of one ``probe_group`` trace the same op
  sequence; *host sync*: ``aten._local_scalar_dense``, ``aten.nonzero`` or
  a device-to-host copy inside the step; *baked host value*: host data
  made a tensor inside the step (``aten.lift_fresh``: on the card a tensor
  built from a Python list is copied there inside that one op), a
  host-to-device copy inside the step, or a kernel entry point given a
  host operand it reads on the host (flash's ``q_offset`` and
  ``kv_hole``). In captured steps (``paged_decode``, ``dense`` and the
  kernel targets) these are violations; the chunk prefill runs eagerly,
  and there they are reported as ``capture_blockers``, the list a capture
  of it would have to clear. The reference's weak-type class has no
  counterpart: a Python scalar reaching an aten op retraces nothing in
  PyTorch, and what a capture freezes of it is the baked-host-value class.
* **static roofline** (:func:`static_cost`) — FLOPs: the products (``mm``,
  ``bmm``, ``addmm``, ``baddbmm``; ``linear`` and ``matmul`` dispatch to
  them) at 2·M·N·K, plus each leaf's cost. Bytes: the reference's
  touched-region model: a product its operands and result, a gather
  (``index``, ``index_select``, ``gather``, ``embedding``) its result
  twice, a scatter (``index_put``, ``scatter``, ``index_copy``,
  ``copy_`` ...) its update twice, a reduction, concatenation or sort its
  operands and result, a leaf its cost's bytes; elementwise ops and views
  are free, so a step of elementwise ops alone has nothing to count and
  its bytes ratio is not gated. On the card each captured bucket's graph
  is replayed and timed with CUDA events, and the bound ``max(Σ
  flops/peak, bytes/HBM)`` (:mod:`repro_torch.kernels.roofline`) is
  reported as its share of the replay's time.

Tolerance bands (documented, asserted, and recorded in the JSON):

=============================  ============  ==================================
ratio                          band          why
=============================  ============  ==================================
flops vs FlopCounterMode       [0.99, 1.01]  the same products counted by
                               (+ leaves)    torch's own counter over the same
                                             run (leaves added to it): any gap
                                             is a product the walk missed or
                                             misread (calibrated 1.000)
bytes vs whole operands        [0.10, 1.05]  the walk charges touched bytes,
                                             the other side every op's whole
                                             operands and results (a paged
                                             call its whole pool): the walk
                                             must be a lower bound; the floor
                                             catches a count that loses bytes
                                             (a leaf costed at 0, an op class
                                             dropped from the walk): the
                                             lowest reading, the paged
                                             kernel target's, is 0.144 on
                                             the CPU and on the H100
replay share (card)            (0, 1.05]     bound over the measured replay:
                                             above 1 the count is wrong
=============================  ============  ==================================

CLI::

    python -m repro_torch.analysis.jitaudit --device cpu \\
        --out artifacts/STATIC_roofline.json
    python -m repro_torch.analysis.jitaudit --full-width   # on the card

audits qwen1.5-0.5b (reduced, or at full width with the launcher's
pools): a paged engine's warmup set (every decode bucket and chunk-prefill
spec), a dense-slot engine's and the three kernel targets, runs the
seeded-violation selftest (the auditor audits itself), then replays a
small corpus through the pump under the compile tracker and fails on any
capture after warmup. Exit 1 on a violation. ``--device`` defaults to
``cuda`` and raises with no card; nothing falls back to the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import traceback
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import leaf, roofline
from repro_torch.serving.engine import SpecStep, resolve_device

#: ratio bands, static/reference (see the module docstring's table)
TOLERANCES = {
    "flops_vs_flop_counter": (0.99, 1.01),
    "bytes_vs_whole_operands": (0.1, 1.05),
}
#: a replayed graph's roofline share above this means the count is wrong
REPLAY_SHARE_LIMIT = 1.05
#: replays timed per captured bucket on the card
REPLAYS = 50

#: products: 2·M·N·K, their two operands and result
_PRODUCTS = {"aten::mm": (0, 1), "aten::bmm": (0, 1), "aten::addmm": (1, 2),
             "aten::baddbmm": (1, 2)}
#: results moved twice (read the touched region, write it out)
_GATHERS = frozenset({"aten::index", "aten::index_select", "aten::gather",
                      "aten::embedding", "aten::take", "aten::masked_select"})
#: the update operand's position; charged twice (an in-place touched region)
_SCATTERS = {"aten::index_put": 2, "aten::index_put_": 2, "aten::_index_put_impl_": 2,
             "aten::scatter": 3, "aten::scatter_": 3, "aten::scatter_add": 3,
             "aten::scatter_add_": 3, "aten::index_copy": 3, "aten::index_copy_": 3,
             "aten::index_add": 3, "aten::index_add_": 3, "aten::copy_": 1,
             "aten::slice_scatter": 1, "aten::select_scatter": 1,
             "aten::masked_scatter": 2, "aten::masked_scatter_": 2}
#: operands and results charged once (real data movement)
_READWRITE = frozenset({
    "aten::sum", "aten::mean", "aten::amax", "aten::amin", "aten::max", "aten::min",
    "aten::prod", "aten::argmax", "aten::argmin", "aten::cat", "aten::sort",
    "aten::cumsum", "aten::logcumsumexp", "aten::topk", "aten::_softmax",
    "aten::_log_softmax",
})
#: host syncs: the host waits for the device to read a value
_HOST_SYNCS = frozenset({"aten::_local_scalar_dense", "aten::nonzero"})
#: host data made a tensor
_HOST_DATA = frozenset({"aten::lift_fresh", "aten::lift_fresh_copy"})
_COPIES = frozenset({"aten::_to_copy", "aten::copy_"})


@dataclass(frozen=True)
class TensorMeta:
    shape: tuple
    dtype: torch.dtype
    device: str
    storage: int                  # the storage's address: aliasing

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize


def _meta(t: torch.Tensor) -> TensorMeta:
    return TensorMeta(tuple(t.shape), t.dtype, t.device.type,
                      t.untyped_storage().data_ptr())


@dataclass
class OpRecord:
    """One op of a traced step: an aten op, or a kernel entry point's call
    (``leaf``, its cost filled in after the step)."""

    name: str
    inputs: list
    outputs: list
    view: bool = False
    update: TensorMeta | None = None
    leaf: object = None           # (entry point, args, kwargs) of a leaf
    cost: dict | None = None
    hazard: str = ""              # "host-sync" | "host-value"
    detail: str = ""
    site: str = ""                # where the traced program did it


@dataclass
class Trace:
    ops: list
    flop_counter: int
    buffers_before: dict
    buffers_after: dict

    def signature(self) -> list[str]:
        return [op.name for op in self.ops]


@dataclass
class AuditTarget:
    """One hot-path step with its inputs.

    ``make_step`` builds the step lazily: a
    :class:`~repro_torch.serving.engine.SpecStep`, ``run`` (no arguments)
    and ``buffers`` (() -> the static buffers by name).
    ``kind`` is the spec's (the chunk prefill runs eagerly; the others are
    captured) or ``kernel``. ``probe`` builds a second bucket of the same
    branch class, traced for its op sequence only; engine targets are
    instead paired inside their ``probe_group``, as the reference pairs
    them. ``replay``, on the card, is a captured bucket's graph replay.
    """

    name: str
    make_step: object
    kind: str
    bucket: dict = field(default_factory=dict)
    probe_group: str = ""
    probe: object = None
    replay: object = None


@dataclass
class AuditViolation:
    target: str
    pass_name: str                # in-place | capture-hazard | roofline
    msg: str
    provenance: str = ""

    def __str__(self) -> str:
        s = f"[{self.pass_name}] {self.target}: {self.msg}"
        if self.provenance:
            s += f"\n    provenance: {self.provenance}"
        return s


# --------------------------------------------------------------------------
# tracing
# --------------------------------------------------------------------------
def _site() -> str:
    """The innermost frame of the traced program's own code: where a
    hazard was written."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for frame in reversed(traceback.extract_stack()):
        path = os.path.abspath(frame.filename)
        if path.startswith(here) and not path.endswith(("jitaudit.py", "leaf.py")):
            rel = os.path.relpath(path, os.path.dirname(here))
            return f"{rel}:{frame.lineno} ({frame.name})"
    return "?"


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class _Recorder(TorchDispatchMode):
    """Records every aten op of a step, and every kernel entry point's
    call as one leaf whose inner ops it does not see."""

    def __init__(self):
        super().__init__()
        self.ops: list[OpRecord] = []
        self._in_leaf = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        ins = _tensors((args, kwargs))
        rec = OpRecord(name, [_meta(t) for t in ins], [_meta(t) for t in _tensors(out)],
                       view=func.is_view)
        if name in _SCATTERS:
            pos = _SCATTERS[name]
            upd = args[pos] if len(args) > pos else None
            if isinstance(upd, torch.Tensor):
                rec.update = _meta(upd)
        if name in _HOST_SYNCS:
            rec.hazard, rec.detail = "host-sync", f"{name} reads a device value on the host"
        elif name in _COPIES and ins and rec.outputs:
            src = ins[1] if name == "aten::copy_" else ins[0]
            dst = rec.outputs[0]
            if src.device.type != "cpu" and dst.device == "cpu":
                rec.hazard, rec.detail = "host-sync", f"{name} copies {src.device.type} to cpu"
            elif src.device.type == "cpu" and dst.device != "cpu":
                rec.hazard = "host-value"
                rec.detail = f"{name} copies host data {list(src.shape)} to {dst.device}"
        elif name in _HOST_DATA and rec.outputs and len(rec.outputs[0].shape) > 0:
            rec.hazard = "host-value"
            rec.detail = (f"{name} makes host data {list(rec.outputs[0].shape)} a tensor "
                          f"on {rec.outputs[0].device}")
        if rec.hazard:
            rec.site = _site()
        self.ops.append(rec)
        return out

    def leaf_call(self, call, fn, args, kwargs):
        """A kernel entry point's call (:mod:`repro_torch.kernels.leaf`): run
        it with every dispatch mode off and record it as one op (an entry
        point it calls in turn is part of it)."""
        if self._in_leaf:
            return fn(*args, **kwargs)
        self._in_leaf = True
        try:
            with _disable_current_modes():
                out = fn(*args, **kwargs)
        finally:
            self._in_leaf = False
        host = {k: kwargs[k] for k in call.host_operands
                if kwargs.get(k) not in (None, 0)}
        rec = OpRecord(f"leaf:{call.leaf_name}", [_meta(t) for t in _tensors((args, kwargs))],
                       [_meta(t) for t in _tensors(out)], leaf=(call, args, kwargs))
        if host:
            rec.hazard, rec.site = "host-value", _site()
            rec.detail = f"{call.leaf_name} reads {host} on the host"
        self.ops.append(rec)
        return out


def trace_target(target: AuditTarget) -> Trace:
    """Run ``target``'s step once, op by op, under the recorder and torch's
    FLOP counter; returns the trace with the static buffers' metadata
    before and after (read afresh, so a rebinding shows)."""
    from torch.utils.flop_counter import FlopCounterMode

    step = target.make_step()
    before = {k: _meta(t) for k, t in step.buffers().items()}
    before_ptr = {k: t.data_ptr() for k, t in step.buffers().items()}
    rec = _Recorder()
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), leaf.recording(rec.leaf_call), counter, rec:
        step.run()
    after_ptr = {k: t.data_ptr() for k, t in step.buffers().items()}
    after = {k: _meta(t) for k, t in step.buffers().items()}
    for op in rec.ops:
        if op.leaf is not None:
            call, args, kwargs = op.leaf
            op.cost = call.cost(*args, **kwargs)
            op.leaf = None
    return Trace(rec.ops, counter.get_total_flops(),
                 {k: (before[k], before_ptr[k]) for k in before},
                 {k: (after[k], after_ptr[k]) for k in after})


# --------------------------------------------------------------------------
# pass 1: in place
# --------------------------------------------------------------------------
def check_in_place(target: AuditTarget, trace: Trace) -> list[AuditViolation]:
    """Every static buffer keeps its address across the step, and no op
    allocates elsewhere a result of a static buffer's shape and dtype, or
    of as many elements as a layered buffer or one layer of it."""
    out: list[AuditViolation] = []
    for name, (meta, ptr) in trace.buffers_before.items():
        after = trace.buffers_after.get(name)
        if after is None or after[1] != ptr or after[0].shape != meta.shape:
            out.append(AuditViolation(
                target.name, "in-place",
                f"static buffer `{name}` was rebound by the step: a replayed graph "
                f"writes the old one, which nothing reads",
                provenance=f"before {meta.shape} @ {ptr:#x}, after "
                           f"{after[0].shape if after else None} @ "
                           f"{after[1] if after else 0:#x}"))
    statics = {(m.shape, m.dtype): f"static buffer `{name}`"
               for name, (m, _) in trace.buffers_before.items()}
    # a buffer of three or more dimensions leads with its layers (the
    # staged input vector has none): a result of its size, or of one
    # layer's, in any layout or dtype, is a copy of it
    sizes: dict = {}
    for name, (m, _) in trace.buffers_before.items():
        if len(m.shape) >= 3:
            numel = int(np.prod(m.shape, dtype=np.int64))
            sizes.setdefault(numel, f"static buffer `{name}`")
            sizes.setdefault(numel // m.shape[0], f"one layer of static buffer `{name}`")
    storages = {m.storage for m, _ in trace.buffers_before.values()}
    for i, op in enumerate(trace.ops):
        if op.view:
            continue
        for o in op.outputs:
            if o.storage in storages:
                continue
            hit = statics.get((o.shape, o.dtype)) or sizes.get(
                int(np.prod(o.shape, dtype=np.int64)))
            if hit is not None:
                out.append(AuditViolation(
                    target.name, "in-place",
                    f"op {i} `{op.name}` allocates a {list(o.shape)} {o.dtype} result, a copy "
                    f"of {hit} (a pool copy per step, or a rebinding)",
                    provenance=f"op {i} of {len(trace.ops)}"))
    return out


# --------------------------------------------------------------------------
# pass 2: capture hazards
# --------------------------------------------------------------------------
def _divergence(a: list[str], b: list[str]) -> str:
    div = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
    return (f"diverges at op {div}: {a[max(0, div - 2):div + 3]} vs "
            f"{b[max(0, div - 2):div + 3]} (lengths {len(a)} vs {len(b)})")


def hazards(trace: Trace, probe: Trace | None = None) -> list[dict]:
    """The step's capture hazards, one a (class, op, site): host syncs,
    baked host values and (with ``probe``, a second bucket of the same
    branch class) a shape-dependent op sequence. Each ``{"class", "op",
    "site", "detail"}``, ``detail`` the first instance's."""
    out: list[dict] = []
    seen: set = set()
    for op in trace.ops:
        if op.hazard and (op.hazard, op.name, op.site) not in seen:
            seen.add((op.hazard, op.name, op.site))
            out.append({"class": op.hazard, "op": op.name, "site": op.site,
                        "detail": op.detail})
    if probe is not None and trace.signature() != probe.signature():
        out.append({"class": "shape-branch", "op": None, "site": None,
                    "detail": _divergence(trace.signature(), probe.signature())})
    return out


def capture_hazards(target: AuditTarget, trace: Trace,
                    probe: Trace | None = None) -> list[AuditViolation]:
    """:func:`hazards` as violations of a captured step."""
    out: list[AuditViolation] = []
    for h in hazards(trace, probe):
        if h["class"] == "shape-branch":
            out.append(AuditViolation(
                target.name, "capture-hazard",
                "shape-branch: the op sequence differs between two buckets of one "
                "probe group, so each bucket captures a different program",
                provenance=h["detail"]))
        else:
            out.append(AuditViolation(target.name, "capture-hazard",
                                      f"{h['class']}: {h['detail']}",
                                      provenance=f"at {h['site']}"))
    return out


# --------------------------------------------------------------------------
# pass 3: static roofline
# --------------------------------------------------------------------------
@dataclass
class StaticCost:
    flops: float = 0.0
    flops_by_type: dict = field(default_factory=dict)
    hbm_bytes: float = 0.0
    whole_bytes: float = 0.0
    leaf_flops: float = 0.0
    ops: int = 0
    counted: int = 0              # ops the walk charges bytes for

    def add_flops(self, n: float, op_type: str) -> None:
        self.flops += n
        self.flops_by_type[op_type] = self.flops_by_type.get(op_type, 0) + n


def static_cost(trace: Trace) -> StaticCost:
    """FLOPs and touched HBM bytes of a traced step (the module docstring's
    model), beside every op's whole operands and results."""
    acc = StaticCost()
    for op in trace.ops:
        acc.ops += 1
        if op.view:
            continue
        if op.cost is not None:
            acc.add_flops(op.cost["flops"], op.cost["op_type"])
            acc.leaf_flops += op.cost["flops"]
            acc.hbm_bytes += op.cost["bytes"]
            acc.counted += 1
            acc.whole_bytes += sum(m.nbytes for m in op.inputs + op.outputs)
            continue
        acc.whole_bytes += sum(m.nbytes for m in op.inputs + op.outputs)
        acc.counted += op.name in _PRODUCTS or op.name in _GATHERS or (
            op.name in _SCATTERS) or op.name in _READWRITE
        if op.name in _PRODUCTS:
            a, b = (op.inputs[i] for i in _PRODUCTS[op.name])
            k = a.shape[-1]
            out_elems = int(np.prod(op.outputs[0].shape, dtype=np.int64))
            acc.add_flops(2.0 * out_elems * k, roofline.op_type(a.dtype))
            acc.hbm_bytes += a.nbytes + b.nbytes + op.outputs[0].nbytes
        elif op.name in _GATHERS:
            acc.hbm_bytes += 2 * sum(m.nbytes for m in op.outputs)
        elif op.name in _SCATTERS:
            acc.hbm_bytes += 2 * (op.update.nbytes if op.update is not None
                                  else op.outputs[0].nbytes)
        elif op.name in _READWRITE:
            acc.hbm_bytes += sum(m.nbytes for m in op.inputs + op.outputs)
    return acc


def step_bound(cost: StaticCost) -> dict:
    """The least time the card could take for a step: its products and
    leaves at the peak of their types, or its bytes over HBM."""
    ops_ms = sum(n / roofline.PEAK_OPS_PER_S[t] for t, n in cost.flops_by_type.items()) * 1e3
    bytes_ms = cost.hbm_bytes / roofline.HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms), ops_ms=ops_ms, bytes_ms=bytes_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def _ratio(a: float, b: float) -> float:
    if b:
        return a / b
    return float("nan") if not a else float("inf")


def roofline_row(target: AuditTarget, trace: Trace) -> dict:
    """One STATIC_roofline.json row: the static walk beside torch's FLOP
    counter and the whole operands, with the gated ratios."""
    st = static_cost(trace)
    counter = trace.flop_counter + st.leaf_flops
    return {
        "target": target.name,
        "kind": target.kind,
        "bucket": target.bucket,
        "static": {"flops": st.flops, "flops_by_type": st.flops_by_type,
                   "hbm_bytes": st.hbm_bytes, "ops": st.ops,
                   "leaves": [op.name for op in trace.ops if op.cost is not None]},
        "flop_counter": {"flops": float(trace.flop_counter), "with_leaves": counter},
        "whole_operands": {"bytes": st.whole_bytes},
        "ratios": {
            "flops_vs_flop_counter": _ratio(st.flops, counter),
            "bytes_vs_whole_operands": (_ratio(st.hbm_bytes, st.whole_bytes)
                                        if st.counted else float("nan")),
        },
        **step_bound(st),
    }


def check_roofline(target: AuditTarget, row: dict) -> list[AuditViolation]:
    out: list[AuditViolation] = []
    for key, (lo, hi) in TOLERANCES.items():
        r = row["ratios"][key]
        if r != r:                     # nothing to count
            continue
        if not (lo <= r <= hi):
            out.append(AuditViolation(
                target.name, "roofline",
                f"static/{key.split('_vs_')[1]} ratio {r:.4f} outside the documented "
                f"band [{lo}, {hi}] for {key.split('_vs_')[0]}",
                provenance=json.dumps(row["ratios"])))
    share = row.get("replay_share")
    if share is not None and not 0 < share <= REPLAY_SHARE_LIMIT:
        out.append(AuditViolation(
            target.name, "roofline",
            f"replay share of the bound {share:.4f} outside (0, {REPLAY_SHARE_LIMIT}]: "
            "the step's count is wrong",
            provenance=f"bound {row['bound_ms']:.5f} ms, replay {row['replay_ms']:.5f} ms"))
    return out


def blocker_sites(rows: list[dict]) -> list[str]:
    """The chunk prefill's capture blockers over every row, one line a
    (class, op, site)."""
    return sorted({f"{b['class']}: {b['op']} at {b['site']}"
                   for r in rows for b in r.get("capture_blockers", [])})


def time_replay(replay, n: int = REPLAYS) -> float:
    """Mean ms of one graph replay over ``n``, by CUDA events, after two
    untimed replays."""
    for _ in range(2):
        replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


# --------------------------------------------------------------------------
# targets
# --------------------------------------------------------------------------
def engine_targets(engine, prefill_chunks: bool = True) -> list[AuditTarget]:
    """A target for every spec ``Engine.warmup`` runs, paired inside each
    probe group. On the card a captured bucket's target also replays its
    graph (captured here first if the engine was not warmed)."""
    out: list[AuditTarget] = []
    for spec in engine.warmup_specs(prefill_chunks=prefill_chunks):
        replay = None
        if spec.kind != "chunk_prefill" and engine.device.type == "cuda":
            replay = _graph_replay(engine, spec)
        out.append(AuditTarget(
            name=f"engine{engine._audit_id}.{spec.name}",
            make_step=lambda spec=spec: engine.spec_step(spec, eager=True),
            kind=spec.kind, bucket=dict(spec.bucket), probe_group=spec.probe_group,
            replay=replay))
    return out


def _graph_replay(engine, spec):
    """A function that replays ``spec``'s bucket graph over whatever its
    static vector holds (the spec's scratch inputs after the trace)."""
    from repro_torch.serving.engine import DENSE_KEY

    key = DENSE_KEY if spec.kind == "dense" else spec.bucket["table_pages"]

    def replay():
        if key not in engine.graphs:
            with torch.no_grad():
                engine.spec_step(spec).run()
        return engine.graphs.replay(key)

    return replay


def _kernel_step(fn, make_args) -> SpecStep:
    """A kernel target's step: one call of the entry point on inputs built
    before the step."""
    args = make_args()
    return SpecStep(lambda: fn(*args), dict)


def kernel_targets(device=None) -> list[AuditTarget]:
    """The three kernels' entry points at the example shapes their ops
    modules own (``audit_spec``), each probed at a second bucket.
    ``device`` as :func:`~repro_torch.serving.engine.resolve_device` reads
    it: ``None`` is the card."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    device = resolve_device(device)
    out: list[AuditTarget] = []
    for mod in (paged_ops, flash_ops, ssd_ops):
        spec = mod.audit_spec(device)
        out.append(AuditTarget(
            name=spec["name"], kind="kernel", bucket=spec["bucket"],
            make_step=lambda s=spec: _kernel_step(s["fn"], s["make_args"]),
            probe=lambda s=spec: _kernel_step(s["fn"], s["probe_args"])))
    return out


def audit(targets: list[AuditTarget]) -> tuple[list[dict], list[AuditViolation]]:
    """The three passes over ``targets``; returns (roofline rows,
    violations). A chunk-prefill target's hazards go into its row's
    ``capture_blockers``, not into the violations: the port runs that
    step eagerly."""
    traces: dict[str, Trace] = {}
    for t in targets:
        traces[t.name] = trace_target(t)
    groups: dict[str, list[AuditTarget]] = {}
    for t in targets:
        if t.probe_group:
            groups.setdefault(t.probe_group, []).append(t)
    partner = {}
    for group in groups.values():
        for a, b in zip(group, group[1:]):
            partner[a.name] = traces[b.name]
    rows: list[dict] = []
    violations: list[AuditViolation] = []
    for t in targets:
        trace = traces[t.name]
        probe = partner.get(t.name)
        if t.probe is not None:
            probe = trace_target(AuditTarget(f"{t.name}[probe]", t.probe, t.kind))
        row = roofline_row(t, trace)
        if t.replay is not None:
            row["replay_ms"] = time_replay(t.replay)
            row["replay_share"] = row["bound_ms"] / row["replay_ms"]
        if t.kind == "chunk_prefill":
            row["capture_blockers"] = hazards(trace, probe)
        else:
            violations += capture_hazards(t, trace, probe)
        violations += check_in_place(t, trace)
        violations += check_roofline(t, row)
        rows.append(row)
    return rows, violations


# --------------------------------------------------------------------------
# seeded-violation selftest: the auditor must catch planted bugs
# --------------------------------------------------------------------------
#: a leaf whose cost loses its bytes: the roofline pass's floor must fire
_zero_bytes_leaf = leaf.entry(
    "selftest.zero_bytes",
    lambda x: {"flops": x.numel(), "bytes": 0, "op_type": roofline.op_type(x.dtype)},
)(lambda x: x * 2)


def _seeded_targets(device) -> dict:
    """One target a seeded class, and one honored in-place step: ``{name:
    (target, probe target or None, the pass that must fire or None)}``."""
    dev = torch.device(device)
    # a pool of 2 layers, as the engine's pages lead with theirs
    held = {"pool": torch.zeros((2, 8, 16), dtype=torch.bfloat16, device=dev)}

    def rebinding():
        # the owner's buffer replaced by an out-of-place result
        held["pool"] = held["pool"] * 2

    def per_layer_copy():
        # each layer copied out in another layout: the pool copied per step
        return [held["pool"][layer].t().contiguous() for layer in range(2)]

    def honored():
        held["pool"].mul_(2)
        held["pool"][0].add_(1)

    def branchy(x):
        if x.shape[0] > 8:
            return x * 2
        return x + 1

    x8, x16 = torch.zeros(8, device=dev), torch.zeros(16, device=dev)
    x4 = torch.zeros(4, device=dev)

    def steps(run, buffers=dict):
        return lambda: SpecStep(run, buffers)

    def target(name, make):
        return AuditTarget(name, make, "paged_decode")

    def pool():
        return dict(held)

    return {
        "in-place": (target("selftest-rebinding", steps(rebinding, pool)), None, "in-place"),
        "per-layer-copy": (target("selftest-per-layer-copy", steps(per_layer_copy, pool)),
                           None, "in-place"),
        "honored": (target("selftest-in-place-ok", steps(honored, pool)), None, None),
        "shape-branch": (target("selftest-shape-branch", steps(lambda: branchy(x8))),
                         target("selftest-shape-branch[probe]", steps(lambda: branchy(x16))),
                         "capture-hazard"),
        "host-sync": (target("selftest-host-sync", steps(lambda: (x4 + 1).sum().item())),
                      None, "capture-hazard"),
        "host-value": (target("selftest-host-value", steps(
            lambda: x4 + torch.as_tensor(np.arange(4.0, dtype=np.float32), device=dev))),
            None, "capture-hazard"),
        "zero-bytes-leaf": (target("selftest-zero-bytes-leaf",
                                   steps(lambda: _zero_bytes_leaf(x16))), None, "roofline"),
    }


def selftest(device=None) -> list[str]:
    """Plant one instance of each class (a rebound buffer, a per-layer
    copy of one, a shape branch, a host sync, a baked host value, a leaf
    costed at zero bytes) and run one honored in-place step; returns
    failure descriptions (empty: every class fires its pass alone and the
    honored step stays clean). ``device``: ``None`` is the card."""
    failures: list[str] = []
    for cls, (t, probe_t, want) in _seeded_targets(resolve_device(device)).items():
        trace = trace_target(t)
        probe = trace_target(probe_t) if probe_t is not None else None
        fired = {v.pass_name for v in check_in_place(t, trace)}
        fired |= {v.pass_name for v in capture_hazards(t, trace, probe)}
        fired |= {v.pass_name for v in check_roofline(t, roofline_row(t, trace))}
        expected = {want} if want else set()
        if fired != expected:
            failures.append(f"{cls}: passes fired {sorted(fired)}, expected {sorted(expected)}")
    return failures


# --------------------------------------------------------------------------
# replay gate: no capture after warmup through the real pump
# --------------------------------------------------------------------------
#: the replay gate's engine geometry (the reduced audit's)
GATE_POOLS = dict(page_tokens=16, n_device_pages=96, n_host_pages=64, max_slots=2, max_seq=128)
#: the reduced audit's dense-slot engine
DENSE_POOLS = dict(GATE_POOLS, n_device_pages=8, n_host_pages=8, max_seq=64)


def replay_gate(cfg, params, *, device=None, log=print) -> dict:
    """Warm a paged engine (:data:`GATE_POOLS`), push a small corpus
    through the chunked-prefill decode pump under the armed compile
    tracker and return its verdict (the router's end-of-replay hook raises
    on a capture after warmup). The tracker's environment switch and
    arming are set for the gate and restored after it. ``device``:
    ``None`` is the card."""
    from repro_torch.analysis import compile_tracker
    from repro_torch.core.types import ProgramTrace, RequestRecord
    from repro_torch.serving import Engine, MoriRouter

    device = resolve_device(device)
    tracker = compile_tracker.get_tracker()
    was_armed, prev = tracker.armed, os.environ.get(compile_tracker.ENV_VAR)
    os.environ[compile_tracker.ENV_VAR] = "1"
    tracker.arm()
    try:
        with tracker.phase("engine-build"):
            engine = Engine(cfg, params, device=device, **GATE_POOLS)
        engine.warmup(prefill_chunks=True)
        router = MoriRouter(
            [engine], scheduler="mori",
            gpu_capacity_bytes=engine.radix_device_pages * engine.pool.page_bytes,
            chunked_prefill=True,
        )
        corpus = [
            ProgramTrace(f"audit-p{p}", [
                RequestRecord(input_tokens=24 + 13 * p + 7 * s, output_tokens=4,
                              tool_duration_s=0.0 if s == 2 else 5.0, reasoning_wall_s=0.0)
                for s in range(3)
            ])
            for p in range(3)
        ]
        router.replay(corpus, vocab_size=cfg.vocab_size, max_new_tokens=4)
        verdict = {
            "post_warmup_captures": tracker.post_warmup_compiles(),
            "cache_sizes": tracker.cache_sizes(),
            "captures_by_phase": {ph: len(tracker.events_in(ph))
                                  for ph in ("engine-build", "warmup", "replay")},
            "graph_replays": engine.graphs.replays,
        }
    finally:
        if not was_armed:
            tracker.disarm()
        if prev is None:
            os.environ.pop(compile_tracker.ENV_VAR, None)
        else:
            os.environ[compile_tracker.ENV_VAR] = prev
    log(f"replay gate: cache sizes {verdict['cache_sizes']}, captures by phase "
        f"{verdict['captures_by_phase']}")
    return verdict


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------
def audit_engines(cfg, params, device, *, pools: dict, dense_pools: dict,
                  log=print) -> tuple[list[dict], list[AuditViolation], int]:
    """A paged engine's warmup set with chunk prefill, a dense-slot
    engine's and the kernel targets; returns (rows, violations, targets)."""
    from repro_torch.serving import Engine

    paged = Engine(cfg, params, device=device, **pools)
    dense = Engine(cfg, params, device=device, dense_slots=True, **dense_pools)
    targets = (engine_targets(paged, prefill_chunks=True)
               + engine_targets(dense, prefill_chunks=False) + kernel_targets(device))
    log(f"auditing {len(targets)} step targets ({cfg.name}, device {device})")
    rows, violations = audit(targets)
    return rows, violations, len(targets)


#: the model the CLI audits
MODEL = "qwen1.5-0.5b"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.jitaudit",
        description="step-graph audit: in place, capture hazards, capture budget, "
                    "static roofline")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--full-width", action="store_true",
                    help="audit the full-width model with the launcher's pools "
                         "(default: the reduced model)")
    ap.add_argument("--out", default="artifacts/STATIC_roofline.json")
    ap.add_argument("--skip-replay", action="store_true",
                    help="skip the pump-replay capture-budget gate")
    ap.add_argument("--skip-selftest", action="store_true",
                    help="skip the seeded-violation selftest")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.models import Model, materialize

    device = resolve_device(args.device)
    cfg = get_config(MODEL)
    if not args.full_width:
        cfg = cfg.reduced()
    params = materialize(Model(cfg).describe(), seed=0, device=device)

    failures: list[str] = []
    if not args.skip_selftest:
        failures = selftest(device)
        for f in failures:
            print(f"SELFTEST FAIL: {f}")
        if not failures:
            print(f"selftest: {len(_seeded_targets(device)) - 1} seeded classes each detected "
                  "alone, the honored step clean")
    if args.full_width:
        from repro_torch.launch.serve import ENGINE_POOLS

        pools = dense_pools = ENGINE_POOLS
    else:
        pools, dense_pools = GATE_POOLS, DENSE_POOLS
    rows, violations, n = audit_engines(cfg, params, device, pools=pools,
                                        dense_pools=dense_pools)
    for v in violations:
        print(v)
    report = {
        "generated_by": "repro_torch.analysis.jitaudit",
        "model": MODEL,
        "full_width": args.full_width,
        "device": str(device),
        "card": torch.cuda.get_device_name(device) if device.type == "cuda" else None,
        "geometry": pools,
        "tolerances": {k: list(v) for k, v in TOLERANCES.items()},
        "replay_share_limit": REPLAY_SHARE_LIMIT,
        "targets": rows,
        "violations": [{"target": v.target, "pass": v.pass_name, "msg": v.msg,
                        "provenance": v.provenance} for v in violations],
        "selftest_failures": failures,
    }
    if not args.skip_replay:
        report["replay"] = replay_gate(cfg, params, device=device)
        if report["replay"]["post_warmup_captures"]:
            failures.append("the replay gate saw captures after warmup")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2, default=str)
        print(f"wrote {args.out} ({n} roofline rows)")
    ok = not violations and not failures
    print("jitaudit: " + ("clean" if ok else f"{len(violations)} violation(s), "
                                             f"{len(failures)} selftest failure(s)"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
