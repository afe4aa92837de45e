"""The port's AST lint: the invariants this repo keeps re-learning.

The counterpart of ``repro/analysis/lint.py``. Run as ``python -m
repro_torch.analysis.lint [paths...]`` (defaults to ``src/repro_torch``,
``tests/test_torch_*.py`` and ``chip_smoke.py`` under the repository's
root). Exit code 1 when violations exist. Like the reference's, it imports
no runtime code.

Rules (suppress a finding with a ``# lint: <rule>-ok`` marker on the
flagged line). Kept under the reference's IDs:

* **KV002 lru-cache-hashable** — ``functools.lru_cache`` keys must be
  hashable and immutable: parameters annotated, never with a known
  unhashable container type, and a repo dataclass used as a key must be
  ``frozen=True``.
* **KV003 action-exhaustive** — an ``isinstance`` dispatch chain over the
  :mod:`repro_torch.core.actions` union names every action type or has an
  ``else``.
* **KV004 pin-paired** — a scope (class or module) that calls
  ``tree.pin()`` / ``tree.acquire_nodes()`` also calls the matching
  ``unpin()`` / ``release_program()`` / ``release_nodes()``.
* **KV005 wall-clock** — modules under ``repro_torch/core`` or
  ``repro_torch/sim`` run on the replay's virtual clock: no
  ``time.time()`` / ``time.monotonic()`` / ``datetime.now()`` there
  (``perf_counter`` measures real compute and is allowed).
* **KV008 format-aware-sizing** — byte math over KV pages goes through the
  format-aware helpers: (a) a host/offload/wire quantity priced with a
  device-format size (``page_bytes`` / ``kv_bytes`` /
  ``kv_bytes_per_token``); (b) model geometry multiplied by a literal
  ``2`` in a byte quantity. ``repro_torch/kernels/kv_quant.py`` is exempt.

The reference's jit rules, replaced by their graph counterparts:

* **KV001 replay-reuse** (for the reference's KV001 donated-reuse and
  KV007 decorated-donated-reuse) — :meth:`StepGraphs.replay` returns the
  graph's *static* outputs, which the next replay of the same cache
  overwrites (``serving/graphs.py``). A name bound from a replay and read
  after a later replay of the same cache in the same function reads the
  later step's values. A method that returns a replay (``Engine._decode``)
  counts as a replay of its cache. The decorator form of KV007 has no
  counterpart: a graph is captured by ``StepGraphs.capture``, never by a
  decorator.
* **KV006 capture-shape-branch** (for jit-shape-branch) — a Python
  ``if``/``while`` on ``.shape`` / ``len()`` / ``.ndim`` inside a function
  handed to ``StepGraphs.capture`` (directly, through a lambda, or as what
  a local function returns) freezes one branch into the graph; bucket the
  shapes and mark the line if it is deliberate.

New rules:

* **KV009 capture-host-sync** — ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()`` or ``torch.nonzero`` inside a captured step (found as for
  KV006): the host cannot wait inside a graph.
* **KV010 import-time-build** — under ``repro_torch/kernels``, ``triton``
  imported or a kernel built or loaded (``build``, ``load``,
  ``load_inline``, ``CDLL``, ``subprocess``) when the module is imported:
  modules import everywhere, the CPU included, and kernels are built at
  their first launch.
* **KV011 ref-fallback** — an ``except`` handler that calls a plain
  ``*_ref`` / ``*_reference`` version: a kernel failure that quietly
  returns the plain version's answer. A wrapper chooses by device, never
  on a failure.

The step auditor (:mod:`repro_torch.analysis.jitaudit`) checks the same
properties on a real run of each step; this lint checks the source.
"""
from __future__ import annotations

import argparse
import ast
import glob
import os
import sys
from dataclasses import dataclass

#: the repository's root (this file is ``src/repro_torch/analysis/lint.py``)
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
_DEFAULT_PATHS = ("src/repro_torch", "tests/test_torch_*.py", "chip_smoke.py")

#: the Action union (see ``repro_torch.core.actions._ACTION_TYPES``) — kept
#: as a literal so the linter never imports runtime code
ACTION_NAMES = frozenset(
    {"Forward", "Offload", "Discard", "Migrate", "SetLabel", "CancelTransfer"}
)

_UNHASHABLE = frozenset(
    {"list", "dict", "set", "bytearray", "List", "Dict", "Set",
     "ndarray", "Array", "array", "Tensor"}
)
_WALLCLOCK_TIME_ATTRS = frozenset({"time", "monotonic", "localtime"})
_WALLCLOCK_DT_ATTRS = frozenset({"now", "utcnow", "today"})
_PIN_CALLS = frozenset({"pin", "acquire_nodes"})
_UNPIN_CALLS = frozenset({"unpin", "release_program", "release_nodes"})
_HOST_SYNC_ATTRS = frozenset({"item", "tolist", "cpu", "numpy", "nonzero"})
_BUILD_CALLS = frozenset({"build", "load", "load_bwd", "load_inline", "CDLL",
                          "LoadLibrary", "load_library"})


@dataclass
class Violation:
    path: str
    line: int
    rule: str
    msg: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.msg}"


def _dotted(node) -> str | None:
    """``a.b.c`` attribute chains as a string (None for anything else)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _suppressed(lines: list[str], lineno: int, rule_key: str) -> bool:
    if 1 <= lineno <= len(lines):
        return f"lint: {rule_key}-ok" in lines[lineno - 1]
    return False


def _pos(node) -> tuple[int, int]:
    return node.lineno, node.col_offset


def _end(node) -> tuple[int, int]:
    return node.end_lineno or node.lineno, node.end_col_offset or 0


def _ann_base(ann) -> str | None:
    """The base type name of an annotation expression."""
    if ann is None:
        return None
    if isinstance(ann, ast.Subscript):
        return _ann_base(ann.value)
    if isinstance(ann, ast.Attribute):
        return ann.attr
    if isinstance(ann, ast.Name):
        return ann.id
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        head = ann.value.split("[", 1)[0].strip()
        return head.rsplit(".", 1)[-1] or None
    if isinstance(ann, ast.BinOp):            # X | None unions
        return _ann_base(ann.left)
    return None


def _functions(tree):
    return [n for n in ast.walk(tree) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


# --------------------------------------------------------------------------
# module pre-pass: dataclass registry (name -> frozen?) across all files
# --------------------------------------------------------------------------
def _index_dataclasses(tree: ast.Module, registry: dict[str, bool]) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for dec in node.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            if _dotted(target) not in ("dataclass", "dataclasses.dataclass"):
                continue
            frozen = False
            if isinstance(dec, ast.Call):
                for kw in dec.keywords:
                    if kw.arg == "frozen" and isinstance(kw.value, ast.Constant):
                        frozen = bool(kw.value.value)
            registry[node.name] = frozen


# --------------------------------------------------------------------------
# KV001 replay-reuse
# --------------------------------------------------------------------------
def _replay_aliases(tree: ast.Module) -> dict[str, str]:
    """Method name -> the attribute chain under ``self`` of the cache it
    replays, for methods whose body returns ``self.<cache>.replay(...)``."""
    out: dict[str, str] = {}
    for fn in _functions(tree):
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Return) and isinstance(node.value, ast.Call)):
                continue
            f = node.value.func
            base = _dotted(f.value) if isinstance(f, ast.Attribute) else None
            if f is not None and isinstance(f, ast.Attribute) and f.attr == "replay" and base \
                    and base.startswith("self."):
                out[fn.name] = base.removeprefix("self.")
    return out


def _replay_key(call, aliases: dict[str, str]) -> str | None:
    """The cache a call replays (``self.graphs``), or None."""
    if not (isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)):
        return None
    base = _dotted(call.func.value)
    if base is None:
        return None
    if call.func.attr == "replay":
        return base
    if call.func.attr in aliases:
        return f"{base}.{aliases[call.func.attr]}"
    return None


def _unwrap_call(node):
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        node = node.value
    return node if isinstance(node, ast.Call) else None


def _bound_names(targets) -> list[ast.Name]:
    out: list[ast.Name] = []
    for t in targets:
        for n in ast.walk(t):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                out.append(n)
    return out


def check_replay_reuse(path: str, tree: ast.Module, lines: list[str], registry) -> list[Violation]:
    del registry
    aliases = _replay_aliases(tree)
    out: list[Violation] = []
    for func in _functions(tree):
        replays = [(c, k) for c in ast.walk(func) for k in [_replay_key(c, aliases)] if k]
        if len(replays) < 2:
            continue
        for stmt in ast.walk(func):
            if not isinstance(stmt, (ast.Assign, ast.AnnAssign)) or stmt.value is None:
                continue
            call = _unwrap_call(stmt.value)
            key = _replay_key(call, aliases) if call is not None else None
            if key is None:
                continue
            later = sorted((c for c, k in replays if k == key and _pos(c) > _end(call)),
                           key=_pos)
            if not later:
                continue
            nxt = later[0]
            targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            for name in _bound_names(targets):
                refs = sorted((n for n in ast.walk(func)
                               if isinstance(n, ast.Name) and n.id == name.id
                               and _pos(n) > _end(call)), key=_pos)
                if any(isinstance(r.ctx, ast.Store) and _pos(r) < _end(nxt) for r in refs):
                    continue             # rebound before the later replay returns
                for r in refs:
                    if _pos(r) <= _end(nxt):
                        continue
                    if isinstance(r.ctx, ast.Store):
                        break
                    if not _suppressed(lines, r.lineno, "replay-reuse"):
                        out.append(Violation(
                            path, r.lineno, "KV001",
                            f"`{name.id}` holds the static outputs of the replay of `{key}` "
                            f"on line {call.lineno}, overwritten by its replay on line "
                            f"{nxt.lineno}; copy or read them before the next replay"))
                    break
    return out


# --------------------------------------------------------------------------
# KV002 lru-cache-hashable
# --------------------------------------------------------------------------
def _is_cache_decorator(dec) -> bool:
    target = dec.func if isinstance(dec, ast.Call) else dec
    return _dotted(target) in (
        "lru_cache", "functools.lru_cache", "cache", "functools.cache",
    )


def check_lru_cache_hashable(
    path: str, tree: ast.Module, lines: list[str], registry: dict[str, bool]
) -> list[Violation]:
    out: list[Violation] = []
    for func in _functions(tree):
        if not any(_is_cache_decorator(d) for d in func.decorator_list):
            continue
        if _suppressed(lines, func.lineno, "lru-cache-hashable"):
            continue
        for arg in func.args.posonlyargs + func.args.args + func.args.kwonlyargs:
            if arg.arg in ("self", "cls"):
                continue
            if arg.annotation is None:
                out.append(Violation(
                    path, func.lineno, "KV002",
                    f"cached function `{func.name}` has unannotated parameter "
                    f"`{arg.arg}` — cache keys must be demonstrably hashable (annotate it)"))
                continue
            base = _ann_base(arg.annotation)
            if base in _UNHASHABLE:
                out.append(Violation(
                    path, func.lineno, "KV002",
                    f"cached function `{func.name}` keys on unhashable `{base}` "
                    f"parameter `{arg.arg}`"))
            elif base in registry and not registry[base]:
                out.append(Violation(
                    path, func.lineno, "KV002",
                    f"cached function `{func.name}` keys on dataclass `{base}` which is "
                    f"not frozen=True — mutable keys poison or split the cache"))
    return out


# --------------------------------------------------------------------------
# KV003 action-exhaustive
# --------------------------------------------------------------------------
def _isinstance_targets(test) -> set[str]:
    names: set[str] = set()
    for node in ast.walk(test):
        if not (isinstance(node, ast.Call) and _dotted(node.func) == "isinstance"):
            continue
        if len(node.args) != 2:
            continue
        spec = node.args[1]
        for e in spec.elts if isinstance(spec, ast.Tuple) else [spec]:
            d = _dotted(e)
            if d is not None:
                names.add(d.rsplit(".", 1)[-1])
    return names


def check_action_exhaustive(
    path: str, tree: ast.Module, lines: list[str], registry
) -> list[Violation]:
    del registry
    out: list[Violation] = []
    elif_nodes = {id(n.orelse[0]) for n in ast.walk(tree)
                  if isinstance(n, ast.If) and len(n.orelse) == 1
                  and isinstance(n.orelse[0], ast.If)}
    for node in ast.walk(tree):
        if not isinstance(node, ast.If) or id(node) in elif_nodes:
            continue
        covered: set[str] = set()
        cur = node
        while True:
            covered |= _isinstance_targets(cur.test)
            if len(cur.orelse) == 1 and isinstance(cur.orelse[0], ast.If):
                cur = cur.orelse[0]
                continue
            has_else = bool(cur.orelse)
            break
        if len(covered & ACTION_NAMES) < 2:
            continue                     # not an Action-union dispatcher
        missing = ACTION_NAMES - covered
        if missing and not has_else and not _suppressed(lines, node.lineno,
                                                        "action-exhaustive"):
            out.append(Violation(
                path, node.lineno, "KV003",
                f"Action dispatch does not handle {sorted(missing)} and has no `else` — "
                f"a new or unrouted action would be silently dropped"))
    return out


# --------------------------------------------------------------------------
# KV004 pin-paired
# --------------------------------------------------------------------------
def _call_attr_names(scope) -> dict[str, int]:
    """attr-call name -> first line, over a class body or statement list."""
    found: dict[str, int] = {}
    for root in scope if isinstance(scope, list) else [scope]:
        for node in ast.walk(root):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
                found.setdefault(node.func.attr, node.lineno)
    return found


def check_pin_paired(path: str, tree: ast.Module, lines: list[str], registry) -> list[Violation]:
    del registry
    out: list[Violation] = []
    scopes: list[tuple[str, object]] = [
        ("module scope", [n for n in tree.body if not isinstance(n, ast.ClassDef)])]
    scopes += [(f"class {n.name}", n) for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]
    for label, scope in scopes:
        calls = _call_attr_names(scope)
        pins = {c: ln for c, ln in calls.items() if c in _PIN_CALLS}
        if pins and not set(calls) & _UNPIN_CALLS:
            name, line = min(pins.items(), key=lambda kv: kv[1])
            if _suppressed(lines, line, "pin-paired"):
                continue
            out.append(Violation(
                path, line, "KV004",
                f"`{name}()` called in {label} with no matching unpin()/release_program()/"
                f"release_nodes() anywhere in the scope — leaked refcounts wedge eviction"))
    return out


# --------------------------------------------------------------------------
# KV005 wall-clock
# --------------------------------------------------------------------------
def _virtual_clock_module(path: str) -> bool:
    p = path.replace(os.sep, "/")
    return "repro_torch/core/" in p or "repro_torch/sim/" in p


def check_wall_clock(path: str, tree: ast.Module, lines: list[str], registry) -> list[Violation]:
    del registry
    if not _virtual_clock_module(path):
        return []
    out: list[Violation] = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        attr = node.func.attr
        base = _dotted(node.func.value) or ""
        base_tail = base.rsplit(".", 1)[-1].lstrip("_")
        bad = ((attr in _WALLCLOCK_TIME_ATTRS and base_tail == "time")
               or (attr in _WALLCLOCK_DT_ATTRS and base_tail in ("datetime", "date")))
        if bad and not _suppressed(lines, node.lineno, "wall-clock"):
            out.append(Violation(
                path, node.lineno, "KV005",
                f"`{base}.{attr}()` in a virtual-clock module — scheduler and simulator "
                f"time must come from the replay clock, never the host's wall clock"))
    return out


# --------------------------------------------------------------------------
# KV006 capture-shape-branch, KV009 capture-host-sync
# --------------------------------------------------------------------------
def _captured_bodies(tree: ast.Module) -> list[tuple[ast.AST, int]]:
    """Every function body a ``.capture(key, step)`` call in the module
    runs, with the capture's line: ``step`` itself (a lambda or a local
    function), the local functions a lambda calls, and what a local
    function called to make ``step`` returns."""
    defs = {fn.name: fn for fn in _functions(tree)}

    def local(node):
        d = _dotted(node)
        return defs.get(d.rsplit(".", 1)[-1]) if d else None

    def resolve(expr, depth: int) -> list:
        if depth > 2:
            return []
        if isinstance(expr, ast.Lambda):
            found = [expr.body]
            for c in ast.walk(expr.body):
                if isinstance(c, ast.Call) and local(c.func) is not None:
                    found.append(local(c.func))
            return found
        if isinstance(expr, ast.Call) and local(expr.func) is not None:
            return [b for r in ast.walk(local(expr.func))
                    if isinstance(r, ast.Return) and r.value is not None
                    for b in resolve(r.value, depth + 1)]
        if isinstance(expr, ast.IfExp):
            return resolve(expr.body, depth) + resolve(expr.orelse, depth)
        fn = local(expr)
        return [fn] if fn is not None else []

    out: list[tuple[ast.AST, int]] = []
    for call in ast.walk(tree):
        if (isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)
                and call.func.attr == "capture" and len(call.args) >= 2):
            out += [(body, call.lineno) for body in resolve(call.args[1], 0)]
    return out


def _shape_dependent(test) -> bool:
    for node in ast.walk(test):
        if isinstance(node, ast.Attribute) and node.attr in ("shape", "ndim"):
            return True
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id == "len":
            return True
    return False


def check_capture_shape_branch(path: str, tree: ast.Module, lines: list[str],
                               registry) -> list[Violation]:
    del registry
    out: list[Violation] = []
    for body, line in _captured_bodies(tree):
        for node in ast.walk(body):
            if (isinstance(node, (ast.If, ast.While, ast.IfExp)) and _shape_dependent(node.test)
                    and not _suppressed(lines, node.lineno, "capture-shape-branch")):
                out.append(Violation(
                    path, node.lineno, "KV006",
                    f"shape-dependent Python branch in a step captured on line {line}: the "
                    f"graph freezes one branch; bucket the shapes and mark the line "
                    f"`# lint: capture-shape-branch-ok` if deliberate"))
    return out


def check_capture_host_sync(path: str, tree: ast.Module, lines: list[str],
                            registry) -> list[Violation]:
    del registry
    out: list[Violation] = []
    for body, line in _captured_bodies(tree):
        for node in ast.walk(body):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
                continue
            d = _dotted(node.func) or ""
            if node.func.attr in _HOST_SYNC_ATTRS and not _suppressed(
                    lines, node.lineno, "capture-host-sync"):
                out.append(Violation(
                    path, node.lineno, "KV009",
                    f"`{d or node.func.attr}()` in a step captured on line {line}: a graph "
                    f"cannot wait on the host; keep the value on the device"))
    return out


# --------------------------------------------------------------------------
# KV010 import-time-build
# --------------------------------------------------------------------------
def _kernel_module(path: str) -> bool:
    return "repro_torch/kernels/" in path.replace(os.sep, "/")


def _import_time_nodes(body: list) -> list:
    """Statements a module runs when imported: its body and the bodies of
    its classes, ifs, trys and withs, never a function's."""
    out: list = []
    for stmt in body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out += stmt.decorator_list
            continue
        out.append(stmt)
        for attr in ("body", "orelse", "finalbody"):
            out += _import_time_nodes(getattr(stmt, attr, []) or [])
        for h in getattr(stmt, "handlers", []) or []:
            out += _import_time_nodes(h.body)
    return out


def check_import_time_build(path: str, tree: ast.Module, lines: list[str],
                            registry) -> list[Violation]:
    del registry
    if not _kernel_module(path):
        return []
    out: list[Violation] = []

    def flag(node, what):
        if not _suppressed(lines, node.lineno, "import-build"):
            out.append(Violation(
                path, node.lineno, "KV010",
                f"{what} when the module is imported: kernels are built at their first "
                f"launch, and every module imports on the CPU"))

    for stmt in _import_time_nodes(tree.body):
        if isinstance(stmt, ast.Import) and any(a.name.split(".")[0] == "triton"
                                                for a in stmt.names):
            flag(stmt, "`import triton`")
        elif isinstance(stmt, ast.ImportFrom) and (stmt.module or "").split(".")[0] == "triton":
            flag(stmt, "`from triton import ...`")
        if isinstance(stmt, (ast.Import, ast.ImportFrom, ast.ClassDef)):
            continue
        nodes = [stmt] if not isinstance(stmt, ast.stmt) else [
            c for c in ast.iter_child_nodes(stmt) if not isinstance(c, ast.stmt)]
        for node in (n for root in nodes for n in _walk_eager(root)):
            if isinstance(node, ast.Call):
                d = _dotted(node.func) or ""
                if d.rsplit(".", 1)[-1] in _BUILD_CALLS or d.startswith("subprocess."):
                    flag(node, f"`{d}()` builds or loads a kernel")
    return out


def _walk_eager(node):
    """``ast.walk`` that does not enter a lambda's body (not run at import)."""
    yield node
    if not isinstance(node, ast.Lambda):
        for child in ast.iter_child_nodes(node):
            yield from _walk_eager(child)


# --------------------------------------------------------------------------
# KV011 ref-fallback
# --------------------------------------------------------------------------
def check_ref_fallback(path: str, tree: ast.Module, lines: list[str],
                       registry) -> list[Violation]:
    del registry
    out: list[Violation] = []
    for handler in ast.walk(tree):
        if not isinstance(handler, ast.ExceptHandler):
            continue
        for stmt in handler.body:
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Call):
                    continue
                name = (_dotted(node.func) or "").rsplit(".", 1)[-1]
                if name.endswith(("_ref", "_reference")) and not _suppressed(
                        lines, node.lineno, "ref-fallback"):
                    out.append(Violation(
                        path, node.lineno, "KV011",
                        f"`{name}()` called in an `except` handler: a fallback to the plain "
                        f"version; a wrapper chooses by device and raises on a failure"))
    return out


# --------------------------------------------------------------------------
# KV008 format-aware-sizing
# --------------------------------------------------------------------------
#: device-format size attributes — pricing a host/offload/wire quantity with
#: one of these bills an int8 copy at bf16 size
_KV008_DEVICE_ATTRS = frozenset({"page_bytes", "kv_bytes", "kv_bytes_per_token"})
#: identifier fragments that mark a statement as pricing an offload-side
#: quantity (host tier budgets, wire transfers, NVMe reloads)
_KV008_OFFLOAD_HINTS = (
    "host", "cpu", "ssd", "wire", "offload", "reload", "nvme", "dram",
)
_KV008_GEOMETRY = frozenset({"num_layers", "num_kv_heads", "num_heads", "head_dim"})


def _kv008_exempt(path: str) -> bool:
    """The sizing helpers themselves are the one sanctioned place for raw
    bytes-per-element arithmetic."""
    return path.replace(os.sep, "/").endswith("repro_torch/kernels/kv_quant.py")


def _own_exprs(stmt: ast.stmt) -> list[ast.AST]:
    """A statement's direct expression children, so each expression is
    examined once, in the statement that spells it."""
    return [c for c in ast.iter_child_nodes(stmt) if not isinstance(c, ast.stmt)]


def _idents(nodes: list[ast.AST]) -> set[str]:
    idents: set[str] = set()
    for root in nodes:
        for node in ast.walk(root):
            if isinstance(node, ast.Name):
                idents.add(node.id.lower())
            elif isinstance(node, ast.Attribute):
                idents.add(node.attr.lower())
    return idents


def _topmost_mults(exprs: list[ast.AST]) -> list[ast.BinOp]:
    """Multiplication subtrees, outermost chain only."""
    mults = [n for root in exprs for n in ast.walk(root)
             if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Mult)]
    inner = {id(side) for m in mults for side in (m.left, m.right)
             if isinstance(side, ast.BinOp) and isinstance(side.op, ast.Mult)}
    return [m for m in mults if id(m) not in inner]


def check_format_aware_sizing(path: str, tree: ast.Module, lines: list[str],
                              registry) -> list[Violation]:
    del registry
    if _kv008_exempt(path):
        return []
    out: list[Violation] = []
    for stmt in ast.walk(tree):
        if not isinstance(stmt, ast.stmt):
            continue
        exprs = _own_exprs(stmt)
        mults = _topmost_mults(exprs)
        if not mults:
            continue
        ctx = _idents(exprs)
        hinted = any(any(h in ident for ident in ctx) for h in _KV008_OFFLOAD_HINTS)
        byteish = any("bytes" in ident for ident in ctx)
        for m in mults:
            sub_attrs = {n.attr for n in ast.walk(m) if isinstance(n, ast.Attribute)}
            sub_names = sub_attrs | {n.id for n in ast.walk(m) if isinstance(n, ast.Name)}
            has_two = any(isinstance(n, ast.Constant) and n.value == 2 for n in ast.walk(m))
            if _suppressed(lines, m.lineno, "kv008"):
                continue
            dev = sub_attrs & _KV008_DEVICE_ATTRS
            if dev and hinted:
                out.append(Violation(
                    path, m.lineno, "KV008",
                    f"host/offload/wire quantity priced with device-format "
                    f"`{sorted(dev)[0]}` — with an int8 offload format this bills the wrong "
                    f"byte count; use host_page_bytes / host_kv_bytes / kv_quant wire "
                    f"helpers (or mark `# lint: kv008-ok` if device-side math is intended)"))
            elif has_two and ((byteish and sub_names & _KV008_GEOMETRY)
                              or len(sub_names & _KV008_GEOMETRY) >= 2):
                out.append(Violation(
                    path, m.lineno, "KV008",
                    "byte sizing multiplies model geometry by literal 2 — a bf16 "
                    "bytes-per-element assumption that breaks under int8 tiers; use "
                    "kv_quant.bytes_per_element / token_wire_bytes (or mark "
                    "`# lint: kv008-ok`)"))
    return out


# --------------------------------------------------------------------------
# running the lint
# --------------------------------------------------------------------------
RULES = (
    check_replay_reuse,
    check_lru_cache_hashable,
    check_action_exhaustive,
    check_pin_paired,
    check_wall_clock,
    check_capture_shape_branch,
    check_format_aware_sizing,
    check_capture_host_sync,
    check_import_time_build,
    check_ref_fallback,
)


def _gather(paths) -> list[str]:
    files: list[str] = []
    for path in paths:
        if os.path.isfile(path) and path.endswith(".py"):
            files.append(path)
            continue
        for root, dirs, names in os.walk(path):
            dirs[:] = [d for d in dirs if not d.startswith(".") and d != "__pycache__"]
            files.extend(os.path.join(root, n) for n in names if n.endswith(".py"))
    return sorted(files)


def default_paths(root: str = _ROOT) -> list[str]:
    """The port's sources, its tests and ``chip_smoke.py`` under ``root``."""
    return [p for pattern in _DEFAULT_PATHS
            for p in sorted(glob.glob(os.path.join(root, pattern)))]


def run(paths) -> list[Violation]:
    """Lint ``paths`` (files or directories); returns all violations."""
    registry: dict[str, bool] = {}
    parsed: list[tuple[str, ast.Module, list[str]]] = []
    out: list[Violation] = []
    for f in _gather(paths):
        try:
            with open(f, encoding="utf-8") as fh:
                src = fh.read()
            tree = ast.parse(src, filename=f)
        except SyntaxError as e:
            out.append(Violation(f, e.lineno or 0, "KV000", f"syntax error: {e.msg}"))
            continue
        parsed.append((f, tree, src.splitlines()))
        _index_dataclasses(tree, registry)
    for f, tree, lines in parsed:
        for rule in RULES:
            out.extend(rule(f, tree, lines, registry))
    out.sort(key=lambda v: (v.path, v.line, v.rule))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="the port's AST lint (KV001-KV011)",
    )
    ap.add_argument("paths", nargs="*", help="files or directories to lint")
    args = ap.parse_args(argv)
    paths = args.paths or default_paths()
    if not paths:
        print("lint: no paths to check", file=sys.stderr)
        return 2
    violations = run(paths)
    for v in violations:
        print(v)
    n_files = len(_gather(paths))
    if violations:
        print(f"\n{len(violations)} violation(s) in {n_files} file(s)")
        return 1
    print(f"clean: {n_files} file(s), {len(RULES)} rules")
    return 0


if __name__ == "__main__":
    sys.exit(main())
