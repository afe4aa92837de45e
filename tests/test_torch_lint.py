"""The port's lint (``python -m repro_torch.analysis.lint``).

* The kept rules (KV002-KV005, KV008) on the reference's seeded snippets,
  copied from ``tests/test_lint.py``: the same hits from
  ``repro.analysis.lint.run`` and from the port's ``run``.
* Each rule of the graph plane (KV001 replay-reuse, KV006
  capture-shape-branch) and each new rule (KV009 capture-host-sync, KV010
  import-time-build, KV011 ref-fallback) fires on a seeded snippet and is
  silenced by its marker.
* The port lints clean over its default paths; the CLI's exit codes; the
  lint imports no runtime code.
"""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

from repro_torch.analysis import lint

REPO = Path(__file__).resolve().parent.parent
KEPT = {"KV002", "KV003", "KV004", "KV005", "KV008"}


def run_lint(tmp_path, source: str, name: str = "mod.py"):
    f = tmp_path / name
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(source)
    return lint.run([str(f)])


def rules_hit(violations):
    return {v.rule for v in violations}


# --------------------------------------------------------------------------
# the reference's seeded snippets (tests/test_lint.py), for the kept rules
# --------------------------------------------------------------------------
SNIPPETS = {
    "lru_bad": """
import functools

@functools.lru_cache(maxsize=None)
def build(cfg: dict, n: int):
    return n
""",
    "lru_good": """
import functools

@functools.lru_cache(maxsize=None)
def build(cfg: "FrozenCfg", n: int):
    return n
""",
    "lru_unfrozen_dataclass": """
import functools
from dataclasses import dataclass

@dataclass
class Cfg:
    n: int = 0

@functools.lru_cache(maxsize=None)
def build(cfg: Cfg):
    return cfg.n
""",
    "lru_frozen_dataclass": """
import functools
from dataclasses import dataclass

@dataclass(frozen=True)
class Cfg:
    n: int = 0

@functools.lru_cache(maxsize=None)
def build(cfg: Cfg):
    return cfg.n
""",
    "action_bad": """
def apply(plan):
    for act in plan:
        if isinstance(act, Forward):
            pass
        elif isinstance(act, Offload):
            pass
        elif isinstance(act, Discard):
            pass
""",
    "action_else": """
def apply(plan):
    for act in plan:
        if isinstance(act, Forward):
            pass
        elif isinstance(act, Offload):
            pass
        else:
            raise ValueError(act)
""",
    "action_all": """
def apply(plan):
    for act in plan:
        if isinstance(act, Forward):
            pass
        elif isinstance(act, Offload):
            pass
        elif isinstance(act, Discard):
            pass
        elif isinstance(act, SetLabel):
            pass
        elif isinstance(act, CancelTransfer):
            pass
        elif isinstance(act, Migrate):
            pass
""",
    "pin_bad": """
class Stream:
    def start(self, tree, pid):
        tree.pin(pid)

    def finish(self, tree, pid):
        pass
""",
    "pin_good": """
class Stream:
    def start(self, tree, pid):
        tree.pin(pid)

    def finish(self, tree, pid):
        tree.unpin(pid)
""",
    "clock_bad": """
import time

def tick():
    return time.monotonic()
""",
    "clock_perf_counter": """
import time as _time

def profile():
    return _time.perf_counter()
""",
    "kv008_device_attr": """
def cpu_budget(pool, n):
    cpu_capacity_bytes = n * pool.page_bytes
    return cpu_capacity_bytes
""",
    "kv008_bf16_hardcode": """
def kv_size(cfg):
    kvb = cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim * 2
    return kvb
""",
    "kv008_helper": """
def cpu_budget(pool, n):
    cpu_capacity_bytes = n * pool.host_page_bytes
    return cpu_capacity_bytes
""",
    "kv008_device_side": """
def gpu_budget(pool, n):
    gpu_capacity_bytes = n * pool.page_bytes
    return gpu_capacity_bytes
""",
    "kv008_suppressed": """
def cpu_budget(pool, n):
    cpu_capacity_bytes = n * pool.page_bytes  # lint: kv008-ok
    return cpu_capacity_bytes
""",
    "clean": "x = 1\n",
}
#: where a snippet sits, by the package each lint scopes its rules to:
#: (reference's path, port's path)
PLACES = {
    "mod": ("mod.py", "mod.py"),
    "core": ("repro/core/clock_user.py", "repro_torch/core/clock_user.py"),
    "sim": ("repro/sim/prof.py", "repro_torch/sim/prof.py"),
    "serving": ("repro/serving/clock_user.py", "repro_torch/serving/clock_user.py"),
    "kv_quant": ("repro/kernels/kv_quant.py", "repro_torch/kernels/kv_quant.py"),
}
CASES = [(name, "mod") for name in SNIPPETS] + [
    ("clock_bad", "core"), ("clock_perf_counter", "sim"), ("clock_bad", "serving"),
    ("kv008_bf16_hardcode", "kv_quant"), ("kv008_device_attr", "core"),
]


@pytest.mark.parametrize("name, place", CASES)
def test_kept_rules_match_the_reference(tmp_path, name, place):
    from repro.analysis import lint as ref_lint

    ref_rel, port_rel = PLACES[place]
    hits = {}
    for who, mod, rel in (("ref", ref_lint, ref_rel), ("port", lint, port_rel)):
        f = tmp_path / who / rel
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text(SNIPPETS[name])
        hits[who] = sorted((v.rule, v.line) for v in mod.run([str(f)]) if v.rule in KEPT)
    assert hits["port"] == hits["ref"]


def test_the_kept_cases_cover_hits_and_misses(tmp_path):
    """The parity cases are not all silent: each kept rule fires somewhere."""
    fired = set()
    for name, place in CASES:
        f = tmp_path / name / place / PLACES[place][1]
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text(SNIPPETS[name])
        fired |= rules_hit(lint.run([str(f)]))
    assert KEPT <= fired


# --------------------------------------------------------------------------
# KV001 replay-reuse
# --------------------------------------------------------------------------
class TestReplayReuse:
    BAD = """
def two_steps(graphs, a, b):
    logits, tok = graphs.replay(a)
    graphs.replay(b)
    return tok.cpu()
"""
    READ_FIRST = """
def two_steps(graphs, a, b):
    logits, tok = graphs.replay(a)
    first = tok.clone()
    graphs.replay(b)
    return first
"""
    REBOUND = """
def two_steps(graphs, a, b):
    logits, tok = graphs.replay(a)
    logits, tok = graphs.replay(b)
    return tok
"""
    OTHER_CACHE = """
def two_steps(mine, theirs, a, b):
    logits, tok = mine.replay(a)
    theirs.replay(b)
    return tok
"""
    ALIAS = """
class Engine:
    def _decode(self, key, packed):
        return self.graphs.replay(key)

    def two(self, a, b):
        _, tok = self._decode(a, None)
        self.graphs.replay(b)
        return tok
"""
    MARKED = """
def two_steps(graphs, a, b):
    logits, tok = graphs.replay(a)
    graphs.replay(b)
    return tok.cpu()  # lint: replay-reuse-ok
"""

    def test_read_after_a_later_replay(self, tmp_path):
        vs = run_lint(tmp_path, self.BAD)
        assert rules_hit(vs) == {"KV001"} and vs[0].line == 5

    @pytest.mark.parametrize("src", ["READ_FIRST", "REBOUND", "OTHER_CACHE"])
    def test_safe_uses_pass(self, tmp_path, src):
        assert "KV001" not in rules_hit(run_lint(tmp_path, getattr(self, src)))

    def test_a_method_returning_a_replay_counts(self, tmp_path):
        assert "KV001" in rules_hit(run_lint(tmp_path, self.ALIAS))

    def test_marker_suppresses(self, tmp_path):
        assert run_lint(tmp_path, self.MARKED) == []


# --------------------------------------------------------------------------
# KV006 capture-shape-branch, KV009 capture-host-sync
# --------------------------------------------------------------------------
class TestCapturedSteps:
    LAMBDA = """
def step(x):
    if x.shape[0] > 4:
        return x * 2
    return x

def capture(graphs, x):
    graphs.capture(8, lambda: step(x))
"""
    DIRECT = """
def step():
    while len(BUF) > 4:
        BUF.pop()

def capture(graphs):
    graphs.capture(8, step)
"""
    MADE = """
class Engine:
    def _step_fn(self, key, x):
        return lambda: self.decode(x)

    def decode(self, x):
        n = x.sum().item()
        return x.ndim if x.ndim > 1 else n

    def capture(self, key, x):
        self.graphs.capture(key, self._step_fn(key, x))
"""
    UNCAPTURED = """
def step(x):
    if x.shape[0] > 4:
        return x.cpu()
    return x
"""
    MARKED = """
def step(x):
    if x.shape[0] > 4:  # lint: capture-shape-branch-ok
        return x.tolist()  # lint: capture-host-sync-ok
    return x

def capture(graphs, x):
    graphs.capture(8, lambda: step(x))
"""

    def test_shape_branch_through_a_lambda(self, tmp_path):
        vs = run_lint(tmp_path, self.LAMBDA)
        assert rules_hit(vs) == {"KV006"} and vs[0].line == 3

    def test_shape_branch_in_a_function_handed_over(self, tmp_path):
        assert rules_hit(run_lint(tmp_path, self.DIRECT)) == {"KV006"}

    def test_what_a_local_function_returns(self, tmp_path):
        vs = run_lint(tmp_path, self.MADE)
        assert rules_hit(vs) == {"KV006", "KV009"}
        assert [v.line for v in vs if v.rule == "KV009"] == [7]

    def test_uncaptured_function_allowed(self, tmp_path):
        assert run_lint(tmp_path, self.UNCAPTURED) == []

    def test_markers_suppress(self, tmp_path):
        assert run_lint(tmp_path, self.MARKED) == []

    @pytest.mark.parametrize("call", ["x.item()", "x.tolist()", "x.cpu()", "x.numpy()",
                                      "torch.nonzero(x)", "x.nonzero()"])
    def test_each_host_sync(self, tmp_path, call):
        src = f"import torch\n\ndef capture(graphs, x):\n    graphs.capture(1, lambda: {call})\n"
        assert rules_hit(run_lint(tmp_path, src)) == {"KV009"}


# --------------------------------------------------------------------------
# KV010 import-time-build
# --------------------------------------------------------------------------
class TestImportTimeBuild:
    KERNEL = "repro_torch/kernels/foo/ops.py"

    @pytest.mark.parametrize("src", [
        "import triton\n",
        "from triton import language as tl\n",
        "from repro_torch.kernels.foo import _build\nLIB = _build.load()\n",
        "import ctypes\nLIB = ctypes.CDLL('libfoo.so')\n",
        "import subprocess\nsubprocess.run(['nvcc'])\n",
        "class K:\n    lib = build('foo.cu')\n",
        "try:\n    import triton\nexcept ImportError:\n    triton = None\n",
    ])
    def test_fires_at_import(self, tmp_path, src):
        assert rules_hit(run_lint(tmp_path, src, self.KERNEL)) == {"KV010"}

    @pytest.mark.parametrize("src", [
        "def launch():\n    import triton\n    return triton\n",
        "def load():\n    return _build.load()\n",
        "KERNEL = Kernel(_build.load)\n",
        "LOADER = lambda: _build.load()\n",
    ])
    def test_first_launch_allowed(self, tmp_path, src):
        assert run_lint(tmp_path, src, self.KERNEL) == []

    def test_outside_the_kernels_allowed(self, tmp_path):
        assert run_lint(tmp_path, "import triton\n", "repro_torch/serving/x.py") == []

    def test_marker_suppresses(self, tmp_path):
        src = "import triton  # lint: import-build-ok\n"
        assert run_lint(tmp_path, src, self.KERNEL) == []


# --------------------------------------------------------------------------
# KV011 ref-fallback
# --------------------------------------------------------------------------
class TestRefFallback:
    BAD = """
def attention(q, k, v):
    try:
        return KERNEL(q, k, v)
    except RuntimeError:
        return attention_ref(q, k, v)
"""
    REFERENCE = """
def scan(x):
    try:
        return KERNEL(x)
    except RuntimeError:
        return ops.ssd_reference(x)
"""
    DEVICE_CHOICE = """
def attention(q, k, v):
    if q.is_cuda:
        return KERNEL(q, k, v)
    return attention_ref(q, k, v)
"""
    MARKED = """
def attention(q, k, v):
    try:
        return KERNEL(q, k, v)
    except RuntimeError:
        return attention_ref(q, k, v)  # lint: ref-fallback-ok
"""

    @pytest.mark.parametrize("src", ["BAD", "REFERENCE"])
    def test_fallback_in_a_handler(self, tmp_path, src):
        vs = run_lint(tmp_path, getattr(self, src))
        assert rules_hit(vs) == {"KV011"} and vs[0].line == 6

    def test_choice_by_device_allowed(self, tmp_path):
        assert run_lint(tmp_path, self.DEVICE_CHOICE) == []

    def test_marker_suppresses(self, tmp_path):
        assert run_lint(tmp_path, self.MARKED) == []


# --------------------------------------------------------------------------
# running the lint
# --------------------------------------------------------------------------
class TestDriver:
    def test_the_port_lints_clean(self):
        paths = lint.default_paths(str(REPO))
        assert str(REPO / "chip_smoke.py") in paths
        assert str(REPO / "tests" / "test_torch_lint.py") in paths
        vs = lint.run(paths)
        assert vs == [], "\n".join(str(v) for v in vs)

    def test_syntax_error_reported_not_crash(self, tmp_path):
        assert rules_hit(run_lint(tmp_path, "def broken(:\n")) == {"KV000"}

    def test_cli_exit_codes(self, tmp_path, capsys):
        bad = tmp_path / "bad.py"
        bad.write_text(SNIPPETS["action_bad"])
        assert lint.main([str(bad)]) == 1
        good = tmp_path / "good.py"
        good.write_text("x = 1\n")
        assert lint.main([str(good)]) == 0
        assert "clean" in capsys.readouterr().out

    def test_the_default_run_exits_0(self, capsys):
        assert lint.main([]) == 0
        assert "clean" in capsys.readouterr().out

    def test_imports_no_runtime_code(self):
        tree = ast.parse((REPO / "src" / "repro_torch" / "analysis" / "lint.py").read_text())
        imported = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                    for a in n.names}
        imported |= {n.module.split(".")[0] for n in ast.walk(tree)
                     if isinstance(n, ast.ImportFrom) and n.module}
        assert imported <= {"__future__", "argparse", "ast", "glob", "os", "sys",
                            "dataclasses"}
