"""Import hygiene of the PyTorch port: ``repro_torch`` and every one of its
modules load without JAX and without any module of the JAX package, and
no source file under ``src/repro_torch`` imports either."""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_every_port_module_imports_without_jax_or_repro():
    mods = _port_modules()
    assert "repro_torch.launch.serve" in mods
    assert "repro_torch.serving.router" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(json.dumps(bad))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
        cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO / "src")},
    )
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_no_port_source_imports_jax_or_repro():
    pattern = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b|from\s+repro\b|"
        r"from\s+repro\.|import\s+repro\.)",
        re.MULTILINE,
    )
    offenders = [
        str(path.relative_to(REPO))
        for path in PORT.rglob("*.py")
        if pattern.search(path.read_text())
    ]
    assert offenders == []
