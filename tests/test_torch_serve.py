"""Smoke test of the port's serving launcher on the CPU at reduced size:
``python -m repro_torch.launch.serve --device cpu --reduced --programs 2``
in a subprocess, under a time limit."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def test_serve_launcher_runs_on_cpu_reduced():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--reduced", "--programs", "2"],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        # one intra-op thread: test workers share the CPU
        env={**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1"},
    )
    assert res.returncode == 0, res.stderr
    assert "serving 2 programs of qwen1.5-0.5b (4 layers, d_model 256)" in res.stdout
    steps = int(res.stdout.split("steps ")[1].split()[0])
    assert steps > 0
