"""The port's randomized replay fuzzer (``repro_torch.analysis.fuzz``).

A few seeded rounds on the CPU replay clean under the page-lifetime
sanitizer, with and without the capture-budget audit, and draw the
reference's knobs and corpora from the same seed. A seeded violation (an
engine that frees a live scratch page) is caught, shrunk to a smaller
corpus that still fails the same way, and written as a replayable JSON
artifact, as ``tests/test_kvsan.py``'s fuzz-harness test checks for the
reference.
"""
from __future__ import annotations

import dataclasses
import json
import random

import pytest
import torch

from repro.analysis import fuzz as jax_fuzz
from repro_torch.analysis import compile_tracker, fuzz, kvsan
from repro_torch.serving import Engine


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    """``fuzz`` arms its switches in ``os.environ``; put them back after."""
    monkeypatch.setenv(kvsan.ENV_VAR, "1")
    monkeypatch.setenv(compile_tracker.ENV_VAR, "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", range(3))
def test_knobs_and_corpora_are_the_references(seed):
    for r in range(4):
        rng, jrng = random.Random((seed << 16) ^ r), random.Random((seed << 16) ^ r)
        assert fuzz._make_knobs(rng) == jax_fuzz._make_knobs(jrng)
        corpus, jcorpus = fuzz._make_corpus(rng, r), jax_fuzz._make_corpus(jrng, r)
        assert [(t.program_id, [dataclasses.asdict(s) for s in t.steps]) for t in corpus] == [
            (t.program_id, [dataclasses.asdict(s) for s in t.steps]) for t in jcorpus]


@pytest.mark.parametrize("audit", [False, True], ids=["kvsan", "kvsan+compile-audit"])
def test_seeded_rounds_are_clean(audit, tmp_path):
    lines = []
    failures = fuzz.fuzz(3, seed=0, out_dir=str(tmp_path), compile_audit=audit,
                         device="cpu", log=lines.append)
    assert failures == [], failures
    assert len(lines) == 3 and all(": ok (" in line for line in lines)
    assert not list(tmp_path.iterdir())


def test_a_seeded_violation_is_caught_shrunk_and_dumped(tmp_path, monkeypatch):
    """Every finished request frees its engine's first scratch page, which
    a decode step's block table still names: the sanitizer raises, the
    round shrinks to one program, and the artifact replays the failure."""
    finish = Engine._finish

    def leaky_finish(self, slot):
        out = finish(self, slot)
        self.pool.free_device(self._scratch_pages[0])
        return out

    monkeypatch.setattr(Engine, "_finish", leaky_finish)
    lines = []
    failures = fuzz.fuzz(1, seed=0, out_dir=str(tmp_path), device="cpu", log=lines.append)
    assert len(failures) == 1
    rep = failures[0]
    assert rep.error_type == "KvsanError"
    assert rep.shrink_attempts > 0
    assert len(rep.corpus) == 1                      # shrank to one program
    assert rep.kvsan_trace and rep.actions
    (path,) = tmp_path.iterdir()
    loaded = json.loads(path.read_text())
    assert loaded["error_type"] == "KvsanError" and loaded["corpus"] == rep.corpus
    # the artifact alone replays the failure
    from repro_torch.configs import get_config
    from repro_torch.core.types import ProgramTrace, RequestRecord
    from repro_torch.models import Model, materialize

    corpus = [ProgramTrace(c["program_id"], [RequestRecord(**s) for s in c["steps"]])
              for c in loaded["corpus"]]
    cfg = get_config("qwen1.5-0.5b").reduced()
    params = materialize(Model(cfg).describe(), seed=0)
    err = fuzz._run_once(loaded["knobs"], corpus, cfg, params, device="cpu")
    assert type(err).__name__ == "KvsanError"
