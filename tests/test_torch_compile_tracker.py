"""The port's compile plane: warmup completeness, the zero-post-warmup-
capture budget through the real pump, and the tracker's own bookkeeping,
as ``tests/test_jitaudit.py``'s ``TestWarmupSpecs``, ``TestCompileBudget``
and ``TestTrackerUnit`` check them on the reference.

On the CPU a graph cache holds no graph and runs its steps eagerly, with
the same bucket bookkeeping, so every budget here is the one the card
enforces. No JAX: the reference's half of these checks is its own test.
"""
from __future__ import annotations

import gc

import numpy as np
import pytest
import torch

from repro_torch.analysis import compile_tracker
from repro_torch.configs import get_config
from repro_torch.core.types import ProgramTrace, RequestRecord
from repro_torch.models import Model, materialize
from repro_torch.serving import Engine, MoriRouter
from repro_torch.serving.graphs import StepGraphs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU: one intra-op thread per process keeps
    torch from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfg():
    return get_config("qwen1.5-0.5b").reduced()


@pytest.fixture(scope="module")
def params(cfg):
    return materialize(Model(cfg).describe(), seed=0)


def make_engine(cfg, params, **kw):
    """The knobs of tests/test_jitaudit.py's make_engine."""
    kw.setdefault("page_tokens", 16)
    kw.setdefault("n_device_pages", 96)
    kw.setdefault("n_host_pages", 64)
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_seq", 128)
    return Engine(cfg, params, device="cpu", **kw)


@pytest.fixture
def tracker(monkeypatch):
    """Armed, clean tracker; reset on the way out so the process-global
    singleton never leaks registrations into other tests."""
    monkeypatch.setenv(compile_tracker.ENV_VAR, "1")
    t = compile_tracker.get_tracker()
    t.reset()
    yield t
    t.reset()
    t.disarm()


# --------------------------------------------------------------- warmup specs
class TestWarmupSpecs:
    def test_paged_specs_cover_every_bucket(self, cfg, params):
        eng = make_engine(cfg, params)
        specs = eng.warmup_specs(prefill_chunks=True)
        n_buckets = -(-eng.pages_per_slot // eng._table_bucket)
        decode = [s for s in specs if s.kind == "paged_decode"]
        chunk = [s for s in specs if s.kind == "chunk_prefill"]
        assert len(decode) == n_buckets
        assert [s.bucket["table_pages"] for s in decode] == [
            i * eng._table_bucket for i in range(1, n_buckets + 1)
        ]
        cap = max(eng.page_tokens,
                  (eng.prefill_chunk_tokens // eng.page_tokens) * eng.page_tokens)
        cap_pad = -(-cap // eng.prefill_bucket) * eng.prefill_bucket
        n_chunk_buckets = cap_pad // eng.prefill_bucket
        assert len(chunk) == (n_buckets + 1) * n_chunk_buckets
        assert len({s.name for s in specs}) == len(specs)

    def test_prefill_chunks_off_omits_chunk_specs(self, cfg, params):
        eng = make_engine(cfg, params)
        kinds = {s.kind for s in eng.warmup_specs(prefill_chunks=False)}
        assert kinds == {"paged_decode"}

    def test_decode_spec_inputs_stay_on_scratch_pages(self, cfg, params):
        eng = make_engine(cfg, params)
        B, scratch = eng.max_slots, eng._scratch_pages
        for spec in eng.warmup_specs():
            p_pad = spec.bucket["table_pages"]
            packed = spec.make_args()
            assert packed.dtype == np.int32 and packed.shape == (B * (4 + p_pad),)
            toks, lens, tails, offs = packed[: 4 * B].reshape(4, B)
            assert toks.tolist() == [0] * B and lens.tolist() == [1] * B
            assert tails.tolist() == scratch and offs.tolist() == [0] * B
            assert (packed[4 * B:].reshape(B, p_pad) == np.asarray(scratch)[:, None]).all()

    def test_warmup_captures_exactly_the_decode_specs(self, cfg, params):
        """Warmup captures one entry per decode bucket and, with
        ``prefill_chunks``, one per chunk bucket in the second cache,
        replaying each once; both caches are budgeted."""
        eng = make_engine(cfg, params)
        specs = eng.warmup_specs(prefill_chunks=True)
        decode = [s.bucket["table_pages"] for s in specs if s.kind == "paged_decode"]
        chunk = [(s.bucket["prefix_pages"], s.bucket["chunk_tokens"])
                 for s in specs if s.kind == "chunk_prefill"]
        assert len(chunk) == 6
        assert set(eng.graph_functions().values()) == {eng.graphs, eng.chunk_graphs}
        eng.warmup(prefill_chunks=True)
        assert eng.graphs.cache_size() == len(decode)
        assert eng.graphs.keys() == decode
        assert eng.graphs.replays == len(decode)
        assert eng.chunk_graphs.keys() == chunk
        assert eng.chunk_graphs.replays == len(chunk)
        # idempotence: a second warmup replays every bucket, captures none
        eng.warmup(prefill_chunks=True)
        assert eng.graphs.cache_size() == len(decode)
        assert eng.graphs.replays == 2 * len(decode)
        assert eng.chunk_graphs.cache_size() == len(chunk)
        assert eng.chunk_graphs.replays == 2 * len(chunk)

    def test_warmup_refuses_a_busy_engine(self, cfg, params):
        eng = make_engine(cfg, params)
        from repro_torch.serving import EngineRequest

        eng.submit(EngineRequest("p", list(range(2, 22)), max_new_tokens=3))
        with pytest.raises(RuntimeError, match="idle engine"):
            eng.warmup()


# ------------------------------------------------------------ compile budget
class TestCompileBudget:
    def _replay(self, cfg, engine):
        router = MoriRouter(
            [engine], scheduler="mori",
            gpu_capacity_bytes=engine.radix_device_pages * engine.pool.page_bytes,
            chunked_prefill=True,
        )
        corpus = [
            ProgramTrace(f"p{p}", [
                RequestRecord(input_tokens=20 + 11 * p + 5 * s, output_tokens=3,
                              tool_duration_s=0.0 if s == 1 else 4.0,
                              reasoning_wall_s=0.0)
                for s in range(2)
            ])
            for p in range(3)
        ]
        m = router.replay(corpus, vocab_size=cfg.vocab_size, max_new_tokens=3)
        return router, m

    def test_pump_replay_captures_nothing_after_warmup(self, cfg, params, tracker):
        eng = make_engine(cfg, params)        # registers (env armed)
        assert set(eng.graph_functions()) <= set(tracker.registered())
        eng.warmup(prefill_chunks=True)       # marks the warm baseline
        assert tracker.marked()
        replays, chunk_replays = eng.graphs.replays, eng.chunk_graphs.replays
        _, m = self._replay(cfg, eng)         # raises via the router hook
        assert tracker.post_warmup_compiles() == {}
        # every decode step and every prefill chunk replayed one graph
        assert m.steps_completed == 6
        assert eng.graphs.replays - replays == eng.steps > 0
        assert eng.chunk_graphs.replays - chunk_replays == m.prefill_chunks > 0

    def test_post_warmup_capture_detected_and_replay_fails(self, cfg, params, tracker):
        eng = make_engine(cfg, params)
        eng.warmup(prefill_chunks=True)
        # seed a bucket escape: a table width warmup never captured
        rogue = 3 * eng._table_bucket + eng.pages_per_slot  # off-bucket
        eng._decode(rogue, eng._scratch_decode_inputs(rogue))
        grew = tracker.post_warmup_compiles()
        assert any("paged_decode" in name for name in grew)
        router = MoriRouter(
            [eng], scheduler="mori",
            gpu_capacity_bytes=eng.radix_device_pages * eng.pool.page_bytes,
        )
        with pytest.raises(RuntimeError, match="compile budget violated"):
            router._jitaudit_end_of_replay()

    def test_adopt_copies_in_place_and_keeps_the_graphs(self, cfg, params, tracker):
        eng = make_engine(cfg, params)
        eng.warmup()
        buckets = eng.graphs.keys()
        pool = eng.pool
        k, v = pool.k, pool.v
        gen = torch.Generator().manual_seed(3)
        new = [torch.randn(t.shape, generator=gen).to(t.dtype) for t in (k, v)]
        pool.adopt(*new)
        # the pool's tensors keep their addresses and hold the adopted bytes
        assert pool.k is k and pool.v is v
        assert torch.equal(k, new[0]) and torch.equal(v, new[1])
        packed = eng._scratch_decode_inputs(4)
        want = eng.decode_packed(torch.from_numpy(packed), 4, [t.clone() for t in new])
        logits, tokens = eng._decode(4, packed)
        assert torch.equal(logits, want[0]) and torch.equal(tokens, want[1])
        assert eng.graphs.keys() == buckets and tracker.post_warmup_compiles() == {}

    def test_captures_are_tagged_with_the_phase_they_ran_in(self, cfg, params, tracker):
        eng = make_engine(cfg, params)
        eng.warmup()
        name = eng.graphs.name
        assert [e.event for e in tracker.events_in("warmup")] == [
            f"{name}[{p}]" for p in eng.graphs.keys()]
        # a bucket first met inside a replay is logged under ``replay``
        router = MoriRouter(
            [eng], scheduler="mori",
            gpu_capacity_bytes=eng.radix_device_pages * eng.pool.page_bytes,
        )
        rogue = 3 * eng._table_bucket + eng.pages_per_slot
        router._jitaudit_end_of_replay = lambda: eng._decode(
            rogue, eng._scratch_decode_inputs(rogue))
        router.replay([], vocab_size=cfg.vocab_size)
        assert [e.event for e in tracker.events_in("replay")] == [f"{name}[{rogue}]"]
        with pytest.raises(RuntimeError, match=r"captures by phase: \{'replay': 1, 'warmup': "):
            MoriRouter._jitaudit_end_of_replay(router)

    def test_tracker_unarmed_is_inert(self, cfg, params, monkeypatch):
        monkeypatch.delenv(compile_tracker.ENV_VAR, raising=False)
        t = compile_tracker.get_tracker()
        assert not compile_tracker.enabled()
        eng = make_engine(cfg, params)
        mine = list(eng.graph_functions())
        assert mine and not any(n in t.registered() for n in mine)
        MoriRouter([eng], scheduler="mori")._jitaudit_end_of_replay()


# ------------------------------------------------------------- tracker unit
def _entry(graphs: StepGraphs, key) -> None:
    graphs.capture(key, lambda: torch.zeros(key) * 2)


class TestTrackerUnit:
    def test_register_mark_and_growth(self, tracker):
        g = StepGraphs("unit.f", "cpu")
        tracker.register("unit.f", g)
        _entry(g, 4)
        tracker.mark_warm(("unit.f",))
        assert tracker.post_warmup_compiles() == {}
        _entry(g, 8)                         # new bucket -> new capture
        assert tracker.post_warmup_compiles() == {"unit.f": (1, 2)}

    def test_same_object_reregistration_keeps_baseline(self, tracker):
        g = StepGraphs("unit.shared", "cpu")
        tracker.register("unit.shared", g)
        _entry(g, 4)
        tracker.mark_warm(("unit.shared",))
        tracker.register("unit.shared", g)   # same object: no-op
        assert tracker.post_warmup_compiles() == {}

    def test_phase_tagged_captures(self, tracker):
        g = StepGraphs("unit.phase", "cpu")
        with tracker.phase("unit-test-phase"):
            _entry(g, 7)
        assert [e.event for e in tracker.events_in("unit-test-phase")] == ["unit.phase[7]"]

    def test_dead_cache_leaves_the_budget(self, tracker):
        g = StepGraphs("unit.dead", "cpu")
        tracker.register("unit.dead", g)
        _entry(g, 4)
        tracker.mark_warm()
        _entry(g, 8)
        assert tracker.post_warmup_compiles() == {"unit.dead": (1, 2)}
        del g
        gc.collect()
        assert tracker.registered() == () and not tracker.marked()
        assert tracker.post_warmup_compiles() == {}


class TestStepGraphs:
    def test_cpu_entries_run_eagerly_and_count_replays(self):
        g = StepGraphs("unit.cpu", "cpu")
        calls = []
        g.capture("k", lambda: calls.append(1) or torch.ones(2))
        assert calls == [] and "k" in g and g.cache_size() == 1
        assert torch.equal(g.replay("k"), torch.ones(2))
        g.replay("k")
        assert calls == [1, 1] and g.replays == 2
        with pytest.raises(KeyError, match="already captured"):
            g.capture("k", lambda: None)

    def test_each_key_replays_its_own_step(self):
        g = StepGraphs("unit.keys", "cpu")
        for key in (4, 8):
            _entry(g, key)
        assert g.keys() == [4, 8] and g.cache_size() == 2
        for key in (4, 4, 8):
            assert torch.equal(g.replay(key), torch.zeros(key))
        assert g.replays == 3 and g.cache_size() == 2

    def test_a_missing_key_raises_rather_than_running_anything(self):
        g = StepGraphs("unit.missing", "cpu")
        _entry(g, 4)
        with pytest.raises(KeyError):
            g.replay(8)
        assert g.keys() == [4]
