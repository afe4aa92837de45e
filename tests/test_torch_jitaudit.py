"""The port's step auditor (``repro_torch.analysis.jitaudit``) on the CPU.

* The seeded-violation selftest: a rebound buffer, a per-layer copy of
  one, a shape branch, a host sync, a baked host value and a leaf costed
  at zero bytes each fire their pass alone, and an honored in-place step
  stays clean.
* Every decode spec of a reduced-qwen paged engine and of a dense-slot
  engine is clean in all three passes and inside the documented bands;
  each probe group traces one op sequence; the chunk specs' capture
  blockers name the host data their step copies in.
* Each kernel's ``cost`` against a hand count at a small shape, and a
  leaf's plain-version ops kept out of the walk.
* Parity with the live reference: the static FLOPs of one decode bucket
  against ``repro.analysis.jitaudit.static_cost`` of the reference's
  target at the same bucket (JAX imported inside that test only).
* The CLI's exit codes; the CLI and every public entry point refuse to
  run without a card unless given the CPU; the replay gate.
* One ``cuda``-marked test: the audit of a reduced engine on the card.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro_torch.analysis import jitaudit
from repro_torch.configs import get_config
from repro_torch.kernels import roofline
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import Model, materialize
from repro_torch.serving import Engine
from repro_torch.serving.engine import SpecStep

#: the reference test's reduced geometry (tests/test_jitaudit.py)
PAGED_KW = dict(page_tokens=16, n_device_pages=96, n_host_pages=64, max_slots=2, max_seq=128)
DENSE_KW = dict(PAGED_KW, n_device_pages=8, n_host_pages=8, max_seq=64)
DECODE_TARGETS = ["paged_decode_fn[pages=4]", "paged_decode_fn[pages=8]", "decode_fn"]


@pytest.fixture(scope="module")
def qwen():
    cfg = get_config("qwen1.5-0.5b").reduced()
    return cfg, materialize(Model(cfg).describe(), seed=0)


@pytest.fixture(scope="module")
def engines(qwen):
    cfg, params = qwen
    return (Engine(cfg, params, device="cpu", **PAGED_KW),
            Engine(cfg, params, device="cpu", dense_slots=True, **DENSE_KW))


@pytest.fixture(scope="module")
def audited(engines):
    paged, dense = engines
    targets = (jitaudit.engine_targets(paged, prefill_chunks=True)
               + jitaudit.engine_targets(dense, prefill_chunks=False)
               + jitaudit.kernel_targets("cpu"))
    rows, violations = jitaudit.audit(targets)
    return targets, {r["target"].split(".", 1)[-1] if r["kind"] != "kernel" else r["target"]: r
                     for r in rows}, violations


def m(*shape, dtype=torch.bfloat16):
    """An operand of ``shape`` and ``dtype`` with no data."""
    return torch.empty(shape, dtype=dtype, device="meta")


# ------------------------------------------------------------------ selftest
class TestSelftest:
    def test_selftest_catches_every_class(self):
        assert jitaudit.selftest("cpu") == []

    @pytest.mark.parametrize("cls", ["in-place", "per-layer-copy", "honored", "shape-branch",
                                     "host-sync", "host-value", "zero-bytes-leaf"])
    def test_each_class_fires_alone(self, cls):
        target, probe_t, want = jitaudit._seeded_targets("cpu")[cls]
        trace = jitaudit.trace_target(target)
        probe = jitaudit.trace_target(probe_t) if probe_t is not None else None
        found = (jitaudit.check_in_place(target, trace)
                 + jitaudit.capture_hazards(target, trace, probe)
                 + jitaudit.check_roofline(target, jitaudit.roofline_row(target, trace)))
        assert {v.pass_name for v in found} == ({want} if want else set())
        text = " ".join(v.msg + v.provenance for v in found)
        expect = {"in-place": "rebound", "per-layer-copy": "one layer of static buffer `pool`",
                  "shape-branch": "diverges at op 0", "host-sync": "_local_scalar_dense",
                  "host-value": "lift_fresh", "zero-bytes-leaf": "bytes_vs_whole_operands"}
        if cls in expect:
            assert expect[cls] in text

    def test_a_step_that_copies_a_buffer_is_caught(self):
        pool = torch.zeros((4, 8))
        step = SpecStep(lambda: pool.clone().add_(1), lambda: {"pool": pool})
        t = jitaudit.AuditTarget("copy", lambda: step, "paged_decode")
        found = jitaudit.check_in_place(t, jitaudit.trace_target(t))
        assert found and "a copy of static buffer `pool`" in found[0].msg

    @pytest.mark.parametrize("copy, what", [
        (lambda pool, layer: pool[layer].clone(), "one layer of static buffer `k`"),
        (lambda pool, layer: pool[layer].permute(0, 2, 1, 3).contiguous(),
         "one layer of static buffer `k`"),
        (lambda pool, layer: pool[layer].float(), "one layer of static buffer `k`"),
        (lambda pool, layer: pool.reshape(-1, 16)[::1].clone(), "static buffer `k`"),
    ])
    def test_a_step_that_copies_a_pool_layer_is_caught(self, copy, what):
        """A copy of one layer of an [L, N, T, KH, D] pool, in any layout
        or dtype, repeated over the layers."""
        pool = torch.zeros((3, 6, 4, 2, 16), dtype=torch.bfloat16)
        step = SpecStep(lambda: [copy(pool, layer) for layer in range(3)], lambda: {"k": pool})
        t = jitaudit.AuditTarget("layer-copy", lambda: step, "paged_decode")
        found = jitaudit.check_in_place(t, jitaudit.trace_target(t))
        assert found and all(what in v.msg for v in found), [v.msg for v in found]

    def test_reading_a_pool_layer_in_place_is_clean(self):
        pool = torch.zeros((3, 6, 4, 2, 16), dtype=torch.bfloat16)

        def run():
            for layer in range(3):
                pool[layer, 1].add_(1)
                pool[layer].select(0, 2).mul_(2)
            return pool[0, :2].sum()

        t = jitaudit.AuditTarget("ok", lambda: SpecStep(run, lambda: {"k": pool}), "paged_decode")
        assert jitaudit.check_in_place(t, jitaudit.trace_target(t)) == []


# ------------------------------------------------------------- engine specs
class TestEngineSpecs:
    @pytest.mark.parametrize("name", DECODE_TARGETS)
    def test_decode_spec_clean_and_in_band(self, audited, name):
        _, rows, violations = audited
        row = rows[name]
        assert [str(v) for v in violations if v.target.endswith(name)] == []
        for key, (lo, hi) in jitaudit.TOLERANCES.items():
            assert lo <= row["ratios"][key] <= hi, (key, row["ratios"])
        assert row["ratios"]["flops_vs_flop_counter"] == pytest.approx(1.0, abs=1e-12)
        # the step's only leaf is the paged kernel (over the slots as pages
        # in the dense step), one call a layer
        leaf = ("leaf:layers.decode_attention" if name == "decode_fn"
                else "leaf:paged_attention.paged_attention_decode")
        assert row["static"]["leaves"] == [leaf] * 4
        assert row["static"]["flops"] > 0 and row["bound_ms"] > 0

    def test_no_violation_anywhere(self, audited):
        _, _, violations = audited
        assert [str(v) for v in violations] == []

    def test_each_probe_group_traces_one_op_sequence(self, engines):
        for engine, chunks in zip(engines, (True, False)):
            groups: dict = {}
            for t in jitaudit.engine_targets(engine, prefill_chunks=chunks):
                groups.setdefault(t.probe_group, []).append(
                    jitaudit.trace_target(t).signature())
            for group, sigs in groups.items():
                assert all(s == sigs[0] for s in sigs), group
                assert len(sigs[0]) > 100

    def test_chunk_specs_name_their_capture_blockers(self, audited):
        _, rows, _ = audited
        chunk = {k: r for k, r in rows.items() if r["kind"] == "chunk_prefill"}
        assert len(chunk) == 6
        for name, row in chunk.items():
            blockers = row["capture_blockers"]
            assert blockers, name
            assert all(b["class"] == "host-value" for b in blockers), blockers
            # the page-index lists become tensors inside the step (on the
            # card then copied to it)
            assert any(b["op"] == "aten::lift_fresh" and "serving/kvpool.py" in b["site"]
                       and "(_index)" in b["site"] for b in blockers), blockers
            if row["bucket"]["prefix_pages"]:
                # flash reads the chunk's offset and the prefix's hole on the host
                assert any(b["op"] == "leaf:flash_attention.prefill_attention"
                           and "q_offset" in b["detail"] and "kv_hole" in b["detail"]
                           and "models/layers.py" in b["site"] for b in blockers), blockers
        sites = jitaudit.blocker_sites(list(rows.values()))
        assert len(sites) == 2, sites

    def test_spec_step_runs_what_warmup_runs(self, qwen):
        cfg, params = qwen
        eng = Engine(cfg, params, device="cpu", **PAGED_KW)
        eng.warmup(prefill_chunks=True)
        assert eng.graphs.keys() == [4, 8]
        spec = eng.warmup_specs()[0]
        step = eng.spec_step(spec, eager=True)
        assert set(step.buffers()) == {"k", "v", "staged"}
        logits, tok = step.run()
        want_logits, want_tok = eng.spec_step(spec).run()
        assert torch.equal(logits, want_logits) and torch.equal(tok, want_tok)


# -------------------------------------------------------------- kernel costs
class TestKernelCosts:
    def test_paged_cost_by_hand(self):
        # B=2, H=4, KH=2, D=32, T=4, P=3, lengths 5 and 9, new token as operands
        q, pages, tables = m(2, 4, 32), m(10, 4, 2, 32), m(2, 3, dtype=torch.int32)
        c = paged_ops.cost(q, pages, tables, [5, 9], k_new=m(2, 2, 32))
        assert c["flops"] == 4 * 4 * 32 * (5 + 9)                     # q·kᵀ, p·v
        kv = 2 * (4 + 8) * 2 * 32 * 2          # k and v at the 12 positions from the pool
        io = (2 * 2 * 4 * 32 + 2 * 2 * 2 * 32) * 2   # q, out; k_new, v_new
        assert c["bytes"] == kv + io + 4 * (2 * 3 + 2)            # tables, lengths
        assert c["op_type"] == "bfloat16"
        # no new token: every visible position from the pool; no lengths: the table
        c = paged_ops.cost(q, pages, tables)
        assert c["flops"] == 4 * 4 * 32 * 2 * 12
        assert c["bytes"] == 2 * 24 * 2 * 32 * 2 + 2 * 2 * 4 * 32 * 2 + 4 * 8

    def test_flash_cost_by_hand(self):
        q, k = m(1, 8, 2, 16), m(1, 8, 1, 16)                      # [B, S, H, D], GQA 2:1
        c = flash_ops.prefill_cost(q, k, k, causal=True)
        assert c["flops"] == 4 * 2 * 16 * 36                       # 1 + 2 + ... + 8 pairs
        assert c["bytes"] == (2 * 8 * 2 * 16 + 2 * 8 * 1 * 16) * 2
        assert flash_ops.prefill_cost(q, k, k, causal=True, window=3)["flops"] == \
            4 * 2 * 16 * (1 + 2 + 3 * 6)
        # 4 queries at positions 4..7 over 8 keys, keys 1 and 2 a hole
        assert flash_ops.prefill_cost(m(1, 4, 2, 16), k, k, causal=True, q_offset=4,
                                      kv_hole=(1, 3))["flops"] == 4 * 2 * 16 * (3 + 4 + 5 + 6)
        assert flash_ops.flash_cost(q.transpose(1, 2), k.transpose(1, 2),
                                    k.transpose(1, 2))["flops"] == c["flops"]
        b = flash_ops.backward_cost(q, k, k, seq_dim=1, head_dim=2, causal=True)
        assert b["flops"] == 10 * 16 * 2 * 36
        assert b["bytes"] == (4 * 8 * 2 * 16 + 4 * 8 * 1 * 16) * 2 + 4 * 2 * 8

    def test_ssd_cost_by_hand(self):
        # B=1, S=6, H=2, P=4, N=3, chunk 4: chunks of 4 and 2 positions
        x, dt, A = m(1, 6, 2, 4), m(1, 6, 2, dtype=torch.float32), m(2, dtype=torch.float32)
        Bm = m(1, 6, 3)
        c = ssd_ops.cost(x, dt, A, Bm, Bm, chunk=4)
        first = 10 * 3 + 10 * 4 + 4 * 4 * 3              # C·Bᵀ, with x, the state update
        second = 3 * 3 + 3 * 4 + 2 * 4 * 3 + 2 * 4 * 3   # ... and C·stateᵀ
        assert c["flops"] == 2 * (first + second) * 2
        assert c["bytes"] == 2 * 6 * 2 * 4 * 2 + 6 * 2 * 4 + 2 * 4 + 2 * 6 * 3 * 2 + 2 * 4 * 3 * 4
        b = ssd_ops.backward_cost(x, dt, A, Bm, Bm, chunk=4)
        first = 10 * 17 + 48 + 2 * 48                    # triangle, state out, its gradient
        second = 3 * 17 + 24 + 24                        # triangle, dh_in share, h_inᵀ dy
        assert b["flops"] == 2 * (first + second) * 2
        assert b["bytes"] == 3 * 6 * 2 * 4 * 2 + 2 * 6 * 2 * 4 + 2 * 2 * 4 + 4 * 6 * 3 * 2

    def test_bound_is_the_larger_time(self):
        b = roofline.bound(3_350_000, 989_000_000, "bfloat16")
        assert b["bound_by"] == "bytes" and b["bound_ms"] == pytest.approx(1e-3)
        assert roofline.bound_of({"bytes": 0, "flops": 989e9, "op_type": "bfloat16"})[
            "bound_ms"] == pytest.approx(1.0)

    @pytest.mark.parametrize("mod, leaf", [
        (paged_ops, "leaf:paged_attention.paged_attention_decode"),
        (flash_ops, "leaf:flash_attention.prefill_attention"),
        (ssd_ops, "leaf:ssd.ssd"),
    ])
    def test_leaf_keeps_the_plain_version_out_of_the_walk(self, mod, leaf):
        spec = mod.audit_spec("cpu")
        [t] = [t for t in jitaudit.kernel_targets("cpu") if t.name == spec["name"]]
        trace = jitaudit.trace_target(t)
        # one op, the entry point: the plain version's products and
        # elementwise ops neither recorded nor counted by torch's counter
        assert [op.name for op in trace.ops] == [leaf]
        assert trace.flop_counter == 0
        assert trace.ops[0].cost["flops"] > 0
        # without the recorder the plain version's products are counted
        with torch.utils.flop_counter.FlopCounterMode(display=False) as plain:
            spec["fn"](*spec["make_args"]())
        assert plain.get_total_flops() > 0


# ------------------------------------------------------------------ parity
class TestReferenceParity:
    def test_decode_flops_against_the_reference(self, qwen, engines):
        """The port's products of one decode bucket equal the reference's
        static FLOPs without its attention products; the totals differ by
        attention alone: the reference's CPU oracle attends over the whole
        padded table (4·B·H·D·P·T a layer), the port's leaf over the
        visible positions (4·H·D·Σlengths; the scratch inputs' lengths are
        1)."""
        from repro.analysis import jitaudit as ref_audit
        from repro.configs import get_config as ref_config
        from repro.models import Model as RefModel
        from repro.models import materialize as ref_materialize
        from repro.serving import Engine as RefEngine

        cfg, _ = qwen
        rcfg = ref_config("qwen1.5-0.5b").reduced()
        reng = RefEngine(rcfg, ref_materialize(RefModel(rcfg).describe(), seed=0),
                         page_tokens=16, n_device_pages=96, n_host_pages=64, max_slots=2,
                         max_seq=128)
        [rt] = [t for t in ref_audit.engine_targets(reng, prefill_chunks=False)
                if t.name == "paged_decode_fn[pages=4]"]
        ref_flops = ref_audit.static_cost(rt.fn.trace(*rt.make_args()).jaxpr).flops

        [pt] = [t for t in jitaudit.engine_targets(engines[0], prefill_chunks=False)
                if t.name.endswith("paged_decode_fn[pages=4]")]
        st = jitaudit.static_cost(jitaudit.trace_target(pt))
        B, H, D, L = PAGED_KW["max_slots"], cfg.num_heads, cfg.head_dim, cfg.num_layers
        ref_attention = 4 * B * H * D * (4 * 16) * L
        assert st.flops - st.leaf_flops == ref_flops - ref_attention
        assert st.leaf_flops == 4 * H * D * B * L
        # the stated band: the port's total over the reference's, attention
        # over 1 visible position against 64 table positions
        assert 0.9 <= st.flops / ref_flops <= 1.0


# -------------------------------------------------------------- CLI, gate
class TestCli:
    def test_clean_run_exits_0_and_writes_the_report(self, tmp_path):
        out = tmp_path / "roof.json"
        assert jitaudit.main(["--device", "cpu", "--skip-replay", "--out", str(out)]) == 0
        report = json.loads(out.read_text())
        assert report["violations"] == [] and report["selftest_failures"] == []
        assert len(report["targets"]) == 12
        assert report["tolerances"]["bytes_vs_whole_operands"] == [0.1, 1.05]

    def test_a_violation_exits_1(self, monkeypatch, tmp_path):
        bad = jitaudit.AuditViolation("t", "in-place", "seeded")
        monkeypatch.setattr(jitaudit, "audit_engines", lambda *a, **k: ([], [bad], 1))
        assert jitaudit.main(["--device", "cpu", "--skip-replay", "--skip-selftest",
                              "--out", str(tmp_path / "r.json")]) == 1

    def test_a_selftest_failure_exits_1(self, monkeypatch, tmp_path):
        monkeypatch.setattr(jitaudit, "selftest", lambda device: ["seeded"])
        monkeypatch.setattr(jitaudit, "audit_engines", lambda *a, **k: ([], [], 0))
        assert jitaudit.main(["--device", "cpu", "--skip-replay",
                              "--out", str(tmp_path / "r.json")]) == 1

    def test_without_a_card_the_default_device_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is usable")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            jitaudit.main(["--skip-replay", "--skip-selftest", "--out", ""])

    @pytest.mark.parametrize("call", [
        jitaudit.selftest, jitaudit.kernel_targets, paged_ops.audit_spec,
        flash_ops.audit_spec, ssd_ops.audit_spec,
        lambda: jitaudit.replay_gate(get_config("qwen1.5-0.5b").reduced(), {}),
    ])
    def test_entry_points_default_to_the_card(self, call):
        """With no device given, each public entry point means the card
        and raises without one: none of them audits the CPU silently."""
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is usable")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()

    @pytest.mark.parametrize("flag", ["--model", "--max-seq", "--page-tokens"])
    def test_the_cli_takes_no_geometry(self, flag):
        """The model and the pools are the auditor's constants."""
        with pytest.raises(SystemExit):
            jitaudit.main(["--device", "cpu", flag, "1"])

    def test_replay_gate_captures_nothing_after_warmup(self, qwen):
        from repro_torch.analysis import compile_tracker

        cfg, params = qwen
        tracker = compile_tracker.get_tracker()
        armed = tracker.armed
        verdict = jitaudit.replay_gate(cfg, params, device="cpu", log=lambda s: None)
        assert verdict["post_warmup_captures"] == {}
        assert verdict["captures_by_phase"]["replay"] == 0
        assert verdict["captures_by_phase"]["warmup"] == 2
        assert verdict["graph_replays"] > 2
        assert tracker.armed == armed


# -------------------------------------------------------------------- card
@pytest.mark.cuda
def test_audit_on_the_card(qwen):
    """The audit of a reduced engine on the card: clean, each decode
    bucket's replay timed and its share of the bound in (0, 1.05]."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the audit replays captured graphs")
    cfg, params = qwen
    eng = Engine(cfg, params, device="cuda", **PAGED_KW)
    eng.warmup()
    assert jitaudit.selftest("cuda") == []
    rows, violations = jitaudit.audit(jitaudit.engine_targets(eng, prefill_chunks=True)
                                      + jitaudit.kernel_targets("cuda"))
    assert [str(v) for v in violations] == []
    shares = [r["replay_share"] for r in rows if r["kind"] == "paged_decode"]
    assert len(shares) == 2 and all(0 < s <= jitaudit.REPLAY_SHARE_LIMIT for s in shares)
    assert np.isfinite(shares).all()
