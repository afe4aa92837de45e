"""The port's gemma2, whisper and internvl2 on a mesh, against the
reference on two XLA CPU devices: gemma2's local/global alternation
trained under FSDP over "data" on a ``(2, 1)`` mesh and tensor parallelism
over "model" on a ``(1, 2)`` mesh through ``Trainer(mesh=...)``; whisper's
encoder-decoder and internvl2's image prefix through ``Model.loss`` and its
gradient on both meshes (the reference's ``Trainer`` feeds neither frames
nor images, so neither trains through a ``Trainer`` there); and the three
at model level, prefill and decode on ``(1, 2)`` under the decode rules.
Reduced gemma2-9b (2 (local, global) pairs, 4 query heads over 2 KV heads,
window 64), whisper-medium (2 encoder and 4 decoder layers of 4 heads, 24
encoder positions) and internvl2-26b (4 query heads over 1 KV head, which
the model axis does not divide, and 8 image tokens).

Both sides start together once per module (``_tp_ranks.run_both`` with the
``train_families`` suite): the port as two ``gloo`` ranks under
``no_functional_collectives``, the reference in a subprocess of its own
(its ``Trainer``, a jitted ``value_and_grad(Model.loss)`` on the train
rules' and ``batch_specs``' shardings, its jitted ``prefill``/``decode``).
The tests read them:

* **the blocks alone under autograd** (f32): gemma2's (local, global) pair
  over 80 positions (its window 64 binds) and whisper's decoder block
  (self-attention, cross-attention over an encoder output placed by rows,
  the FFN): the gradient of ``(block(x) * w).sum()`` with respect to
  ``x``, the encoder output and every leaf, on each mesh against one
  device within 1e-5 of each gradient's largest magnitude; on ``(1, 2)``
  3 decode steps from the sequence's caches (gemma2's local layer over a
  ring of 64 slots) the same. The encoder output's gradient through the
  cross K/V is each model rank's partial sum: left unsummed or summed
  twice, it fails here;
* **gemma2 through both** ``Trainer``\\ s: in f32 the step-1 losses within
  1e-5 relative, every step-1 gradient within 1e-4 x its largest
  magnitude plus 1e-6, three steps' losses within 1e-4 relative and the
  parameters in the grad-accumulation tolerance; in bf16 the step-1
  losses within 1e-2 relative and each gradient within 5e-2 relative
  Frobenius error;
* **``Model.loss`` and its gradient** for internvl2 (f32 and bf16) and
  whisper (bf16: the reference's encoder refuses f32 weights, ROADMAP §3)
  against the reference, the same bands; whisper in f32 against the port
  on one device;
* **the port against itself**: each mesh against one device, each rank
  holding about half of the parameter and moment bytes, the losses every
  rank logs equal, the heads each attention call of a rank saw;
* **model level**: the prefill's logits and 4 teacher-forced decode
  steps' (gemma2's 80-token prompt wraps its 64-slot ring) and the last
  cache gathered whole, against the reference and against the port on
  one device, in f32 within 1e-4 and in bf16 within the model band
  2**-4 + 2**-6·|x| (ROADMAP §3); a rank's parameter and cache bytes;
* a ``Trainer`` of whisper or internvl2 on a mesh is built and fails at
  its first step with the error that the same ``Trainer`` gives on one
  device, and an ``Engine`` on ``(1, 2)`` admits internvl2 and fails at
  its first prefill as on one device (``KeyError('image_embeds')``).
"""
from __future__ import annotations

import math

import numpy as np
import pytest

import _tp_common as C
import _tp_ranks
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models.params import leaves

#: the deadline of each side's processes
DEADLINE_S = 240
F32_TRAIN = [c for c in C.GEMMA2_TRAIN_CASES if c[2] == "f32"]
BF16_TRAIN = [c for c in C.GEMMA2_TRAIN_CASES if c[2] == "bf16"]
#: the loss cases the reference runs (whisper in bf16 alone)
REF_LOSS_CASES = [c for c in C.LOSS_CASES if not (c[0] == "whisper" and c[2] == "f32")]
REF_MODEL_CASES = [c for c in C.FAMILY_MODEL_CASES if c != ("whisper", "f32")]
#: the model band (ROADMAP §3) and the f32 tolerance of the model-level cases
BAND = dict(atol=2**-4, rtol=2**-6)
F32_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("tp_families")


@pytest.fixture(scope="module")
def runs(work):
    """Both sides of the families suite, started together: the reference's
    results and arrays, and each rank's results (rank 0's arrays, the
    gathered leaves both ranks hold)."""
    ref, ref_arrays, ranks = _tp_ranks.run_both(work, "train_families", DEADLINE_S)
    return ref, ref_arrays, [r for r, _ in ranks], ranks[0][1]


def _ids(cases):
    return [C.train_key(*c) for c in cases]


def _cfg(name: str):
    return get_config(C.TRAIN_FAMILY_CONFIGS[name]).reduced()


def _leaves_of(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


def _rel_close(got, want, rtol) -> None:
    assert len(got) == len(want) and len(want)
    for g, w in zip(got, want):
        assert math.isfinite(g) and abs(g - w) <= rtol * abs(w), (got, want)


def _f32_close(got: dict, want: dict, rel: float = 1e-4, floor: float = 1e-6) -> None:
    assert set(got) == set(want) and want
    for name, w in want.items():
        tol = rel * np.abs(w).max() + floor
        np.testing.assert_allclose(got[name], w, rtol=0, atol=tol, err_msg=name)


def _frobenius(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _frobenius_close(got: dict, want: dict) -> None:
    """Each gradient within 5e-2 relative Frobenius error."""
    assert set(got) == set(want) and want
    for name, w in want.items():
        assert np.isfinite(got[name]).all(), name
        assert _frobenius(got[name], w) <= 5e-2, (name, _frobenius(got[name], w))


def _grads_close(got: dict, want: dict, dtype: str) -> None:
    if dtype == "f32":
        _f32_close(got, want)
    else:
        _frobenius_close(got, want)


# ------------------------------------------------------ the blocks alone
@pytest.mark.parametrize("case", C.BLOCK_CASES, ids=[f"{n} {m[0]}x{m[1]}" for n, m in C.BLOCK_CASES])
def test_block_gradient_and_decode_match_one_device(runs, case):
    _, _, ranks, arrays = runs
    name, mesh = case
    key = f"{C.train_key(name, mesh, 'f32')} block"
    for r in ranks:
        _rel_close([r[f"{key} mesh loss"]], [ranks[0][f"{key} one loss"]], 1e-5)
    got, want = (_leaves_of(arrays, f"{key} {side} grad ") for side in ("mesh", "one"))
    expect = ({"x", "enc", "cross.wk", "cross.wv", "ffn.w_down"} if name == "whisper" else
              {"x", "local.attn.wq", "global.ffn.w_up"})
    assert expect <= set(want)
    _f32_close(got, want, rel=1e-5, floor=0.0)
    steps = {side: {k: v for k, v in _leaves_of(arrays, f"{key} {side} ").items()
                    if k.startswith("step")} for side in ("mesh", "one")}
    assert len(steps["one"]) == 3
    if mesh[0] == 1:
        _f32_close(steps["mesh"], steps["one"], rel=1e-5, floor=0.0)


# ------------------------------------------------------------ gemma2, f32
@pytest.mark.parametrize("case", F32_TRAIN, ids=_ids(F32_TRAIN))
def test_gemma2_step1_loss_matches_reference_in_f32(runs, case):
    ref, _, ranks, _ = runs
    key = C.train_key(*case)
    for r in ranks:
        _rel_close(r[f"{key} mesh losses1"], ref[f"{key} losses1"], 1e-5)


@pytest.mark.parametrize("case", F32_TRAIN, ids=_ids(F32_TRAIN))
def test_gemma2_step1_gradients_match_reference_in_f32(runs, case):
    _, ref_arrays, _, arrays = runs
    key = C.train_key(*case)
    _f32_close(_leaves_of(arrays, f"{key} mesh grad "), _leaves_of(ref_arrays, f"{key} grad "))


@pytest.mark.parametrize("case", F32_TRAIN, ids=_ids(F32_TRAIN))
def test_gemma2_three_steps_match_reference_in_f32(runs, case):
    ref, ref_arrays, ranks, arrays = runs
    key = C.train_key(*case)
    for r in ranks:
        _rel_close(r[f"{key} mesh losses"], ref[f"{key} losses"], 1e-4)
    got, want = _leaves_of(arrays, f"{key} mesh param "), _leaves_of(ref_arrays, f"{key} param ")
    assert set(got) == set(want) and len(ranks[0][f"{key} mesh losses"]) == C.TRAIN_STEPS
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=2e-2, atol=2e-3, err_msg=name)


# ------------------------------------------------------------ gemma2, bf16
@pytest.mark.parametrize("case", BF16_TRAIN, ids=_ids(BF16_TRAIN))
def test_gemma2_step1_matches_reference_in_bf16(runs, case):
    ref, ref_arrays, ranks, arrays = runs
    key = C.train_key(*case)
    for r in ranks:
        _rel_close(r[f"{key} mesh losses1"], ref[f"{key} losses1"], 1e-2)
    _frobenius_close(_leaves_of(arrays, f"{key} mesh grad "), _leaves_of(ref_arrays, f"{key} grad "))


@pytest.mark.parametrize("case", C.GEMMA2_TRAIN_CASES, ids=_ids(C.GEMMA2_TRAIN_CASES))
def test_gemma2_mesh_matches_the_port_on_one_device(runs, case):
    _, _, ranks, arrays = runs
    key = C.train_key(*case)
    got, want = _leaves_of(arrays, f"{key} mesh grad "), _leaves_of(arrays, f"{key} one grad ")
    if case[2] == "bf16":
        _rel_close(ranks[0][f"{key} mesh losses1"], ranks[0][f"{key} one losses1"], 1e-2)
        _frobenius_close(got, want)
        return
    _rel_close(ranks[0][f"{key} mesh losses1"], ranks[0][f"{key} one losses1"], 1e-5)
    _f32_close(got, want)
    _rel_close(ranks[0][f"{key} mesh losses"], ranks[0][f"{key} one losses"], 1e-4)
    got, want = _leaves_of(arrays, f"{key} mesh param "), _leaves_of(arrays, f"{key} one param ")
    assert set(got) == set(want) and want
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=2e-2, atol=2e-3, err_msg=name)


@pytest.mark.parametrize("case", C.GEMMA2_TRAIN_CASES, ids=_ids(C.GEMMA2_TRAIN_CASES))
def test_gemma2_ranks_hold_half_log_the_same_losses_and_attend_their_heads(runs, case):
    """Each rank holds about half of the parameter and moment bytes, and
    every attention call of its step (rank 0 also runs one device's) sees
    its half of the heads on ``(1, 2)``, its half of the rows on
    ``(2, 1)``."""
    _, _, ranks, _ = runs
    key = C.train_key(*case)
    _, mesh, dtype = case
    cfg = _cfg("gemma2")
    width = 4 if dtype == "f32" else 2
    moment = 2 if cfg.bf16_moments else 4
    whole = sum(math.prod(l.shape) for _, l in leaves(Model(cfg).describe()))
    for r in ranks:
        assert 0.45 < r[f"{key} param bytes"] / (width * whole) < 0.55, r[f"{key} param bytes"]
        assert 0.45 < r[f"{key} moment bytes"] / (2 * moment * whole) < 0.55
    for metric in ("losses1", "losses"):
        if f"{key} mesh {metric}" in ranks[0]:
            assert ranks[0][f"{key} mesh {metric}"] == ranks[1][f"{key} mesh {metric}"]
    H, KH, tp = cfg.num_heads, cfg.num_kv_heads, mesh[1]
    rank_heads = ("flash", H // tp, KH // tp)
    assert {tuple(s) for s in ranks[1][f"{key} heads seen"]} == {rank_heads}
    assert {tuple(s) for s in ranks[0][f"{key} heads seen"]} == {rank_heads, ("flash", H, KH)}


# -------------------------------------------- Model.loss: whisper, internvl2
def _loss_ids(cases):
    return [C.train_key(*c) for c in cases]


@pytest.mark.parametrize("case", REF_LOSS_CASES, ids=_loss_ids(REF_LOSS_CASES))
def test_loss_and_gradient_match_reference(runs, case):
    ref, ref_arrays, ranks, arrays = runs
    key = f"{C.train_key(*case)} loss"
    dtype = case[2]
    for r in ranks:
        _rel_close([r[f"{key} mesh"]], [ref[key]], 1e-5 if dtype == "f32" else 1e-2)
    _grads_close(_leaves_of(arrays, f"{key} mesh grad "), _leaves_of(ref_arrays, f"{key} grad "),
                 dtype)


@pytest.mark.parametrize("case", C.LOSS_CASES, ids=_loss_ids(C.LOSS_CASES))
def test_loss_and_gradient_match_the_port_on_one_device(runs, case):
    """Every loss case against the port on one device: for whisper in f32
    the only reference there is. whisper's first encoder layer normalises
    the frames in bf16 whatever the weights' type (the reference casts
    them so), so its norm weight's gradient is taken in bf16: a rank
    rounds its partial sum (its rows, or its heads' share of the norm's
    output gradient) to bf16 before the f32 sum over the ranks, where one
    device rounds the whole sum once. That slice is held to 2**-7 of its
    largest, one bf16 rounding; every other gradient to the f32 band."""
    _, _, ranks, arrays = runs
    key = f"{C.train_key(*case)} loss"
    name, _, dtype = case
    for r in ranks:
        _rel_close([r[f"{key} mesh"]], [ranks[0][f"{key} one"]], 1e-5 if dtype == "f32" else 1e-2)
    got, want = (_leaves_of(arrays, f"{key} {side} grad ") for side in ("mesh", "one"))
    if name == "whisper" and dtype == "f32":
        ln = "enc_blocks.ln1"
        _f32_close({ln: got[ln][0]}, {ln: want[ln][0]}, rel=2**-7, floor=0.0)
        got[ln], want[ln] = got[ln][1:], want[ln][1:]
    _grads_close(got, want, dtype)


@pytest.mark.parametrize("case", C.LOSS_CASES, ids=_loss_ids(C.LOSS_CASES))
def test_loss_attention_calls_see_the_ranks_heads(runs, case):
    """Every attention call of a rank's forward and backward: its half of
    the query heads on ``(1, 2)`` (and of whisper's KV heads; internvl2's
    one KV head, which the model axis does not divide, is replicated and
    read once a query head), its half of the rows on ``(2, 1)``."""
    _, _, ranks, _ = runs
    name, mesh, _ = case
    cfg = _cfg(name)
    H, KH, tp = cfg.num_heads, cfg.num_kv_heads, mesh[1]
    kv = KH // tp if KH % tp == 0 else H // tp
    for r in ranks:
        assert {tuple(s) for s in r[f"{C.train_key(*case)} loss heads seen"]} == {
            ("flash", H // tp, kv)}


# ------------------------------------------------------------ model level
def _model_level_close(got: dict, want: dict, dtype: str, spread: dict | None = None) -> None:
    """f32 within ``F32_TOL``; bf16 within ``BAND`` plus, elementwise, the
    leaf's ``spread`` where given."""
    assert set(got) == set(want) and want
    for name, w in want.items():
        assert got[name].shape == w.shape, (name, got[name].shape, w.shape)
        if dtype == "f32":
            np.testing.assert_allclose(got[name], w, err_msg=name, **F32_TOL)
            continue
        band = BAND["atol"] + BAND["rtol"] * np.abs(w) + (0 if spread is None else spread[name])
        excess = np.abs(got[name] - w) - band
        assert excess.max() <= 0, (name, float(excess.max()))


@pytest.mark.parametrize("case", REF_MODEL_CASES, ids=[C.family_key(*c) for c in REF_MODEL_CASES])
def test_model_level_prefill_and_decode_match_reference(runs, case):
    """In bf16 the band is widened elementwise by the reference's own
    difference between its run on the mesh and on one device: XLA's
    sharded program rounds otherwise (whisper's self-attention K moves
    past the plain band there), and the port's one-device run lies as far
    outside the plain band of the reference's mesh run as its mesh run
    does."""
    _, ref_arrays, _, arrays = runs
    key = C.family_key(*case)
    want = _leaves_of(ref_arrays, f"{key} mesh ")
    assert f"step{C.FAMILY_DECODE_STEPS - 1} logits" in want
    spread = None
    if case[1] == "bf16":
        one = _leaves_of(ref_arrays, f"{key} one ")
        spread = {n: np.abs(w - one[n]) for n, w in want.items()}
    _model_level_close(_leaves_of(arrays, f"{key} mesh "), want, case[1], spread)


@pytest.mark.parametrize("case", C.FAMILY_MODEL_CASES,
                         ids=[C.family_key(*c) for c in C.FAMILY_MODEL_CASES])
def test_model_level_mesh_matches_the_port_on_one_device(runs, case):
    _, _, _, arrays = runs
    key = C.family_key(*case)
    want = _leaves_of(arrays, f"{key} one ")
    assert f"step{C.FAMILY_DECODE_STEPS - 1} logits" in want
    _model_level_close(_leaves_of(arrays, f"{key} mesh "), want, case[1])


@pytest.mark.parametrize("case", C.FAMILY_MODEL_CASES,
                         ids=[C.family_key(*c) for c in C.FAMILY_MODEL_CASES])
def test_model_level_ranks_hold_their_heads(runs, case):
    """A rank holds about half of the parameter bytes and half of the
    caches (internvl2 all of them: its one KV head is replicated), and
    each attention call sees its half of the query heads."""
    _, _, ranks, arrays = runs
    name, dtype = case
    key = C.family_key(*case)
    cfg = _cfg(name)
    width = 4 if dtype == "f32" else 2
    whole = sum(math.prod(l.shape) for _, l in leaves(Model(cfg).describe()))
    cache_whole = sum(v.size * width for v in _leaves_of(arrays, f"{key} one cache ").values())
    H, KH = cfg.num_heads, cfg.num_kv_heads
    share = 0.5 if KH % 2 == 0 else 1.0
    kv = KH // 2 if KH % 2 == 0 else H // 2
    for r in ranks:
        assert 0.4 < r[f"{key} param bytes"] / (width * whole) < 0.6, r[f"{key} param bytes"]
        assert r[f"{key} cache bytes"] == share * cache_whole
        assert {tuple(s) for s in r[f"{key} heads seen"]} == {("flash", H // 2, kv),
                                                              ("paged", H // 2, kv)}


# ------------------------------------------------- what a mesh builds now
@pytest.mark.parametrize("name", ["whisper", "internvl2"])
def test_trainer_on_a_mesh_fails_at_its_first_step_as_on_one_device(runs, name):
    """The reference's ``Trainer`` hands ``Model.loss`` only the tokens:
    whisper has no frames there and internvl2 no image embeddings. The
    port's is built on either mesh and fails at its first step, on every
    rank, with the one-device error."""
    _, _, ranks, _ = runs
    want = ranks[0][f"{name} trainer one"]
    assert want == ("KeyError('image_embeds')" if name == "internvl2" else
                    'ValueError("whisper-medium (encdec) takes the encoder\'s frames")')
    for r in ranks:
        for mesh in C.TRAIN_MESHES:
            assert r[f"{name} trainer {mesh[0]}x{mesh[1]}"] == want


@pytest.mark.parametrize("family", ["alternating", "encdec", "vlm"])
def test_alternating_encdec_and_vlm_take_a_step_on_a_mesh(runs, family):
    """What ``(2, 1)`` and ``(1, 2)`` refused before: gemma2 takes three
    ``Trainer`` steps there with finite, falling losses; whisper and
    internvl2 take ``Model.loss`` and a finite gradient of every leaf."""
    _, _, ranks, arrays = runs
    for mesh in C.TRAIN_MESHES:
        if family == "alternating":
            key = C.train_key("gemma2", mesh, "f32")
            for r in ranks:
                losses = r[f"{key} mesh losses"]
                assert len(losses) == C.TRAIN_STEPS and all(map(math.isfinite, losses))
                assert losses[-1] < losses[0]
            continue
        name = "whisper" if family == "encdec" else "internvl2"
        key = f"{C.train_key(name, mesh, 'bf16')} loss"
        grads = _leaves_of(arrays, f"{key} mesh grad ")
        assert len(grads) == len(list(leaves(Model(_cfg(name)).describe())))
        assert all(np.isfinite(g).all() and np.abs(g).max() > 0 for g in grads.values())
        for r in ranks:
            assert math.isfinite(r[f"{key} mesh"])


def test_engine_on_a_mesh_admits_vlm_and_fails_at_its_first_prefill(runs):
    """The reference's ``Engine`` admits vlm with a placement; neither
    engine passes ``image_embeds``, so the first prefill fails, on the mesh
    as on one device."""
    _, _, ranks, _ = runs
    for r in ranks:
        got = r["vlm engine"]
        assert got["mesh built"] and got["one built"]
        assert got["mesh first prefill"] == got["one first prefill"] == "KeyError('image_embeds')"
