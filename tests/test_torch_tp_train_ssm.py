"""The port's mamba2 and zamba2 on a mesh, against the reference on two
XLA CPU devices: training under FSDP over "data" on a ``(2, 1)`` mesh and
tensor parallelism over "model" on a ``(1, 2)`` mesh, and model-level
prefill and decode on ``(1, 2)`` under the decode rules, for reduced
mamba2-2.7b (4 Mamba-2 blocks of 16 SSD heads) and reduced zamba2-2.7b
(2 groups of 2 Mamba-2 blocks, each followed by the shared attention
block).

Both sides start together once per module (``_tp_ranks.run_both`` with the
``train_ssm`` suite), as ``tests/test_torch_tp_train.py``'s do: the port
as two ``gloo`` ranks running ``Trainer(mesh=...)``, ``Model.prefill`` and
``Model.decode`` with a ``ShardCtx`` under ``no_functional_collectives``,
the reference's ``Trainer``, a jitted ``value_and_grad(model.loss)`` and
its jitted ``prefill``/``decode`` in a subprocess of its own. The tests
read them:

* **the Mamba-2 block alone under autograd** (f32): the gradient of
  ``(apply_mamba_block(x) * w).sum()`` with respect to ``x`` and every
  leaf, on each mesh against one device, within 1e-5 of each gradient's
  largest magnitude. On ``(1, 2)`` a rank that took its contiguous block
  of ``in_proj``'s or the conv's columns for its heads, a ``B``/``C``
  column gradient left a partial sum or summed twice, or a gated norm
  over the rank's columns alone fails it;
* **in f32**: ``tests/test_torch_tp_train.py``'s bands (step-1 losses
  within 1e-5 relative, every step-1 gradient within 1e-4 x its largest
  magnitude plus 1e-6, three steps' losses within 1e-4 relative and the
  parameters in the grad-accumulation tolerance);
* **in bf16**: the step-1 losses within 1e-2 relative and each gradient
  within 5e-2 relative Frobenius error of the reference's, plus the
  reference's own spread for that leaf between its two meshes (the same
  weights and tokens: what bf16 rounding alone moves it by). ``D``'s
  gradient, a sum over every position and head channel of products that
  largely cancel, moves 5-7 % between the reference's own meshes, and the
  port's on one device lies as far from them;
* **the port against itself**: each mesh against ``Trainer`` on one
  device (the same bands), each rank holding about half of the parameter
  and moment bytes, the losses every rank logs equal, and every SSD scan
  of a step on ``(1, 2)`` seeing the rank's half of the heads;
* **model level**: the prefill's logits and 4 teacher-forced decode steps'
  (zamba2's shared slots padded to 32) against the reference and against
  the port on one device, in f32 within 1e-4 and in bf16 within the model
  band 2**-4 + 2**-6·|x| (ROADMAP §3), against the reference widened
  elementwise by its own difference between its run on the mesh and on
  one device (XLA's sharded program rounds otherwise: zamba2's shared
  K/V and logits move by up to 2**-4 there, and the port's one-device
  run lies outside the plain band of the reference's mesh run by as
  much as its mesh run does); the last cache gathered whole (the
  SSM state, the conv state reassembled from each rank's heads' ``x``
  channels and the shared ``B``/``C``, zamba2's slots) the same; each
  rank's SSM state its half of the heads and its conv state its heads'
  channels and all of ``B`` and ``C``;
* ``SsmEngine`` takes no placement, as the reference's does not.
"""
from __future__ import annotations

import inspect
import math

import numpy as np
import pytest

import _tp_common as C
import _tp_ranks
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models.params import leaves
from repro_torch.serving import SsmEngine

#: the deadline of each side's processes
DEADLINE_S = 240
F32_CASES = [c for c in C.TRAIN_SSM_CASES if c[2] == "f32"]
BF16_CASES = [c for c in C.TRAIN_SSM_CASES if c[2] == "bf16"]
LAYER_CASES = [(name, mesh) for name in C.TRAIN_SSM_CONFIGS for mesh in C.TRAIN_MESHES]
#: the model band (ROADMAP §3) and the f32 tolerance of the model-level cases
BAND = dict(atol=2**-4, rtol=2**-6)
F32_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("tp_train_ssm")


@pytest.fixture(scope="module")
def runs(work):
    """Both sides of the SSM suite, started together: the reference's
    results and arrays, and each rank's results (rank 0's arrays, the
    gathered leaves both ranks hold)."""
    ref, ref_arrays, ranks = _tp_ranks.run_both(work, "train_ssm", DEADLINE_S)
    return ref, ref_arrays, [r for r, _ in ranks], ranks[0][1]


def _ids(cases):
    return [C.train_key(*c) for c in cases]


def _cfg(name: str):
    return get_config(C.TRAIN_SSM_CONFIGS[name]).reduced()


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


def _frobenius_close(got: dict, want: dict, spread: dict | None = None) -> None:
    """Each gradient within 5e-2 relative Frobenius error, plus the leaf's
    ``spread`` where given."""
    assert set(got) == set(want) and want
    for name, w in want.items():
        assert np.isfinite(got[name]).all(), name
        band = 5e-2 + (spread[name] if spread else 0.0)
        assert _frobenius(got[name], w) <= band, (name, _frobenius(got[name], w), band)


def _reference_spread(ref_arrays: dict, name: str) -> dict:
    """Each leaf's relative Frobenius spread between the reference's own
    bf16 step-1 gradients on its two meshes."""
    a, b = (_leaves_of(ref_arrays, f"{C.train_key(name, m, 'bf16')} grad ")
            for m in C.TRAIN_MESHES)
    return {n: _frobenius(b[n], a[n]) for n in a}


# ------------------------------------------------------ the block alone
@pytest.mark.parametrize("case", LAYER_CASES, ids=[f"{n} {m[0]}x{m[1]}" for n, m in LAYER_CASES])
def test_mamba_block_gradient_matches_one_device(runs, case):
    _, _, ranks, arrays = runs
    name, mesh = case
    key = f"{C.train_key(name, mesh, 'f32')} layer"
    for r in ranks:
        _rel_close([r[f"{key} mesh loss"]], [ranks[0][f"{key} one loss"]], 1e-5)
    got, want = (_leaves_of(arrays, f"{key} {side} grad ") for side in ("mesh", "one"))
    assert {"x", "in_proj", "conv_w", "conv_b", "dt_bias", "A_log", "D", "norm",
            "out_proj", "ln"} == set(want)
    _f32_close(got, want, rel=1e-5, floor=0.0)


# ------------------------------------------------------------ f32
@pytest.mark.parametrize("case", F32_CASES, ids=_ids(F32_CASES))
def test_step1_loss_matches_reference_in_f32(runs, case):
    ref, _, ranks, _ = runs
    key = C.train_key(*case)
    for r in ranks:
        _rel_close(r[f"{key} mesh losses1"], ref[f"{key} losses1"], 1e-5)


@pytest.mark.parametrize("case", F32_CASES, ids=_ids(F32_CASES))
def test_step1_gradients_match_reference_in_f32(runs, case):
    _, ref_arrays, _, arrays = runs
    key = C.train_key(*case)
    _f32_close(_leaves_of(arrays, f"{key} mesh grad "), _leaves_of(ref_arrays, f"{key} grad "))


@pytest.mark.parametrize("case", F32_CASES, ids=_ids(F32_CASES))
def test_three_steps_match_reference_in_f32(runs, case):
    ref, ref_arrays, ranks, arrays = runs
    key = C.train_key(*case)
    for r in ranks:
        _rel_close(r[f"{key} mesh losses"], ref[f"{key} losses"], 1e-4)
    got, want = _leaves_of(arrays, f"{key} mesh param "), _leaves_of(ref_arrays, f"{key} param ")
    assert set(got) == set(want) and len(ranks[0][f"{key} mesh losses"]) == C.TRAIN_STEPS
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=2e-2, atol=2e-3, err_msg=name)


# ------------------------------------------------------------ bf16
@pytest.mark.parametrize("case", BF16_CASES, ids=_ids(BF16_CASES))
def test_step1_matches_reference_in_bf16(runs, case):
    ref, ref_arrays, ranks, arrays = runs
    key = C.train_key(*case)
    for r in ranks:
        _rel_close(r[f"{key} mesh losses1"], ref[f"{key} losses1"], 1e-2)
    _frobenius_close(_leaves_of(arrays, f"{key} mesh grad "),
                     _leaves_of(ref_arrays, f"{key} grad "), _reference_spread(ref_arrays, case[0]))


# ------------------------------------------------ the port against itself
@pytest.mark.parametrize("case", C.TRAIN_SSM_CASES, ids=_ids(C.TRAIN_SSM_CASES))
def test_mesh_matches_the_port_on_one_device(runs, case):
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


@pytest.mark.parametrize("case", C.TRAIN_SSM_CASES, ids=_ids(C.TRAIN_SSM_CASES))
def test_every_rank_holds_half_and_logs_the_same_losses(runs, case):
    _, _, ranks, _ = runs
    key = C.train_key(*case)
    name, _, dtype = case
    cfg = _cfg(name)
    width = 4 if dtype == "f32" else 2
    moment = 2 if cfg.bf16_moments else 4
    whole = sum(math.prod(l.shape) for _, l in leaves(Model(cfg).describe()))
    for r in ranks:
        assert 0.45 < r[f"{key} param bytes"] / (width * whole) < 0.55, r[f"{key} param bytes"]
        assert 0.45 < r[f"{key} moment bytes"] / (2 * moment * whole) < 0.55
    for metric in ("losses1", "losses"):
        if f"{key} mesh {metric}" in ranks[0]:
            assert ranks[0][f"{key} mesh {metric}"] == ranks[1][f"{key} mesh {metric}"]


@pytest.mark.parametrize("case", C.TRAIN_SSM_CASES, ids=_ids(C.TRAIN_SSM_CASES))
def test_each_rank_scans_its_own_heads(runs, case):
    """Every SSD scan of the step (rank 0 also runs one device's) sees the
    rank's half of the heads on ``(1, 2)``, all of them on ``(2, 1)``."""
    _, _, ranks, _ = runs
    key = C.train_key(*case)
    heads = _cfg(case[0]).ssm_heads
    tp = case[1][1]
    assert ranks[1][f"{key} ssd heads"] == [heads // tp]
    assert ranks[0][f"{key} ssd heads"] == sorted({heads // tp, heads})


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


@pytest.mark.parametrize("case", C.SSM_MODEL_CASES, ids=[C.ssm_key(*c) for c in C.SSM_MODEL_CASES])
def test_model_level_prefill_and_decode_match_reference(runs, case):
    _, ref_arrays, _, arrays = runs
    key = C.ssm_key(*case)
    want = _leaves_of(ref_arrays, f"{key} mesh ")
    assert {f"step{C.SSM_DECODE_STEPS - 1} logits", "cache ssm", "cache conv"} <= set(want)
    spread = None
    if case[1] == "bf16":
        one = _leaves_of(ref_arrays, f"{key} one ")
        spread = {n: np.abs(w - one[n]) for n, w in want.items()}
    _model_level_close(_leaves_of(arrays, f"{key} mesh "), want, case[1], spread)


@pytest.mark.parametrize("case", C.SSM_MODEL_CASES, ids=[C.ssm_key(*c) for c in C.SSM_MODEL_CASES])
def test_model_level_mesh_matches_the_port_on_one_device(runs, case):
    _, _, _, arrays = runs
    key = C.ssm_key(*case)
    _model_level_close(_leaves_of(arrays, f"{key} mesh "), _leaves_of(arrays, f"{key} one "),
                       case[1])


@pytest.mark.parametrize("case", C.SSM_MODEL_CASES, ids=[C.ssm_key(*c) for c in C.SSM_MODEL_CASES])
def test_each_rank_holds_its_heads_state(runs, case):
    _, ref_arrays, ranks, _ = runs
    key = C.ssm_key(*case)
    cfg = _cfg(case[0])
    whole = ref_arrays[f"{key} mesh cache ssm"]
    for r in ranks:
        assert r[f"{key} ssm heads"] == cfg.ssm_heads // 2
        assert r[f"{key} ssm bytes"] * 2 == whole.size * 4
        assert r[f"{key} conv channels"] == cfg.ssm_inner // 2 + 2 * cfg.ssm_state


def test_ssm_engine_takes_no_placement():
    """The reference's ``SsmEngine`` serves one device; the port's takes no
    placement either."""
    assert "placement" not in inspect.signature(SsmEngine).parameters
