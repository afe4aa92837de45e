"""The port's MoE training on a mesh, against the reference on two XLA CPU
devices: FSDP over "data" on a ``(2, 1)`` mesh and tensor parallelism
over "model" on a ``(1, 2)`` mesh, for reduced dbrx-132b and reduced
arctic-480b (its dense residual FFN beside the experts).

Both sides start together once per module (``_tp_ranks.run_both`` with the
``train_moe`` suite), as ``tests/test_torch_tp_train.py``'s do: the port
as two ``gloo`` ranks running ``Trainer(mesh=...)`` under
``no_functional_collectives``, the reference's ``Trainer`` and a jitted
``value_and_grad(model.loss)`` in a subprocess of its own. The tests read
them:

* **the MoE layer alone under autograd** (f32): the gradient of
  ``(apply_moe(x) * w).sum() + aux``, the aux loss at weight 1 so that its
  path is not drowned, with respect to ``x``, the router and the three
  expert weights (and arctic's dense FFN), on each mesh against one
  device, within 1e-5 of each gradient's largest magnitude. A crossing
  that left a partial sum where the whole gradient belongs (the tokens'
  gradient along the experts, the router's along the combine product) or
  summed a whole one again (the aux loss over "model"), or a layer that
  ran every rank's rows on every data rank, fails it;
* **in f32**: ``tests/test_torch_tp_train.py``'s bands (step-1 losses
  within 1e-5 relative, every step-1 gradient within 1e-4 x its largest
  magnitude plus 1e-6, three steps' losses within 1e-4 relative and the
  parameters in the grad-accumulation tolerance);
* **in bf16, held by routing**: MoE routing is discontinuous, so both
  sides record every MoE layer's router gates at step 1. Every token whose
  chosen experts differ between the two runs must differ first at a near
  tie: its margin there (the gap between its k-th and (k+1)-th gate in
  the run held to) at most twice the largest gate difference of the
  tokens routed alike in every layer (what rounding alone moved a gate).
  The step-1 losses lie within 1e-2 relative; each gradient within 5e-2
  relative Frobenius error where no token flips, and where some do within
  5e-2 plus the reference's own spread for that leaf between its two
  meshes (the same weights and tokens: what its routing flips alone move
  a gradient by);
* **the port against itself**: each mesh against ``Trainer`` on one device
  (the same bands, bf16 by routing), each rank holding about half of the
  parameter and moment bytes, and the losses every rank logs equal;
* **the pod refusal**: a training mesh whose "pod" axis has more than one
  device, over which the rules shard the experts, raises.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import _tp_common as C
import _tp_ranks
from repro_torch.configs import get_config
from repro_torch.launch.mesh import Mesh
from repro_torch.models import Model
from repro_torch.models.layers import ShardCtx
from repro_torch.models.params import leaves
from repro_torch.train.data import DataConfig
from repro_torch.train.loop import TrainConfig, Trainer

CPU = torch.device("cpu")
#: the deadline of each side's processes
DEADLINE_S = 240
F32_CASES = [c for c in C.TRAIN_MOE_CASES if c[2] == "f32"]
BF16_CASES = [c for c in C.TRAIN_MOE_CASES if c[2] == "bf16"]
LAYER_CASES = [(name, mesh) for name in C.TRAIN_MOE_CONFIGS for mesh in C.TRAIN_MESHES]


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("tp_train_moe")


@pytest.fixture(scope="module")
def runs(work):
    """Both sides of the MoE train suite, started together: the
    reference's results and arrays, and each rank's results (rank 0's
    arrays, the gathered leaves both ranks hold)."""
    ref, ref_arrays, ranks = _tp_ranks.run_both(work, "train_moe", DEADLINE_S)
    return ref, ref_arrays, [r for r, _ in ranks], ranks[0][1]


def _ids(cases):
    return [C.train_key(*c) for c in cases]


def _cfg(name: str):
    return get_config(C.TRAIN_MOE_CONFIGS[name]).reduced()


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


# -------------------------------------------------------- routing
def _chosen(gates, k: int):
    return np.sort(np.argsort(-gates, axis=-1, kind="stable")[..., :k], axis=-1)


def route_flips(gates, want, k: int, layers: int) -> dict:
    """Two runs' gates ``[microbatches * layers, groups, g, E]`` on the
    same inputs: the tokens whose chosen experts differ in some layer,
    each with its margin in ``want`` at the first layer where they differ,
    and ``eps``, the largest gate difference over the tokens routed alike
    in every layer."""
    E = gates.shape[-1]
    g = gates.reshape(-1, layers, gates.shape[1] * gates.shape[2], E)
    w = want.reshape(g.shape)
    differ = (_chosen(g, k) != _chosen(w, k)).any(-1)                # [mb, L, tokens]
    flipped = differ.any(1)                                          # [mb, tokens]
    alike = np.broadcast_to(~flipped[:, None, :], differ.shape)
    eps = float(np.abs(g - w).max(-1)[alike].max())
    top = -np.sort(-w, axis=-1)
    margin = top[..., k - 1] - top[..., k]                           # [mb, L, tokens]
    first = differ.argmax(1)
    mb, tok = np.nonzero(flipped)
    return {"eps": eps, "flips": [(int(m), int(t), int(first[m, t]),
                                   float(margin[m, first[m, t], t])) for m, t in zip(mb, tok)]}


def _held_by_routing(gates, want, cfg, got_grads: dict, want_grads: dict, spread: dict) -> None:
    """The bf16 rule of the module docstring: every flip a near tie, each
    gradient in the band, widened by the reference's own spread where
    tokens flip."""
    routes = route_flips(gates, want, cfg.top_k, cfg.num_layers)
    for m, t, layer, margin in routes["flips"]:
        assert margin <= 2 * routes["eps"], (m, t, layer, margin, routes["eps"])
    assert set(got_grads) == set(want_grads) and want_grads
    for name, w in want_grads.items():
        assert np.isfinite(got_grads[name]).all(), name
        band = 5e-2 + (spread[name] if routes["flips"] else 0.0)
        assert _frobenius(got_grads[name], w) <= band, (name, band, routes)


def _reference_spread(ref_arrays: dict, name: str) -> dict:
    """Each leaf's relative Frobenius spread between the reference's own
    bf16 step-1 gradients on its two meshes."""
    a, b = (_leaves_of(ref_arrays, f"{C.train_key(name, m, 'bf16')} grad ")
            for m in C.TRAIN_MESHES)
    return {n: _frobenius(b[n], a[n]) for n in a}


# ------------------------------------------------------ the layer alone
@pytest.mark.parametrize("case", LAYER_CASES, ids=[f"{n} {m[0]}x{m[1]}" for n, m in LAYER_CASES])
def test_moe_layer_gradient_matches_one_device(runs, case):
    _, _, ranks, arrays = runs
    name, mesh = case
    key = f"{C.train_key(name, mesh, 'f32')} layer"
    for r in ranks:
        _rel_close([r[f"{key} mesh loss"]], [ranks[0][f"{key} one loss"]], 1e-5)
        _rel_close([r[f"{key} mesh aux"]], [ranks[0][f"{key} one aux"]], 1e-5)
    assert ranks[0][f"{key} one aux"] > 0
    got, want = (_leaves_of(arrays, f"{key} {side} grad ") for side in ("mesh", "one"))
    assert {"x", "router", "w_gate", "w_up", "w_down"} <= set(want)
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
def test_step1_held_to_the_reference_by_routing_in_bf16(runs, case):
    ref, ref_arrays, ranks, arrays = runs
    key = C.train_key(*case)
    for r in ranks:
        _rel_close(r[f"{key} mesh losses1"], ref[f"{key} losses1"], 1e-2)
    _held_by_routing(arrays[f"{key} mesh gates"], ref_arrays[f"{key} gates"], _cfg(case[0]),
                     _leaves_of(arrays, f"{key} mesh grad "),
                     _leaves_of(ref_arrays, f"{key} grad "),
                     _reference_spread(ref_arrays, case[0]))


# ------------------------------------------------ the port against itself
@pytest.mark.parametrize("case", C.TRAIN_MOE_CASES, ids=_ids(C.TRAIN_MOE_CASES))
def test_mesh_matches_the_port_on_one_device(runs, case):
    _, ref_arrays, ranks, arrays = runs
    key = C.train_key(*case)
    f32 = case[2] == "f32"
    _rel_close(ranks[0][f"{key} mesh losses1"], ranks[0][f"{key} one losses1"],
               1e-5 if f32 else 1e-2)
    got, want = _leaves_of(arrays, f"{key} mesh grad "), _leaves_of(arrays, f"{key} one grad ")
    if not f32:
        _held_by_routing(arrays[f"{key} mesh gates"], arrays[f"{key} one gates"],
                         _cfg(case[0]), got, want, _reference_spread(ref_arrays, case[0]))
        return
    _f32_close(got, want)
    _rel_close(ranks[0][f"{key} mesh losses"], ranks[0][f"{key} one losses"], 1e-4)
    got, want = _leaves_of(arrays, f"{key} mesh param "), _leaves_of(arrays, f"{key} one param ")
    assert set(got) == set(want) and want
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=2e-2, atol=2e-3, err_msg=name)


@pytest.mark.parametrize("case", C.TRAIN_MOE_CASES, ids=_ids(C.TRAIN_MOE_CASES))
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


# ------------------------------------------------------------ what raises
@pytest.mark.parametrize("name", sorted(C.TRAIN_MOE_CONFIGS))
def test_a_pod_axis_refuses_moe_training(name):
    """The train rules put the experts on "pod": expert parallelism needs a
    token exchange that the port does not have yet."""
    cfg = _cfg(name)
    mesh = Mesh(("pod", "data", "model"), np.array([CPU] * 2, dtype=object).reshape(2, 1, 1))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(cfg, TrainConfig(), DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                               global_batch=2), mesh=mesh)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(cfg).loss({"tokens": torch.zeros(2, 9, dtype=torch.long)}, ShardCtx(mesh=mesh))
