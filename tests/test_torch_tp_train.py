"""The port's training on a mesh, against the reference on two XLA CPU
devices: FSDP over "data" on a ``(2, 1)`` mesh and tensor parallelism over
"model" on a ``(1, 2)`` mesh, for reduced qwen1.5-0.5b and its GQA 6/3
variant (whose KV heads the model axis does not divide: the rules
replicate the KV while the query heads stay sharded).

Both sides start together once per module (``_tp_ranks.run_both`` with the
``train`` suite): the port as two ``gloo`` ranks in spawned processes
running ``Trainer(mesh=...)`` under ``no_functional_collectives``, the
reference in a subprocess of its own (``_tp_reference.py``), which sets
``XLA_FLAGS`` before JAX is imported and runs its own ``Trainer`` on the
same mesh shapes. Both draw the seed-0 weights (in f32 from an f32
descriptor tree) and the launcher's token pipeline at a reduced size.
The tests read them:

* **in f32** (the two compute the same function in the same type): the
  step-1 microbatch losses within 1e-5 relative, every gathered step-1
  gradient (each leaf's mean over the microbatches) within 1e-4 x its
  largest magnitude plus 1e-6 (the f32 bands of
  ``tests/test_torch_loss.py``), three steps' losses within 1e-4 relative
  and the final parameters within the reference's own grad-accumulation
  tolerance (rtol 2e-2, atol 2e-3, ``tests/test_train.py``);
* **in bf16**: the step-1 losses within 1e-2 relative and each gradient
  within 5e-2 relative Frobenius error (the bf16 bands of
  ``tests/test_torch_loss.py``);
* **the port against itself**: on each mesh against ``Trainer`` on one
  device (the same bands; the parameters after three steps in the
  grad-accumulation tolerance), each rank holding about half of the parameter
  and moment bytes, the losses every rank logs equal, and M = 2
  microbatches against M = 1 on each mesh;
* **crash and restore**: a ``FaultInjector`` crash at step 2 on ``(2, 1)``,
  resumed, ends bit-identical to the uninterrupted run; its checkpoint
  restores on ``(1, 2)``, on one device and in the reference
  (``repro.train.checkpoint.restore``), bit-equal to the gathered leaves;
* **what raises**: a backward that would ask DTensor for a functional
  collective (``no_functional_collectives`` is armed over every backward
  in the ranks, and the port's ``place_block`` takes the same graph
  through ``torch.distributed``), a microbatch that "data" does not
  divide (MoE training on a mesh is ``tests/test_torch_tp_train_moe.py``'s,
  mamba2's and zamba2's ``tests/test_torch_tp_train_ssm.py``'s, gemma2's,
  whisper's and internvl2's ``tests/test_torch_tp_families.py``'s).
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import _tp_common as C
import _tp_ranks
from repro.models import Model as JaxModel
from repro.models.params import abstract as jax_abstract
from repro.train import checkpoint as jax_ck
from repro.train.optimizer import describe_opt_state as jax_describe_opt
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models.params import flatten_tree, leaves
from repro_torch.train import checkpoint as ck
from repro_torch.train.optimizer import describe_opt_state

#: the deadline of each side's processes
DEADLINE_S = 240
F32_CASES = [c for c in C.TRAIN_CASES if c[2] == "f32"]
BF16_CASES = [c for c in C.TRAIN_CASES if c[2] == "bf16"]


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("tp_train")


@pytest.fixture(scope="module")
def runs(work):
    """Both sides of the train suite, started together: the reference's
    results and arrays, and each rank's results (rank 0's arrays, the
    gathered leaves both ranks hold)."""
    ref, ref_arrays, ranks = _tp_ranks.run_both(work, "train", DEADLINE_S)
    return ref, ref_arrays, [r for r, _ in ranks], ranks[0][1]


def _ids(cases):
    return [C.train_key(*c) for c in cases]


def _leaves_of(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


def _f32_close(got: dict, want: dict) -> None:
    assert set(got) == set(want) and want
    for name, w in want.items():
        tol = 1e-4 * np.abs(w).max() + 1e-6
        np.testing.assert_allclose(got[name], w, rtol=0, atol=tol, err_msg=name)


def _bf16_close(got: dict, want: dict) -> None:
    assert set(got) == set(want) and want
    for name, w in want.items():
        assert np.isfinite(got[name]).all(), name
        rel = np.linalg.norm(got[name] - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= 5e-2, (name, rel)


def _rel_close(got, want, rtol) -> None:
    assert len(got) == len(want) and len(want)
    for g, w in zip(got, want):
        assert math.isfinite(g) and abs(g - w) <= rtol * abs(w), (got, want)


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
def test_step1_loss_and_gradients_in_the_reference_bf16_band(runs, case):
    ref, ref_arrays, ranks, arrays = runs
    key = C.train_key(*case)
    for r in ranks:
        _rel_close(r[f"{key} mesh losses1"], ref[f"{key} losses1"], 1e-2)
    _bf16_close(_leaves_of(arrays, f"{key} mesh grad "), _leaves_of(ref_arrays, f"{key} grad "))


# ------------------------------------------------ the port against itself
@pytest.mark.parametrize("case", C.TRAIN_CASES, ids=_ids(C.TRAIN_CASES))
def test_mesh_matches_the_port_on_one_device(runs, case):
    _, _, ranks, arrays = runs
    key = C.train_key(*case)
    f32 = case[2] == "f32"
    _rel_close(ranks[0][f"{key} mesh losses1"], ranks[0][f"{key} one losses1"],
               1e-5 if f32 else 1e-2)
    got, want = _leaves_of(arrays, f"{key} mesh grad "), _leaves_of(arrays, f"{key} one grad ")
    (_f32_close if f32 else _bf16_close)(got, want)
    if f32:
        _rel_close(ranks[0][f"{key} mesh losses"], ranks[0][f"{key} one losses"], 1e-4)
        got, want = _leaves_of(arrays, f"{key} mesh param "), _leaves_of(arrays, f"{key} one param ")
        assert set(got) == set(want) and want
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, rtol=2e-2, atol=2e-3, err_msg=name)


@pytest.mark.parametrize("case", C.TRAIN_CASES, ids=_ids(C.TRAIN_CASES))
def test_every_rank_holds_half_and_logs_the_same_losses(runs, case):
    _, _, ranks, _ = runs
    key = C.train_key(*case)
    name, _, dtype = case
    cfg = get_config(C.ARCH).reduced(**(C.GQA if name == "gqa" else {}))
    width = 4 if dtype == "f32" else 2
    whole = sum(math.prod(l.shape) for _, l in leaves(Model(cfg).describe()))
    for r in ranks:
        assert 0.45 < r[f"{key} param bytes"] / (width * whole) < 0.55, r[f"{key} param bytes"]
        assert 0.45 < r[f"{key} moment bytes"] / (2 * 4 * whole) < 0.55
    for metric in ("losses1", "losses"):
        if f"{key} mesh {metric}" in ranks[0]:
            assert ranks[0][f"{key} mesh {metric}"] == ranks[1][f"{key} mesh {metric}"]


@pytest.mark.parametrize("mesh", C.TRAIN_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_two_microbatches_against_one_on_a_mesh(runs, mesh):
    _, _, _, arrays = runs
    key = C.train_key("qwen", mesh, "bf16")
    one, two = (_leaves_of(arrays, f"{key} micro{m} param ") for m in (1, 2))
    assert set(one) == set(two) and one
    for name, w in one.items():
        np.testing.assert_allclose(two[name], w, rtol=2e-2, atol=2e-3, err_msg=name)


# ------------------------------------------------------ crash and restore
def test_crash_restart_on_a_mesh_is_bit_identical(runs):
    _, _, ranks, arrays = runs
    for r in ranks:
        assert r["crashed"] and "step 2" in r["crashed"] and r["resumed at"] == 2
    assert ranks[0]["resumed losses"] == ranks[1]["resumed losses"]
    resumed = _leaves_of(arrays, "resumed params.")
    clean = _leaves_of(arrays, "clean params.")
    assert set(resumed) == set(clean) and resumed
    for name, w in clean.items():
        assert np.array_equal(resumed[name], w), name


def _written(arrays) -> dict:
    """The resumed run's gathered leaves, which its last checkpoint holds,
    keyed as the checkpoint keys them."""
    return {k.replace(".", "/"): v for k, v in _leaves_of(arrays, "resumed ").items()}


@pytest.mark.parametrize("onto", ["1x2 mesh", "one device", "reference"])
def test_checkpoint_from_one_mesh_restores_bit_equal(runs, work, onto):
    _, _, ranks, arrays = runs
    want = _written(arrays)
    cfg = get_config(C.ARCH).reduced()
    if onto == "1x2 mesh":
        got = {k.replace(".", "/"): v for k, v in _leaves_of(arrays, "restored 1x2 ").items()}
        for r in ranks:
            assert r["restored 1x2 step"] == 4
            wq = r["restored 1x2 local shapes"]["params.blocks.attn.wq"]
            assert wq == [cfg.num_layers, cfg.d_model, cfg.num_heads * cfg.head_dim // 2]
    elif onto == "one device":
        desc = Model(cfg).describe()
        tree, step, _ = ck.restore(work / "ckpt", {"params": desc,
                                                   "opt": describe_opt_state(desc)})
        assert step == 4
        got = {n.replace(".", "/"): t.float().numpy() for n, t in flatten_tree(tree)}
    else:
        jdesc = JaxModel(_jax_cfg()).describe()
        tree, step, _ = jax_ck.restore(work / "ckpt", {
            "params": jax_abstract(jdesc), "opt": jax_abstract(jax_describe_opt(jdesc))})
        assert step == 4
        got = {n.replace(".", "/"): np.asarray(t, np.float32) for n, t in _jax_flat(tree)}
    assert set(got) == set(want) and want
    for name, w in want.items():
        assert np.array_equal(got[name], w), name


def _jax_cfg():
    from repro.configs import get_config as jax_get_config

    return jax_get_config(C.ARCH).reduced()


def _jax_flat(tree, prefix: str = ""):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _jax_flat(tree[key], f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", tree[key]


# ------------------------------------------------------------ what raises
def test_no_functional_collective_is_reached_in_a_backward(runs):
    _, _, ranks, _ = runs
    for r in ranks:
        got = r["functional collective in a backward"]
        assert got["DTensor.from_local"].startswith("RuntimeError") \
            and "reached funcol" in got["DTensor.from_local"], got
        assert got["place_block"] < 1e-5, got


def test_a_microbatch_that_data_does_not_divide_raises(runs):
    _, _, ranks, _ = runs
    for r in ranks:
        assert r["indivisible batch"] and "not divisible" in r["indivisible batch"]


# --------------------------------------------- the embedding's gradient
def test_embedding_gradient_sums_repeated_tokens_in_f32():
    """A token that fills most of a batch: ``Model.loss``'s embedding
    gradient is the f32 sum of the rows' gradients rounded once to bf16.
    Autograd's own lookup adds the duplicates into the bf16 gradient one by
    one and stalls (all-ones rows sum to 256, not 1000): on the card
    full-width qwen's embedding gradient came out 0.13 off the exact one."""
    from repro_torch.dist.local import lookup_rows

    table = torch.zeros(8, 4, dtype=torch.bfloat16, requires_grad=True)
    idx = torch.full((1000,), 3)
    (plain,) = torch.autograd.grad(table[idx].float().sum(), table)
    (summed,) = torch.autograd.grad(lookup_rows(table, idx).float().sum(), table)
    assert plain[3].tolist() == [256.0] * 4
    assert summed[3].tolist() == [1000.0] * 4 and summed.dtype == torch.bfloat16

    cfg = get_config(C.ARCH).reduced()
    params = _materialized(cfg)
    tokens = torch.full((4, 257), 7, dtype=torch.long)
    tokens[:, ::5] = 11
    for _, t in flatten_tree(params):
        t.requires_grad_(True)
    model = Model(cfg, params)
    loss, _ = model.loss({"tokens": tokens})
    (got,) = torch.autograd.grad(loss, params["embed"])
    # the exact sum: the gradient at the lookup's output, summed in f32
    x = params["embed"].detach()[tokens[:, :-1]].requires_grad_(True)
    h, _, _ = model.sequence(x, torch.arange(256)[None, :])
    logits = model._logits(h)
    labels = tokens[:, 1:]
    ce = (torch.logsumexp(logits, -1) - torch.gather(logits, -1, labels[..., None])[..., 0]).mean()
    (gx,) = torch.autograd.grad(ce, x)
    exact = torch.zeros(params["embed"].shape).index_add_(
        0, tokens[:, :-1].reshape(-1), gx.reshape(-1, cfg.d_model).float())
    for row in (7, 11):
        np.testing.assert_allclose(got[row].float().numpy(), exact[row].numpy(),
                                   rtol=2**-7, atol=1e-6 * exact[row].abs().max().item())


def _materialized(cfg) -> dict:
    from repro_torch.models import materialize

    return materialize(Model(cfg).describe(), seed=0)
