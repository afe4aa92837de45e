"""The port's training loss against the JAX reference at reduced size:
``Model.loss`` and the gradient of every parameter leaf, held against
``jax.value_and_grad`` of the reference's ``Model.loss`` on the same
weights (``materialize(seed=0)`` in the reference, carried across leaf for
leaf) and the same tokens (numpy, seed 0).

In f32 (qwen, dbrx with its nonzero MoE aux loss, mamba2) the two
compute the same function in the same type: the loss within 1e-5
relative, each leaf's gradient within 1e-4 x its largest magnitude plus
1e-6. In bf16 (those three and gemma2, zamba2, whisper, internvl2) the
reference's compiled forward keeps f32 between fused ops where the port
rounds op by op (tests/test_torch_model.py), and its bf16 reductions
accumulate in bf16: the loss within 1e-2 relative, each leaf's gradient
within 5e-2 relative Frobenius error. whisper runs in bf16 only: the
reference's encoder refuses f32 weights (ROADMAP §3). On the CPU every
attention layer runs the plain ``blockwise_attention`` and mamba's scan
``ssd_reference``; the card's kernels are held to those in
``tests/test_torch_kernels_on_card.py`` and ``chip_smoke.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import materialize as jax_materialize
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models.params import _from_numpy, flatten_tree

B, S = 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU: one intra-op thread per process keeps
    torch from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_torch(tree) -> dict:
    return {k: _to_torch(v) if isinstance(v, dict) else _from_numpy(np.asarray(v))
            for k, v in tree.items()}


def loss_case(arch: str, f32: bool):
    """Both models on the same weights and batch: returns the reference's
    loss, aux and flat f32 grads, and the port's, with leaf names."""
    cfg = get_config(arch).reduced()
    jmodel = JaxModel(jax_get_config(arch).reduced())
    jparams = jax_materialize(jmodel.describe(), seed=0)
    if f32:
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    params = _to_torch(jax.tree.map(np.asarray, jparams))
    for _, t in flatten_tree(params):
        t.requires_grad_(True)
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    jbatch, batch = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.from_numpy(tokens)}
    extra = {"vlm": ("image_embeds", cfg.num_image_tokens),
             "encdec": ("frames", cfg.encoder_seq)}.get(cfg.family)
    if extra:
        name, n = extra
        x = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
        jbatch[name], batch[name] = jnp.asarray(x), torch.from_numpy(x)

    (jloss, jaux), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(jparams, jbatch)
    loss, aux = Model(cfg, params).loss(batch)
    names = [n for n, _ in flatten_tree(params)]
    grads = torch.autograd.grad(loss, [t for _, t in flatten_tree(params)])
    want = {n: np.asarray(jnp.asarray(g, jnp.float32))
            for n, g in flatten_tree(jax.tree.map(np.asarray, jgrads))}
    got = {n: g.float().numpy() for n, g in zip(names, grads)}
    return (float(jloss), float(jaux["aux"]), want), (loss.item(), aux["aux"].item(), got)


F32_ARCHS = ["qwen1.5-0.5b", "dbrx-132b", "mamba2-2.7b"]
BF16_ARCHS = F32_ARCHS + ["gemma2-9b", "zamba2-2.7b", "whisper-medium", "internvl2-26b"]


@pytest.mark.parametrize("arch", F32_ARCHS)
def test_loss_and_every_gradient_match_the_reference_in_f32(arch):
    (jloss, jaux, want), (loss, aux, got) = loss_case(arch, f32=True)
    assert np.isfinite(loss)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    assert abs(aux - jaux) <= 1e-5 * max(abs(jaux), 1e-30)
    if arch == "dbrx-132b":
        assert aux > 0
    assert set(got) == set(want)
    for name, w in want.items():
        tol = 1e-4 * np.abs(w).max() + 1e-6
        np.testing.assert_allclose(got[name], w, rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_loss_and_every_gradient_match_the_reference_in_bf16(arch):
    (jloss, _, want), (loss, _, got) = loss_case(arch, f32=False)
    assert np.isfinite(loss)
    assert abs(loss - jloss) <= 1e-2 * abs(jloss)
    assert set(got) == set(want)
    for name, w in want.items():
        assert np.isfinite(got[name]).all(), name
        rel = np.linalg.norm(got[name] - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= 5e-2, (name, rel)
