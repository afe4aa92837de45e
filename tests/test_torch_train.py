"""The port's training substrate against the JAX reference: the token
pipeline (bit-identical batches), AdamW (the reference's arithmetic on the
same numpy inputs), checkpoints (the reference's format: each package
restores the other's), and the trainer's own guarantees as
``tests/test_train.py`` states them for the reference (the loss falls,
M microbatches equal one batch, a crash-restart retraces the run bit for
bit on the CPU), plus what the port adds: remat leaves the gradients as
they are, a gradient reaches the stacked leaves through the attention
wrapper, and the entry points raise without a card unless asked for the
CPU. ``Model.loss`` itself is held against the reference in
``tests/test_torch_loss.py``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models.params import abstract as jax_abstract
from repro.train import checkpoint as jax_ck
from repro.train.data import DataConfig as JaxDataConfig
from repro.train.data import TokenPipeline as JaxTokenPipeline
from repro.train.optimizer import adamw_update as jax_adamw
from repro.train.optimizer import describe_opt_state as jax_describe_opt
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import Model, materialize
from repro_torch.models import layers
from repro_torch.models import model as model_mod
from repro_torch.models.params import _from_numpy, flatten_tree, leaves
from repro_torch.train import checkpoint as ck
from repro_torch.train.data import DataConfig, TokenPipeline
from repro_torch.train.loop import FaultInjector, TrainConfig, Trainer
from repro_torch.train.optimizer import adamw_update, describe_opt_state

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU: one intra-op thread per process keeps
    torch from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bits(x) -> np.ndarray:
    """Raw bits of a tensor or array: bf16 as int16, anything else as is."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("vocab,seq,batch,seed,mean_doc", [
    (128, 32, 4, 0, 512), (50, 16, 6, 3, 8), (151936, 64, 2, 7, 40)])
def test_token_pipeline_is_bit_identical_to_the_reference(vocab, seq, batch, seed, mean_doc):
    mine = TokenPipeline(DataConfig(vocab, seq, batch, seed, mean_doc))
    ref = JaxTokenPipeline(JaxDataConfig(vocab, seq, batch, seed, mean_doc))
    for step in (0, 1, 7, 1000):
        for hosts in (1, 2):
            for host in range(hosts):
                got = mine.batch_at(step, host_id=host, num_hosts=hosts)["tokens"]
                want = ref.batch_at(step, host_id=host, num_hosts=hosts)["tokens"]
                assert got.dtype == want.dtype == np.int32
                np.testing.assert_array_equal(got, want)
    for _, (step, got), (ref_step, want) in zip(range(3), mine.batches(5), ref.batches(5)):
        assert step == ref_step
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_token_pipeline_shape_range_and_steps_differ():
    p = TokenPipeline(DataConfig(vocab_size=50, seq_len=16, global_batch=3))
    t = p.batch_at(0)["tokens"]
    assert t.shape == (3, 17) and t.min() >= 0 and t.max() < 50
    assert not np.array_equal(t, p.batch_at(1)["tokens"])


# -------------------------------------------------------------- optimizer
def _opt_inputs(seed: int, pdt, bf16_moments: bool, count: int):
    rng = np.random.default_rng(seed)
    shapes = {"w": (64, 96), "b": (96,), "blocks": {"wq": (3, 16, 24)}}

    def draw(scale, positive=False):
        def one(shape):
            a = rng.standard_normal(shape).astype(np.float32) * scale
            return np.abs(a) if positive else a
        return jax.tree.map(one, shapes, is_leaf=lambda s: isinstance(s, tuple))

    mdt = jnp.bfloat16 if bf16_moments else jnp.float32
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(pdt), draw(0.05))
    jg = jax.tree.map(lambda a: jnp.asarray(a).astype(pdt), draw(1e-3))
    jm = jax.tree.map(lambda a: jnp.asarray(a).astype(mdt), draw(1e-3))
    jv = jax.tree.map(lambda a: jnp.asarray(a).astype(mdt), draw(1e-6, positive=True))
    return jp, jg, {"m": jm, "v": jv, "count": jnp.asarray(count, jnp.int32)}


def _torch_tree(tree):
    return jax.tree.map(lambda a: _from_numpy(np.asarray(a)), tree)


@pytest.mark.parametrize("count", [0, 1, 41])
@pytest.mark.parametrize("pdt,bf16_moments", [(jnp.bfloat16, False), (jnp.float32, False),
                                              (jnp.bfloat16, True)],
                         ids=["bf16", "f32", "bf16_moments"])
def test_adamw_matches_the_reference(pdt, bf16_moments, count):
    jp, jg, jopt = _opt_inputs(count, pdt, bf16_moments, count)
    want_p, want_opt = jax_adamw(jg, jopt, jp, lr=1e-3)
    params, grads, opt = _torch_tree(jp), _torch_tree(jg), _torch_tree(jopt)
    got_p, got_opt = adamw_update(grads, opt, params, lr=1e-3)
    assert got_p is params and got_opt is opt           # in place
    assert int(opt["count"]) == int(want_opt["count"]) == count + 1
    for (name, got), (_, want) in zip(flatten_tree(params), flatten_tree(want_p)):
        assert got.dtype == {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}[pdt]
        if pdt == jnp.bfloat16:
            np.testing.assert_array_equal(bits(got), bits(want), err_msg=name)
        else:
            np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want), maxulp=1)
    for key in ("m", "v"):
        for (name, got), (_, want) in zip(flatten_tree(opt[key]), flatten_tree(want_opt[key])):
            np.testing.assert_array_equal(bits(got), bits(want), err_msg=f"{key}.{name}")


@pytest.mark.parametrize("pdt,bf16_moments", [(jnp.bfloat16, False), (jnp.float32, False),
                                              (jnp.bfloat16, True)],
                         ids=["bf16", "f32", "bf16_moments"])
def test_adamw_in_pieces_gives_the_bits_of_the_whole(monkeypatch, pdt, bf16_moments):
    """A leaf larger than ``_CHUNK_ELEMENTS`` is updated a slice range at
    a time (to bound the f32 temporaries on the card); the update is
    elementwise, so the pieces give the whole leaf's bits."""
    from repro_torch.train import optimizer

    jp, jg, jopt = _opt_inputs(5, pdt, bf16_moments, 3)
    runs = []
    for limit in (optimizer._CHUNK_ELEMENTS, 100):
        monkeypatch.setattr(optimizer, "_CHUNK_ELEMENTS", limit)
        params, grads, opt = _torch_tree(jp), _torch_tree(jg), _torch_tree(jopt)
        adamw_update(grads, opt, params, lr=1e-3)
        runs.append(flatten_tree({"p": params, "m": opt["m"], "v": opt["v"]}))
    assert len(optimizer._chunks(torch.zeros(3, 16, 24))) == 3      # 384 per slice > 100
    assert len(optimizer._chunks(torch.zeros(64, 96))) == 64
    for (name, whole), (_, pieces) in zip(*runs):
        np.testing.assert_array_equal(bits(pieces), bits(whole), err_msg=name)


def test_describe_opt_state_mirrors_the_reference():
    for bf16 in (False, True):
        cfg = get_config("qwen1.5-0.5b").reduced(bf16_moments=bf16)
        mine = dict(leaves(describe_opt_state(Model(cfg).describe(), bf16_moments=bf16)))
        ref = jax_describe_opt(JaxModel(jax_get_config("qwen1.5-0.5b").reduced()).describe(),
                               bf16_moments=bf16)
        want = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                ref, is_leaf=lambda x: hasattr(x, "axes"))[0]:
            want[".".join(str(p.key) for p in path)] = (tuple(leaf.shape), np.dtype(leaf.dtype).name)
        got = {n: (tuple(l.shape), str(l.dtype).removeprefix("torch.")) for n, l in mine.items()}
        assert got == want


# ------------------------------------------------------------- checkpoint
def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": {"a": torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))},
        "b": torch.arange(5, dtype=torch.int32),
        "h": torch.from_numpy(rng.standard_normal((3,)).astype(np.float32)).bfloat16(),
    }


def _equal(a, b):
    for (na, x), (nb, y) in zip(flatten_tree(a), flatten_tree(b)):
        assert na == nb and x.dtype == y.dtype
        np.testing.assert_array_equal(bits(x), bits(y))


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    ck.save(tmp_path, 10, t, extra={"k": 1})
    restored, step, extra = ck.restore(tmp_path, t)
    assert step == 10 and extra == {"k": 1}
    _equal(restored, t)


def test_checkpoint_latest_and_retention(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ck.save(tmp_path, s, _tree(), keep=2)
    assert ck.latest_step(tmp_path) == 5
    assert sorted(d.name for d in tmp_path.glob("step_*")) == ["step_00000004", "step_00000005"]


def test_checkpoint_corruption_falls_back(tmp_path):
    ck.save(tmp_path, 1, _tree(seed=1))
    ck.save(tmp_path, 2, _tree(seed=2))
    shard = tmp_path / "step_00000002" / "host00.npz"
    shard.write_bytes(shard.read_bytes()[:-20])
    restored, step, _ = ck.restore(tmp_path, _tree())
    assert step == 1
    _equal(restored, _tree(seed=1))


def test_checkpoint_crash_mid_write_leaves_old_intact(tmp_path):
    ck.save(tmp_path, 1, _tree(seed=1))
    (tmp_path / "step_00000002.tmp").mkdir()
    (tmp_path / "step_00000002.tmp" / "host00.npz").write_bytes(b"garbage")
    _, step, _ = ck.restore(tmp_path, _tree())
    assert step == 1


def test_checkpoint_crc_matches_manifest(tmp_path):
    d = ck.save(tmp_path, 3, _tree())
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["shards"]["host00.npz"] == zlib.crc32((d / "host00.npz").read_bytes())
    assert manifest["leaves"] == ["b", "h", "w/a"]


def _trainer(tmp_path=None, steps=4, micro=1, ckpt_every=0, seed=0, **cfg_over):
    cfg = get_config("qwen1.5-0.5b").reduced(**cfg_over)
    tcfg = TrainConfig(steps=steps, microbatches=micro, log_every=1, ckpt_every=ckpt_every,
                       ckpt_dir=str(tmp_path or ""), seed=seed)
    return Trainer(cfg, tcfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                         global_batch=4, seed=seed), device="cpu")


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A trainer state written by either package restores in the other,
    leaf for leaf and bit for bit (bf16 widened to f32 on disk)."""
    tr = _trainer()
    state = tr.init_state()
    state.opt["count"] += 3
    ck.save(tmp_path / "port", 3, {"params": state.params, "opt": state.opt},
            extra={"model": tr.cfg.name})
    jcfg = jax_get_config("qwen1.5-0.5b").reduced()
    jtree = {"params": jax_abstract(JaxModel(jcfg).describe()),
             "opt": jax_abstract(jax_describe_opt(JaxModel(jcfg).describe()))}
    jrestored, step, extra = jax_ck.restore(tmp_path / "port", jtree)
    assert step == 3 and extra == {"model": tr.cfg.name}
    want = {"params": state.params, "opt": state.opt}
    for (name, got), (_, mine) in zip(flatten_tree(jax.tree.map(np.asarray, jrestored)),
                                      flatten_tree(want)):
        np.testing.assert_array_equal(bits(got), bits(mine), err_msg=name)

    jax_ck.save(tmp_path / "ref", 5, jrestored, extra={"k": 2})
    back, step, extra = ck.restore(tmp_path / "ref", {"params": tr.param_tree,
                                                      "opt": tr.opt_tree})
    assert step == 5 and extra == {"k": 2}
    _equal(back, want)


# ---------------------------------------------------------------- trainer
def test_trainer_loss_decreases():
    tr = _trainer(steps=8)
    state = tr.run(tr.init_state())
    assert state.step == 8
    losses = [m["loss"] for m in tr.metrics]
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_grad_accumulation_matches_single_batch():
    """M microbatches of B/M must equal one batch of B (same tokens)."""
    tr1, tr2 = _trainer(steps=1, micro=1), _trainer(steps=1, micro=2)
    s1, s2 = tr1.run(tr1.init_state()), tr2.run(tr2.init_state())
    for (name, a), (_, b) in zip(flatten_tree(s1.params), flatten_tree(s2.params)):
        np.testing.assert_allclose(a.detach().float().numpy(), b.detach().float().numpy(),
                                   rtol=2e-2, atol=2e-3, err_msg=name)


def test_crash_restart_bit_identical(tmp_path):
    """Crash at step 2, restart, reach step 4: bit for bit the run that
    never crashed."""
    tr_a = _trainer(tmp_path / "a", steps=4, ckpt_every=1)
    with pytest.raises(RuntimeError):
        tr_a.run(tr_a.resume_or_init(), FaultInjector(fail_at=(2,)))
    tr_a2 = _trainer(tmp_path / "a", steps=4, ckpt_every=1)
    resumed = tr_a2.resume_or_init()
    assert resumed.step == 2
    final_a = tr_a2.run(resumed)
    tr_b = _trainer(tmp_path / "b", steps=4)
    final_b = tr_b.run(tr_b.init_state())
    _equal({"params": final_a.params, "opt": final_a.opt},
           {"params": final_b.params, "opt": final_b.opt})


def test_restore_onto_the_device(tmp_path):
    tr = _trainer(tmp_path, steps=2, ckpt_every=2)
    tr.run(tr.init_state())
    state = _trainer(tmp_path, steps=2, ckpt_every=2).resume_or_init()
    assert state.step == 2 and int(state.opt["count"]) == 2
    for name, t in flatten_tree(state.params):
        assert t.device.type == "cpu" and t.requires_grad and torch.isfinite(t).all(), name


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "gemma2-9b", "zamba2-2.7b",
                                  "whisper-medium"])
def test_remat_leaves_the_gradients_as_they_are(arch):
    base = get_config(arch).reduced()
    params = materialize(Model(base).describe(), seed=0)
    for _, t in flatten_tree(params):
        t.requires_grad_(True)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(1, base.vocab_size, (2, 17)))}
    if base.family == "encdec":
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((2, base.encoder_seq, base.d_model)).astype(np.float32))
    out = []
    for remat in (False, True):
        model = Model(dataclasses.replace(base, remat=remat), params)
        loss, _ = model.loss(batch)
        out.append((loss, torch.autograd.grad(loss, [t for _, t in flatten_tree(params)])))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "gemma2-9b", "mamba2-2.7b", "zamba2-2.7b",
                                  "whisper-medium"])
def test_sequence_collects_no_cache_unless_asked(arch, monkeypatch):
    """``sequence(collect_cache=False)``, the loss's forward, returns the
    same hidden state and aux loss with no cache, and stacks no layer's
    cache on the way."""
    cfg = get_config(arch).reduced()
    model = Model(cfg, materialize(Model(cfg).describe(), seed=0))
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 16)))
    frames = None
    if cfg.family == "encdec":
        frames = torch.from_numpy(
            rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    x = model.params.embed[tokens]
    positions = torch.arange(16)[None, :]
    stacked = []
    real = model_mod._stack_layers
    monkeypatch.setattr(model_mod, "_stack_layers", lambda cols: stacked.append(1) or real(cols))
    with torch.no_grad():
        h1, cache, aux1 = model.sequence(x, positions, frames=frames, collect_cache=True)
        assert cache is not None and stacked
        stacked.clear()
        h0, none, aux0 = model.sequence(x, positions, frames=frames)
    assert none is None and not stacked
    assert torch.equal(h0, h1)
    assert float(aux0) == float(aux1)


def test_gradient_reaches_the_stacked_leaves_through_prefill_attention(monkeypatch):
    """The model is built before its leaves require grad (its cached layer
    views then carry none): the loss slices the stacked leaves itself, and
    every layer's ``blocks.attn.wq`` slice gets a gradient through
    ``prefill_attention``."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    params = materialize(Model(cfg).describe(), seed=0)
    model = Model(cfg, params)
    calls = []
    real = layers.prefill_attention

    def counted(q, *a, **kw):
        calls.append(q.requires_grad)
        return real(q, *a, **kw)

    monkeypatch.setattr(layers, "prefill_attention", counted)
    for _, t in flatten_tree(params):
        t.requires_grad_(True)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(1, cfg.vocab_size, (2, 17)))
    loss, _ = model.loss({"tokens": tokens})
    wq = params["blocks"]["attn"]["wq"]
    (g,) = torch.autograd.grad(loss, [wq])
    assert calls == [True] * cfg.num_layers
    assert torch.isfinite(g).all()
    assert all(g[l].abs().sum() > 0 for l in range(cfg.num_layers))
    assert flash_ops.KERNEL.backward_launches == 0    # the CPU takes the plain version


def test_trainer_and_launcher_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    cfg = get_config("qwen1.5-0.5b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, TrainConfig(steps=1))
    from repro_torch.launch import train as launch_train

    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--reduced", "--steps", "1", "--ckpt-every", "0"])
    # the H100 fleet's mesh is made of cards, whatever --device says
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--reduced", "--production-mesh", "--device", "cpu"])


def test_launcher_runs_on_the_cpu_in_a_subprocess(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--reduced",
         "--steps", "3", "--global-batch", "4", "--seq-len", "32", "--microbatches", "2",
         "--ckpt-every", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")},
    )
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[0] == ("training qwen1.5-0.5b from step 0 to 3 "
                        "on mesh {'data': 1, 'model': 1} (cpu)")
    assert lines[-1] == "done at step 3"
