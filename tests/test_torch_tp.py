"""Tensor-parallel paged serving of the port on a ``(1, 2)`` mesh, against
the reference on two XLA CPU devices.

The port runs as two ``gloo`` ranks in spawned processes
(``tests/_tp_ranks.py``); the reference runs in a subprocess of its own
that sets ``XLA_FLAGS`` before JAX is imported (``tests/_tp_reference.py``).
Both start together once per module and are read by every test here:

* the kernel entry points (``paged_attention_decode``,
  ``prefill_attention``) on DTensors under ``local_map`` (on the CPU their
  plain versions) against the reference's ``paged_attention_ref`` and
  ``blockwise_attention`` on the same inputs, within the reference's
  kernel bands, including a GQA layout (6 query heads over 3 KV heads)
  whose KV heads the model axis does not divide;
* ``Engine(placement=...)`` on the mesh, monolithic and chunked, for
  reduced qwen1.5-0.5b (seed-0 weights carried across with
  ``load_jax_params``) and its GQA 6/3 variant: greedy tokens equal to
  the reference engine's or in the reference's bf16 tie set, each rank's
  pool holding its block of the KV heads, the blocks side by side within
  the bf16 model band of the reference's pool, no graph captured;
* ``MoriRouter.replay`` over two replicas aliasing the mesh, with
  pressure migration on and replica 1 failing and recovering: metrics
  (but the wall clock) and action streams equal to the reference's,
  pages offloaded, reloaded and migrated;
* the refusals that remain on a mesh (a data axis, the vlm family,
  ``Trainer`` for a family other than dense), each naming ROADMAP. Dense slots, int8 pages and the MoE
  family on the mesh are ``tests/test_torch_tp_serving.py``'s.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _tp_common as C
import _tp_ranks
from repro.configs import get_config as jax_get_config
from repro.kernels.paged_attention.ref import paged_attention_ref
from repro.models import Model as JaxModel
from repro.models import materialize as jax_materialize
from repro.models.layers import blockwise_attention as jax_blockwise_attention
from repro_torch.configs import get_config
from repro_torch.dist import make_replica_set
from repro_torch.launch.mesh import Mesh
from repro_torch.models import Model, materialize
from repro_torch.serving import Engine
from repro_torch.train.data import DataConfig
from repro_torch.train.loop import TrainConfig, Trainer

HERE = Path(__file__).resolve().parent
CPU = torch.device("cpu")
#: the deadline of each side's processes
DEADLINE_S = 180
#: the reference's kernel band in bf16 (tests/test_kernels.py tol())
KERNEL_BAND = dict(rtol=2e-2, atol=2e-2)
MODEL_ATOL, MODEL_RTOL = 2**-4, 2**-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides, started together: the reference's results and pools,
    and each rank's results and arrays."""
    return _tp_ranks.run_both(tmp_path_factory.mktemp("tp"), "tp", DEADLINE_S)


# ------------------------------------------------------------- kernels
def _ref_kernels(case) -> dict:
    x = C.kernel_inputs(case)
    bf = {k: jnp.asarray(v, jnp.bfloat16) for k, v in x.items() if v.dtype == np.float32}
    B = x["q"].shape[0]
    pos = x["lengths"] - 1
    tail = x["tables"][np.arange(B), pos // C.PAGE_TOKENS]
    k_pages = bf["k_pages"].at[tail, pos % C.PAGE_TOKENS].set(bf["k_new"])
    v_pages = bf["v_pages"].at[tail, pos % C.PAGE_TOKENS].set(bf["v_new"])
    paged = paged_attention_ref(bf["q"], k_pages, v_pages, jnp.asarray(x["tables"]),
                                jnp.asarray(x["lengths"]))
    prefill = jax_blockwise_attention(bf["pq"], bf["pk"], bf["pv"], causal=True,
                                      q_offset=C.PREFIX_S, kv_hole=(C.PREFIX_S - 4, C.PREFIX_S))
    return {"paged": np.asarray(paged, np.float32), "prefill": np.asarray(prefill, np.float32)}


@pytest.mark.parametrize("case", C.KERNEL_CASES, ids=[c[0] for c in C.KERNEL_CASES])
@pytest.mark.parametrize("kernel", ["paged", "prefill"])
def test_kernels_under_local_map_match_reference(runs, case, kernel):
    _, _, ranks = runs
    want = _ref_kernels(case)[kernel]
    for _, arrays in ranks:
        np.testing.assert_allclose(arrays[f"kernel {case[0]} {kernel}"], want, **KERNEL_BAND)
    if kernel == "paged":
        # each rank ran its own half of the query heads
        assert [int(a[f"kernel {case[0]} paged local heads"]) for _, a in ranks] == [
            case[2] // 2] * 2


# -------------------------------------------------------------- engine
def _in_tie_set(cfg_name, ctx, tokens, ref_tokens):
    """Each port token equals the reference's or is in the tie set of the
    reference's bf16-rounded logits at the port's context (one device)."""
    jcfg = _jax_cfg(cfg_name)
    jmodel = JaxModel(jcfg)
    jparams = jax_materialize(jmodel.describe(), seed=0)
    cur = list(ctx)
    for tok, ref_tok in zip(tokens, ref_tokens):
        if tok != ref_tok:
            jlogits, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray([cur], jnp.int32)})
            rounded = np.asarray(jnp.asarray(jlogits[0], jnp.bfloat16).astype(jnp.float32))
            assert rounded[tok] == rounded.max(), (tok, ref_tok)
        cur.append(tok)


def _jax_cfg(name):
    cfg = jax_get_config(C.ARCH).reduced()
    return cfg if name == "qwen" else dataclasses.replace(cfg, **C.GQA)


ENGINE_RUNS = [f"{n} {m}" for n in ("qwen", "gqa") for m in ("monolithic", "chunked")]


@pytest.mark.parametrize("key", ENGINE_RUNS)
def test_sharded_engine_tokens_match_reference(runs, key):
    ref, _, ranks = runs
    want = ref[key]
    ctxs = C.contexts(get_config(C.ARCH).reduced().vocab_size)
    for out, _ in ranks:
        got = out[key]
        assert got == ranks[0][0][key]          # every rank samples the same tokens
        assert set(got) == set(want)
        for pid in want:
            assert len(got[pid]) == len(want[pid]) == C.NEW_TOKENS
            _in_tie_set(key.split()[0], ctxs[pid], got[pid], want[pid])
        assert out[f"{key} captured"] == 0


@pytest.mark.parametrize("key", ENGINE_RUNS)
def test_sharded_engine_pools_match_reference(runs, key):
    ref, pools, ranks = runs
    name = key.split()[0]
    kh = (get_config(C.ARCH).reduced().num_kv_heads if name == "qwen"
          else C.GQA["num_kv_heads"])
    divides = kh % 2 == 0
    # the model axis shards the KV heads where it divides them; else
    # every rank holds them all (the rules' recorded fallback)
    assert [out[f"{key} pool heads"] for out, _ in ranks] == [kh // 2 if divides else kh] * 2
    assert ref[f"{name} fallbacks"] == ranks[0][0][f"{name} fallbacks"]
    for kv in ("k", "v"):
        want = pools[f"{key} {kv}"]
        blocks = [arrays[f"{key} {kv}"] for _, arrays in ranks]
        got = np.concatenate(blocks, axis=3) if divides else blocks[0]
        if not divides:
            np.testing.assert_array_equal(blocks[1], blocks[0])
        assert got.shape == want.shape
        excess = np.abs(got - want) - (MODEL_ATOL + MODEL_RTOL * np.abs(want))
        assert excess.max() <= 0, (key, kv, float(excess.max()))


def test_sharded_engine_in_f32_matches_one_device_to_rounding(runs):
    # in bf16 the sharded engine's own roundings differ from one device's
    # (its partial sums are reduced, in f32, then rounded); in f32 only the
    # order of f32 sums does
    _, _, ranks = runs
    for out, _ in ranks:
        f = out["f32"]
        assert f["prefill_max_abs_diff"] <= 1e-5 * f["prefill_max_abs"], f
        assert f["tokens_equal"]


# -------------------------------------------------------------- router
def test_router_replay_over_aliased_sharded_replicas_matches_reference(runs):
    ref, _, ranks = runs
    want = ref["router"]
    for out, _ in ranks:
        got = out["router"]
        assert got["metrics"] == want["metrics"]
        assert got["actions"] == want["actions"]
        assert got["lengths"] == want["lengths"] and got["steps"] == want["steps"]
    got = ranks[0][0]["router"]["metrics"]
    assert got["offloaded_pages"] > 0 and got["reloaded_pages"] > 0
    # replica 1's failure migrates its programs' pages to replica 0
    assert got["drain_events"] == 1 and got["migrated_pages"] > 0
    got = ranks[0][0]["router"]
    assert got["weights_shared"]
    # the router bills the whole page; a rank holds half of it
    assert got["page_bytes"] == 2 * got["rank_page_bytes"]


def test_one_device_path_imports_no_dtensor_and_makes_no_process_group():
    code = (
        "import sys, torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.dist import make_replica_set\n"
        "from repro_torch.models import Model, materialize\n"
        "from repro_torch.serving import Engine, EngineRequest\n"
        "cfg = get_config('qwen1.5-0.5b').reduced()\n"
        "rs = make_replica_set(2, devices=[torch.device('cpu')], num_kv_heads=cfg.num_kv_heads)\n"
        "params = materialize(Model(cfg).describe(), seed=0)\n"
        "for p in rs:\n"
        "    e = Engine(cfg, params, placement=p, page_tokens=8, n_device_pages=16,\n"
        "               n_host_pages=8, max_slots=1, max_seq=64)\n"
        "    e.submit(EngineRequest('a', [3, 4, 5, 6, 7], max_new_tokens=3))\n"
        "    e.run_to_completion()\n"
        "import torch.distributed as dist\n"
        "print(sorted(m for m in sys.modules if m.startswith('torch.distributed.tensor')),\n"
        "      dist.is_initialized())\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": str(HERE.parent / "src")})
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[] False"


# ------------------------------------------------------------ refusals
def _placement(shape):
    return make_replica_set(1, mesh_shape=shape, devices=[CPU] * 2,
                            num_kv_heads=4).placement(0)


@pytest.mark.parametrize("what", ["data axis"])
def test_engine_refuses_what_a_mesh_does_not_serve_yet(what):
    # an engine on a mesh serves every family it serves at all (vlm:
    # tests/test_torch_tp_families.py), over a model axis alone
    cfg = get_config(C.ARCH).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(cfg, materialize(Model(cfg).describe(), seed=0), placement=_placement((2, 1)),
               **C.ENGINE_KW)


def test_trainer_refuses_a_mesh():
    # every family trains on a mesh (tests/test_torch_tp_train*.py,
    # tests/test_torch_tp_families.py) but moe on a "pod" axis of more
    # than one device, which refuses before any process group is asked for
    cfg = get_config("dbrx-132b").reduced()
    mesh = Mesh(("pod", "data", "model"), np.array([CPU, CPU], dtype=object).reshape(2, 1, 1))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(cfg, TrainConfig(), DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                               global_batch=2), mesh=mesh)
