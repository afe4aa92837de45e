"""The rest of the port's paged serving on a ``(1, 2)`` mesh, against the
reference on two XLA CPU devices: the int8 page formats, the dense-slot
engine and the MoE family.

Both sides start together once per module (``_tp_ranks.run_both`` with the
``serving`` suite): the port as two ``gloo`` ranks in spawned processes,
the reference in a subprocess of its own that sets ``XLA_FLAGS`` before
JAX is imported. Every test here reads them:

* **int8 scales over the whole page.** One page through each quantizing
  site of a pool that holds a rank's half of the KV heads (the prefill's
  scatter into an int8 pool, the decode commit's requantize, the int8
  offload's host copy): the two payload blocks side by side and each
  rank's scales are bit-equal to the reference's one-device
  ``quantize_pages`` / ``requantize_insert_run`` on the whole page.
* **The engines on the mesh** (``_tp_common.SERVING_ENGINES``): reduced
  qwen1.5-0.5b on int8 device pages (monolithic and chunked) and on dense
  slots with int8 offload; reduced dbrx-132b (4 query heads over 1 KV
  head: the KV fallback) and its 2-KV-head variant (KV sharded),
  monolithic and chunked; reduced arctic-480b (the dense residual). Greedy
  tokens equal to the reference engine's on the mesh or in the
  reference's bf16 tie set (for MoE within the model band of the tie: a
  top-k near-tie of the router turns an ulp into another expert, and the
  port and the reference already part so on one device,
  ``tests/test_torch_moe.py``); no graph captured. For qwen, each rank's
  blocks side by side within the bf16 model band of the reference's pool
  or slot caches (dequantized), wherever the KV comes from the same
  tokens on both sides; both ranks' scales equal.
* **The MoE layer alone** in f32, on DTensors, against the reference's
  ``apply_moe`` on two devices, on bit-equal inputs; each rank holds half
  of every expert weight's hidden dimension and the whole router, and no
  collective of a MoE engine moves as much as one expert weight block.
* **The router** over two replicas aliasing the mesh with int8 offload,
  pressure migration on and replica 1 failing and recovering: metrics and
  action streams equal to the reference's, offloads billed at the whole
  int8 page. (Under int8 offload this corpus migrates no page on either
  side: the drain finds none of replica 1's KV on the host.)
"""
from __future__ import annotations

import dataclasses
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest

import _tp_common as C
import _tp_ranks
from repro.configs import get_config as jax_get_config
from repro.kernels import kv_quant as jax_kv_quant
from repro.models import Model as JaxModel
from repro.models import materialize as jax_materialize
from repro_torch.configs import get_config
from repro_torch.kernels import kv_quant

#: the deadline of each side's processes
DEADLINE_S = 240
#: the bf16 model band (tests/test_torch_tp.py), for pools and slot caches
MODEL_ATOL, MODEL_RTOL = 2**-4, 2**-6
#: the MoE layer in f32 on the mesh against the reference's on the mesh:
#: only the order of f32 sums differs (the port reduces the two ranks'
#: partial sums after the combine product)
MOE_ATOL = MOE_RTOL = 1e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides of the serving suite, started together: the reference's
    results and pools, and each rank's results and arrays."""
    return _tp_ranks.run_both(tmp_path_factory.mktemp("tp_serving"), "serving", DEADLINE_S)


def _jax_cfg(name):
    arch, kw = C.SERVING_CONFIGS[name]
    return jax_get_config(arch).reduced(**kw)


def _side_by_side(blocks, heads_axis: int, divides: bool):
    """The ranks' blocks as the whole: side by side on the heads axis
    where the model axis shards the heads, else the one (equal) copy."""
    if not divides:
        np.testing.assert_array_equal(blocks[1], blocks[0])
        return blocks[0]
    return np.concatenate(blocks, axis=heads_axis)


# -------------------------------------------------------- int8 scales
def _bf16(a):
    return jnp.asarray(a, jnp.bfloat16)


def _ref_quant_sites() -> dict:
    """The reference's one-device quantizers on the whole page of each
    site, as ``_tp_ranks._quant_sites`` feeds them."""
    x = C.quant_inputs()
    L, T, KH, HD = (C.QUANT_SHAPE[k] for k in ("L", "T", "KH", "HD"))
    out = {}
    for name in ("k", "v"):
        run = jnp.pad(_bf16(x[name]), ((0, 0), (0, 2 * T - C.QUANT_RUN), (0, 0), (0, 0)))
        q, s = jax_kv_quant.quantize_pages(run.reshape(L, 2, T, KH, HD))
        out[f"prefill {name}"], out[f"prefill {name}_scale"] = q, s
        q2, s2 = jax_kv_quant.requantize_insert_run(
            q, s, jnp.asarray([1]), jnp.asarray(x["offset"]), _bf16(x[f"new_{name}"]))
        out[f"decode {name}"], out[f"decode {name}_scale"] = q2[:, 1], s2[:, 1]
        q1, s1 = jax_kv_quant.quantize_pages(_bf16(x[name][:, :T]))
        out[f"offload {name}"], out[f"offload {name}_scale"] = q1, s1
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("site", C.QUANT_SITES)
def test_int8_scales_on_a_mesh_are_the_whole_pages(runs, site):
    _, _, ranks = runs
    want = _ref_quant_sites()
    heads_axis = -2
    for name in ("k", "v"):
        blocks = [a[f"quant {site} {name}"] for _, a in ranks]
        got = np.concatenate(blocks, axis=heads_axis)
        # bit for bit: the same scale, the same rounding of every element
        np.testing.assert_array_equal(got, want[f"{site} {name}"])
        for _, a in ranks:
            np.testing.assert_array_equal(a[f"quant {site} {name}_scale"],
                                          want[f"{site} {name}_scale"])
    # the page's amax lies on rank 0's heads in layer 0 and rank 1's in
    # layer 1, so a rank's own max would have given another scale
    x = C.quant_inputs()["k"]
    n = C.QUANT_SHAPE["KH"] // 2
    own = [np.abs(x[:, :C.QUANT_SHAPE["T"], r * n:(r + 1) * n]).max(axis=(1, 2, 3))
           for r in range(2)]
    assert own[0][0] > own[1][0] and own[1][1] > own[0][1]


# -------------------------------------------------------------- engines
@functools.cache
def _jax_model(name: str):
    """The reference's model of configuration ``name`` and its seed-0
    weights (one device)."""
    jmodel = JaxModel(_jax_cfg(name))
    return jmodel, jax_materialize(jmodel.describe(), seed=0)


def _in_tie_set(name, ctx, tokens, ref_tokens):
    """Each port token equals the reference's or is in the tie set of the
    reference's bf16-rounded logits at the port's context (one device);
    for the MoE family within the model band of the largest."""
    jcfg = _jax_cfg(name)
    jmodel, jparams = _jax_model(name)
    cur = list(ctx)
    for tok, ref_tok in zip(tokens, ref_tokens):
        if tok != ref_tok:
            jlogits, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray([cur], jnp.int32)})
            rounded = np.asarray(jnp.asarray(jlogits[0], jnp.bfloat16).astype(jnp.float32))
            top = rounded.max()
            tie = MODEL_ATOL + MODEL_RTOL * abs(top) if jcfg.num_experts else 0.0
            assert top - rounded[tok] <= tie, (tok, ref_tok, float(top - rounded[tok]), tie)
        cur.append(tok)


def _kv_divides(name) -> bool:
    return _jax_cfg(name).num_kv_heads % 2 == 0


@pytest.mark.parametrize("key", list(C.SERVING_ENGINES))
def test_engine_tokens_on_a_mesh_match_reference(runs, key):
    ref, _, ranks = runs
    name = C.SERVING_ENGINES[key][0]
    want = ref[key]
    ctxs = C.contexts(_jax_cfg(name).vocab_size)
    for out, _ in ranks:
        got = out[key]
        assert got == ranks[0][0][key]          # every rank samples the same tokens
        assert set(got) == set(want)
        for pid in want:
            assert len(got[pid]) == len(want[pid]) == C.NEW_TOKENS
            _in_tie_set(name, ctxs[pid], got[pid], want[pid])
        assert out[f"{key} captured"] == 0
        assert out[f"{name} fallbacks"] == ref[f"{name} fallbacks"]


def _same_token_rows(ctx, got, want, rows, ref_rows, page_tokens):
    """The device pages (paged) or slot positions (dense slots) whose KV
    both sides computed from the same tokens: the positions before the
    first token at which the port's stream parts from the reference's."""
    first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), len(got) - 1)
    n_same = len(ctx) + first
    assert rows["slot"] == ref_rows["slot"]
    pages = []
    for j, (page, ref_page) in enumerate(zip(rows["pages"], ref_rows["pages"])):
        if (j + 1) * page_tokens <= n_same and page is not None:
            assert page == ref_page
            pages.append(page)
    return rows["slot"], n_same, pages


QWEN_ENGINES = [k for k, (name, _, _) in C.SERVING_ENGINES.items() if name == "qwen"]


@pytest.mark.parametrize("key", QWEN_ENGINES)
def test_engine_pools_on_a_mesh_match_reference(runs, key):
    ref, pools, ranks = runs
    kh = _jax_cfg("qwen").num_kv_heads
    assert [out[f"{key} pool heads"] for out, _ in ranks] == [kh // 2] * 2
    got = {kv: _side_by_side([a[f"{key} {kv}"] for _, a in ranks], 3, True) for kv in ("k", "v")}
    ctxs = C.contexts(_jax_cfg("qwen").vocab_size)
    held = 0
    for pid, ctx in ctxs.items():
        slot, n_same, pages = _same_token_rows(
            ctx, ranks[0][0][key][pid], ref[key][pid], ranks[0][0][f"{key} rows"][pid],
            ref[f"{key} rows"][pid], C.ENGINE_KW["page_tokens"])
        for kv in ("k", "v"):
            want = pools[f"{key} {kv}"]
            assert got[kv].shape == want.shape
            if C.SERVING_ENGINES[key][1].get("dense_slots"):
                a, b = got[kv][:, slot, :n_same], want[:, slot, :n_same]
            else:
                a, b = got[kv][:, pages], want[:, pages]
            excess = np.abs(a - b) - (MODEL_ATOL + MODEL_RTOL * np.abs(b))
            assert excess.max() <= 0, (key, pid, kv, float(excess.max()))
            held += b.size
    assert held > 0


INT8_ENGINES = [k for k, (_, kw, _) in C.SERVING_ENGINES.items()
                if kw.get("offload_format") == "int8"]


@pytest.mark.parametrize("key", INT8_ENGINES)
def test_int8_engines_hold_one_scale_a_page_on_both_ranks(runs, key):
    ref, _, ranks = runs
    (a0, a1) = (a for _, a in ranks)
    names = [f"{key} {n}" for n in ("k_scale", "v_scale", "host_k_scale", "host_v_scale")
             if f"{key} {n}" in a0]
    assert f"{key} host_k_scale" in names
    assert (f"{key} k_scale" in names) == (key != "qwen dense_slots")
    for n in names:
        np.testing.assert_array_equal(a0[n], a1[n])
    # the engine moved pages to the host, billed at the whole int8 page
    out = ranks[0][0]
    assert out[f"{key} offloaded"] == ref[f"{key} offloaded"]
    if key == "qwen dense_slots":
        assert out[f"{key} offloaded"] > 0
        assert (a0[f"{key} host_k_scale"] != 1.0).any()


MOE_ENGINES = [k for k, (name, _, _) in C.SERVING_ENGINES.items() if name != "qwen"]


@pytest.mark.parametrize("key", MOE_ENGINES)
def test_moe_engines_hold_half_of_each_expert_and_gather_none(runs, key):
    _, _, ranks = runs
    name = C.SERVING_ENGINES[key][0]
    cfg = _jax_cfg(name)
    kh = cfg.num_kv_heads
    divides = _kv_divides(name)
    # the model axis shards the KV heads where it divides them; else each
    # rank's pool holds them all, the same bits on both (the KV fallback)
    assert [out[f"{key} pool heads"] for out, _ in ranks] == [kh // 2 if divides else kh] * 2
    for kv in ("k", "v"):
        _side_by_side([a[f"{key} {kv}"] for _, a in ranks], 3, divides)
    for out, _ in ranks:
        shapes = out[f"{key} expert weights"]
        (whole, local) = shapes["router"]
        assert whole == local == [cfg.num_layers, cfg.d_model, cfg.num_experts]
        for n, f_dim in (("w_gate", 3), ("w_up", 3), ("w_down", 2)):
            whole, local = shapes[n]
            assert local[f_dim] * 2 == whole[f_dim] == cfg.moe_d_ff
            assert [d for i, d in enumerate(local) if i != f_dim] == [
                d for i, d in enumerate(whole) if i != f_dim]
        # no collective moves as many elements as one expert's block of one
        # layer's weight (the experts are never gathered)
        block = cfg.d_model * cfg.moe_d_ff // 2
        moved = out[f"{key} collectives"]
        assert moved and max(moved) < block, (max(moved), block)


@pytest.mark.parametrize("case", C.MOE_CASES, ids=[f"{c[0]} B{c[1]} S{c[2]}" for c in C.MOE_CASES])
def test_moe_layer_on_dtensors_matches_reference_on_the_mesh(runs, case):
    _, pools, ranks = runs
    want = pools[f"moe {case}"]
    for _, arrays in ranks:
        got = arrays[f"moe {case}"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=MOE_ATOL, rtol=MOE_RTOL)


# -------------------------------------------------------------- router
def test_router_replay_with_int8_offload_matches_reference(runs):
    ref, _, ranks = runs
    want = ref["router int8"]
    for out, _ in ranks:
        got = out["router int8"]
        assert got["metrics"] == want["metrics"]
        assert got["actions"] == want["actions"]
        assert got["lengths"] == want["lengths"] and got["steps"] == want["steps"]
    got = ranks[0][0]["router int8"]
    m = got["metrics"]
    assert m["offloaded_pages"] > 0 and m["reloaded_pages"] > 0
    assert m["drain_events"] == 1
    cfg = _jax_cfg("qwen")
    whole = kv_quant.page_wire_bytes(cfg.num_layers, C.ROUTER_ENGINE_KW["page_tokens"],
                                     cfg.num_kv_heads, cfg.head_dim, "int8")
    # the whole int8 page is billed (payload and one f32 scale a layer for
    # K and V), where a rank holds half of the payload
    assert got["host_page_bytes"] == whole
    assert m["offload_bytes"] == m["offloaded_pages"] * whole
    assert got["weights_shared"]
    # both ranks' host tiers hold the same scales, page for page
    assert got["host_scales"] == ranks[1][0]["router int8"]["host_scales"]
    assert any(s != 1.0 for rows in got["host_scales"][0] for s in rows)
    assert math.isclose(got["rank_page_bytes"] * 2, got["page_bytes"])


def test_configs_are_the_reference_configs():
    for name in C.SERVING_CONFIGS:
        arch, kw = C.SERVING_CONFIGS[name]
        assert dataclasses.asdict(get_config(arch).reduced(**kw)) == dataclasses.asdict(
            _jax_cfg(name))
