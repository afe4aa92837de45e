"""The port's ``moe`` family against the JAX reference at reduced size.

Reduced dbrx-132b (pure MoE blocks, ``d_ff = 0``) and reduced arctic-480b
(an MoE layer beside a dense residual FFN), each at the reduced config's
dropless ``capacity_factor`` 8.0 and at the real 1.25, set with
``dataclasses.replace`` on both sides. Weights are the reference's
``materialize(seed=0)`` carried across with ``load_jax_params``.

What is held, from the layer up:

* ``apply_moe`` on bit-equal inputs: the chosen experts and the kept
  (token, k) entries equal the reference's (its own routing lines, run
  here in jnp), ``y`` in the model band, the aux loss close. Shapes cover
  a decode step (S = 1, one group per sequence), a prefill padded to its
  bucket (pad rows after the real ones enlarge the group and with it the
  capacity) and two sequences of one group each.
* At 1.25 entries really are dropped; at 8.0 none are.
* One block in sequence and in paged-decode mode: the model band of
  ``tests/test_torch_model.py``.
* ``Model.prefill`` and teacher-forced ``decode_paged`` with the weights
  held in f32 on both sides, at both capacities: logits to 1e-4, equal
  greedy tokens. In bf16 at 8.0: the band, widened to the reference's own
  spread between two routes to the same logits where that is larger
  (a top-k near-tie turns an ulp into another expert), greedy tokens in
  the reference's tie set.

The engine, the router and the launcher on these configs are held in
``tests/test_torch_moe_serving.py``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import materialize as jax_materialize
from repro.models.layers import apply_dense_block as jax_block
from repro.models.layers import apply_dense_block_paged as jax_block_paged
from repro.models.layers import apply_moe as jax_apply_moe
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import Model, layers, load_jax_params, materialize
from repro_torch.models.params import flatten_tree


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU: one intra-op thread per process keeps
    torch from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: the model band of tests/test_torch_model.py
ATOL, RTOL = 2**-4, 2**-6
ARCHS = ["dbrx-132b", "arctic-480b"]
CAPACITY = [8.0, 1.25]


def configs(arch: str, capacity: float):
    return (dataclasses.replace(get_config(arch).reduced(), capacity_factor=capacity),
            dataclasses.replace(jax_get_config(arch).reduced(), capacity_factor=capacity))


@pytest.fixture(scope="module", params=[(a, c) for a in ARCHS for c in CAPACITY],
                ids=lambda p: f"{p[0]}-cf{p[1]}")
def setup(request):
    arch, capacity = request.param
    cfg, jcfg = configs(arch, capacity)
    jmodel = JaxModel(jcfg)
    jparams = jax_materialize(jmodel.describe(), seed=0)
    params = load_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    return dict(cfg=cfg, jcfg=jcfg, jmodel=jmodel, jparams=jparams, params=params,
                model=Model(cfg, params))


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want):
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=RTOL, atol=ATOL)


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def layer0(tree):
    """Layer 0's slice of a stacked tree (jax arrays or tensors)."""
    if isinstance(tree, dict):
        return {k: layer0(v) for k, v in tree.items()}
    return tree[0]


def tie_set(jlogits) -> set:
    """Tokens whose bf16-rounded logit equals the bf16-rounded maximum."""
    rounded = np.asarray(jnp.asarray(jlogits, jnp.bfloat16).astype(jnp.float32))
    return set(np.flatnonzero(rounded == rounded.max()).tolist())


def jax_route(p, xg, jcfg):
    """The routing lines of the reference's ``apply_moe``, as written there:
    the chosen experts ``[G,g,k]`` and which (token, k) entries keep a slot."""
    e, k = jcfg.num_experts, jcfg.top_k
    n_groups, g, _ = xg.shape
    logits = (xg @ p["router"].astype(jnp.float32)).astype(jnp.float32)
    gates = jax.nn.softmax(logits, axis=-1)
    _, top_idx = jax.lax.top_k(gates, k)
    cap = max(1, int(g * k * jcfg.capacity_factor / e))
    onehot = jax.nn.one_hot(top_idx, e, dtype=jnp.float32)
    flat = onehot.reshape(n_groups, g * k, e)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(n_groups, g, k, e)
    keep = ((pos < cap) * onehot).sum(-1) > 0
    return np.asarray(top_idx), np.asarray(keep)


# ----------------------------------------------------------------- family
def test_the_moe_family_is_admitted_and_the_rest_refused():
    """Every configuration of the registry constructs, reduced and at full
    width; a family the reference does not know is refused."""
    for arch in ARCH_IDS:
        Model(get_config(arch).reduced())
        Model(get_config(arch))
    whisper = Model(get_config("whisper-medium").reduced())
    assert set(whisper.describe_cache(2, 64)) == {"k", "v", "ck", "cv"}
    with pytest.raises(ValueError, match="unknown family"):
        Model(dataclasses.replace(get_config(ARCHS[0]).reduced(), family="speech"))


# ---------------------------------------------------------------- weights
@pytest.mark.parametrize("arch", ARCHS)
def test_materialize_and_load_carry_the_expert_leaves(arch):
    cfg, jcfg = configs(arch, 1.25)
    jparams = jax_materialize(JaxModel(jcfg).describe(), seed=0)
    jleaves = {".".join(str(k.key) for k in path): leaf
               for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    params = materialize(Model(cfg).describe(), seed=0)
    tleaves = dict(flatten_tree(params))
    assert list(tleaves) == list(jleaves)          # same sorted-key order
    L, d, e, f = cfg.num_layers, cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    assert tuple(tleaves["blocks.ffn.router"].shape) == (L, d, e)
    assert tuple(tleaves["blocks.ffn.w_gate"].shape) == (L, e, d, f)
    assert tuple(tleaves["blocks.ffn.w_up"].shape) == (L, e, d, f)
    assert tuple(tleaves["blocks.ffn.w_down"].shape) == (L, e, f, d)
    assert ("blocks.ffn.dense.w_gate" in tleaves) == cfg.dense_residual
    loaded = dict(flatten_tree(load_jax_params(jax.tree.map(np.asarray, jparams), cfg)))
    for name, t in tleaves.items():
        np.testing.assert_array_equal(bits(t), bits(jleaves[name]), err_msg=name)
        np.testing.assert_array_equal(bits(loaded[name]), bits(t), err_msg=name)
    bad = jax.tree.map(np.asarray, jparams)
    bad["blocks"]["ffn"].pop("router")
    with pytest.raises(ValueError, match="router"):
        load_jax_params(bad, cfg)


# -------------------------------------------------------------- apply_moe
MOE_CASES = {
    # name -> (B, S, real rows a sequence; the rest repeat one pad row)
    "decode B=3 S=1": (3, 1, 1),
    "prefill padded to 48 (37 real)": (1, 48, 37),
    "two sequences S=40": (2, 40, 40),
}


def moe_input(cfg, B, S, real, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    x[:, real:] = rng.standard_normal(cfg.d_model, dtype=np.float32)
    return x


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_apply_moe_matches_reference(setup, case):
    cfg, jcfg = setup["cfg"], setup["jcfg"]
    B, S, real = MOE_CASES[case]
    jp, tp = layer0(setup["jparams"]["blocks"]["ffn"]), layer0(setup["params"]["blocks"]["ffn"])
    x = moe_input(cfg, B, S, real)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    g = min(4096, S)
    want_idx, want_keep = jax_route(jp, jx.reshape(-1, g, cfg.d_model), jcfg)
    _, _, top_idx, _, keep = layers.moe_route(tp, tx.reshape(-1, g, cfg.d_model), cfg)
    np.testing.assert_array_equal(top_idx.numpy(), want_idx)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    want_y, want_aux = jax_apply_moe(jp, jx, jcfg)
    y, aux = layers.apply_moe(tp, tx, cfg)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (B, S, cfg.d_model)
    close(y, want_y)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


@pytest.mark.parametrize("g", [1, 7, 16, 48, 384, 4096])
def test_capacity_is_the_reference_formula(setup, g):
    cfg = setup["cfg"]
    want = max(1, int(g * cfg.top_k * cfg.capacity_factor / cfg.num_experts))
    assert layers.moe_capacity(cfg, g) == want


def test_drops_occur_at_capacity_one_and_a_quarter(setup, monkeypatch):
    """The engine's padded prefill of a 37-token prompt (48 rows) routes
    through every layer; at 1.25 some entries overflow their expert."""
    cfg, model = setup["cfg"], setup["model"]
    dropped = []
    route = layers.moe_route

    def counting(*args):
        out = route(*args)
        dropped.append(int((~out[-1]).sum()))
        return out

    monkeypatch.setattr(layers, "moe_route", counting)
    toks = np.random.default_rng(4).integers(2, cfg.vocab_size, (1, 48))
    toks[:, 37:] = 0
    model.prefill({"tokens": torch.from_numpy(toks)}, logit_index=36)
    assert len(dropped) == cfg.num_layers
    if cfg.capacity_factor == 8.0:
        assert sum(dropped) == 0
    else:
        assert sum(dropped) > 0, dropped


# ----------------------------------------------------------------- blocks
def test_block_in_sequence_mode_matches_reference(setup):
    cfg, jcfg = setup["cfg"], setup["jcfg"]
    jp, tp = layer0(setup["jparams"]["blocks"]), layer0(setup["params"]["blocks"])
    x = moe_input(cfg, 1, 32, 32, seed=1) * 0.5
    pos = np.arange(32)[None, :]
    jy, (jk, jv), _ = jax_block(jp, jnp.asarray(x, jnp.bfloat16), jcfg,
                                positions=jnp.asarray(pos))
    y, (k, v) = layers.apply_dense_block(tp, torch.from_numpy(x).bfloat16(), cfg,
                                         positions=torch.from_numpy(pos))
    close(y, jy)
    close(k, jk)
    close(v, jv)


def test_block_in_paged_decode_mode_matches_reference(setup):
    cfg, jcfg = setup["cfg"], setup["jcfg"]
    jp, tp = layer0(setup["jparams"]["blocks"]), layer0(setup["params"]["blocks"])
    rng = np.random.default_rng(2)
    T, N, KH, HD = 8, 10, cfg.num_kv_heads, cfg.head_dim
    kp = rng.standard_normal((N, T, KH, HD), dtype=np.float32)
    vp = rng.standard_normal((N, T, KH, HD), dtype=np.float32)
    tables = np.asarray([[3, 7, 1], [5, 2, 0], [9, 9, 9]], np.int32)
    lens = np.asarray([19, 9, 1], np.int32)
    x = moe_input(cfg, 3, 1, 1, seed=3) * 0.5
    tail = tables[np.arange(3), (lens - 1) // T]
    jy, (jk, jv), _ = jax_block_paged(
        jp, jnp.asarray(x, jnp.bfloat16), jcfg, k_pages=jnp.asarray(kp, jnp.bfloat16),
        v_pages=jnp.asarray(vp, jnp.bfloat16), block_tables=jnp.asarray(tables),
        tail_pages=jnp.asarray(tail), tail_offsets=jnp.asarray((lens - 1) % T),
        lengths=jnp.asarray(lens))
    y, (k, v) = layers.apply_dense_block_paged(
        tp, torch.from_numpy(x).bfloat16(), cfg, k_pages=torch.from_numpy(kp).bfloat16(),
        v_pages=torch.from_numpy(vp).bfloat16(), block_tables=torch.from_numpy(tables),
        lengths=torch.from_numpy(lens))
    close(y, jy)
    close(k, jk)
    close(v, jv)


# ------------------------------------------------------------------ model
def as_f32(setup):
    """The same weights held in f32 on both sides (the cast is exact), so
    the model computes in f32: only summation order differs, and a routing
    decision flips only at a gate gap near f32 resolution."""
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32), setup["jparams"])
    params = jax.tree.map(lambda t: t.float(), setup["params"])
    return params, jparams


def prefill_then_decode(cfg, params, jmodel, jparams, dtype, steps=4, seed=5):
    """Both models prefill a 29-token context, then decode ``steps``
    teacher-forced tokens through ``decode_paged`` over a pool holding the
    port's prefill KV (the same starting pool for both). Returns, per pass
    (the prefill, then each step), the port's and the reference's logits
    and the context they close."""
    model = Model(cfg, params)
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, cfg.vocab_size, (1, 29)).astype(np.int32)
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    logits, cache = model.prefill({"tokens": torch.from_numpy(toks).long()})
    ctx = toks[0].tolist()
    out = [(logits[0], jlogits[0], list(ctx), (cache["k"], jcache["k"]))]
    L, KH, HD, T, N = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, 8, 12
    kp0 = np.zeros((L, N, T, KH, HD), np.float32)
    vp0 = np.zeros_like(kp0)
    table = np.asarray([[4, 9, 2, 7, 11]], np.int32)
    for i in range(29):
        kp0[:, table[0, i // T], i % T] = to_np(cache["k"][:, 0, i])
        vp0[:, table[0, i // T], i % T] = to_np(cache["v"][:, 0, i])
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jk, jv = jnp.asarray(kp0, jdt), jnp.asarray(vp0, jdt)
    tk, tv = torch.from_numpy(kp0).to(dtype), torch.from_numpy(vp0).to(dtype)
    for step in range(steps):
        lens = np.asarray([30 + step], np.int32)
        pos = lens - 1
        tp, to = table[np.arange(1), pos // T], pos % T
        tok = rng.integers(2, cfg.vocab_size, 1).astype(np.int32)
        ctx.append(int(tok[0]))
        jlogits, jk, jv = jmodel.decode_paged(
            jparams, jk, jv, jnp.asarray(tok), jnp.asarray(lens), jnp.asarray(table),
            jnp.asarray(tp), jnp.asarray(to))
        logits = model.decode_paged(
            tk, tv, torch.from_numpy(tok).long(), torch.from_numpy(lens),
            torch.from_numpy(table), torch.from_numpy(tp), torch.from_numpy(to))
        out.append((logits[0], jlogits[0], list(ctx), (tk.clone(), jk)))
    return out


def test_model_in_f32_matches_reference(setup):
    """Prefill and teacher-forced paged decode with the weights in f32, at
    both capacities: the capacity drops of the 1.25 prefill are the
    reference's, so the logits agree to f32 summation order (5e-6 here)
    and the greedy tokens are equal."""
    cfg = setup["cfg"]
    params, jparams = as_f32(setup)
    passes = prefill_then_decode(cfg, params, setup["jmodel"], jparams, torch.float32)
    for logits, jlogits, _, (pages, jpages) in passes:
        assert logits.dtype == torch.float32 and tuple(logits.shape) == (cfg.vocab_size,)
        np.testing.assert_allclose(to_np(logits), to_np(jlogits), rtol=1e-4, atol=1e-4)
        assert int(torch.argmax(logits)) == int(jnp.argmax(jlogits))
        np.testing.assert_allclose(to_np(pages), to_np(jpages), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_in_bf16_is_as_close_to_the_reference_as_it_is_to_itself(arch):
    """bf16 at the dropless 8.0, where prefill and decode compute one
    function. MoE is less forgiving of rounding than the dense block: the
    router's top-k of bf16 activations turns an ulp into another expert
    where two gates nearly tie, and the reference's own decode and prefill
    of one context differ by up to ~0.2 here (XLA keeps f32 between the
    fused ops of each program, in different places). So each pass's
    logits are held to the model band or, where the reference's two
    routes to the same logits (its decode of each step and its prefill of
    the step's whole context) differ by more somewhere in this run, to that
    difference; greedy tokens are in the reference's tie set."""
    cfg, jcfg = configs(arch, 8.0)
    jmodel = JaxModel(jcfg)
    jparams = jax_materialize(jmodel.describe(), seed=0)
    params = load_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    passes = prefill_then_decode(cfg, params, jmodel, jparams, torch.bfloat16)
    spread = 0.0
    for _, jlogits, ctx, _ in passes[1:]:
        jfull, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray([ctx], jnp.int32)})
        spread = max(spread, float(np.abs(to_np(jfull[0]) - to_np(jlogits)).max()))
    assert spread > 0.0
    for i, (logits, jlogits, _, (pages, jpages)) in enumerate(passes):
        diff = np.abs(to_np(logits) - to_np(jlogits))
        band = ATOL + RTOL * np.abs(to_np(jlogits))
        assert (diff <= np.maximum(band, spread)).all(), (i, diff.max(), spread)
        assert int(torch.argmax(logits)) in tie_set(jlogits), i
    close(pages, jpages)
