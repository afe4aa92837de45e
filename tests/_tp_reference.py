"""The reference side of ``tests/test_torch_tp.py`` and
``tests/test_torch_tp_serving.py``, run as a script in a process of its
own: ``python _tp_reference.py <work dir> [tp|serving]`` (the suite,
``tp`` by default, ``serving``, ``train``, ``train_moe``, ``train_ssm`` or
``train_families``).

JAX sees two CPU devices only if ``XLA_FLAGS`` is set before it is first
imported (as ``src/repro/launch/dryrun.py`` does), so this runs apart from
the test process, which imports JAX already. On a ``(1, 2)`` mesh it
serves reduced qwen1.5-0.5b (and its GQA 6/3 variant) through the
reference's ``Engine(placement=...)``, monolithic and chunked, and replays
the router corpus over two replicas aliasing the mesh. The ``serving``
suite serves the int8 formats, dense slots with int8 offload and the MoE
family (reduced dbrx-132b, its 2-KV-head variant and arctic-480b) on the
mesh, replays the router with int8 offload, and runs the MoE layer alone
in f32 on the mesh. It writes the seed-0 weights first
(``params_<config>.npz``, bf16 as its bits), so the port's ranks can
start on them, then ``results.json`` and ``pools.npz``.
"""
from __future__ import annotations

import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import _tp_common as C  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro.dist as jdist  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core.actions import action_to_json  # noqa: E402
from repro.core.types import ProgramTrace, RequestRecord, SchedulerConfig, TransferCost  # noqa: E402
from repro.kernels import kv_quant  # noqa: E402
from repro.models import Model, materialize  # noqa: E402
from repro.models.layers import ShardCtx, apply_moe  # noqa: E402
from repro.models.params import sharding_tree  # noqa: E402
from repro.serving import Engine, EngineRequest, MoriRouter  # noqa: E402
from repro.sim import FaultPlan  # noqa: E402


def configs() -> dict:
    cfg = get_config(C.ARCH).reduced()
    return {"qwen": cfg, "gqa": dataclasses.replace(cfg, **C.GQA)}


def flatten_tree(tree, prefix: str = ""):
    """``(dotted_name, array)`` pairs of a nested dict, in sorted-key order."""
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from flatten_tree(tree[key], f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", tree[key]


def save_params(work: Path, name: str, params) -> None:
    """Leaf name -> bits (bf16 as uint16) and dtype name, for the port's
    ``load_jax_params``."""
    arrays, dtypes = {}, {}
    for leaf, value in flatten_tree(params):
        a = np.asarray(value)
        dtypes[leaf] = a.dtype.name
        arrays[leaf] = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
    np.savez(work / f"params_{name}.tmp.npz", **arrays)
    (work / f"params_{name}.json").write_text(json.dumps(dtypes))
    os.replace(work / f"params_{name}.tmp.npz", work / f"params_{name}.npz")


def serve(engine, chunked: bool, ctxs: dict, sids: dict | None = None) -> dict:
    """Each context's tokens; ``sids`` collects each program's slot."""
    sids = {} if sids is None else sids
    for pid, ctx in ctxs.items():
        req = EngineRequest(pid, ctx, max_new_tokens=C.NEW_TOKENS)
        if chunked:
            job = engine.begin_submit(req)
            sids[pid] = job.slot_id
            while not engine.prefill_step(job):
                pass
        else:
            sids[pid] = engine.submit(req)
    return {c.program_id: list(c.output_tokens) for c in engine.run_to_completion()}


def replay(cfg, params, **engine_kw) -> dict:
    rs = jdist.make_replica_set(2, mesh_shape=C.MESH, num_kv_heads=cfg.num_kv_heads)
    engines = [Engine(cfg, params, placement=p, **C.ROUTER_ENGINE_KW, **engine_kw)
               for p in rs]
    kvb = kv_quant.token_wire_bytes(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, "bf16")
    router = MoriRouter(engines, **C.router_kw(kvb, TransferCost, SchedulerConfig))
    router.sched = C.PlanRecorder(router.sched)
    m = router.replay(C.corpus(ProgramTrace, RequestRecord), vocab_size=cfg.vocab_size,
                      max_new_tokens=C.ROUTER_NEW_TOKENS, faults=C.faults(FaultPlan))
    metrics = dataclasses.asdict(m)
    metrics.pop("ttft_samples")
    return dict(metrics=metrics, actions=[action_to_json(a) for a in router.sched.actions],
                lengths={pid: len(t) for pid, t in router.output_log.items()},
                steps=[e.steps for e in engines])


def serving_configs() -> dict:
    return {name: get_config(arch).reduced(**kw) for name, (arch, kw) in C.SERVING_CONFIGS.items()}


def pool_arrays(engine) -> dict:
    """What the serving suite holds of an engine: its slot caches (dense
    slots) or its device pool, dequantized (int8) to f32."""
    if engine.dense_slots:
        return {"k": np.asarray(engine.slot_k, np.float32),
                "v": np.asarray(engine.slot_v, np.float32)}
    pool = engine.pool
    if pool.k_scale is None:
        return {"k": np.asarray(pool.k, np.float32), "v": np.asarray(pool.v, np.float32)}
    return {kv: np.asarray(kv_quant.dequantize_pages(getattr(pool, kv), getattr(pool, f"{kv}_scale"),
                                                     jnp.float32))
            for kv in ("k", "v")}


def moe_layer(cfg, params, case) -> np.ndarray:
    """Layer 0's MoE in f32 (the weights cast up exactly) on the mesh, as
    the engine places its weights."""
    rs = jdist.make_replica_set(1, mesh_shape=C.MESH, num_kv_heads=cfg.num_kv_heads)
    mesh, rules = rs.meshes[0], rs.rules
    ffn = {k: v[0].astype(jnp.float32) if not isinstance(v, dict) else
           {kk: vv[0].astype(jnp.float32) for kk, vv in v.items()}
           for k, v in params["blocks"]["ffn"].items()}
    desc = Model(cfg).describe()["blocks"]["ffn"]
    sh = sharding_tree(desc, mesh, rules)
    # the stacked leaves' shardings less their layer dimension
    sh = jax.tree.map(lambda s: jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(
        *s.spec[1:])), sh)
    ffn = jax.tree.map(jax.device_put, ffn, sh)
    ctx = ShardCtx(mesh, rules)
    y, _ = jax.jit(lambda p, x: apply_moe(p, x, cfg, ctx))(ffn, jnp.asarray(C.moe_input(case)))
    return np.asarray(y, np.float32)


def serving(work: Path) -> None:
    """The serving suite."""
    cfgs = serving_configs()
    params = {}
    for name, cfg in cfgs.items():
        params[name] = materialize(Model(cfg).describe(), seed=0)
        save_params(work, name, params[name])
    out, pools = {"devices": len(jax.devices())}, {}
    for key, (name, kw, chunked) in C.SERVING_ENGINES.items():
        cfg = cfgs[name]
        rs = jdist.make_replica_set(1, mesh_shape=C.MESH, num_kv_heads=cfg.num_kv_heads)
        out[f"{name} fallbacks"] = [list(f) for f in rs.rules.fallbacks]
        engine = Engine(cfg, params[name], placement=rs.placement(0), **C.engine_kw(key))
        ctxs, sids = C.contexts(cfg.vocab_size), {}
        out[key] = serve(engine, chunked, ctxs, sids)
        out[f"{key} rows"] = C.kv_rows(engine, ctxs, out[key], sids)
        out[f"{key} offloaded"] = engine.pool.stats().offload_bytes
        for kv, a in pool_arrays(engine).items():
            pools[f"{key} {kv}"] = a
    out["router int8"] = replay(cfgs["qwen"], params["qwen"], offload_format="int8")
    for case in C.MOE_CASES:
        pools[f"moe {case}"] = moe_layer(cfgs[case[0]], params[case[0]], case)
    np.savez(work / "pools.npz", **pools)
    (work / "results.json").write_text(json.dumps(out))


def f32_tree(tree):
    """A descriptor tree with every floating leaf in f32: both packages
    draw the same f32 values from it (the seed's stream before the cast)."""
    return {k: f32_tree(v) if isinstance(v, dict) else
            dataclasses.replace(v, dtype=jnp.float32) if jnp.issubdtype(v.dtype, jnp.floating)
            else v for k, v in tree.items()}


def train_suite(work: Path, cases=C.TRAIN_CASES, cfgs=None, arrays=None, out=None) -> None:
    """The train suite: for each case of ``cases`` (``C.TRAIN_CASES`` on
    ``configs()``) the reference's ``Trainer`` on the mesh (on the data of
    ``C.TRAIN_DATA_OF``, else ``C.TRAIN_DATA``), its step-1 gradient (the
    mean over the microbatches of a jitted ``value_and_grad(model.loss)``
    on the train rules' shardings) and, in f32, the losses and parameters
    of ``C.TRAIN_STEPS`` steps; written with ``arrays`` and ``out`` (a
    suite's other arrays and results) to ``pools.npz`` and
    ``results.json``."""
    from jax.sharding import Mesh, NamedSharding
    from repro.train.data import DataConfig
    from repro.train.loop import TrainConfig, Trainer
    from repro.train.optimizer import describe_opt_state

    cfgs = configs() if cfgs is None else cfgs
    out, arrays = {"devices": len(jax.devices()), **(out or {})}, dict(arrays or {})
    for name, shape, dtype in cases:
        key = C.train_key(name, shape, dtype)
        cfg = cfgs[name]
        mesh = Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))
        tr = Trainer(cfg, TrainConfig(steps=C.TRAIN_STEPS, microbatches=C.TRAIN_MICRO,
                                      log_every=1),
                     mesh, DataConfig(vocab_size=cfg.vocab_size,
                                      **C.TRAIN_DATA_OF.get(name, C.TRAIN_DATA)))
        if dtype == "f32":
            tr.param_tree = f32_tree(tr.param_tree)
            tr.opt_tree = describe_opt_state(tr.param_tree, bf16_moments=cfg.bf16_moments)
        state = tr.init_state()
        p_sh, _ = tr.shardings()
        tok_sh = NamedSharding(mesh, tr.rules.spec(mesh, ("batch", None)))
        grad_fn = jax.jit(jax.value_and_grad(
            lambda p, t: tr.model.loss(p, {"tokens": t}, tr.ctx), has_aux=True),
            in_shardings=(p_sh, tok_sh))
        tokens = tr._tokens_for(0)
        acc, losses = None, []
        gates = [] if cfg.num_experts and dtype == "bf16" else None
        with recording_gates(gates):
            for tok in tokens:
                (loss, _), g = grad_fn(state.params, tok)
                g = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), g)
                acc = g if acc is None else jax.tree.map(np.add, acc, g)
                losses.append(float(loss))
            jax.effects_barrier()
        if gates:
            arrays[f"{key} gates"] = np.stack(gates)
        out[f"{key} losses1"] = losses
        for leaf, g in flatten_tree(acc):
            arrays[f"{key} grad {leaf}"] = g / tokens.shape[0]
        if dtype == "f32":
            state = tr.run(state)
            out[f"{key} losses"] = [m["loss"] for m in tr.metrics]
            for leaf, p in flatten_tree(state.params):
                arrays[f"{key} param {leaf}"] = np.asarray(p.astype(jnp.float32))
    np.savez(work / "pools.npz", **arrays)
    (work / "results.json").write_text(json.dumps(out))


class recording_gates:
    """While active with a list, the reference's ``apply_moe`` hands each
    call's router gates ``[groups, g, E]`` (f32, computed as it computes
    them) to a host callback that appends them to the list: once a layer
    of a scanned forward, in order. ``None`` records nothing."""

    def __init__(self, store):
        self.store = store

    def __enter__(self):
        import repro.models.layers as jlayers

        self.mod, self.fn = jlayers, jlayers.apply_moe
        if self.store is None:
            return self
        fn, store = self.fn, self.store

        def apply(p, x, cfg, ctx=jlayers.NULL_CTX):
            B, S, d = x.shape
            g = min(4096, S)
            xg = ctx.constrain(x.reshape(B * S // g, g, d), ("batch", None, None))
            gates = jax.nn.softmax((xg @ p["router"].astype(jnp.float32)).astype(jnp.float32),
                                   axis=-1)
            jax.debug.callback(lambda a: store.append(np.asarray(a)), gates)
            return fn(p, x, cfg, ctx)

        jlayers.apply_moe = apply
        return self

    def __exit__(self, *exc):
        self.mod.apply_moe = self.fn


def train_moe_suite(work: Path) -> None:
    """The MoE train suite: ``train_suite`` over ``C.TRAIN_MOE_CASES``,
    reduced dbrx-132b and arctic-480b."""
    train_suite(work, C.TRAIN_MOE_CASES,
                {name: get_config(arch).reduced() for name, arch in C.TRAIN_MOE_CONFIGS.items()})


def ssm_configs() -> dict:
    return {name: get_config(arch).reduced() for name, arch in C.TRAIN_SSM_CONFIGS.items()}


def ssm_model_level(cfg, dtype: str, placed: bool = True) -> dict:
    """Reduced ``cfg`` at model level on ``C.MESH`` under the decode rules
    (``placed``; else on one device): the seed-0 weights (in f32 from an
    f32 descriptor tree, or bf16) placed as an engine places them, a
    jitted prefill of ``C.ssm_tokens``' prompt, then ``C.SSM_DECODE_STEPS``
    jitted teacher-forced decode steps from its cache (zamba2's shared
    slots padded to ``C.SSM_MAX_SEQ``). Returns the logits of the prefill
    and of each step and the last cache, whole."""
    model = Model(cfg)
    desc = model.describe()
    desc = f32_tree(desc) if dtype == "f32" else desc
    params, ctx = materialize(desc, seed=0), ShardCtx()
    if placed:
        rs = jdist.make_replica_set(1, mesh_shape=C.MESH, num_kv_heads=cfg.num_kv_heads)
        params = jax.device_put(params, sharding_tree(desc, rs.meshes[0], rs.rules))
        ctx = ShardCtx(rs.meshes[0], rs.rules)
    tok = C.ssm_tokens(cfg.vocab_size)
    logits, cache = jax.jit(lambda p, t: model.prefill(p, {"tokens": t}, ctx=ctx))(
        params, jnp.asarray(tok["prompt"], jnp.int32))
    out = {"prefill logits": np.asarray(logits, np.float32)}
    for name in ("shared_k", "shared_v"):
        if name in cache:
            pad = C.SSM_MAX_SEQ - cache[name].shape[2]
            cache[name] = jnp.pad(cache[name], ((0, 0), (0, 0), (0, pad), (0, 0), (0, 0)))
    decode = jax.jit(lambda p, c, t, l: model.decode(p, c, t, l, ctx=ctx))
    S = C.SSM_PROMPT[1]
    for i, t in enumerate(tok["steps"]):
        lengths = jnp.full((C.SSM_PROMPT[0],), S + i + 1, jnp.int32)
        logits, cache = decode(params, cache, jnp.asarray(t, jnp.int32), lengths)
        out[f"step{i} logits"] = np.asarray(logits, np.float32)
    out.update({f"cache {k}": np.asarray(v, np.float32) for k, v in cache.items()})
    return out


def train_ssm_suite(work: Path) -> None:
    """The SSM suite: model level on the mesh under the decode rules
    (``C.SSM_MODEL_CASES``; in bf16 on one device too, the spread of the
    reference's own rounding), then ``train_suite`` over
    ``C.TRAIN_SSM_CASES``, reduced mamba2-2.7b and zamba2-2.7b."""
    cfgs = ssm_configs()
    arrays = {}
    for name, dtype in C.SSM_MODEL_CASES:
        for side in ("mesh", "one")[:1 if dtype == "f32" else 2]:
            got = ssm_model_level(cfgs[name], dtype, placed=side == "mesh")
            arrays.update({f"{C.ssm_key(name, dtype)} {side} {k}": v for k, v in got.items()})
    train_suite(work, C.TRAIN_SSM_CASES, cfgs, arrays)


def family_configs() -> dict:
    return {name: get_config(arch).reduced() for name, arch in C.TRAIN_FAMILY_CONFIGS.items()}


def _batch(inputs: dict) -> dict:
    """A numpy batch as the reference takes it: int32 tokens, f32 arrays."""
    return {k: jnp.asarray(v, jnp.int32 if k in ("tokens", "steps") else jnp.float32)
            for k, v in inputs.items()}


def family_loss(cfg, name: str, shape, dtype: str) -> tuple[float, dict]:
    """``Model.loss`` and its gradient on ``C.loss_inputs``: a jitted
    ``value_and_grad`` on the mesh ``shape``, the seed-0 weights (from an
    f32 descriptor tree in f32) and the batch placed by the train rules
    and ``batch_specs``, as the dry run places them. Returns the loss and
    each leaf's gradient in f32."""
    from jax.sharding import Mesh

    from repro.dist.sharding import make_train_rules
    from repro.launch.steps import batch_specs

    mesh = Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))
    rules = make_train_rules(mesh)
    model = Model(cfg)
    desc = model.describe()
    desc = f32_tree(desc) if dtype == "f32" else desc
    params = materialize(desc, seed=0)
    batch = _batch(C.loss_inputs(name, cfg))
    ctx = ShardCtx(mesh, rules)
    fn = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b, ctx), has_aux=True),
                 in_shardings=(sharding_tree(desc, mesh, rules), batch_specs(batch, mesh, rules)))
    (loss, _), g = fn(params, batch)
    return float(loss), {n: np.asarray(a.astype(jnp.float32)) for n, a in flatten_tree(g)}


def family_cache(name: str, cfg, cache):
    """A prefill's cache as decode takes it: gemma2's local K/V as a ring
    of ``C.RING_SLOTS`` slots (position ``p`` at slot ``p % slots``, the
    last ``slots`` positions) and its global K/V padded to
    ``C.FAMILY_MAX_SEQ`` slots; whisper's and internvl2's self K/V padded
    so, whisper's cross caches as they are."""
    S = C.prompt_length(name, cfg)

    def pad(t):
        return jnp.pad(t, ((0, 0), (0, 0), (0, C.FAMILY_MAX_SEQ - t.shape[2]), (0, 0), (0, 0)))

    if name == "gemma2":
        R = C.RING_SLOTS
        idx = np.arange(S - R, S) % R

        def ring(t):
            return jnp.zeros((*t.shape[:2], R, *t.shape[3:]), t.dtype).at[:, :, idx].set(
                t[:, :, S - R:S])

        return {"local": {k: ring(v) for k, v in cache["local"].items()},
                "global": {k: pad(v) for k, v in cache["global"].items()}}
    return {k: v if k in ("ck", "cv") else pad(v) for k, v in cache.items()}


def family_model_level(name: str, cfg, dtype: str, placed: bool = True) -> dict:
    """Reduced ``cfg`` at model level on ``C.MESH`` under the decode rules
    (``placed``; else on one device): the seed-0 weights (in f32 from an
    f32 descriptor tree, or bf16) placed as an engine places them, a
    jitted prefill of ``C.family_prompt``'s batch, then
    ``C.FAMILY_DECODE_STEPS`` jitted teacher-forced decode steps from its
    cache (``family_cache``). Returns the logits of the prefill and of
    each step and the last cache, whole."""
    model = Model(cfg)
    desc = model.describe()
    desc = f32_tree(desc) if dtype == "f32" else desc
    params, ctx = materialize(desc, seed=0), ShardCtx()
    if placed:
        rs = jdist.make_replica_set(1, mesh_shape=C.MESH, num_kv_heads=cfg.num_kv_heads)
        params = jax.device_put(params, sharding_tree(desc, rs.meshes[0], rs.rules))
        ctx = ShardCtx(rs.meshes[0], rs.rules)
    batch = _batch(C.family_prompt(name, cfg))
    steps = batch.pop("steps")
    logits, cache = jax.jit(lambda p, b: model.prefill(p, b, ctx=ctx))(params, batch)
    out = {"prefill logits": np.asarray(logits, np.float32)}
    cache = family_cache(name, cfg, cache)
    decode = jax.jit(lambda p, c, t, l: model.decode(p, c, t, l, ctx=ctx))
    S = C.prompt_length(name, cfg)
    for i, t in enumerate(steps):
        lengths = jnp.full((t.shape[0],), S + i + 1, jnp.int32)
        logits, cache = decode(params, cache, t, lengths)
        out[f"step{i} logits"] = np.asarray(logits, np.float32)
    out.update({f"cache {k}": np.asarray(v, np.float32) for k, v in flatten_tree(cache)})
    return out


def train_families_suite(work: Path) -> None:
    """The families suite: model level on the mesh under the decode rules
    (``C.FAMILY_MODEL_CASES``; in bf16 on one device too, the spread of
    the reference's own rounding; whisper in bf16 alone, since the
    reference's encoder refuses f32 weights), ``Model.loss`` and its
    gradient (``C.LOSS_CASES``, whisper in bf16 alone), then
    ``train_suite`` over ``C.GEMMA2_TRAIN_CASES``."""
    cfgs = family_configs()
    arrays, out = {}, {}
    for name, dtype in C.FAMILY_MODEL_CASES:
        if name == "whisper" and dtype == "f32":
            continue
        for side in ("mesh", "one")[:1 if dtype == "f32" else 2]:
            got = family_model_level(name, cfgs[name], dtype, placed=side == "mesh")
            arrays.update({f"{C.family_key(name, dtype)} {side} {k}": v for k, v in got.items()})
    for name, shape, dtype in C.LOSS_CASES:
        if name == "whisper" and dtype == "f32":
            continue
        key = f"{C.train_key(name, shape, dtype)} loss"
        out[key], grads = family_loss(cfgs[name], name, shape, dtype)
        arrays.update({f"{key} grad {n}": g for n, g in grads.items()})
    train_suite(work, C.GEMMA2_TRAIN_CASES, cfgs, arrays, out)


def main(work: Path) -> None:
    assert len(jax.devices()) == 2, jax.devices()
    cfgs = configs()
    params = {}
    for name, cfg in cfgs.items():
        params[name] = materialize(Model(cfg).describe(), seed=0)
        save_params(work, name, params[name])
    out, pools = {"devices": len(jax.devices())}, {}
    for name, cfg in cfgs.items():
        rs = jdist.make_replica_set(1, mesh_shape=C.MESH, num_kv_heads=cfg.num_kv_heads)
        out[f"{name} fallbacks"] = [list(f) for f in rs.rules.fallbacks]
        for chunked in (False, True):
            key = f"{name} {'chunked' if chunked else 'monolithic'}"
            engine = Engine(cfg, params[name], placement=rs.placement(0), **C.ENGINE_KW)
            out[key] = serve(engine, chunked, C.contexts(cfg.vocab_size))
            pools[f"{key} k"] = np.asarray(engine.pool.k, np.float32)
            pools[f"{key} v"] = np.asarray(engine.pool.v, np.float32)
    out["router"] = replay(cfgs["qwen"], params["qwen"])
    np.savez(work / "pools.npz", **pools)
    (work / "results.json").write_text(json.dumps(out))


if __name__ == "__main__":
    assert len(jax.devices()) == 2, jax.devices()
    suite = sys.argv[2] if len(sys.argv) > 2 else "tp"
    {"serving": serving, "train": train_suite, "train_moe": train_moe_suite,
     "train_ssm": train_ssm_suite, "train_families": train_families_suite}.get(
        suite, main)(Path(sys.argv[1]))
