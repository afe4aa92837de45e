"""The port's side of ``tests/test_torch_tp.py`` and
``tests/test_torch_tp_serving.py``: two ``gloo`` ranks on the CPU, one a
position of a ``(1, 2)`` mesh, each in a process of its own.

:func:`start` spawns them over a file store in the caller's work
directory (no TCP port, so parallel test workers never collide), and
:func:`join` waits for them within a deadline and kills them past it. Each rank waits for the reference's
seed-0 weights (``params_<config>.npz``, written by ``_tp_reference.py``),
carries them across with ``load_jax_params`` and runs the same jobs as
the reference: the kernel entry points on DTensors under ``local_map``,
the sharded engine (monolithic and chunked, reduced qwen and its GQA 6/3
variant) and the router's replay over two replicas aliasing the mesh. The
``serving`` suite runs the int8 quantize sites on one page each, the
int8, dense-slot and MoE engines, the router's replay with int8 offload
and the MoE layer alone in f32. The ``train`` suite trains on ``(2, 1)``
and ``(1, 2)`` meshes (``_tp_common.TRAIN_CASES``) beside the port on one
device, crashes and resumes on ``(2, 1)``, restores that run's checkpoint
on ``(1, 2)``, and shows what raises. Every collective goes through
``torch.distributed`` (DTensor's functional collectives are refused,
over every backward too). Imports torch, numpy and the port, never JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import multiprocessing as mp
import time
import traceback
from pathlib import Path

import numpy as np

import _tp_common as C

WORLD = 2


def start(work: Path, suite: str = "tp") -> list:
    """Spawn the ranks of ``suite`` (``"tp"``, ``tests/test_torch_tp.py``'s,
    ``"serving"``, ``tests/test_torch_tp_serving.py``'s, ``"train"``,
    ``tests/test_torch_tp_train.py``'s, ``"train_moe"``, ``"train_ssm"`` or
    ``"train_families"``, ``tests/test_torch_tp_{train_moe,train_ssm,
    families}.py``'s) over a file store in ``work``."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, str(work), suite)) for r in range(WORLD)]
    for p in procs:
        p.start()
    return procs


def run_both(work: Path, suite: str, deadline_s: float) -> tuple:
    """Both sides of ``suite``, started together: the reference's
    subprocess (``_tp_reference.py``, which sets ``XLA_FLAGS`` for two CPU
    devices before it imports JAX) and the port's ranks. Returns the
    reference's results and pools and each rank's ``(results, arrays)``;
    fails the calling test if either side exits badly or outlives
    ``deadline_s``."""
    import os
    import subprocess
    import sys

    import pytest

    here = Path(__file__).resolve().parent
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(here.parent / "src")}
    ref = subprocess.Popen([sys.executable, str(here / "_tp_reference.py"), str(work), suite],
                           env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    t0 = time.monotonic()
    procs = start(work, suite)
    try:
        ref_out, _ = ref.communicate(timeout=deadline_s)
    except subprocess.TimeoutExpired:
        ref.kill()
        ref_out, _ = ref.communicate()
    if ref.returncode != 0:
        join(procs, 0)
        pytest.fail(f"the reference exited {ref.returncode}:\n{ref_out[-3000:]}")
    codes = join(procs, max(1.0, deadline_s - (time.monotonic() - t0)))
    errs = "".join(p.read_text() for p in sorted(work.glob("rank*.err")))
    assert codes == [0] * WORLD, f"ranks exited {codes}:\n{errs[-4000:]}"
    ranks = [(json.loads((work / f"rank{r}.json").read_text()),
              dict(np.load(work / f"rank{r}.npz"))) for r in range(WORLD)]
    return (json.loads((work / "results.json").read_text()),
            dict(np.load(work / "pools.npz")), ranks)


def join(procs: list, deadline_s: float) -> list:
    """Wait for the ranks until ``deadline_s`` has passed, kill any still
    running; their exit codes (``None`` for one killed)."""
    end = time.monotonic() + deadline_s
    for p in procs:
        p.join(max(0.1, end - time.monotonic()))
    codes = []
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
            codes.append(None)
        else:
            codes.append(p.exitcode)
    return codes


def _rank(rank: int, work: str, suite: str) -> None:
    work = Path(work)
    jobs = {"serving": _serving_jobs, "train": _train_jobs, "train_moe": _train_moe_jobs,
            "train_ssm": _train_ssm_jobs, "train_families": _train_families_jobs}.get(suite, _jobs)
    try:
        out, arrays = jobs(rank, work)
    except BaseException:
        (work / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    np.savez(work / f"rank{rank}.npz", **arrays)
    (work / f"rank{rank}.json").write_text(json.dumps(out))


def _wait_for(path: Path, timeout_s: float = 150.0) -> None:
    end = time.monotonic() + timeout_s
    while not path.exists():
        if time.monotonic() > end:
            raise TimeoutError(f"{path} did not appear")
        time.sleep(0.05)


def _params(work: Path, name: str, cfg):
    import ml_dtypes

    from repro_torch.models.params import load_jax_params

    _wait_for(work / f"params_{name}.npz")
    dtypes = json.loads((work / f"params_{name}.json").read_text())
    flat = dict(np.load(work / f"params_{name}.npz"))
    tree: dict = {}
    for leaf, a in flat.items():
        if dtypes[leaf] == "bfloat16":
            a = a.view(ml_dtypes.bfloat16)
        *path, last = leaf.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[last] = a
    return load_jax_params(tree, cfg, device="cpu")


def _jobs(rank: int, work: Path):
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.dist.local import no_functional_collectives

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work / 'store'}", rank=rank,
                            world_size=WORLD)
    cfg = get_config(C.ARCH).reduced()
    cfgs = {"qwen": cfg, "gqa": dataclasses.replace(cfg, **C.GQA)}
    out, arrays = {"rank": rank}, {}
    cpu = torch.device("cpu")
    with no_functional_collectives():
        for case in C.KERNEL_CASES:
            got = _kernel_case(case, cpu)
            for k, v in got.items():
                arrays[f"kernel {case[0]} {k}"] = v
        for name, c in cfgs.items():
            params = _params(work, name, c)
            rs = _replica_set(c, cpu)
            out[f"{name} fallbacks"] = [list(f) for f in rs.rules.fallbacks]
            for chunked in (False, True):
                key = f"{name} {'chunked' if chunked else 'monolithic'}"
                engine, tokens = _serve(c, params, rs, chunked)
                out[key] = tokens
                out[f"{key} pool heads"] = engine.pool.local_kv_heads
                out[f"{key} captured"] = engine.graphs.captured
                arrays[f"{key} k"] = engine.pool.k.float().numpy()
                arrays[f"{key} v"] = engine.pool.v.float().numpy()
        out["router"] = _replay(cfg, _params(work, "qwen", cfg), cpu)
        out["f32"] = _f32_against_one_device(cfg, _params(work, "qwen", cfg), cpu)
    dist.barrier()
    dist.destroy_process_group()
    return out, arrays


def _kernel_case(case, dev) -> dict:
    """The paged decode and the prefill of ``case`` on DTensors placed by
    the decode rules, each rank's pages its own block; the outputs
    gathered."""
    import torch

    from repro_torch.dist.sharding import make_decode_rules
    from repro_torch.kernels.flash_attention.ops import prefill_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention_decode
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.params import device_put_tree

    name, B, H, KH, D = case
    x = {k: torch.from_numpy(v) for k, v in C.kernel_inputs(case).items()}
    bf = {k: v.to(torch.bfloat16) for k, v in x.items() if v.dtype == torch.float32}
    mesh = Mesh(("data", "model"), np.array([[dev] * WORLD], dtype=object))
    rules = make_decode_rules(mesh, KH)
    ctx = ShardCtx(mesh, rules)

    def place(t, logical):
        return device_put_tree({"t": t}, {"t": rules.sharding(mesh, logical, tuple(t.shape))})["t"]

    def own(t, logical):
        """This rank's block, as the page pool holds it."""
        return place(t, logical).to_local()

    heads, kv = ("batch", "heads_act", None), ("batch", "kv_heads_act", None)
    page = (None, None, "kv_heads_act", None)
    out = paged_attention_decode(
        place(bf["q"], heads), place(bf["k_new"], kv), place(bf["v_new"], kv),
        own(bf["k_pages"], page), own(bf["v_pages"], page), x["tables"], x["lengths"])
    seq_heads, seq_kv = ("batch", None, "heads_act", None), ("batch", None, "kv_heads_act", None)
    pre = prefill_attention(
        place(bf["pq"], seq_heads), place(bf["pk"], seq_kv), place(bf["pv"], seq_kv),
        causal=True, q_offset=C.PREFIX_S, kv_hole=(C.PREFIX_S - 4, C.PREFIX_S))
    return {"paged": ctx.full(out).float().numpy(), "prefill": ctx.full(pre).float().numpy(),
            "paged local heads": np.array(out.to_local().shape[1])}


def _serve(cfg, params, rs, chunked: bool, kw=C.ENGINE_KW, sids: dict | None = None):
    """The engine and each context's tokens; ``sids`` collects each
    program's slot."""
    from repro_torch.serving import Engine, EngineRequest

    sids = {} if sids is None else sids
    engine = Engine(cfg, params, placement=rs.placement(0), **kw)
    for pid, ctx in C.contexts(cfg.vocab_size).items():
        req = EngineRequest(pid, ctx, max_new_tokens=C.NEW_TOKENS)
        if chunked:
            job = engine.begin_submit(req)
            sids[pid] = job.slot_id
            while not engine.prefill_step(job):
                pass
        else:
            sids[pid] = engine.submit(req)
    return engine, {c.program_id: list(c.output_tokens) for c in engine.run_to_completion()}


def _f32_against_one_device(cfg, params, dev) -> dict:
    """The weights in f32: the sharded engine's prefill logits and served
    tokens against a one-device engine's in the same process. Only the
    order of f32 sums differs, so the logits agree to f32 rounding."""
    import torch

    from repro_torch.models.params import _unflatten, flatten_tree
    from repro_torch.serving import Engine, EngineRequest

    params = _unflatten([(n, t.float()) for n, t in flatten_tree(params)])
    rs = _replica_set(cfg, dev)
    tp = Engine(cfg, params, placement=rs.placement(0), **C.ENGINE_KW)
    one = Engine(cfg, params, device=dev, **C.ENGINE_KW)
    ctxs = C.contexts(cfg.vocab_size)
    tokens = torch.as_tensor([ctxs["a"]])
    got, _ = tp.model.prefill({"tokens": tokens}, ctx=tp.ctx)
    want, _ = one.model.prefill({"tokens": tokens})
    served = []
    for e in (tp, one):
        for pid, ctx in ctxs.items():
            e.submit(EngineRequest(pid, ctx, max_new_tokens=C.NEW_TOKENS))
        served.append({c.program_id: list(c.output_tokens) for c in e.run_to_completion()})
    return dict(prefill_max_abs_diff=(tp.ctx.full(got) - want).abs().max().item(),
                prefill_max_abs=want.abs().max().item(),
                tokens_equal=served[0] == served[1])


def _replica_set(cfg, dev, replicas: int = 1):
    """``replicas`` replicas aliasing one ``(1, 2)`` mesh on ``dev``."""
    from repro_torch.dist import make_replica_set

    return make_replica_set(replicas, mesh_shape=C.MESH, devices=[dev] * WORLD,
                            num_kv_heads=cfg.num_kv_heads)


def _replay(cfg, params, dev, **engine_kw) -> dict:
    from repro_torch.core.actions import action_to_json
    from repro_torch.core.types import ProgramTrace, RequestRecord, SchedulerConfig, TransferCost
    from repro_torch.kernels import kv_quant
    from repro_torch.models import Model
    from repro_torch.models.params import device_put_tree, flatten_tree, sharding_tree
    from repro_torch.serving import Engine, MoriRouter
    from repro_torch.sim import FaultPlan

    rs = _replica_set(cfg, dev, replicas=2)
    # placed once: both replicas alias the mesh and take the same DTensors
    placed = device_put_tree(params, sharding_tree(Model(cfg).describe(), rs.meshes[0],
                                                   rs.rules))
    engines = [Engine(cfg, placed, placement=p, **C.ROUTER_ENGINE_KW, **engine_kw)
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
                steps=[e.steps for e in engines],
                weights_shared=all(a is b for (_, a), (_, b) in zip(
                    flatten_tree(engines[0].model._stacked),
                    flatten_tree(engines[1].model._stacked))),
                page_bytes=engines[0].pool.page_bytes,
                host_page_bytes=engines[0].pool.host_page_bytes,
                rank_page_bytes=engines[0].pool.rank_page_bytes,
                host_scales=[e.pool.host_k_scale.numpy().tolist() for e in engines]
                if engines[0].pool.host_k_scale is not None else None)


# ------------------------------------------------- the serving suite
def _serving_jobs(rank: int, work: Path):
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.dist.local import no_functional_collectives

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work / 'store'}", rank=rank,
                            world_size=WORLD)
    cfgs = {name: get_config(arch).reduced(**kw)
            for name, (arch, kw) in C.SERVING_CONFIGS.items()}
    out, arrays = {"rank": rank}, {}
    cpu = torch.device("cpu")
    with no_functional_collectives():
        arrays.update(_quant_sites(cpu))
        for key, (name, _, chunked) in C.SERVING_ENGINES.items():
            cfg = cfgs[name]
            params = _params(work, name, cfg)
            rs = _replica_set(cfg, cpu)
            out[f"{name} fallbacks"] = [list(f) for f in rs.rules.fallbacks]
            sids: dict = {}
            with _collectives() as moved:
                engine, tokens = _serve(cfg, params, rs, chunked, C.engine_kw(key), sids)
            out[key] = tokens
            out[f"{key} rows"] = C.kv_rows(engine, C.contexts(cfg.vocab_size), tokens, sids)
            out[f"{key} captured"] = engine.graphs.captured
            out[f"{key} pool heads"] = engine.pool.local_kv_heads
            out[f"{key} offloaded"] = engine.pool.offload_bytes
            out[f"{key} offloaded pages"] = engine.pool.offload_bytes // engine.pool.host_page_bytes
            out[f"{key} collectives"] = moved
            for kv, a in _pool_arrays(engine).items():
                arrays[f"{key} {kv}"] = a
            if cfg.num_experts:
                ffn = engine.model._stacked["blocks"]["ffn"]
                out[f"{key} expert weights"] = {
                    n: [list(ffn[n].shape), list(ffn[n].to_local().shape)]
                    for n in ("router", "w_gate", "w_up", "w_down")}
        out["router int8"] = _replay(cfgs["qwen"], _params(work, "qwen", cfgs["qwen"]), cpu,
                                     offload_format="int8")
        for case in C.MOE_CASES:
            arrays[f"moe {case}"] = _moe_layer(cfgs[case[0]], _params(work, case[0],
                                                                       cfgs[case[0]]), case, cpu)
    dist.barrier()
    dist.destroy_process_group()
    return out, arrays


@contextlib.contextmanager
def _collectives():
    """Record the elements every ``torch.distributed`` all-reduce and
    all-gather moves while the block runs (each call's tensor, the one
    the rank sends), in the list it yields."""
    import torch.distributed as dist

    moved: list = []
    saved = {n: getattr(dist, n) for n in ("all_reduce", "all_gather", "all_gather_into_tensor")}

    def record(name):
        def call(*args, **kwargs):
            t = args[1] if name != "all_reduce" else args[0]
            moved.append(int(t.numel()))
            return saved[name](*args, **kwargs)
        return call

    for n in saved:
        setattr(dist, n, record(n))
    try:
        yield moved
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)


def _pool_arrays(engine) -> dict:
    """The rank's slot caches (dense slots) or device pool, dequantized
    (int8) to f32, with the int8 pool's device and host scales."""
    import torch

    from repro_torch.kernels import kv_quant

    pool = engine.pool
    if engine.dense_slots:
        out = {"k": engine.slot_k.float().numpy(), "v": engine.slot_v.float().numpy()}
    elif pool.k_scale is None:
        out = {"k": pool.k.float().numpy(), "v": pool.v.float().numpy()}
    else:
        out = {kv: kv_quant.dequantize_pages(getattr(pool, kv), getattr(pool, f"{kv}_scale"),
                                             torch.float32).numpy() for kv in ("k", "v")}
        out.update(k_scale=pool.k_scale.numpy(), v_scale=pool.v_scale.numpy())
    if pool.host_k_scale is not None:
        out.update(host_k_scale=pool.host_k_scale.numpy(), host_v_scale=pool.host_v_scale.numpy())
    return out


def _quant_sites(dev) -> dict:
    """One page through each int8 quantize site of a pool holding this
    rank's half of the KV heads: the prefill's scatter into an int8 pool,
    the decode commit's requantize of that page, and the int8 offload of
    the same page from a bf16 pool. Returns each site's payload block and
    scales (K and V)."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist.sharding import make_decode_rules
    from repro_torch.dist.local import max_reducer
    from repro_torch.kernels import kv_quant
    from repro_torch.launch.mesh import Mesh
    from repro_torch.serving.kvpool import PagePool

    sh = C.QUANT_SHAPE
    L, T, KH, HD = sh["L"], sh["T"], sh["KH"], sh["HD"]
    x = {k: torch.from_numpy(v) for k, v in C.quant_inputs().items()}
    r, n = dist.get_rank(), KH // WORLD
    own = {k: x[k][..., r * n:(r + 1) * n, :].bfloat16() for k in ("k", "v", "new_k", "new_v")}
    mesh = Mesh(("data", "model"), np.array([[dev] * WORLD], dtype=object))
    shape = (L, 1, T, KH, HD)
    kv = make_decode_rules(mesh, KH).sharding(mesh, ("layers", "batch", "kv_seq",
                                                     "kv_heads_act", "head_dim"), shape)
    reduce_amax = max_reducer(mesh.device_mesh(), kv.placements(), 3)

    def pool(**kw):
        return PagePool(layers=L, kv_heads=KH, head_dim=HD, page_tokens=T, n_device_pages=4,
                        n_host_pages=4, device=dev, local_kv_heads=n, reduce_amax=reduce_amax,
                        **kw)

    out = {}
    q = pool(offload_format="int8", device_format="int8")
    q.write_device_pages([1, 2], own["k"], own["v"])
    for name in ("k", "v"):
        # copies: the decode commit below rewrites page 2 in place
        out[f"quant prefill {name}"] = getattr(q, name)[:, 1:3].clone().numpy()
        out[f"quant prefill {name}_scale"] = getattr(q, f"{name}_scale")[:, 1:3].clone().numpy()
    pages, offs = torch.tensor([2]), x["offset"]
    for name in ("k", "v"):
        kv_quant.requantize_insert_run(getattr(q, name), getattr(q, f"{name}_scale"), pages,
                                       offs, own[f"new_{name}"], reduce_amax)
        out[f"quant decode {name}"] = getattr(q, name)[:, 2].numpy()
        out[f"quant decode {name}_scale"] = getattr(q, f"{name}_scale")[:, 2].numpy()
    b = pool(offload_format="int8")
    b.write_device_pages([0], own["k"][:, :T], own["v"][:, :T])
    hp = b.copy_page_to_host(0)
    for name in ("k", "v"):
        out[f"quant offload {name}"] = getattr(b, f"host_{name}")[:, hp].numpy()
        out[f"quant offload {name}_scale"] = getattr(b, f"host_{name}_scale")[:, hp].numpy()
    return out


def _moe_layer(cfg, params, case, dev) -> np.ndarray:
    """Layer 0's MoE in f32 (the weights cast up exactly) on DTensors
    placed by the decode rules, on a replicated input; the output
    gathered."""
    import torch
    from torch.distributed.tensor import Replicate

    from repro_torch.dist.local import place_block
    from repro_torch.models import Model
    from repro_torch.models.layers import ShardCtx, apply_moe
    from repro_torch.models.params import _unflatten, device_put_tree, flatten_tree, sharding_tree

    rs = _replica_set(cfg, dev)
    mesh, rules = rs.meshes[0], rs.rules
    ffn = _unflatten([(n, t.float()) for n, t in flatten_tree(params["blocks"]["ffn"])])
    placed = device_put_tree(ffn, sharding_tree(Model(cfg).describe()["blocks"]["ffn"],
                                                mesh, rules))
    layer0 = _unflatten([(n, t[0]) for n, t in flatten_tree(placed)])
    x = torch.from_numpy(C.moe_input(case))
    x = place_block(x, mesh.device_mesh(), [Replicate()] * 2, x.shape)
    ctx = ShardCtx(mesh, rules)
    with ctx.scope():
        y, _ = apply_moe(layer0, x, cfg, ctx)
    return ctx.full(y).numpy()


# ------------------------------------------------- the train suite
def _train_jobs(rank: int, work: Path):
    import torch
    import torch.distributed as dist

    from repro_torch.dist.local import no_functional_collectives

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work / 'store'}", rank=rank,
                            world_size=WORLD)
    cpu = torch.device("cpu")
    out, arrays = {"rank": rank}, {}
    with no_functional_collectives():
        for name, shape, dtype in C.TRAIN_CASES:
            key = C.train_key(name, shape, dtype)
            got, a = _train_case(name, shape, dtype, cpu)
            out.update({f"{key} {k}": v for k, v in got.items()})
            arrays.update({f"{key} {k}": v for k, v in a.items()})
        for shape in C.TRAIN_MESHES:
            key = C.train_key("qwen", shape, "bf16")
            for m in (1, 2):
                params = _gathered(_run(_train_trainer("qwen", shape, "bf16", cpu, steps=1,
                                                       micro=m)).params)
                arrays.update({f"{key} micro{m} param {n}": v for n, v in params.items()})
        a, got = _crash_and_restore(work, cpu)
        arrays.update(a)
        out.update(got)
        out["indivisible batch"] = _raises(lambda: _train_trainer(
            "qwen", (2, 1), "bf16", cpu, batch=2)._tokens_for(0), ValueError)
        out["functional collective in a backward"] = _functional_in_backward(cpu)
    dist.barrier()
    dist.destroy_process_group()
    if rank:
        arrays = {}     # rank 0's gathered arrays are both ranks'
    return out, arrays


def _train_cfg(name: str):
    from repro_torch.configs import get_config

    if name in C.TRAIN_MOE_CONFIGS:
        return get_config(C.TRAIN_MOE_CONFIGS[name]).reduced()
    if name in C.TRAIN_SSM_CONFIGS:
        return get_config(C.TRAIN_SSM_CONFIGS[name]).reduced()
    if name in C.TRAIN_FAMILY_CONFIGS:
        return get_config(C.TRAIN_FAMILY_CONFIGS[name]).reduced()
    cfg = get_config(C.ARCH).reduced()
    return dataclasses.replace(cfg, **C.GQA) if name == "gqa" else cfg


def _train_mesh(shape, dev):
    from repro_torch.launch.mesh import Mesh

    return Mesh(("data", "model"), np.array([dev] * WORLD, dtype=object).reshape(shape))


def _f32_tree(tree):
    """The descriptor tree with every floating leaf in f32 (the reference
    side's ``f32_tree``)."""
    import torch

    return {k: _f32_tree(v) if isinstance(v, dict) else
            dataclasses.replace(v, dtype=torch.float32) if v.dtype.is_floating_point else v
            for k, v in tree.items()}


def _train_trainer(name: str, shape, dtype: str, dev, *, steps: int = C.TRAIN_STEPS,
                   micro: int = C.TRAIN_MICRO, batch: int | None = None, **tcfg):
    """The port's trainer of a case: on the mesh ``shape``, or on ``dev``
    alone for ``shape`` None."""
    from repro_torch.train.data import DataConfig
    from repro_torch.train.loop import TrainConfig, Trainer
    from repro_torch.train.optimizer import describe_opt_state

    cfg = _train_cfg(name)
    data = {**C.TRAIN_DATA_OF.get(name, C.TRAIN_DATA),
            **({} if batch is None else {"global_batch": batch})}
    kw = dict(device=dev) if shape is None else dict(mesh=_train_mesh(shape, dev))
    tr = Trainer(cfg, TrainConfig(steps=steps, microbatches=micro, log_every=1, **tcfg),
                 DataConfig(vocab_size=cfg.vocab_size, **data), **kw)
    if dtype == "f32":
        tr.param_tree = _f32_tree(tr.param_tree)
        tr.opt_tree = describe_opt_state(tr.param_tree, bf16_moments=cfg.bf16_moments)
    return tr


def _run(tr, state=None, fault=None):
    return tr.run(tr.init_state() if state is None else state, fault)


def _gathered(tree) -> dict:
    """Leaf name -> the whole leaf in f32 (numpy)."""
    from repro_torch.models.params import flatten_tree, gather_tree

    return {n: t.float().numpy() for n, t in flatten_tree(gather_tree(tree))}


def _gathered_grads(tr, state) -> tuple[dict, list]:
    """The step-1 gradient (each leaf's mean over the microbatches, whole)
    and the microbatches' losses."""
    from repro_torch.dist.local import full, is_dtensor, place_block
    from repro_torch.models.params import flatten_tree

    acc, losses = tr.gradients(state, tr._tokens_for(0))
    out = {}
    for (n, leaf), a in zip(flatten_tree(state.params), acc):
        if is_dtensor(leaf):
            a = full(place_block(a, leaf.device_mesh, leaf.placements, leaf.shape))
        out[n] = a.numpy()
    return out, [float(x) for x in losses]


def _held_bytes(tree) -> int:
    from repro_torch.dist.local import is_dtensor
    from repro_torch.models.params import flatten_tree

    return sum((t.to_local() if is_dtensor(t) else t).nbytes for _, t in flatten_tree(tree))


def _train_case(name: str, shape, dtype: str, dev) -> tuple[dict, dict]:
    """One case on the mesh and on one device: the step-1 gradient and
    losses; in f32 ``C.TRAIN_STEPS`` steps' losses and final parameters;
    the bytes the rank holds."""
    import torch.distributed as dist

    out, arrays = {}, {}
    # the one-device side needs no collective: rank 0 runs it alone
    sides = (("mesh", shape), ("one", None))[:1 if dist.get_rank() else 2]
    for side, where in sides:
        tr = _train_trainer(name, where, dtype, dev)
        state = tr.init_state()
        with _gates() as gates:
            grads, out[f"{side} losses1"] = _gathered_grads(tr, state)
        arrays.update({f"{side} grad {n}": g for n, g in grads.items()})
        if gates:
            arrays[f"{side} gates"] = _whole_gates(gates, tr)
        if side == "mesh":
            out["param bytes"] = _held_bytes(state.params)
            out["moment bytes"] = _held_bytes({"m": state.opt["m"], "v": state.opt["v"]})
        if dtype == "f32":
            state = _run(tr, state)
            out[f"{side} losses"] = [m["loss"] for m in tr.metrics]
            arrays.update({f"{side} param {n}": p for n, p in _gathered(state.params).items()})
    return out, arrays


@contextlib.contextmanager
def _gates():
    """Record the router gates of every MoE layer the block runs, each a
    ``[groups, g, E]`` f32 tensor of the rank's rows, in the list it
    yields."""
    from repro_torch.models import layers

    fn = layers.moe_route
    calls: list = []

    def call(p, xg, cfg):
        out = fn(p, xg, cfg)
        calls.append(out[0].detach().float())
        return out

    layers.moe_route = call
    try:
        yield calls
    finally:
        layers.moe_route = fn


def _whole_gates(calls: list, tr) -> np.ndarray:
    """The gates of every call ``[calls, groups, g, E]`` over the whole
    batch: on a mesh each rank's rows (its groups) gathered in the order
    of the ranks over "data", the ranks over "model" holding the same."""
    import torch
    import torch.distributed as dist

    local = torch.stack(calls)
    if tr.mesh.size == 1:
        return local.numpy()
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, local.contiguous())
    data = tr.mesh.axis_names.index("data")
    by_row = {}
    for r, t in enumerate(parts):
        row = int(np.argwhere(tr.mesh.ranks == r)[0][data])
        assert row not in by_row or torch.equal(by_row[row], t), "model ranks differ"
        by_row.setdefault(row, t)
    return torch.cat([by_row[i] for i in sorted(by_row)], dim=1).numpy()


def _crash_and_restore(work: Path, dev) -> tuple[dict, dict]:
    """A crash at step 2 of 4 on ``(2, 1)`` (a checkpoint every step),
    resumed, against the run without one; then the resumed run's last
    checkpoint restored on ``(1, 2)``."""
    from repro_torch.models.params import flatten_tree
    from repro_torch.train.loop import FaultInjector, InjectedFailure

    ckpt = work / "ckpt"
    kw = dict(steps=4, ckpt_every=1, ckpt_dir=str(ckpt))
    out, arrays = {}, {}
    tr = _train_trainer("qwen", (2, 1), "bf16", dev, **kw)
    out["crashed"] = _raises(lambda: _run(tr, fault=FaultInjector((2,))), InjectedFailure)
    tr = _train_trainer("qwen", (2, 1), "bf16", dev, **kw)
    state = tr.resume_or_init()
    out["resumed at"] = state.step
    state = _run(tr, state)
    whole = _gathered({"params": state.params, "opt": state.opt})
    clean = _run(_train_trainer("qwen", (2, 1), "bf16", dev, steps=4))
    arrays.update({f"resumed {n}": v for n, v in whole.items()})
    arrays.update({f"clean {n}": v for n, v in _gathered({"params": clean.params}).items()})
    out["resumed losses"] = [m["loss"] for m in tr.metrics]
    re = _train_trainer("qwen", (1, 2), "bf16", dev, **kw)
    state = re.resume_or_init()
    out["restored 1x2 step"] = state.step
    out["restored 1x2 local shapes"] = {
        n: list(t.to_local().shape) for n, t in flatten_tree({"params": state.params})}
    arrays.update({f"restored 1x2 {n}": v
                   for n, v in _gathered({"params": state.params, "opt": state.opt}).items()})
    return arrays, out


def _raises(fn, exc) -> str | None:
    """The message of the ``exc`` that ``fn()`` raises, else ``None``."""
    try:
        fn()
    except exc as e:
        return str(e)
    return None


def _functional_in_backward(dev) -> dict:
    """The same product under autograd on a ``(1, 2)`` mesh, a replicated
    input times a weight sharded by columns, its input a DTensor made by
    ``DTensor.from_local`` and by the port's ``place_block``: the first's
    backward asks DTensor to all-reduce the input's partial gradient (a
    functional collective, which raises here), the port's all-reduces it
    through ``torch.distributed``. Returns the first's error and the
    port's gradient against the product's."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.dist.local import place_block

    mesh = _train_mesh((1, 2), dev).device_mesh()
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 8, generator=g)
    w = torch.randn(8, 6, generator=g)
    w_d = place_block(w.chunk(2, dim=1)[mesh.get_local_rank(1)], mesh, (Replicate(), Shard(1)),
                      w.shape)
    out = {}
    for how in ("DTensor.from_local", "place_block"):
        t = x.clone().requires_grad_(True)
        x_d = (DTensor.from_local(t, mesh, (Replicate(), Replicate()), run_check=False)
               if how == "DTensor.from_local" else
               place_block(t, mesh, (Replicate(), Replicate()), x.shape))
        y = x_d @ w_d
        try:
            (grad,) = torch.autograd.grad(y.to_local().sum(), t)
            out[how] = float((grad - w.sum(1)).abs().max())
        except RuntimeError as e:
            out[how] = f"RuntimeError: {e}"
    return out


# ------------------------------------------------- the MoE train suite
def _train_moe_jobs(rank: int, work: Path):
    import torch
    import torch.distributed as dist

    from repro_torch.dist.local import no_functional_collectives

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work / 'store'}", rank=rank,
                            world_size=WORLD)
    cpu = torch.device("cpu")
    out, arrays = {"rank": rank}, {}
    with no_functional_collectives():
        for name in C.TRAIN_MOE_CONFIGS:
            for shape in C.TRAIN_MESHES:
                key = C.train_key(name, shape, "f32")
                got, a = _moe_layer_grads(name, shape, cpu)
                out.update({f"{key} layer {k}": v for k, v in got.items()})
                arrays.update({f"{key} layer {k}": v for k, v in a.items()})
        for name, shape, dtype in C.TRAIN_MOE_CASES:
            key = C.train_key(name, shape, dtype)
            got, a = _train_case(name, shape, dtype, cpu)
            out.update({f"{key} {k}": v for k, v in got.items()})
            arrays.update({f"{key} {k}": v for k, v in a.items()})
    dist.barrier()
    dist.destroy_process_group()
    if rank:
        arrays = {}     # rank 0's gathered arrays are both ranks'
    return out, arrays


def _moe_layer_grads(name: str, shape, dev) -> tuple[dict, dict]:
    """Layer 0's MoE in f32 under autograd: the gradient of
    ``(apply_moe(x) * w).sum() + aux`` (the aux loss at weight 1, so its
    path is not drowned) with respect to ``x`` and every weight of the
    layer, on the mesh ``shape`` (the weights placed by the train rules,
    ``x`` by the residual stream's) and, on rank 0, on one device. Returns
    the loss on each side and each gradient, gathered whole."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist.local import full, is_dtensor, row_mean
    from repro_torch.dist.sharding import make_train_rules
    from repro_torch.models import materialize
    from repro_torch.models.layers import ShardCtx, apply_moe, describe_moe
    from repro_torch.models.params import device_put_tree, flatten_tree, sharding_tree

    cfg = _train_cfg(name)
    desc = _f32_tree(describe_moe(cfg))
    inputs = {k: torch.from_numpy(v) for k, v in C.moe_grad_inputs(cfg.d_model).items()}
    mesh = _train_mesh(shape, dev)
    rules = make_train_rules(mesh)
    ctx = ShardCtx(mesh, rules)
    dm = mesh.device_mesh()
    sides = ("mesh", "one")[:1 if dist.get_rank() else 2]
    out, arrays = {}, {}
    for side in sides:
        params = materialize(desc, seed=3)
        x = inputs["x"]
        if side == "mesh":
            params = device_put_tree(params, sharding_tree(desc, mesh, rules))
            x = device_put_tree({"x": x}, {"x": rules.sharding(
                mesh, ("batch", "seq", "embed_act"), tuple(x.shape))})["x"]
        leaves = [("x", x.requires_grad_(True))] + [
            (n, t.requires_grad_(True)) for n, t in flatten_tree(params)]
        with ctx.scope() if side == "mesh" else contextlib.nullcontext():
            if side == "mesh":
                params = ctx.params(params)     # as a block's body takes its weights
            y, aux = apply_moe(params, x, cfg, ctx if side == "mesh" else ShardCtx())
            if side == "mesh":
                rows = [i for i, p in enumerate(y.placements) if p.is_shard(0)]
                w = device_put_tree({"w": inputs["w"]}, {"w": rules.sharding(
                    mesh, ("batch", "seq", "embed_act"), tuple(x.shape))})["w"].to_local()
                part = (y.to_local(grad_placements=tuple(y.placements)) * w).sum()
                # the sum over every rank's rows, its backward the identity
                n = math.prod(mesh.device_mesh().size(i) for i in rows)
                loss = row_mean(part, dm, rows) * n + aux
            else:
                loss = (y * inputs["w"]).sum() + aux
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
        out[f"{side} loss"] = loss.item()
        out[f"{side} aux"] = aux.item()
        for (n, t), g in zip(leaves, grads):
            if is_dtensor(t):
                assert tuple(g.placements) == tuple(t.placements), (n, g.placements, t.placements)
                g = full(g)
            arrays[f"{side} grad {n}"] = g.detach().numpy()
    return out, arrays


# ------------------------------------------------- the SSM train suite
def _train_ssm_jobs(rank: int, work: Path):
    import torch
    import torch.distributed as dist

    from repro_torch.dist.local import no_functional_collectives

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work / 'store'}", rank=rank,
                            world_size=WORLD)
    cpu = torch.device("cpu")
    out, arrays = {"rank": rank}, {}
    with no_functional_collectives():
        for name in C.TRAIN_SSM_CONFIGS:
            for shape in C.TRAIN_MESHES:
                key = C.train_key(name, shape, "f32")
                got, a = _mamba_layer_grads(name, shape, cpu)
                out.update({f"{key} layer {k}": v for k, v in got.items()})
                arrays.update({f"{key} layer {k}": v for k, v in a.items()})
        for name, dtype in C.SSM_MODEL_CASES:
            key = C.ssm_key(name, dtype)
            got, a = _ssm_model_level(name, dtype, cpu)
            out.update({f"{key} {k}": v for k, v in got.items()})
            arrays.update({f"{key} {k}": v for k, v in a.items()})
        with _ssd_shapes() as seen:
            for name, shape, dtype in C.TRAIN_SSM_CASES:
                key = C.train_key(name, shape, dtype)
                seen.clear()
                got, a = _train_case(name, shape, dtype, cpu)
                out.update({f"{key} {k}": v for k, v in got.items()})
                out[f"{key} ssd heads"] = sorted(set(seen))
                arrays.update({f"{key} {k}": v for k, v in a.items()})
    dist.barrier()
    dist.destroy_process_group()
    if rank:
        arrays = {}     # rank 0's gathered arrays are both ranks'
    return out, arrays


@contextlib.contextmanager
def _ssd_shapes():
    """Record the head count of every SSD scan the block runs (``x``'s
    dimension 2), in the list it yields."""
    from repro_torch.models import layers

    fn = layers.ssd
    seen: list = []

    def call(x, *args, **kwargs):
        seen.append(int(x.shape[2]))
        return fn(x, *args, **kwargs)

    layers.ssd = call
    try:
        yield seen
    finally:
        layers.ssd = fn


def _mamba_layer_grads(name: str, shape, dev) -> tuple[dict, dict]:
    """Layer 0's Mamba-2 block in f32 under autograd: the gradient of
    ``(apply_mamba_block(x) * w).sum()`` with respect to ``x`` and every
    leaf of the block, on the mesh ``shape`` (the weights placed by the
    train rules, ``x`` by the residual stream's) and, on rank 0, on one
    device. Returns the loss on each side and each gradient, gathered
    whole."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist.local import full, is_dtensor, row_mean
    from repro_torch.dist.sharding import make_train_rules
    from repro_torch.models import materialize
    from repro_torch.models.layers import ShardCtx, apply_mamba_block, describe_mamba_block
    from repro_torch.models.params import device_put_tree, flatten_tree, sharding_tree

    cfg = _train_cfg(name)
    desc = _f32_tree(describe_mamba_block(cfg))
    inputs = {k: torch.from_numpy(v) for k, v in C.ssm_grad_inputs(cfg.d_model).items()}
    mesh = _train_mesh(shape, dev)
    rules = make_train_rules(mesh)
    ctx = ShardCtx(mesh, rules)
    dm = mesh.device_mesh()
    act = ("batch", "seq", "embed_act")
    sides = ("mesh", "one")[:1 if dist.get_rank() else 2]
    out, arrays = {}, {}
    for side in sides:
        params = materialize(desc, seed=4)
        x = inputs["x"]
        if side == "mesh":
            params = device_put_tree(params, sharding_tree(desc, mesh, rules))
            x = device_put_tree({"x": x}, {"x": rules.sharding(mesh, act, tuple(x.shape))})["x"]
        leaves = [("x", x.requires_grad_(True))] + [
            (n, t.requires_grad_(True)) for n, t in flatten_tree(params)]
        with ctx.scope() if side == "mesh" else contextlib.nullcontext():
            if side == "mesh":
                y, _ = apply_mamba_block(ctx.params(params), x, cfg, ctx=ctx)
                rows = [i for i, p in enumerate(y.placements) if p.is_shard(0)]
                w = device_put_tree({"w": inputs["w"]}, {"w": rules.sharding(
                    mesh, act, tuple(x.shape))})["w"].to_local()
                part = (y.to_local(grad_placements=tuple(y.placements)) * w).sum()
                # the sum over every rank's rows, its backward the identity
                loss = row_mean(part, dm, rows) * math.prod(dm.size(i) for i in rows)
            else:
                y, _ = apply_mamba_block(params, x, cfg)
                loss = (y * inputs["w"]).sum()
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
        out[f"{side} loss"] = loss.item()
        for (n, t), g in zip(leaves, grads):
            if is_dtensor(t):
                assert tuple(g.placements) == tuple(t.placements), (n, g.placements, t.placements)
                g = full(g)
            arrays[f"{side} grad {n}"] = g.detach().numpy()
    return out, arrays


def _ssm_model_level(name: str, dtype: str, dev) -> tuple[dict, dict]:
    """The reference's ``ssm_model_level`` on the port: the seed-0 weights
    placed by the decode rules on ``C.MESH``, ``Model.prefill`` and
    ``C.SSM_DECODE_STEPS`` teacher-forced ``Model.decode`` steps with a
    ``ShardCtx``; on rank 0 the same on one device. Returns the logits and
    the last cache gathered whole (the conv state reassembled from each
    rank's heads' channels and the shared ``B``/``C``), the bytes of the
    rank's SSM state and the heads and channels it holds."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist.sharding import make_decode_rules
    from repro_torch.models import Model, materialize
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.params import device_put_tree, sharding_tree

    cfg = _train_cfg(name)
    desc = Model(cfg).describe()
    desc = _f32_tree(desc) if dtype == "f32" else desc
    tok = {k: torch.from_numpy(v) for k, v in C.ssm_tokens(cfg.vocab_size).items()}
    mesh = _train_mesh(C.MESH, dev)
    rules = make_decode_rules(mesh, cfg.num_kv_heads)
    ctx = ShardCtx(mesh, rules)
    out, arrays = {}, {}
    sides = ("mesh", "one")[:1 if dist.get_rank() else 2]
    for side in sides:
        params = materialize(desc, seed=0)
        c = ctx if side == "mesh" else ShardCtx()
        if side == "mesh":
            params = device_put_tree(params, sharding_tree(desc, mesh, rules))
        model = Model(cfg, params)
        logits, cache = model.prefill({"tokens": tok["prompt"]}, ctx=c)
        arrays[f"{side} prefill logits"] = c.full(logits).numpy()
        cache = {k: c.local(v) for k, v in cache.items()}
        for kv in ("shared_k", "shared_v"):
            if kv in cache:
                t = cache[kv]
                slots = t.new_zeros((*t.shape[:2], C.SSM_MAX_SEQ, *t.shape[3:]))
                slots[:, :, :t.shape[2]] = t
                cache[kv] = slots
        S = C.SSM_PROMPT[1]
        for i, t in enumerate(tok["steps"]):
            lengths = torch.full((C.SSM_PROMPT[0],), S + i + 1, dtype=torch.int32)
            logits, cache = model.decode(cache, t, lengths, ctx=c)
            arrays[f"{side} step{i} logits"] = c.full(logits).numpy()
        if side == "mesh":
            out["ssm bytes"] = cache["ssm"].nbytes
            out["ssm heads"] = cache["ssm"].shape[-3]
            out["conv channels"] = cache["conv"].shape[-1]
            cache = _whole_ssm_cache(cache, cfg, mesh)
        arrays.update({f"{side} cache {k}": v.float().numpy() for k, v in cache.items()})
    return out, arrays


def _whole_ssm_cache(cache: dict, cfg, mesh) -> dict:
    """Each rank's ssm/hybrid cache gathered whole over "model": the SSM
    state and the shared slots by heads, the conv state reassembled in
    the reference's channel order from each rank's heads' ``x`` channels
    (``mamba_columns``) and the shared ``B``/``C``."""
    import torch
    import torch.distributed as dist

    from repro_torch.models.layers import mamba_columns

    def gathered(t):
        parts = [torch.empty_like(t) for _ in range(WORLD)]
        dist.all_gather(parts, t.contiguous())
        return parts

    out = {}
    for name, t in cache.items():
        parts = gathered(t)
        if name == "conv":
            whole = t.new_zeros((*t.shape[:-1], cfg.ssm_inner + 2 * cfg.ssm_state))
            for r, part in enumerate(parts):
                whole[..., mamba_columns(cfg, r, WORLD)[1]] = part
            out[name] = whole
        else:
            out[name] = torch.cat(parts, dim=t.ndim - 3 if name == "ssm" else t.ndim - 2)
    return out


# ------------------------------------------------- the families suite
def _train_families_jobs(rank: int, work: Path):
    import torch
    import torch.distributed as dist

    from repro_torch.dist.local import no_functional_collectives

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work / 'store'}", rank=rank,
                            world_size=WORLD)
    cpu = torch.device("cpu")
    out, arrays = {"rank": rank}, {}

    def add(key, got, a):
        out.update({f"{key} {k}": v for k, v in got.items()})
        arrays.update({f"{key} {k}": v for k, v in a.items()})

    with no_functional_collectives():
        for name, shape in C.BLOCK_CASES:
            add(f"{C.train_key(name, shape, 'f32')} block", *_family_block(name, shape, cpu))
        for name, dtype in C.FAMILY_MODEL_CASES:
            add(C.family_key(name, dtype), *_family_model_level(name, dtype, cpu))
        for name, shape, dtype in C.LOSS_CASES:
            add(f"{C.train_key(name, shape, dtype)} loss", *_family_loss(name, shape, dtype, cpu))
        for name, shape, dtype in C.GEMMA2_TRAIN_CASES:
            key = C.train_key(name, shape, dtype)
            with _heads_seen() as seen:
                add(key, *_train_case(name, shape, dtype, cpu))
            out[f"{key} heads seen"] = sorted(set(seen))
        for name in ("whisper", "internvl2"):
            for shape in (*C.TRAIN_MESHES, None):
                where = "one" if shape is None else f"{shape[0]}x{shape[1]}"
                out[f"{name} trainer {where}"] = _trainer_first_step(name, shape, cpu)
        out["vlm engine"] = _vlm_engine(cpu)
    dist.barrier()
    dist.destroy_process_group()
    if rank:
        arrays = {}     # rank 0's gathered arrays are both ranks'
    return out, arrays


@contextlib.contextmanager
def _heads_seen():
    """Record ``(kernel, query heads, KV heads)`` of every attention call on
    plain tensors while the block runs (on a mesh, each rank's local call),
    in the list it yields: the flash kernel's plain version and the slot
    cache's decode attention (which on the card reads the slots with the
    paged kernel)."""
    from repro_torch.dist.local import is_dtensor
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import layers

    flash, decode = flash_ops.blockwise_attention, layers.decode_attention
    seen: list = []

    def flash_call(q, k, v, **kw):
        seen.append(("flash", int(q.shape[2]), int(k.shape[2])))
        return flash(q, k, v, **kw)

    def decode_call(q, k_cache, v_cache, **kw):
        if not is_dtensor(q):
            seen.append(("paged", int(q.shape[1]), int(k_cache.shape[2])))
        return decode(q, k_cache, v_cache, **kw)

    flash_ops.blockwise_attention, layers.decode_attention = flash_call, decode_call
    try:
        yield seen
    finally:
        flash_ops.blockwise_attention, layers.decode_attention = flash, decode


def _layer_desc(tree):
    """A stacked descriptor tree less its leading layer dimension."""
    from repro_torch.models.params import Leaf

    if isinstance(tree, Leaf):
        return dataclasses.replace(tree, shape=tree.shape[1:], axes=tree.axes[1:])
    return {k: _layer_desc(v) for k, v in tree.items()}


def _family_block(name: str, shape, dev) -> tuple[dict, dict]:
    """One block in f32 under autograd: gemma2's (local, global) pair over
    a sequence longer than its window, or whisper's decoder block (self-
    and cross-attention, the FFN) over an encoder output ``enc`` placed by
    rows and whole over "model" (a rank's block entering through
    ``place_block``, as the encoder's final norm hands it over). The
    gradient of ``(block(x) * w).sum()`` with respect to ``x``, ``enc``
    and every leaf, on the mesh ``shape`` (train rules) and, on rank 0,
    one device, each gathered whole. On ``(1, 2)`` also 3 decode steps from
    the sequence's caches (gemma2's local layer over a ring of
    ``C.RING_SLOTS`` slots): each step's output, whole."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist.local import full, is_dtensor, place_block, row_mean
    from repro_torch.dist.sharding import make_train_rules
    from repro_torch.models import Model, materialize
    from repro_torch.models.layers import ShardCtx, apply_dense_block
    from repro_torch.models.params import device_put_tree, flatten_tree, put_block, sharding_tree

    cfg = _train_cfg(name)
    desc = _f32_tree(_layer_desc(Model(cfg).describe()["blocks"]))
    inputs = {k: torch.from_numpy(v) for k, v in C.block_inputs(name, cfg).items()}
    mesh = _train_mesh(shape, dev)
    rules = make_train_rules(mesh)
    dm = mesh.device_mesh()
    act = ("batch", "seq", "embed_act")
    B, S = C.BLOCK_SHAPE[name]
    positions = torch.arange(S)[None, :]
    out, arrays = {}, {}
    for side in ("mesh", "one")[:1 if dist.get_rank() else 2]:
        on_mesh = side == "mesh"
        ctx = ShardCtx(mesh, rules) if on_mesh else ShardCtx()
        model = Model(cfg)

        def put(t):
            return put_block(t, rules.sharding(mesh, act, tuple(t.shape))) if on_mesh else t

        params = materialize(desc, seed=5)
        if on_mesh:
            params = device_put_tree(params, sharding_tree(desc, mesh, rules))
        x = put(inputs["x"]).requires_grad_(True)
        leaves = [("x", x)] + [(n, t.requires_grad_(True)) for n, t in flatten_tree(params)]
        enc_out = None
        if name == "whisper":
            enc = put(inputs["enc"])
            e = (enc.to_local() if on_mesh else enc).requires_grad_(True)
            leaves.append(("enc", e))
            enc_out = place_block(e, dm, enc.placements, enc.shape) if on_mesh else e
        with ctx.scope():
            p = ctx.params(params)
            if name == "gemma2":
                h, kv_l = apply_dense_block(p["local"], x, cfg, positions=positions,
                                            window=cfg.sliding_window, ctx=ctx)
                y, kv_g = apply_dense_block(p["global"], h, cfg, positions=positions, ctx=ctx)
                caches = (kv_l, kv_g)
            else:
                y, kv, ckv = model._decoder_block(p, x, positions, enc_out=enc_out, ctx=ctx)
                caches = (kv, ckv)
            w = put(inputs["w"])
            if on_mesh:
                rows = [i for i, pl in enumerate(y.placements) if pl.is_shard(0)]
                part = (y.to_local(grad_placements=tuple(y.placements)) * w.to_local()).sum()
                # the sum over every rank's rows, its backward the identity
                loss = row_mean(part, dm, rows) * math.prod(dm.size(i) for i in rows)
            else:
                loss = (y * w).sum()
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
        out[f"{side} loss"] = loss.item()
        for (n, t), g in zip(leaves, grads):
            if n == "enc" and on_mesh:
                g = place_block(g, dm, enc.placements, enc.shape)
            elif is_dtensor(t):
                assert tuple(g.placements) == tuple(t.placements), (n, g.placements, t.placements)
            arrays[f"{side} grad {n}"] = (full(g) if is_dtensor(g) else g).detach().numpy()
        if on_mesh and shape[0] > 1:
            continue        # a decode step takes its batch whole over "data"
        with torch.no_grad(), ctx.scope():
            caches = [tuple(ctx.local(t).detach() for t in kv) for kv in caches]
            steps = [put(inputs["w"][:, i:i + 1]) for i in range(3)]
            for i, xs in enumerate(steps):
                lengths = torch.full((B,), S + i + 1, dtype=torch.int32)
                pos = (lengths - 1)[:, None]
                if name == "gemma2":
                    if i == 0:
                        (lk, lv), (gk, gv) = caches
                        caches = ((_ring(lk, S, C.RING_SLOTS), _ring(lv, S, C.RING_SLOTS)),
                                  (_padded(gk, S + 3), _padded(gv, S + 3)))
                    (lk, lv), (gk, gv) = caches
                    h, _ = apply_dense_block(p["local"], xs, cfg, positions=pos,
                                             window=cfg.sliding_window, cache=(lk, lv),
                                             lengths=lengths, ring_window=C.RING_SLOTS, ctx=ctx)
                    y, _ = apply_dense_block(p["global"], h, cfg, positions=pos, cache=(gk, gv),
                                             lengths=lengths, ctx=ctx)
                else:
                    if i == 0:
                        (k, v), (ck, cv) = caches
                        caches = (_padded(k, S + 3), _padded(v, S + 3), ck, cv)
                    y, _, _ = model._decoder_block(p, xs, pos, cache=caches, lengths=lengths,
                                                   ctx=ctx)
                arrays[f"{side} step{i}"] = ctx.full(y).numpy()
    return out, arrays


def _ring(t, length: int, slots: int):
    """Full-sequence K/V ``[..., B, S, KH, HD]`` (positions at dimension
    -3) as a ring of ``slots``: position ``p`` of the last ``slots`` at
    slot ``p % slots``."""
    import torch

    ring = t.new_zeros((*t.shape[:-3], slots, *t.shape[-2:]))
    idx = torch.arange(length - slots, length)
    ring[..., idx % slots, :, :] = t[..., length - slots:length, :, :]
    return ring


def _padded(t, slots: int):
    """K/V ``[..., S, KH, HD]`` in the first ``S`` of ``slots`` zeroed slots."""
    out = t.new_zeros((*t.shape[:-3], slots, *t.shape[-2:]))
    out[..., :t.shape[-3], :, :] = t
    return out


def _family_slots(name: str, cfg, cache: dict) -> dict:
    """The reference's ``family_cache`` on the port's tensors (a rank's own
    blocks on a mesh)."""
    S = C.prompt_length(name, cfg)
    if name == "gemma2":
        return {"local": {k: _ring(v, S, C.RING_SLOTS) for k, v in cache["local"].items()},
                "global": {k: _padded(v, C.FAMILY_MAX_SEQ) for k, v in cache["global"].items()}}
    return {k: v if k in ("ck", "cv") else _padded(v, C.FAMILY_MAX_SEQ) for k, v in cache.items()}


def _whole_kv(t, kv_heads: int):
    """A rank's block of K/V ``[..., KH/n, HD]`` gathered whole over the
    ranks (as it is where the rank holds every KV head)."""
    import torch
    import torch.distributed as dist

    if t.shape[-2] == kv_heads:
        return t
    parts = [torch.empty_like(t) for _ in range(WORLD)]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts, dim=-2)


def _family_model_level(name: str, dtype: str, dev) -> tuple[dict, dict]:
    """The reference's ``family_model_level`` on the port: the seed-0
    weights placed by the decode rules on ``C.MESH``, ``Model.prefill`` and
    ``C.FAMILY_DECODE_STEPS`` teacher-forced ``Model.decode`` steps with a
    ``ShardCtx`` over the rank's own caches; on rank 0 the same on one
    device. Returns the logits and the last cache gathered whole, the
    bytes of the rank's parameters and caches, and the heads every
    attention call saw."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist.sharding import make_decode_rules
    from repro_torch.models import Model, materialize
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.params import _unflatten, device_put_tree, flatten_tree, sharding_tree

    cfg = _train_cfg(name)
    desc = Model(cfg).describe()
    desc = _f32_tree(desc) if dtype == "f32" else desc
    inp = {k: torch.from_numpy(v) for k, v in C.family_prompt(name, cfg).items()}
    steps = inp.pop("steps")
    mesh = _train_mesh(C.MESH, dev)
    rules = make_decode_rules(mesh, cfg.num_kv_heads)
    S = C.prompt_length(name, cfg)
    out, arrays = {}, {}
    for side in ("mesh", "one")[:1 if dist.get_rank() else 2]:
        params = materialize(desc, seed=0)
        c = ShardCtx(mesh, rules) if side == "mesh" else ShardCtx()
        if side == "mesh":
            params = device_put_tree(params, sharding_tree(desc, mesh, rules))
        model = Model(cfg, params)
        with _heads_seen() as seen:
            logits, cache = model.prefill(inp, ctx=c)
            arrays[f"{side} prefill logits"] = c.full(logits).numpy()
            cache = _family_slots(name, cfg, _unflatten(
                [(n, c.local(t)) for n, t in flatten_tree(cache)]))
            for i, t in enumerate(steps):
                lengths = torch.full((t.shape[0],), S + i + 1, dtype=torch.int32)
                logits, cache = model.decode(cache, t, lengths, ctx=c)
                arrays[f"{side} step{i} logits"] = c.full(logits).numpy()
        flat = list(flatten_tree(cache))
        if side == "mesh":
            out["param bytes"] = _held_bytes(params)
            out["cache bytes"] = sum(t.nbytes for _, t in flat)
            out["heads seen"] = sorted(set(seen))
            flat = [(n, _whole_kv(t, cfg.num_kv_heads)) for n, t in flat]
        arrays.update({f"{side} cache {n}": t.float().numpy() for n, t in flat})
    return out, arrays


def _family_loss(name: str, shape, dtype: str, dev) -> tuple[dict, dict]:
    """``Model.loss`` and its gradient on ``C.loss_inputs`` with a
    ``ShardCtx`` on the mesh ``shape`` (the weights placed by the train
    rules, the tokens by rows; ``frames``/``image_embeds`` whole on every
    rank, placed by the model) and, on rank 0, on one device. Returns the
    losses, each gradient gathered whole, and the heads every attention
    call of the mesh's forward and backward saw."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist.local import full, is_dtensor
    from repro_torch.dist.sharding import make_train_rules
    from repro_torch.models import Model, materialize
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.params import device_put_tree, flatten_tree, put_block, sharding_tree

    cfg = _train_cfg(name)
    desc = Model(cfg).describe()
    desc = _f32_tree(desc) if dtype == "f32" else desc
    inputs = {k: torch.from_numpy(v) for k, v in C.loss_inputs(name, cfg).items()}
    mesh = _train_mesh(shape, dev)
    rules = make_train_rules(mesh)
    out, arrays = {}, {}
    for side in ("mesh", "one")[:1 if dist.get_rank() else 2]:
        params = materialize(desc, seed=0)
        batch = dict(inputs)
        ctx = ShardCtx()
        if side == "mesh":
            ctx = ShardCtx(mesh, rules)
            params = device_put_tree(params, sharding_tree(desc, mesh, rules))
            tok = batch["tokens"]
            batch["tokens"] = put_block(tok, rules.sharding(mesh, ("batch", None), tok.shape))
        leaves = [t.requires_grad_(True) for _, t in flatten_tree(params)]
        with _heads_seen() as seen:
            loss, _ = Model(cfg, params).loss(batch, ctx)
            grads = torch.autograd.grad(loss, leaves)
        out[side] = loss.item()
        if side == "mesh":
            out["heads seen"] = sorted(set(seen))
        for (n, t), g in zip(flatten_tree(params), grads):
            if is_dtensor(t):
                assert tuple(g.placements) == tuple(t.placements), (n, g.placements, t.placements)
                g = full(g)
            arrays[f"{side} grad {n}"] = g.float().numpy()
    return out, arrays


def _trainer_first_step(name: str, shape, dev) -> str | None:
    """A ``Trainer`` of ``name`` on the mesh ``shape`` (on ``dev`` alone
    for ``shape`` None): built, then its first step; the error that step
    raises (``repr``), else ``None``."""
    tr = _train_trainer(name, shape, "bf16", dev, steps=1)
    state = tr.init_state()
    try:
        tr.train_step(state, tr._tokens_for(0))
    except Exception as e:  # noqa: BLE001 (the error is the result)
        return repr(e)
    return None


def _vlm_engine(dev) -> dict:
    """Reduced internvl2 in an ``Engine`` on ``C.MESH`` and on one device:
    whether each is built, and the error its first prefill raises."""
    from repro_torch.models import Model, materialize
    from repro_torch.serving import Engine, EngineRequest

    cfg = _train_cfg("internvl2")
    params = materialize(Model(cfg).describe(), seed=0)
    out = {}
    for side in ("mesh", "one"):
        kw = dict(placement=_replica_set(cfg, dev).placement(0)) if side == "mesh" else \
            dict(device=dev)
        engine = Engine(cfg, params, **kw, **C.ENGINE_KW)
        out[f"{side} built"] = True
        try:
            engine.submit(EngineRequest("a", C.contexts(cfg.vocab_size)["a"], max_new_tokens=2))
            engine.run_to_completion()
            out[f"{side} first prefill"] = None
        except Exception as e:  # noqa: BLE001 (the error is the result)
            out[f"{side} first prefill"] = repr(e)
    return out
