"""The port's side of ``tests/test_torch_tp.py``: two ``gloo`` ranks on the
CPU, one a position of a ``(1, 2)`` mesh, each in a process of its own.

:func:`start` spawns them over a file store in the caller's work
directory (no TCP port, so parallel test workers never collide), and
:func:`join` waits for them within a deadline and kills them past it. Each rank waits for the reference's
seed-0 weights (``params_<config>.npz``, written by ``_tp_reference.py``),
carries them across with ``load_jax_params`` and runs the same jobs as
the reference: the kernel entry points on DTensors under ``local_map``,
the sharded engine (monolithic and chunked, reduced qwen and its GQA 6/3
variant) and the router's replay over two replicas aliasing the mesh.
Every collective goes through ``torch.distributed`` (DTensor's functional
collectives are refused). Imports torch, numpy and the port, never JAX.
"""
from __future__ import annotations

import dataclasses
import json
import multiprocessing as mp
import time
import traceback
from pathlib import Path

import numpy as np

import _tp_common as C

WORLD = 2


def start(work: Path) -> list:
    """Spawn the ranks over a file store in ``work``."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, str(work))) for r in range(WORLD)]
    for p in procs:
        p.start()
    return procs


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


def _rank(rank: int, work: str) -> None:
    work = Path(work)
    try:
        out, arrays = _jobs(rank, work)
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


def _serve(cfg, params, rs, chunked: bool):
    from repro_torch.serving import Engine, EngineRequest

    engine = Engine(cfg, params, placement=rs.placement(0), **C.ENGINE_KW)
    for pid, ctx in C.contexts(cfg.vocab_size).items():
        req = EngineRequest(pid, ctx, max_new_tokens=C.NEW_TOKENS)
        if chunked:
            job = engine.begin_submit(req)
            while not engine.prefill_step(job):
                pass
        else:
            engine.submit(req)
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


def _replay(cfg, params, dev) -> dict:
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
    engines = [Engine(cfg, placed, placement=p, **C.ROUTER_ENGINE_KW) for p in rs]
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
                rank_page_bytes=engines[0].pool.rank_page_bytes)
