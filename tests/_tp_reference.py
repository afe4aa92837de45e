"""The reference side of ``tests/test_torch_tp.py``, run as a script in a
process of its own: ``python _tp_reference.py <work dir>``.

JAX sees two CPU devices only if ``XLA_FLAGS`` is set before it is first
imported (as ``src/repro/launch/dryrun.py`` does), so this runs apart from
the test process, which imports JAX already. On a ``(1, 2)`` mesh it
serves reduced qwen1.5-0.5b (and its GQA 6/3 variant) through the
reference's ``Engine(placement=...)``, monolithic and chunked, and replays
the router corpus over two replicas aliasing the mesh. It writes the
seed-0 weights first (``params_<config>.npz``, bf16 as its bits), so the
port's ranks can start on them, then ``results.json`` and ``pools.npz``.
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
import repro.dist as jdist  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core.actions import action_to_json  # noqa: E402
from repro.core.types import ProgramTrace, RequestRecord, SchedulerConfig, TransferCost  # noqa: E402
from repro.kernels import kv_quant  # noqa: E402
from repro.models import Model, materialize  # noqa: E402
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


def serve(engine, chunked: bool, ctxs: dict) -> dict:
    for pid, ctx in ctxs.items():
        req = EngineRequest(pid, ctx, max_new_tokens=C.NEW_TOKENS)
        if chunked:
            job = engine.begin_submit(req)
            while not engine.prefill_step(job):
                pass
        else:
            engine.submit(req)
    return {c.program_id: list(c.output_tokens) for c in engine.run_to_completion()}


def replay(cfg, params) -> dict:
    rs = jdist.make_replica_set(2, mesh_shape=C.MESH, num_kv_heads=cfg.num_kv_heads)
    engines = [Engine(cfg, params, placement=p, **C.ROUTER_ENGINE_KW) for p in rs]
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
    main(Path(sys.argv[1]))
