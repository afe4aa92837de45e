"""End-to-end serving: MORI against the paper's baselines.

Replays an agentic trace corpus against DP=2 engines of a reduced model
under every scheduler (mori / ta+o / ta / smg), with the GPU tier
deliberately undersized so placement policy matters, then prints the
comparison table. The counterpart of ``examples/serve_agents.py``; the
replicas come from one replica set, as the serving launcher places them.

    python -m repro_torch.examples.serve_agents [--programs 8] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_config
from repro_torch.core.types import SchedulerConfig
from repro_torch.dist import make_replica_set
from repro_torch.launch.mesh import devices_for
from repro_torch.launch.serve import ENGINE_POOLS
from repro_torch.models import Model, materialize
from repro_torch.serving import Engine, MoriRouter
from repro_torch.traces import TraceGenConfig, generate_corpus

SCHEDS = ["mori", "ta+o", "ta", "smg"]


def build_router(sched: str, cfg, params, replica_set) -> MoriRouter:
    engines = [Engine(cfg, params, placement=p, **ENGINE_POOLS) for p in replica_set]
    for e in engines:
        e.warmup()
    return MoriRouter(
        engines,
        scheduler=sched,
        # undersize the tiers so placement decisions are exercised
        gpu_capacity_bytes=engines[0].pool.page_bytes * 8,  # lint: kv008-ok (GPU budget at device format)
        cpu_capacity_bytes=engines[0].pool.host_page_bytes * 20,
        config=SchedulerConfig(tick_interval_s=1.0),
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.serve_agents")
    ap.add_argument("--programs", type=int, default=8)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    devices = devices_for(args.device)

    cfg = get_config("qwen1.5-0.5b").reduced()
    replica_set = make_replica_set(args.replicas, num_kv_heads=cfg.num_kv_heads,
                                   devices=devices)
    params = materialize(Model(cfg).describe(), seed=0,
                         device=replica_set.placement(0).mesh.device())
    corpus = generate_corpus(
        args.programs, seed=1,
        cfg=TraceGenConfig(
            min_steps=4, mean_steps=7, max_steps=9,
            initial_context_mean=900, max_context=2400,
            long_median_s=45.0, busy_calls_mean=3.0, idle_calls_mean=3.0,
        ),
    )

    print(f"{args.programs} programs x {args.replicas} replicas, "
          f"schedulers: {', '.join(SCHEDS)}\n")
    header = (f"{'sched':<6} {'steps':>6} {'tokens':>7} {'hit%':>6} "
              f"{'offl':>6} {'reload':>7} {'gated':>6} {'ovlp':>5} "
              f"{'cancl':>6} {'wall_s':>7}")
    print(header)
    print("-" * len(header))
    for sched in SCHEDS:
        router = build_router(sched, cfg, params, replica_set)
        t0 = time.time()
        m = router.replay(corpus, vocab_size=cfg.vocab_size, max_new_tokens=4)
        print(
            f"{sched:<6} {m.steps_completed:>6} {m.tokens_generated:>7} "
            f"{m.cache_hit_rate:>6.1%} {m.offloaded_pages:>6} "
            f"{m.reloaded_pages:>7} {m.gated_events:>6} "
            f"{m.overlap_decode_steps:>5} {m.cancelled_offloads:>6} "
            f"{time.time() - t0:>7.1f}"
        )
    print("\nhigher hit% / fewer gated events = better placement")


if __name__ == "__main__":
    main()
