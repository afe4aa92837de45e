"""Quickstart: the MORI scheduler end to end on the port.

Serves a reduced dense model with the port's engine behind the MORI
router, replays a small agentic trace corpus, and prints the placement and
cache metrics the paper's evaluation is built on. The counterpart of
``examples/quickstart.py``; the engine is warmed first (one decode graph a
table bucket on the card).

    python -m repro_torch.examples.quickstart               # on the card
    python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.dist import make_replica_set
from repro_torch.launch.mesh import devices_for
from repro_torch.models import Model, materialize
from repro_torch.serving import Engine, MoriRouter
from repro_torch.traces import TraceGenConfig, generate_corpus


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--programs", type=int, default=6)
    args = ap.parse_args(argv)
    devices = devices_for(args.device)

    # 1. a reduced qwen1.5-family config (the same code path as 0.5B)
    cfg = get_config("qwen1.5-0.5b").reduced()

    # 2. a one-replica placement on a 1x1 mesh: the same repro_torch.dist
    #    decode rules the H100 fleet's production layout resolves
    placement = make_replica_set(1, num_kv_heads=cfg.num_kv_heads,
                                 devices=devices).placement(0)
    params = materialize(Model(cfg).describe(), seed=0, device=placement.mesh.device())
    print(f"host mesh {dict(placement.mesh.shape)} on {placement.mesh.device()}, "
          f"logits spec {placement.spec(('batch', 'vocab_act'))}")

    # 3. one engine: paged KV pool (device and host tiers), radix prefix
    #    cache with typed eviction, continuous-batching decode
    engine = Engine(
        cfg, params,
        page_tokens=16, n_device_pages=96, n_host_pages=192,
        max_slots=4, max_seq=256,
        placement=placement,
    )
    engine.warmup()

    # 4. the MORI router: windowed idleness ranking, three-tier placement,
    #    sticky rebalancing, admission control (paper §4)
    router = MoriRouter([engine], scheduler="mori")

    # 5. an agentic trace corpus (busy/idle two-phase structure, §3)
    corpus = generate_corpus(
        args.programs, seed=0,
        cfg=TraceGenConfig(
            min_steps=3, mean_steps=5, max_steps=6,
            initial_context_mean=600, max_context=2000,
        ),
    )

    print(f"replaying {len(corpus)} agent programs on 1 engine...")
    m = router.replay(corpus, vocab_size=cfg.vocab_size, max_new_tokens=4)

    print(f"  completed steps     : {m.steps_completed}")
    print(f"  output tokens       : {m.tokens_generated}")
    print(f"  cache hit rate      : {m.cache_hit_rate:.1%}")
    print(f"  pages offloaded     : {m.offloaded_pages}")
    print(f"  pages reloaded      : {m.reloaded_pages}")
    print(f"  gated events        : {m.gated_events}")
    if m.steps_completed <= 0:
        raise SystemExit("the replay completed no program step")
    print("ok — see repro_torch.examples.serve_agents for the scheduler comparison")


if __name__ == "__main__":
    main()
