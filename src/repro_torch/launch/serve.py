"""Serving launcher of the port: the MORI router over engine replicas.

    python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --replicas 2 --programs 8

The counterpart of ``repro.launch.serve``, with the same defaults. It runs
the full-width configuration on the GPU by default; ``--reduced`` serves
the smoke-test size and ``--device cpu`` runs on the CPU (with no CUDA
device and no ``--device cpu`` it raises). The replicas come from one
:func:`~repro_torch.dist.make_replica_set`, one engine a placement, all
under one rules object: on one card (or ``--device cpu``) every replica
aliases that device and the engines share one copy of the weights.
``--snapshot`` persists the control plane each run; ``--resume`` restores
it first.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.core.types import SchedulerConfig
from repro_torch.dist import make_replica_set
from repro_torch.launch.mesh import devices_for
from repro_torch.models import Model, materialize
from repro_torch.serving import Engine, MoriRouter
from repro_torch.serving.engine import check_servable
from repro_torch.serving.state_io import restore_snapshot, save_snapshot
from repro_torch.traces import TraceGenConfig, generate_corpus


#: the launcher's engine geometry: 16-token pages, 72 device and 160 host
#: pages, 3 decode slots of up to 384 tokens
ENGINE_POOLS = dict(page_tokens=16, n_device_pages=72, n_host_pages=160, max_slots=3,
                    max_seq=384)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the smoke-test size instead of full width")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scheduler", default="mori",
                    choices=["mori", "ta+o", "ta", "smg"])
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--programs", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=4)
    ap.add_argument("--gpu-pages", type=int, default=8,
                    help="scheduler GPU budget (pages/replica)")
    ap.add_argument("--cpu-pages", type=int, default=20)
    ap.add_argument("--snapshot", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--serial-decode", action="store_true",
                    help="pre-pump compatibility mode: run each request "
                         "to completion instead of batched decode")
    return ap.parse_args(argv)


def build_router(args: argparse.Namespace):
    """Config, shared weights, engines and router for ``args``; returns
    ``(cfg, engines, router)``. ``--device cuda`` (the default) places the
    replicas on the cards, any other device on that device alone."""
    # the devices first: no card and no --device cpu raises
    devices = devices_for(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    check_servable(cfg)      # before any weight is drawn
    # one rules object shared by all replicas: a program migrated between
    # replicas lands on an identical layout
    replica_set = make_replica_set(args.replicas, num_kv_heads=cfg.num_kv_heads,
                                   devices=devices)
    # drawn onto the first replica's device, where every aliasing replica
    # takes the tensors as they are
    params = materialize(Model(cfg).describe(), seed=0,
                         device=replica_set.placement(0).mesh.device())
    engines = [Engine(cfg, params, placement=placement, **ENGINE_POOLS)
               for placement in replica_set]
    router = MoriRouter(
        engines,
        scheduler=args.scheduler,
        gpu_capacity_bytes=engines[0].pool.page_bytes * args.gpu_pages,  # lint: kv008-ok (GPU budget at device format)
        cpu_capacity_bytes=engines[0].pool.host_page_bytes * args.cpu_pages,
        config=SchedulerConfig(tick_interval_s=1.0),
        serial_decode=args.serial_decode,
    )
    return cfg, engines, router


def corpus_for(args: argparse.Namespace):
    return generate_corpus(
        args.programs, seed=1,
        cfg=TraceGenConfig(
            min_steps=4, mean_steps=7, max_steps=9,
            initial_context_mean=900, max_context=2400,
            long_median_s=45.0, busy_calls_mean=3.0, idle_calls_mean=3.0,
        ),
    )


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg, engines, router = build_router(args)
    if args.resume and args.snapshot and Path(args.snapshot).exists():
        counters = restore_snapshot(router, args.snapshot)
        print(f"resumed control plane: {counters}")
    corpus = corpus_for(args)
    print(f"serving {len(corpus)} programs of {cfg.name} ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}) on {args.replicas} replicas ({args.scheduler}, "
          f"{engines[0].device})")
    m = router.replay(corpus, vocab_size=cfg.vocab_size,
                      max_new_tokens=args.max_new_tokens)
    print(f"steps {m.steps_completed}  tokens {m.tokens_generated}  "
          f"hit {m.cache_hit_rate:.1%}  offl {m.offloaded_pages}  "
          f"reload {m.reloaded_pages}  gated {m.gated_events}")
    print(f"decode dispatches {m.pump_steps}  batch occupancy "
          f"{m.mean_batch_occupancy:.2f} (peak {m.peak_live_slots})  "
          f"slot wait {m.slot_wait_s:.1f}s  overlap steps "
          f"{m.overlap_decode_steps}")
    if args.snapshot:
        save_snapshot(router, args.snapshot)
        print(f"control plane snapshot -> {args.snapshot}")


if __name__ == "__main__":
    main()
