"""Training launcher of the port.

    python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --steps 50 --reduced --ckpt-dir /tmp/ckpt --device cpu

The counterpart of ``repro.launch.train``, with its flags, defaults and
output lines, plus ``--device`` (default ``cuda``; with no CUDA device and
no ``--device cpu`` it raises). ``--reduced`` swaps in the architecture's
smoke-scale config. Restart the same command after a crash and it resumes
from the newest valid checkpoint. The trainer gets ``make_host_mesh`` on
``--device``, or with ``--production-mesh`` the H100 fleet's 32 x 8 mesh
(:mod:`repro_torch.launch.mesh`), which needs 256 cards: with fewer it
raises. On a mesh of more than one device the trainer steps SPMD, one
process a card with its process group up (FSDP over "data", tensor
parallel over "model", the dense family); this launcher starts one
process and makes no process group, so it runs the one-device mesh, as
the reference's launcher runs on the devices its one process sees.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.train.data import DataConfig
from repro_torch.train.loop import (
    FaultInjector,
    InjectedFailure,
    TrainConfig,
    Trainer,
    TrainState,
)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale model config (CPU-runnable)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="32x8 H100 mesh (requires 256 devices)")
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject a crash at these steps (fault-tolerance demo)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build_trainer(args: argparse.Namespace) -> Trainer:
    """The :class:`Trainer` the flags describe."""
    mesh = make_production_mesh() if args.production_mesh else make_host_mesh(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainConfig(
        steps=args.steps,
        microbatches=args.microbatches,
        lr=args.lr,
        ckpt_every=args.ckpt_every if args.ckpt_dir else 0,
        ckpt_dir=args.ckpt_dir,
    )
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.global_batch)
    return Trainer(cfg, tcfg, data, mesh=mesh)


def train(trainer: Trainer, state: TrainState, fault: FaultInjector | None = None) -> TrainState:
    """Run ``state`` to the configured step, restarting from the newest
    checkpoint after each injected failure (any other error propagates)."""
    while True:
        try:
            return trainer.run(state, fault)
        except InjectedFailure as e:
            print(f"!! {e} — restarting from checkpoint")
            state = trainer.resume_or_init()


def main(argv=None) -> None:
    args = parse_args(argv)
    trainer = build_trainer(args)
    fault = FaultInjector(tuple(args.fail_at)) if args.fail_at else None
    state = trainer.resume_or_init()
    print(f"training {trainer.cfg.name} from step {state.step} to {trainer.tcfg.steps} "
          f"on mesh {dict(trainer.mesh.shape)} ({trainer.device})")
    state = train(trainer, state, fault)
    for m in trainer.metrics:
        print(json.dumps(m))
    print(f"done at step {state.step}")


if __name__ == "__main__":
    main()
