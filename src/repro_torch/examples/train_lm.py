"""Train an LM for a few hundred steps with the full substrate: the
deterministic data pipeline, gradient accumulation, atomic checkpoints,
and a crash injected mid-run and restarted from the newest checkpoint.

The counterpart of ``examples/train_lm.py``: the trainer runs on
``make_host_mesh`` of ``--device`` (the card by default). The defaults
are small (~36M params); on the card scale up:

    python -m repro_torch.examples.train_lm \\
        --d-model 768 --layers 12 --batch 32 --steps 300    # ~110M params
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
from dataclasses import replace

import numpy as np

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import Model
from repro_torch.models.params import leaves
from repro_torch.train.data import DataConfig
from repro_torch.train.loop import FaultInjector, InjectedFailure, TrainConfig, Trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.train_lm")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--d-model", type=int, default=384)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    mesh = make_host_mesh(args.device)

    # a qwen-family config (vocab dominates at small scale)
    cfg = replace(
        get_config("qwen1.5-0.5b"),
        num_layers=args.layers,
        d_model=args.d_model,
        num_heads=args.d_model // 64,
        num_kv_heads=args.d_model // 64,
        head_dim=64,
        d_ff=args.d_model * 3,
        vocab_size=32_000,
    )
    n = sum(int(np.prod(l.shape)) for _, l in leaves(Model(cfg).describe()))
    print(f"model: {n/1e6:.1f}M params, {args.steps} steps, "
          f"batch {args.batch} x seq {args.seq_len}, "
          f"{args.microbatches} microbatches, mesh {dict(mesh.shape)} on {mesh.device()}")

    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_train_")
    tcfg = TrainConfig(
        steps=args.steps,
        microbatches=args.microbatches,
        lr=1e-3,
        ckpt_every=max(10, args.steps // 8),
        ckpt_dir=ckpt_dir,
        log_every=max(1, args.steps // 20),
    )
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.batch)
    trainer = Trainer(cfg, tcfg, data, mesh=mesh)
    try:
        # crash mid-run, then restart from the checkpoint: the same trajectory
        fault = FaultInjector(fail_at=(args.steps // 2,))
        state = trainer.resume_or_init()
        while True:
            try:
                state = trainer.run(state, fault)
                break
            except InjectedFailure as e:
                print(f"!! {e} — restarting from newest checkpoint")
                state = trainer.resume_or_init()
                print(f"   resumed at step {state.step}")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    first, last = trainer.metrics[0], trainer.metrics[-1]
    print(f"\nloss {first['loss']:.3f} (step {first['step']}) -> "
          f"{last['loss']:.3f} (step {last['step']})")
    if not last["loss"] < first["loss"]:
        raise SystemExit("the loss did not decrease")
    print("ok")


if __name__ == "__main__":
    main()
