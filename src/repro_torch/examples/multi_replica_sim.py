"""Paper-scale what-if: the DP=3 multi-replica experiment (Fig. 10) in the
discrete-event simulator, plus a replica failure: MORI's Waiting-queue
semantics double as the recovery path when an engine dies.

The counterpart of ``examples/multi_replica_sim.py``. The simulator runs
on the host; the replica set only gives the fleet's layout (the replica
count, and the rules whose fallbacks ride along), so ``--device`` only
names the device the layout is made of.

    python -m repro_torch.examples.multi_replica_sim [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.dist import make_replica_set
from repro_torch.launch.mesh import devices_for
from repro_torch.sim import CONFIGS, FaultPlan, Simulation
from repro_torch.traces import generate_corpus

HW = "h200-qwen3-30b-a3b"


def run(sched: str, args, replica_set, *, conc: int,
        faults: list[FaultPlan] | None = None):
    sim = Simulation(
        sched,
        CONFIGS[HW],
        generate_corpus(args.programs, seed=0),
        placement=replica_set,
        concurrency_per_replica=conc,
        cpu_ratio=2.0,
        duration_s=args.duration_s,
        warmup_s=args.duration_s / 5,
        seed=0,
        faults=faults,
    )
    return sim.run()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.multi_replica_sim")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--programs", type=int, default=64)
    ap.add_argument("--duration-s", type=float, default=600.0,
                    help="simulated seconds (warmup a fifth of it; the failure at "
                         "0.4 and the recovery at 0.7 of it)")
    ap.add_argument("--conc", type=int, nargs="+", default=[20, 80])
    args = ap.parse_args(argv)
    devices = devices_for(args.device)
    # the DP=3 fleet layout: three replicas sharing one rules object, as
    # repro_torch.launch.serve places the engines
    replica_set = make_replica_set(3, devices=devices)

    d = args.duration_s
    print(f"=== Fig.10 slice: {HW}, DP={replica_set.num_replicas}, 2x CPU, {d:g}s sim ===")
    header = (f"{'sched':<6} {'conc':>5} {'tok/s':>8} {'ttft_s':>7} "
              f"{'util':>6} {'churn':>7}")
    print(header)
    print("-" * len(header))
    for conc in args.conc:
        for sched in ("mori", "ta+o", "ta", "smg"):
            r = run(sched, args, replica_set, conc=conc)
            print(f"{sched:<6} {conc:>5} {r.output_tok_per_s:>8.0f} "
                  f"{r.ttft_avg_s:>7.1f} {r.gpu_util:>6.1%} "
                  f"{r.switches_per_program:>7.3f}")

    fail, back = 0.4 * d, 0.7 * d
    print(f"\n=== replica 1 fails at t={fail:g}s, recovers at t={back:g}s ===")
    for sched in ("mori", "ta+o"):
        r = run(sched, args, replica_set, conc=50,
                faults=[FaultPlan(replica=1, fail_at=fail, recover_at=back)])
        print(f"{sched:<6} tok/s {r.output_tok_per_s:>7.0f}  "
              f"ttft {r.ttft_avg_s:>6.1f}s  finished {r.programs_finished}")
    print("\nMORI re-admits the dead replica's programs through the Waiting "
          "queue\n(recompute path) and re-balances via BFD: no stuck programs.")


if __name__ == "__main__":
    main()
