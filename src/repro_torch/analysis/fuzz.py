"""Randomized replay fuzzer driving the real router under kvsan: the
port's counterpart of ``repro/analysis/fuzz.py``, over the port's engine
(on the GPU unless ``device="cpu"``).

Each round synthesizes a small agentic corpus (random contexts, tool
gaps, reasoning walls) and replays it through a :class:`MoriRouter`
built with randomized knobs — scheduler policy × {sync, async}
transfers × {serial, pump} decode × {monolithic, chunked} prefill ×
randomized capacities tight enough to force offload / reload / cancel
traffic.  ``REPRO_KVSAN=1`` is exported before any pool is built, so
the page-lifetime sanitizer, the strict radix refcount mode, and the
control-plane invariant checker all arm; a clean fuzz run therefore
certifies far more than "no exception": every page alloc/free paired,
no ledger record leaked, occupancy conserved at every tick.

A failing round is **shrunk** (greedily dropping programs, then
truncating trailing steps, re-running after each candidate reduction)
and dumped as a JSON artifact — seed, knobs, the minimal corpus, the
error, the sanitizer's recent page-event ring, and the action log — so
the bug replays from the artifact alone.

``--compile-audit`` additionally arms the compile tracker
(``REPRO_JITAUDIT=1``), warms every engine through its bucket specs
before replay, and lets the router's end-of-replay hook fail the round
if any decode graph was captured after warmup — randomized knob coverage
for the capture budget.

CLI::

    python -m repro_torch.analysis.fuzz --rounds 8 --seed 0 --out artifacts/
    python -m repro_torch.analysis.fuzz --rounds 4 --seed 0 --device cpu

Exit status 1 when any round fails.  Importable for tests via
:func:`fuzz` (which returns the failure reports instead of exiting).
"""
from __future__ import annotations

import argparse
import json
import os
import random
import sys
from dataclasses import asdict, dataclass, field

from repro_torch.analysis import compile_tracker, kvsan

#: replay knobs every round draws from
_SCHEDULERS = ("mori", "smg", "ta")


@dataclass
class FuzzFailure:
    """One failing round, fully replayable from this record."""

    round: int
    seed: int
    knobs: dict
    corpus: list            # [{program_id, steps: [...]}], post-shrink
    error_type: str
    error: str
    kvsan_trace: list = field(default_factory=list)
    actions: list = field(default_factory=list)
    shrink_attempts: int = 0


def _make_corpus(rng: random.Random, round_idx: int) -> list:
    """2–5 programs × 1–4 steps with growing contexts; small enough to
    replay in seconds, shaped (tool gaps ≫ decode windows) so schedulers
    actually offload into the idle windows."""
    from repro_torch.core.types import ProgramTrace, RequestRecord

    corpus = []
    for p in range(rng.randint(2, 5)):
        ctx = rng.randint(32, 80)
        steps = []
        n_steps = rng.randint(1, 4)
        for s in range(n_steps):
            last = s == n_steps - 1
            steps.append(RequestRecord(
                input_tokens=ctx,
                output_tokens=4,
                tool_duration_s=0.0 if last else rng.uniform(0.0, 40.0),
                reasoning_wall_s=round(rng.uniform(0.0, 3.0), 3),
            ))
            ctx += rng.randint(8, 24)
        corpus.append(ProgramTrace(f"r{round_idx}p{p}", steps))
    return corpus


def _make_knobs(rng: random.Random) -> dict:
    serial = rng.random() < 0.25
    return {
        "scheduler": rng.choice(_SCHEDULERS),
        "sync_transfers": rng.random() < 0.3,
        "serial_decode": serial,
        # chunked prefill needs the pump
        "chunked_prefill": (not serial) and rng.random() < 0.5,
        "tick_interval_s": rng.choice([1.0, 2.0, 5.0]),
        # fraction of the pool's cache capacity the scheduler may use —
        # < 1.0 forces demotions while contexts grow
        "gpu_frac": rng.choice([0.5, 0.7, 1.0]),
        # pages per virtual second over PCIe: slow enough that copies
        # span decode windows (overlap + mid-stream cancels), fast
        # enough that replay drains promptly
        "pcie_pages_per_s": rng.choice([4, 16, 64]),
        "max_slots": rng.choice([2, 4]),
    }


def _build_router(knobs: dict, cfg, params, *, audit: bool = False, device=None):
    from repro_torch.core import SchedulerConfig
    from repro_torch.core.types import TransferCost
    from repro_torch.kernels import kv_quant
    from repro_torch.serving import Engine, MoriRouter

    kvb = kv_quant.token_wire_bytes(
        cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, "bf16")
    engine = Engine(
        cfg, params, device=device, page_tokens=8, n_device_pages=256, n_host_pages=128,
        max_slots=knobs["max_slots"], max_seq=256,
    )
    if audit:
        # warm every bucket spec and snapshot the graph caches; the
        # router's end-of-replay hook then fails the round on any
        # post-warmup capture (a shape the warmup buckets missed)
        engine.warmup(prefill_chunks=knobs["chunked_prefill"])
    reserve = getattr(engine, "decode_reserve_pages", 0)
    cache_bytes = (engine.pool.n_device_pages - reserve) * engine.pool.page_bytes
    # never squeeze below what the largest single program needs resident
    # (otherwise the replay legitimately wedges and the "failure" is noise)
    floor = int(2.5 * 224 * kvb)
    gpu_cap = max(int(knobs["gpu_frac"] * cache_bytes), floor)
    router = MoriRouter(
        [engine],
        scheduler=knobs["scheduler"],
        gpu_capacity_bytes=min(gpu_cap, cache_bytes),
        config=SchedulerConfig(tick_interval_s=knobs["tick_interval_s"]),
        sync_transfers=knobs["sync_transfers"],
        serial_decode=knobs["serial_decode"],
        chunked_prefill=knobs["chunked_prefill"],
        xfer_cost=TransferCost(
            pcie_bytes_per_s=knobs["pcie_pages_per_s"] * engine.pool.page_bytes
        ),
        record_plans=True,
    )
    return router


def _run_once(knobs: dict, corpus, cfg, params, *,
              audit: bool = False, device=None) -> Exception | None:
    """One replay; returns the exception (with router attached) or None."""
    router = _build_router(knobs, cfg, params, audit=audit, device=device)
    try:
        router.replay(corpus, vocab_size=cfg.vocab_size, max_new_tokens=4)
        return None
    except Exception as exc:            # noqa: BLE001 — every crash is a find
        exc._fuzz_router = router
        return exc


def _shrink(knobs: dict, corpus, err, cfg, params, *, audit: bool = False, device=None):
    """Greedy corpus reduction preserving the failure's error type."""
    attempts = 0
    want = type(err).__name__
    # pass 1: drop whole programs
    i = 0
    while i < len(corpus) and len(corpus) > 1 and attempts < 32:
        cand = corpus[:i] + corpus[i + 1:]
        attempts += 1
        e = _run_once(knobs, cand, cfg, params, audit=audit, device=device)
        if e is not None and type(e).__name__ == want:
            corpus, err = cand, e
        else:
            i += 1
    # pass 2: truncate trailing steps
    changed = True
    while changed and attempts < 48:
        changed = False
        for i, tr in enumerate(corpus):
            if len(tr.steps) <= 1:
                continue
            cand = list(corpus)
            cand[i] = type(tr)(tr.program_id, tr.steps[:-1])
            attempts += 1
            e = _run_once(knobs, cand, cfg, params, audit=audit, device=device)
            if e is not None and type(e).__name__ == want:
                corpus, err, changed = cand, e, True
            if attempts >= 48:
                break
    return corpus, err, attempts


def _report(round_idx, seed, knobs, corpus, err, attempts) -> FuzzFailure:
    router = getattr(err, "_fuzz_router", None)
    return FuzzFailure(
        round=round_idx,
        seed=seed,
        knobs=knobs,
        corpus=[
            {"program_id": tr.program_id,
             "steps": [asdict(s) for s in tr.steps]}
            for tr in corpus
        ],
        error_type=type(err).__name__,
        error=str(err),
        kvsan_trace=list(getattr(err, "trace", [])),
        actions=[repr(a) for a in getattr(router, "action_log", [])][-64:],
        shrink_attempts=attempts,
    )


def fuzz(
    rounds: int = 8,
    seed: int = 0,
    out_dir: str | None = None,
    *,
    compile_audit: bool = False,
    device=None,
    log=print,
) -> list[FuzzFailure]:
    """Run ``rounds`` randomized replays on ``device`` (default: the GPU);
    returns failure reports (empty means clean). Arms kvsan for every pool
    built in this process; with ``compile_audit`` also arms the compile
    tracker and fails any round whose replay captures a decode graph after
    warmup."""
    os.environ[kvsan.ENV_VAR] = "1"
    if compile_audit:
        os.environ[compile_tracker.ENV_VAR] = "1"
    from repro_torch.configs import get_config
    from repro_torch.models import Model, materialize

    from repro_torch.serving.engine import resolve_device

    device = resolve_device(device)
    cfg = get_config("qwen1.5-0.5b").reduced()
    params = materialize(Model(cfg).describe(), seed=0, device=device)
    failures: list[FuzzFailure] = []
    for r in range(rounds):
        rng = random.Random((seed << 16) ^ r)
        knobs = _make_knobs(rng)
        corpus = _make_corpus(rng, r)
        err = _run_once(knobs, corpus, cfg, params, audit=compile_audit, device=device)
        if err is None:
            log(f"round {r}: ok ({knobs['scheduler']}, "
                f"{'sync' if knobs['sync_transfers'] else 'async'}, "
                f"{'serial' if knobs['serial_decode'] else 'pump'}"
                f"{', chunked' if knobs['chunked_prefill'] else ''}"
                f"{', compile-audited' if compile_audit else ''}, "
                f"{len(corpus)} programs)")
            continue
        corpus, err, attempts = _shrink(knobs, corpus, err, cfg, params,
                                        audit=compile_audit, device=device)
        rep = _report(r, seed, knobs, corpus, err, attempts)
        failures.append(rep)
        log(f"round {r}: FAIL {rep.error_type}: {rep.error.splitlines()[0]}")
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, f"fuzz_failure_round{r}.json")
            with open(path, "w") as f:
                json.dump(asdict(rep), f, indent=2)
            log(f"  artifact: {path}")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.fuzz",
        description="randomized kvsan-armed replay fuzz over the router",
    )
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="artifacts")
    ap.add_argument(
        "--compile-audit", action="store_true",
        help="arm REPRO_JITAUDIT: warm each engine's bucket specs and "
             "fail any round that captures a decode graph mid-replay",
    )
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    failures = fuzz(args.rounds, args.seed, args.out,
                    compile_audit=args.compile_audit, device=args.device)
    if failures:
        print(f"{len(failures)}/{args.rounds} rounds failed")
        return 1
    print(f"clean: {args.rounds} rounds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
