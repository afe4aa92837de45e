"""Synthetic Claude-Code-style agentic trace generator (paper §3, §6.1).

The paper replays 186 proxy-collected Claude Code traces from SWE-bench Pro.
Those traces are not public, so we generate a corpus from a two-phase
semi-Markov model calibrated to every statistic the paper reports:

* tool-call durations are heavy-tailed over 3+ orders of magnitude (Fig. 3);
* at the 2 s threshold ~87% of calls are short, yet the ~13% long calls
  carry ~58% of total wall-clock tool time (§3.3);
* busy phases (maximal runs of short calls) last tens of seconds: median
  ~4 s / ~20 s / ~41 s at the 1 s / 2 s / 5 s thresholds (Fig. 5);
* programs issue tens of inference steps over several minutes and grow
  their context monotonically (§3.1).

``tests/test_traces.py::TestCalibration`` asserts the generated corpus
reproduces these statistics, which is the §3 "trace analysis" reproduction.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass

from repro_torch.core.types import ProgramTrace, RequestRecord

SHORT_KINDS = ["read", "write", "edit", "shell", "grep"]
LONG_KINDS = ["pytest", "compile", "human", "subagent"]


@dataclass
class TraceGenConfig:
    """Calibrated defaults; see module docstring for the targets."""

    # --- tool-call duration model (lognormal mixture) ---
    short_median_s: float = 0.40
    short_sigma: float = 0.90
    long_median_s: float = 3.5
    long_sigma: float = 1.05
    long_max_s: float = 600.0           # human / subagent tail: minutes
    # --- phase structure ---
    busy_calls_mean: float = 18.0       # short calls per busy phase
    idle_calls_mean: float = 2.2        # long calls per idle phase
    # --- program shape ---
    min_steps: int = 12
    mean_steps: int = 42
    max_steps: int = 120
    # --- token dynamics ---
    initial_context_mean: int = 9000    # system prompt + task + repo map
    short_result_tokens: tuple[int, int] = (100, 1600)   # file reads, greps
    long_result_tokens: tuple[int, int] = (400, 4000)    # test logs, diffs
    output_tokens_mean: int = 120       # completion per step
    output_tokens_min: int = 16
    max_context: int = 120_000
    # --- reasoning wall-clock model (collection-time decode speed) ---
    decode_tok_per_s: float = 70.0
    ttft_base_s: float = 0.4


def _lognormal(rng: random.Random, median: float, sigma: float) -> float:
    return median * math.exp(rng.gauss(0.0, sigma))


def _geometric(rng: random.Random, mean: float) -> int:
    """Geometric >= 1 with the given mean."""
    p = min(0.999, 1.0 / max(1.0, mean))
    u = rng.random()
    return max(1, int(math.log(max(u, 1e-12)) / math.log(1.0 - p)) + 1)


def generate_program(
    program_id: str, rng: random.Random, cfg: TraceGenConfig | None = None
) -> ProgramTrace:
    cfg = cfg or TraceGenConfig()
    n_steps = min(
        cfg.max_steps, cfg.min_steps + _geometric(rng, cfg.mean_steps - cfg.min_steps)
    )
    context = int(rng.gauss(cfg.initial_context_mean, cfg.initial_context_mean * 0.25))
    context = max(2000, context)
    steps: list[RequestRecord] = []
    in_busy = True  # programs start by exploring (busy phase)
    calls_left = _geometric(rng, cfg.busy_calls_mean)
    for i in range(n_steps):
        output = max(
            cfg.output_tokens_min, int(rng.expovariate(1.0 / cfg.output_tokens_mean))
        )
        if in_busy:
            dur = _lognormal(rng, cfg.short_median_s, cfg.short_sigma)
            kind = rng.choice(SHORT_KINDS)
            result_lo, result_hi = cfg.short_result_tokens
        else:
            dur = min(
                cfg.long_max_s, _lognormal(rng, cfg.long_median_s, cfg.long_sigma)
            )
            kind = rng.choice(LONG_KINDS)
            result_lo, result_hi = cfg.long_result_tokens
        reasoning = cfg.ttft_base_s + output / cfg.decode_tok_per_s
        steps.append(
            RequestRecord(
                input_tokens=min(context, cfg.max_context),
                output_tokens=output,
                tool_duration_s=dur,
                reasoning_wall_s=reasoning,
                tool_kind=kind,
            )
        )
        context = min(
            cfg.max_context, context + output + rng.randint(result_lo, result_hi)
        )
        calls_left -= 1
        if calls_left <= 0:
            in_busy = not in_busy
            mean = cfg.busy_calls_mean if in_busy else cfg.idle_calls_mean
            calls_left = _geometric(rng, mean)
    # final step's tool call is the session ending; zero it out
    steps[-1].tool_duration_s = 0.0
    return ProgramTrace(program_id=program_id, steps=steps)


def generate_corpus(
    n_programs: int = 186, seed: int = 0, cfg: TraceGenConfig | None = None
) -> list[ProgramTrace]:
    """The paper's corpus: 186 complete traces (200 attempted - 14 failed)."""
    rng = random.Random(seed)
    return [generate_program(f"trace-{i:04d}", rng, cfg) for i in range(n_programs)]


def burst_cancel_corpus() -> list[ProgramTrace]:
    """Deterministic early-tool-return scenario (no randomness), shared by
    tests/test_transfer_plane.py and benchmarks/transfer_overlap.py so the
    CI overlap gate and the pinned regression exercise the same timeline:

    pbig's mid-life context burst (50 → 120 tokens) overflows a
    ~130-token GPU tier while both programs sit in tool calls, so the
    control tick demotes the idler p1 (64 tokens materialized); pbig then
    finishes and frees the tier, and p1 returns at t≈9 — before a
    slow-link offload of its KV can complete, which is exactly the window
    the scheduler's CancelTransfer path exploits."""
    return [
        ProgramTrace("pbig", [
            RequestRecord(50, 4, 1.0, reasoning_wall_s=1.0),
            RequestRecord(120, 4, 3.0, reasoning_wall_s=1.0),
            RequestRecord(126, 4, 0.0, reasoning_wall_s=1.0),
        ]),
        ProgramTrace("p1", [
            RequestRecord(60, 4, 8.0, reasoning_wall_s=1.0),
            RequestRecord(76, 4, 0.0, reasoning_wall_s=1.0),
        ]),
    ]
