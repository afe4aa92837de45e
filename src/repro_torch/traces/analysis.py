"""Trace analysis reproducing the paper's §3 characterization.

* :func:`tool_call_cdf` — Fig. 3: CDF of tool-call durations.
* :func:`busy_phase_durations` — Fig. 5: wall-clock busy-phase durations
  under a short-call threshold (busy phase = maximal run of consecutive
  steps whose tool call is shorter than the threshold; wall-clock includes
  the inference time between those calls).
* :func:`phase_stats` — the §3.3 headline numbers (short-call fraction,
  long-call share of tool time, phase medians/p90).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.types import ProgramTrace


def percentile(xs: list[float], q: float) -> float:
    if not xs:
        return float("nan")
    s = sorted(xs)
    idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return s[idx]


def tool_call_cdf(corpus: list[ProgramTrace]) -> list[float]:
    """All tool-call durations (sorted) — plot index/n vs value for the CDF."""
    durs = [
        s.tool_duration_s
        for tr in corpus
        for s in tr.steps
        if s.tool_duration_s > 0
    ]
    durs.sort()
    return durs


def busy_phase_durations(
    corpus: list[ProgramTrace], threshold_s: float
) -> list[float]:
    """Fig. 5: wall-clock duration of each busy phase under ``threshold_s``."""
    phases: list[float] = []
    for tr in corpus:
        cur = 0.0
        n_calls = 0
        for step in tr.steps:
            if step.tool_duration_s <= 0:
                continue
            if step.tool_duration_s < threshold_s:
                cur += step.reasoning_wall_s + step.tool_duration_s
                n_calls += 1
            else:
                if n_calls > 0:
                    phases.append(cur)
                cur, n_calls = 0.0, 0
        if n_calls > 0:
            phases.append(cur)
    return phases


@dataclass
class PhaseStats:
    n_programs: int
    n_calls: int
    short_fraction: float          # fraction of calls below threshold
    long_time_share: float         # share of total tool time in long calls
    busy_median_s: float
    busy_p90_s: float
    duration_p50_s: float
    duration_p99_s: float
    orders_of_magnitude: float     # log10(p99.9 / p0.1) spread


def phase_stats(corpus: list[ProgramTrace], threshold_s: float = 2.0) -> PhaseStats:
    durs = tool_call_cdf(corpus)
    short = [d for d in durs if d < threshold_s]
    long_ = [d for d in durs if d >= threshold_s]
    phases = busy_phase_durations(corpus, threshold_s)
    total = sum(durs) or 1.0
    return PhaseStats(
        n_programs=len(corpus),
        n_calls=len(durs),
        short_fraction=len(short) / max(1, len(durs)),
        long_time_share=sum(long_) / total,
        busy_median_s=percentile(phases, 0.5),
        busy_p90_s=percentile(phases, 0.9),
        duration_p50_s=percentile(durs, 0.5),
        duration_p99_s=percentile(durs, 0.99),
        orders_of_magnitude=(
            __import__("math").log10(
                max(percentile(durs, 0.999), 1e-9) / max(percentile(durs, 0.001), 1e-9)
            )
        ),
    )
