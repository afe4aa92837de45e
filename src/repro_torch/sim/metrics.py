"""Result schema for simulator runs (the paper's §6.2 metrics): the
port's copy of ``repro/sim/metrics.py``."""
from __future__ import annotations

from dataclasses import asdict, dataclass


def percentile(xs: list[float], q: float) -> float:
    if not xs:
        return 0.0
    s = sorted(xs)
    idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return s[idx]


@dataclass
class SimResult:
    scheduler: str
    hw: str
    duration_s: float
    # paper's three headline metrics (§6.2)
    output_tok_per_s: float
    steps_per_s: float
    ttft_avg_s: float
    ttft_p50_s: float
    ttft_p90_s: float
    ttft_p99_s: float
    # secondary metrics
    gpu_util: float
    cache_hit_rate: float
    churn_frac: float                # §6.2.2: fraction of programs switching
    switches_per_program: float
    programs_finished: int
    steps_completed: int
    tick_avg_ms: float               # Table 2: scheduler overhead
    tick_p99_ms: float
    # fraction of compute-busy time during which a KV transfer was in
    # flight on the same replica — the paper's "masked by GPU-CPU overlap"
    # claim (§6.2) as a measurable number
    xfer_overlap_frac: float = 0.0

    def to_dict(self) -> dict:
        return asdict(self)

    def row(self) -> str:
        return (
            f"{self.scheduler:6s} | {self.output_tok_per_s:9.1f} tok/s | "
            f"{self.steps_per_s:6.3f} step/s | TTFT {self.ttft_avg_s:7.2f}s "
            f"(p90 {self.ttft_p90_s:7.2f}) | util {self.gpu_util:5.1%} | "
            f"hit {self.cache_hit_rate:5.1%} | churn {self.churn_frac:5.1%} "
            f"({self.switches_per_program:.3f} sw/prog)"
        )
