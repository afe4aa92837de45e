"""Agentic workload traces: generator, analysis (paper §3), persistence."""
from repro_torch.traces.analysis import (
    PhaseStats,
    busy_phase_durations,
    percentile,
    phase_stats,
    tool_call_cdf,
)
from repro_torch.traces.generator import (
    TraceGenConfig,
    burst_cancel_corpus,
    generate_corpus,
    generate_program,
)
from repro_torch.traces.io import load_corpus, save_corpus

__all__ = [
    "PhaseStats",
    "TraceGenConfig",
    "burst_cancel_corpus",
    "busy_phase_durations",
    "generate_corpus",
    "generate_program",
    "load_corpus",
    "percentile",
    "phase_stats",
    "save_corpus",
    "tool_call_cdf",
]
