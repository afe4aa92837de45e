"""Shared control-plane types for the MORI scheduler.

Everything in ``repro_torch.core`` is *control plane*: pure Python, no JAX. The same
objects drive both the real JAX serving engine (``repro_torch.serving``) and the
discrete-event simulator (``repro.sim``), which is how the paper's policy code
is validated once and reused everywhere.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field


class Status(enum.Enum):
    """Instantaneous program status (paper §4.1).

    REASONING: an inference request for the program is executing on a GPU.
    ACTING:    the program is inside a tool call; its KV cache is idle.
    GATED:     the program has a pending request but the scheduler is holding
               it (KV not GPU-resident / no capacity).  Gated time is excluded
               from the idleness metric (paper §4.2).
    """

    REASONING = "reasoning"
    ACTING = "acting"
    GATED = "gated"


class Tier(enum.Enum):
    """Memory tier a program's KV state currently occupies (paper §4.1)."""

    GPU = "gpu"          # HBM-resident, requests forwarded directly
    CPU = "cpu"          # offloaded to host DRAM, must reload before running
    SSD = "ssd"          # beyond-paper (paper §7.1): local NVMe tier
    WAITING = "waiting"  # KV discarded entirely; resume = full recompute
    NONE = "none"        # brand-new program, nothing allocated yet


class TypeLabel(enum.Enum):
    """Typed-offloading label stamped onto KV blocks (paper §4.3.2)."""

    BUSY = "busy"
    IDLE = "idle"
    INACTIVE = "inactive"


#: Engine-side eviction priority per tier: lower sorts first = evicted first.
#: GPU HBM evicts inactive -> idle -> busy; CPU DRAM evicts
#: inactive -> busy -> idle (reversed so each tier retains "its" programs).
GPU_EVICTION_ORDER = {
    TypeLabel.INACTIVE: 0,
    TypeLabel.IDLE: 1,
    TypeLabel.BUSY: 2,
}
CPU_EVICTION_ORDER = {
    TypeLabel.INACTIVE: 0,
    TypeLabel.BUSY: 1,
    TypeLabel.IDLE: 2,
}


@dataclass
class TierCapacity:
    """Byte budgets for one replica's hardware-backed tiers. ``ssd_kv_bytes``
    defaults to 0 = disabled (the paper's two-tier configuration); setting it
    enables the §7.1 NVMe extension evaluated in benchmarks/ssd_tier.py.

    Tier formats: the GPU budget is consumed at the device format's
    per-token size, the CPU/SSD budgets at the offload format's
    (``ProgramState.host_kv_bytes``) — an int8 offload format fits ~2x the
    contexts in the same host budget without the budget itself changing."""

    gpu_kv_bytes: int
    cpu_kv_bytes: int
    ssd_kv_bytes: int = 0

    def scaled(self, cpu_ratio: float, ssd_ratio: float = 0.0) -> "TierCapacity":
        """Return a copy with CPU capacity = ``cpu_ratio`` x GPU capacity
        (the paper evaluates 1x and 2x) and SSD = ``ssd_ratio`` x GPU."""
        return TierCapacity(
            self.gpu_kv_bytes,
            int(self.gpu_kv_bytes * cpu_ratio),
            int(self.gpu_kv_bytes * ssd_ratio),
        )


@dataclass
class SchedulerConfig:
    """Knobs for :class:`repro_torch.core.scheduler.MoriScheduler`.

    Defaults follow the paper: k=5 cycle idleness window, 5 s control tick.
    """

    idleness_window: int = 5          # k in Eq. (1)
    tick_interval_s: float = 5.0      # control-loop period (paper §5)
    eager_promote: bool = True        # also try promotion on arrival/complete
    swap_hysteresis: float = 0.10     # min idleness gap to swap GPU<-CPU
    max_running: int | None = None    # optional engine batch-slot cap
    # straggler mitigation: penalty weight applied to replicas whose EWMA
    # step latency exceeds the fleet median (beyond-paper, off by default
    # in paper-faithful benchmarks).
    straggler_penalty: float = 0.0
    # beyond-paper: when a pending CPU-resident program cannot fit its home
    # GPU, move its DRAM copy to a roomier replica (a ``Migrate`` action)
    # instead of waiting — breaks strict affinity, so off by default. The
    # real router executes it as a page-granular host-to-host copy on the
    # destination's transfer plane (requires paged engines; it raises at
    # construction naming this knob otherwise).
    migrate_on_pressure: bool = False
    # on replica failure, migrate its DRAM-resident programs to healthy
    # replicas with host headroom instead of discarding them to Waiting
    # (which costs a full recompute). Independent of migrate_on_pressure:
    # drain migrates are emitted even when pressure migration is off.
    drain_migrate: bool = True
    # §7.1 SSD tier, cost-aware guard (beyond the paper's proposal): a
    # program sinks to SSD only if reloading its KV from NVMe would beat
    # recomputing it — kv_bytes/ssd_bw < context_tokens/recompute_rate.
    # Both 0 = no guard (sink whenever SSD has room). Small models with
    # fast prefill (7B-class) fail the guard; 70B-class passes it.
    ssd_bytes_per_s: float = 0.0
    recompute_tok_per_s: float = 0.0
    # recompute burns the SHARED prefill pipeline while NVMe reload runs on
    # the transfer queue in parallel: under load a recomputed token costs
    # more than its raw latency in queueing, so reload wins if
    # reload_s < factor * recompute_s. 1.5 is calibrated on the paper's
    # three hardware pairs (benchmarks/ssd_tier.py): it admits 7B
    # (ratio 0.48) and 70B (1.35) where SSD measurably helps and rejects
    # 30B-A3B (1.90) where cheap MoE recompute beats NVMe.
    ssd_guard_factor: float = 1.5


@dataclass
class ProgramMetrics:
    """Per-program accounting used by benchmarks (churn, hit rates)."""

    replica_switches: int = 0
    promotions: int = 0
    demotions: int = 0
    evictions: int = 0
    recomputed_tokens: int = 0
    reloaded_bytes: int = 0
    gated_time_s: float = 0.0
    # offloads aborted mid-flight because the tool call returned before the
    # bytes left the transfer queue (plan/ack protocol, CancelTransfer)
    cancelled_offloads: int = 0


@dataclass
class TransferCost:
    """Cost model terms for KV movement, used by sim and by the real
    engine's transfer queue accounting.

    Rates price *wire bytes* — the bytes of the format actually moved
    (offload-format payload + scale sidecars), not the device-resident
    size, so quantized offload shortens transfers at equal bandwidth."""

    pcie_bytes_per_s: float = 16e9   # effective host<->device per replica
    ssd_bytes_per_s: float = 3.5e9   # NVMe tier (paper §7.1 extension)
    # fixed per-transfer latency (driver/launch); measured ~100us-1ms range
    fixed_latency_s: float = 0.5e-3


@dataclass
class RequestRecord:
    """One inference step of an agentic program (trace schema, paper §6.1).

    ``input_tokens`` is the *full* context length at this step (prefix
    inclusive); ``tool_duration_s`` is the gap that follows this step's
    response. ``reasoning_wall_s`` is the wall-clock inference latency
    observed at collection time (the paper's proxy logs it); ``tool_kind``
    tags the call for trace analysis (read/edit/shell vs test/human/subagent).
    """

    input_tokens: int
    output_tokens: int
    tool_duration_s: float
    reasoning_wall_s: float = 0.0
    tool_kind: str = "shell"


@dataclass
class ProgramTrace:
    """A full agentic program: ordered steps with prefix dependency."""

    program_id: str
    steps: list[RequestRecord] = field(default_factory=list)

    @property
    def num_steps(self) -> int:
        return len(self.steps)

    def total_tool_time(self) -> float:
        return sum(s.tool_duration_s for s in self.steps)

    def final_context(self) -> int:
        if not self.steps:
            return 0
        last = self.steps[-1]
        return last.input_tokens + last.output_tokens
