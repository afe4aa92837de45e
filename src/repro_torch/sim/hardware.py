"""Hardware + model cost-model configs for the simulator (paper Table 1).

Each :class:`HwConfig` describes one replica of one (GPU, model) pair. The
decode-step model is roofline-style:

    t_step = weight_read_bytes / hbm_bw            (weight streaming)
           + sum_r kv_bytes(r) / hbm_bw            (KV reads, batch-summed)
           + batch * flop_per_token / flops        (MXU/TensorCore term)

Prefill runs at a fixed MFU-derived token rate; chunked-prefill interference
multiplies the decode step time while a prefill is active. KV transfers
(offload/reload) share a full-duplex PCIe link per replica and overlap with
compute (paper §2.2, §6.2 'masked by GPU-CPU overlap').

The port's copy of ``repro/sim/hardware.py``: the dataclasses,
:func:`small_test_hw` and the paper's GPU rows. The reference's ``v5e8-*``
rows describe a TPU deployment and stay in the reference only, so
:data:`CONFIGS` lists the GPU rows alone.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class HwConfig:
    name: str
    # model
    kv_bytes_per_token: int
    weight_bytes: int            # total parameter bytes (per replica)
    active_weight_bytes: int     # bytes actually streamed per decode step
    flop_per_token: float        # 2 * active params
    # memory system
    hbm_bytes: int               # per replica (sum over TP group)
    hbm_bw: float                # bytes/s aggregate
    flops: float                 # peak FLOP/s aggregate (bf16)
    pcie_bw: float               # host<->device bytes/s per replica
    # engine behaviour
    prefill_mfu: float = 0.45
    decode_overhead_s: float = 4e-3   # launch/sampling/framework per step
    prefill_interference: float = 1.7  # decode slowdown while prefilling
    kv_reserve_frac: float = 0.88      # fraction of (HBM - weights) for KV
    # per-token KV size in the *offload* format — what PCIe/NVMe transfers
    # and host tiers carry when pages quantize on offload (int8 ≈ half of
    # kv_bytes_per_token). None = offload format equals device format.
    kv_wire_bytes_per_token: int | None = None

    @property
    def wire_bytes_per_token(self) -> int:
        """Offload-format per-token size with the bf16 fallback applied."""
        return (
            self.kv_bytes_per_token
            if self.kv_wire_bytes_per_token is None
            else self.kv_wire_bytes_per_token
        )

    @property
    def gpu_kv_bytes(self) -> int:
        return int((self.hbm_bytes - self.weight_bytes) * self.kv_reserve_frac)

    @property
    def prefill_rate(self) -> float:
        """tokens/s during prefill."""
        return self.prefill_mfu * self.flops / self.flop_per_token

    def decode_step_time(self, batch: int, total_kv_bytes: int) -> float:
        if batch <= 0:
            return self.decode_overhead_s
        return (
            self.decode_overhead_s
            + self.active_weight_bytes / self.hbm_bw
            + total_kv_bytes / self.hbm_bw
            + batch * self.flop_per_token / self.flops
        )

    def with_cpu_ratio(self, ratio: float) -> "TieredHwConfig":
        return TieredHwConfig(self, int(self.gpu_kv_bytes * ratio))


@dataclass(frozen=True)
class TieredHwConfig:
    hw: HwConfig
    cpu_kv_bytes: int


def _gib(x: float) -> int:
    return int(x * (1 << 30))


# --------------------------------------------------------------- paper rows
# H200 (80 GB cap) + Qwen-2.5 7B, TP=1   [paper Fig. 7]
H200_80_QWEN7B = HwConfig(
    name="h200-80g-qwen2.5-7b",
    kv_bytes_per_token=28 * 2 * 4 * 128 * 2,      # 28L, 4 KV heads, d128, bf16
    weight_bytes=_gib(15.4),
    active_weight_bytes=_gib(15.4),
    flop_per_token=2 * 7.6e9,
    hbm_bytes=_gib(80),
    hbm_bw=4.8e12,
    flops=990e12,
    pcie_bw=55e9,
)

# H200 (141 GB) + Qwen-3 30B-A3B (MoE), TP=1   [paper Fig. 8, Fig. 10]
H200_QWEN30B = HwConfig(
    name="h200-qwen3-30b-a3b",
    kv_bytes_per_token=48 * 2 * 4 * 128 * 2,
    weight_bytes=_gib(61),
    active_weight_bytes=_gib(8.2),                # 3B active + shared
    flop_per_token=2 * 3.3e9,
    hbm_bytes=_gib(141),
    hbm_bw=4.8e12,
    flops=990e12,
    pcie_bw=55e9,
)

# B200 + Llama-3.1 70B, TP=2   [paper Fig. 9]
B200_LLAMA70B = HwConfig(
    name="b200-llama3.1-70b-tp2",
    kv_bytes_per_token=80 * 2 * 8 * 128 * 2,
    weight_bytes=_gib(141),
    active_weight_bytes=_gib(141),
    flop_per_token=2 * 70e9,
    hbm_bytes=2 * _gib(186),
    hbm_bw=2 * 8.0e12,
    flops=2 * 2250e12,
    pcie_bw=60e9,
)

CONFIGS: dict[str, HwConfig] = {
    c.name: c
    for c in [
        H200_80_QWEN7B,
        H200_QWEN30B,
        B200_LLAMA70B,
    ]
}


def small_test_hw(**overrides) -> HwConfig:
    """Tiny deterministic config for unit tests.

    Ratios mirror real serving hardware: a full-HBM read takes ~15 ms,
    recomputing a median context (~45k tokens) takes seconds, while
    reloading it over 'PCIe' takes tens of milliseconds — so placement
    policy matters exactly the way it does at real scale.
    """
    base = HwConfig(
        name="test-hw",
        kv_bytes_per_token=1000,
        weight_bytes=0,
        active_weight_bytes=10_000_000,
        flop_per_token=4.5e7,     # prefill ~10k tok/s at 45% MFU
        hbm_bytes=100_000_000,
        hbm_bw=14e9,
        flops=1e12,
        pcie_bw=2e9,
        decode_overhead_s=1e-3,
    )
    return replace(base, **overrides)
