"""Unified model configuration covering all 10 assigned architectures."""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # attention variants
    qkv_bias: bool = False            # qwen1.5
    sliding_window: int | None = None  # gemma2 local layers
    local_global_alternating: bool = False
    attn_logit_softcap: float | None = None   # gemma2: 50.0
    final_logit_softcap: float | None = None  # gemma2: 30.0
    rope_theta: float = 10_000.0
    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    dense_residual: bool = False      # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    # hybrid (zamba2): one *shared* attention block applied every N layers
    shared_attn_period: int = 0
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500           # whisper frame positions (stub frontend)
    # VLM (internvl2): stub patch embeddings prepended to the text sequence
    num_image_tokens: int = 0
    # numerics / memory
    dtype: str = "bfloat16"
    remat: bool = True
    # optimizer memory mode for the giants (arctic): bf16 Adam moments
    bf16_moments: bool = False

    # ------------------------------------------------------------- derived
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def ssm_inner(self) -> int:
        return self.d_model * self.ssm_expand

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic context handling (long_500k eligibility)."""
        return self.family in ("ssm", "hybrid")

    @property
    def kv_bytes_per_token(self) -> int:
        """Serving-state bytes per context token (MORI's placement currency)."""
        b = 2  # bf16
        if self.family == "ssm":
            return 0  # O(1) state, accounted separately
        if self.family == "hybrid":
            n_shared = self.num_layers // max(1, self.shared_attn_period)
            return n_shared * 2 * self.num_kv_heads * self.hybrid_head_dim * b
        return self.num_layers * 2 * self.num_kv_heads * self.head_dim * b  # lint: kv008-ok (b parameterizes the element size; the 2 is K/V planes)

    @property
    def hybrid_head_dim(self) -> int:
        # zamba2's shared block runs on concat(hidden, embedding) = 2*d_model
        return 2 * self.d_model // self.num_heads

    def params_billions(self) -> float:
        """Rough parameter count (for 6ND model-FLOPs accounting)."""
        d = self.d_model
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.family == "ssm":
            attn = 0
        dense_ffn = 3 * d * self.d_ff if self.d_ff else 0
        moe = self.num_experts * 3 * d * self.moe_d_ff
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            inner = self.ssm_inner
            ssm = d * 2 * inner + d * 2 * self.ssm_heads * self.ssm_state  # in_proj
            ssm += inner * d  # out_proj
        per_layer = attn + dense_ffn + moe + ssm
        total = self.num_layers * per_layer + 2 * self.vocab_size * d
        if self.family == "hybrid" and self.shared_attn_period:
            d2 = 2 * d
            shared = 4 * d2 * d2 + 3 * d2 * self.d_ff + d2 * d
            total += shared - self.num_layers * (attn + dense_ffn)  # replace
            total += self.num_layers * ssm
        if self.encoder_layers:
            total += self.encoder_layers * (attn + dense_ffn)
        return total / 1e9

    def active_params_billions(self) -> float:
        """Active (per-token) params: replaces E experts with top_k."""
        if not self.num_experts:
            return self.params_billions()
        full = self.params_billions()
        moe_total = self.num_layers * self.num_experts * 3 * self.d_model * self.moe_d_ff
        moe_active = self.num_layers * self.top_k * 3 * self.d_model * self.moe_d_ff
        return full - (moe_total - moe_active) / 1e9

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test-sized config of the same family."""
        small = dict(
            num_layers=max(2, min(4, self.num_layers)),
            d_model=256,
            num_heads=4,
            num_kv_heads=min(4, max(1, self.num_kv_heads // max(1, self.num_heads // 4))),
            head_dim=64,
            d_ff=512 if self.d_ff else 0,
            vocab_size=512,
            sliding_window=64 if self.sliding_window else None,
            num_experts=min(4, self.num_experts),
            top_k=min(2, self.top_k),
            moe_d_ff=256 if self.num_experts else 0,
            # dropless at smoke scale so decode == full-forward exactly
            capacity_factor=8.0 if self.num_experts else self.capacity_factor,
            ssm_state=32 if self.ssm_state else 0,
            ssm_head_dim=32,
            ssm_chunk=16,
            shared_attn_period=2 if self.shared_attn_period else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=24 if self.encoder_layers else 1500,
            num_image_tokens=8 if self.num_image_tokens else 0,
            remat=False,
        )
        if self.family == "hybrid":
            small["num_layers"] = 4
        small.update(overrides)
        return replace(self, **small)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)

SHAPES = {s.name: s for s in [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K]}
