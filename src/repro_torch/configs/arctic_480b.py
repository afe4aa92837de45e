"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128e top-2 + dense residual. [hf:Snowflake/snowflake-arctic-base; hf]

Note: 56 q-heads do not divide the 16-way model axis; the sharding rules
fall back to replicated head-activations while the fused projections stay
sharded (DESIGN.md §6). bf16 Adam moments keep optimizer state within HBM.

Paper role: largest capacity-pressure scale point (480B MoE) — the arch that forces KV offload decisions at paper scale and the pad-heads sharding fallback study.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,               # dense residual FFN
    vocab_size=32_000,
    num_experts=128,
    top_k=2,
    moe_d_ff=4864,
    dense_residual=True,
    bf16_moments=True,
)
