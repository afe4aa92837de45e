"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (MHA kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 backbone + ONE shared attention block
applied every 6 layers on concat(hidden, embedding). [arXiv:2411.15242; hf]
Paper role: hybrid SSM+shared-attention family — mixed KV/SSM serving state, the hardest case for tier accounting.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=160,            # shared block: 2*d_model / 32 heads
    d_ff=10_240,
    vocab_size=32_000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    shared_attn_period=6,
)
