"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16e top-4, fine-grained. [hf:databricks/dbrx-base; unverified]
Paper role: mid MoE scale point (132B, 16e top-4) standing in for the paper's MoE serving pair (qwen3-30b-a3b rows of repro.sim.hardware).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,                  # no dense FFN: pure MoE blocks
    vocab_size=100_352,
    num_experts=16,
    top_k=4,
    moe_d_ff=10_752,
)
