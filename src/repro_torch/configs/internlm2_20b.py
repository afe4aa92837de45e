"""internlm2-20b [dense]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544. [arXiv:2403.17297; hf]
Paper role: plain-GQA 20B dense scale point — the clean baseline column between the 9B and MoE rows of the dry-run matrix.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16_384,
    vocab_size=92_544,
    rope_theta=1_000_000.0,
)
