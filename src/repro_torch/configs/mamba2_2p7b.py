"""mamba2-2.7b [ssm]: 64L d_model=2560, attn-free, vocab=50280, ssm_state=128.
[arXiv:2405.21060; unverified]
Paper role: attention-free O(1)-state family — the long_500k cell and the SSM-state (not KV) variant of MORI's placement currency.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,     # 80 SSD heads
)
