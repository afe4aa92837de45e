"""qwen1.5-0.5b [dense]: 24L d_model=1024 16H (MHA kv=16) d_ff=2816
vocab=151936 — QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]
Paper role: smallest scale point — the CPU-runnable stand-in for the paper's 7B-class single-GPU pair (h200-80g-qwen2.5-7b); default arch for quickstart, tests and the real-engine replay.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151_936,
    qkv_bias=True,
)
