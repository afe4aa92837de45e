"""gemma2-27b [dense]: 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000 — local+global alternating, logit softcap.
[arXiv:2408.00118; hf]
Paper role: upper dense scale point (tensor-parallel single node); the softcap + alternating-window case of the decode_32k cell.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36_864,
    vocab_size=256_000,
    local_global_alternating=True,
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
)
