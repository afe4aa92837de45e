"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000 — local+global alternating, logit softcap.
[arXiv:2408.00118; hf]
Paper role: mid-scale dense GPU pair (single-accelerator serving, ~9B); exercises the local/global alternating-cache shape the window-limited-cache lever targets.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14_336,
    vocab_size=256_000,
    local_global_alternating=True,
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
)
