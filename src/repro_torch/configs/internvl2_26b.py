"""internvl2-26b [vlm]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 — InternViT frontend is a STUB (input_specs provides projected
patch embeddings); backbone = InternLM2-20B. [arXiv:2404.16821; hf]
Paper role: VLM agent workload — image-token prefixes inflate prefill and prefix-cache pressure relative to its InternLM2 text backbone.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16_384,
    vocab_size=92_553,
    rope_theta=1_000_000.0,
    num_image_tokens=256,
)
