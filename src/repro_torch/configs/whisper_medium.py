"""whisper-medium [audio]: 24L(+24 enc) d_model=1024 16H (MHA) d_ff=4096
vocab=51865 — enc-dec; conv frontend is a STUB (input_specs provides
precomputed 1500-frame embeddings). [arXiv:2212.04356; unverified]
Paper role: encoder-decoder tool-side workload (audio transcription as an agent tool call) — cross-attention KV joins the cache inventory.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51_865,
    encoder_layers=24,
    encoder_seq=1500,
)
