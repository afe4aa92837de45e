"""Training for the port: the token pipeline, AdamW, checkpoints and the
loop, the counterparts of ``repro/train/``."""
