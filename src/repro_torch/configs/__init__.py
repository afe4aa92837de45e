"""Assigned-architecture registry: ``get_config(arch_id)``.

One module per architecture; each exposes ``CONFIG`` with the exact
published dimensions ([source; verified-tier] in each file).
"""
from __future__ import annotations

import importlib

ARCHS = [
    "mamba2_2p7b",
    "internlm2_20b",
    "gemma2_27b",
    "gemma2_9b",
    "qwen1p5_0p5b",
    "arctic_480b",
    "dbrx_132b",
    "whisper_medium",
    "internvl2_26b",
    "zamba2_2p7b",
]

_ALIASES = {
    "mamba2-2.7b": "mamba2_2p7b",
    "internlm2-20b": "internlm2_20b",
    "gemma2-27b": "gemma2_27b",
    "gemma2-9b": "gemma2_9b",
    "qwen1.5-0.5b": "qwen1p5_0p5b",
    "arctic-480b": "arctic_480b",
    "dbrx-132b": "dbrx_132b",
    "whisper-medium": "whisper_medium",
    "internvl2-26b": "internvl2_26b",
    "zamba2-2.7b": "zamba2_2p7b",
}

ARCH_IDS = list(_ALIASES)


def get_config(arch: str):
    mod_name = _ALIASES.get(arch, arch).replace("-", "_").replace(".", "p")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs():
    return {arch: get_config(arch) for arch in ARCH_IDS}
