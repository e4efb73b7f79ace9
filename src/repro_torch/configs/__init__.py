"""Assigned architecture configs (exact numbers from the assignment table):
a copy of the reference's ``configs`` package, as data for the port.

``get(name)`` returns the full ModelConfig; ``ARCHS`` lists all ids.
"""
from __future__ import annotations

import importlib

ARCHS = (
    "yi_34b",
    "gemma2_9b",
    "qwen15_32b",
    "glm4_9b",
    "whisper_tiny",
    "jamba_15_large",
    "llama4_maverick",
    "kimi_k2",
    "mamba2_27b",
    "llava_next_34b",
)

ALIASES = {
    "yi-34b": "yi_34b",
    "gemma2-9b": "gemma2_9b",
    "qwen1.5-32b": "qwen15_32b",
    "glm4-9b": "glm4_9b",
    "whisper-tiny": "whisper_tiny",
    "jamba-1.5-large-398b": "jamba_15_large",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "kimi-k2-1t-a32b": "kimi_k2",
    "mamba2-2.7b": "mamba2_27b",
    "llava-next-34b": "llava_next_34b",
}


def get(name: str):
    mod_name = ALIASES.get(name, name).replace("-", "_")
    if mod_name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG
