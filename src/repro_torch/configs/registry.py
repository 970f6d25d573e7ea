"""Architecture registry.  `get(name)` returns the full (paper-exact) config;
`get_smoke(name)` returns a reduced same-family config for CPU smoke tests."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.common.types import ModelConfig

ARCHS = (
    "zamba2_2p7b", "rwkv6_7b", "yi_34b", "gemma_2b", "qwen1p5_0p5b",
    "starcoder2_15b", "internvl2_1b", "kimi_k2_1t_a32b", "qwen3_moe_235b_a22b",
    "musicgen_large",
)

# external-id -> module name
ALIASES = {
    "zamba2-2.7b": "zamba2_2p7b",
    "rwkv6-7b": "rwkv6_7b",
    "yi-34b": "yi_34b",
    "gemma-2b": "gemma_2b",
    "qwen1.5-0.5b": "qwen1p5_0p5b",
    "starcoder2-15b": "starcoder2_15b",
    "internvl2-1b": "internvl2_1b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "musicgen-large": "musicgen_large",
}


def canonical(name: str) -> str:
    return ALIASES.get(name, name.replace("-", "_").replace(".", "p"))


def get(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.CONFIG


def get_smoke(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get(a) for a in ARCHS}
