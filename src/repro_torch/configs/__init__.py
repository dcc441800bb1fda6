"""Architecture registry: one module per assigned architecture (exact
public-literature configs), the port's copy of the JAX package's
``configs`` (hyperparameters only; nothing is downloaded).

``get(name)`` returns the full-size ModelConfig; ``get_smoke(name)`` a
reduced same-family config for CPU smoke tests.
"""

from __future__ import annotations

import dataclasses
import importlib

ARCHS = [
    "glm4_9b", "yi_9b", "gemma_7b", "nemotron_4_340b",
    "qwen3_moe_235b_a22b", "qwen2_moe_a2_7b",
    "recurrentgemma_9b", "rwkv6_1_6b", "pixtral_12b",
    "seamless_m4t_large_v2",
]

# canonical ids as assigned (dashes) -> module names
CANON = {a.replace("_", "-"): a for a in ARCHS}
CANON.update({
    "glm4-9b": "glm4_9b", "yi-9b": "yi_9b", "gemma-7b": "gemma_7b",
    "nemotron-4-340b": "nemotron_4_340b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "rwkv6-1.6b": "rwkv6_1_6b", "pixtral-12b": "pixtral_12b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
})


def _module(name: str):
    mod = CANON.get(name, name.replace("-", "_").replace(".", "_"))
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).SMOKE


ASSIGNED_IDS = [
    "glm4-9b", "yi-9b", "gemma-7b", "nemotron-4-340b",
    "qwen3-moe-235b-a22b", "qwen2-moe-a2.7b", "recurrentgemma-9b",
    "rwkv6-1.6b", "pixtral-12b", "seamless-m4t-large-v2",
]


def all_arch_names() -> list[str]:
    return list(ASSIGNED_IDS)
