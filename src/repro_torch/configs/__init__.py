"""Architecture registry: ``--arch <id>`` -> ModelConfig.

All 10 assigned architectures plus the paper's own CNN benchmark family
(used by the faithful reproduction, see repro/cnn/ in the JAX package).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    LONG_CONTEXT_OK,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    cell_is_runnable,
)

# arch id -> module name
ARCHS: dict[str, str] = {
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "glm4-9b": "glm4_9b",
    "internlm2-20b": "internlm2_20b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "musicgen-large": "musicgen_large",
    "hymba-1.5b": "hymba_1_5b",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    key = arch.replace("_", "-")
    if key not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choices: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[key]}")
    return mod.SMOKE if smoke else mod.CONFIG


def all_archs() -> list[str]:
    return list(ARCHS)
