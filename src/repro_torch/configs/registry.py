"""--arch registry: resolve architecture ids to ModelConfigs.

The JAX package's ten archs in its order (``repro/configs/registry.py``):
dense attention (internlm2, glm4 with partial rotary, gemma with
``embed_scale``, gemma2 with local/global windows and softcaps), MoE
(granite-moe, moonshot), a vision frontend (internvl2), audio codebooks
(musicgen), Mamba2 SSD layers (mamba2) and the hybrid attention + SSM
with MoE (jamba).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_16b_a3b",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large",
}

#: archs of the port alone, outside ``list_archs``/``all_configs`` (which
#: stay the JAX package's): their configs use fields ``ModelConfig`` lacks
_PORT_MODULES = {
    "granite-4.0-h-small": "repro_torch.configs.granite_4_0_h_small",
}


def list_archs() -> List[str]:
    return list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    modules = {**_MODULES, **_PORT_MODULES}
    if arch not in modules:
        raise KeyError(f"unknown --arch {arch!r}; known: {', '.join(modules)}")
    cfg: ModelConfig = importlib.import_module(modules[arch]).CONFIG
    if cfg.name != arch:
        raise ValueError(f"config module for {arch!r} names {cfg.name!r}")
    return cfg


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in _MODULES}
