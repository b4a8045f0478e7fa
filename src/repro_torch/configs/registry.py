"""--arch registry: the architectures the port can run.

``internlm2-1.8b`` (dense attention with a gated MLP) and
``mamba2-2.7b`` (attention-free Mamba2 SSD layers). The other archs of
the JAX package need MoE, hybrid attention + SSM with MoE, codebooks,
frontends or other attention variants, which later slices of the port
add.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
}


def list_archs() -> List[str]:
    return list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"the port cannot run --arch {arch!r} yet; "
                       f"it runs: {', '.join(_MODULES)}")
    cfg: ModelConfig = importlib.import_module(_MODULES[arch]).CONFIG
    if cfg.name != arch:
        raise ValueError(f"config module for {arch!r} names {cfg.name!r}")
    return cfg
