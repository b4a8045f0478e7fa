"""--arch registry: the architectures the port can run.

Only ``internlm2-1.8b`` so far: the dense attention path. The other
archs of the JAX package need MoE, SSM, codebooks or frontends, which
later slices of the port add.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
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
