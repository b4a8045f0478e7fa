from repro_torch.configs.base import (
    SHAPES,
    MeshConfig,
    ModelConfig,
    MULTI_POD,
    RunConfig,
    ShapeConfig,
    SINGLE_POD,
    shape_applicable,
)
from repro_torch.configs.registry import all_configs, get_config, list_archs

__all__ = [
    "SHAPES",
    "MeshConfig",
    "ModelConfig",
    "MULTI_POD",
    "RunConfig",
    "ShapeConfig",
    "SINGLE_POD",
    "shape_applicable",
    "all_configs",
    "get_config",
    "list_archs",
]
