from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig, SHAPES  # noqa: F401
from repro_torch.configs.registry import get_config, list_archs  # noqa: F401
