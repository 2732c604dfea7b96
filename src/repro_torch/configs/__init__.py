"""Model configs of the port (port of `repro.configs`): the schema, the
registry, and the dense architectures `qwen3-1.7b` and `deepseek-7b`."""
from .base import SHAPES, ModelConfig, ShapeConfig, shape_applicable
from .registry import get_config, get_smoke_config, list_archs

__all__ = ["SHAPES", "ModelConfig", "ShapeConfig", "shape_applicable",
           "get_config", "get_smoke_config", "list_archs"]
