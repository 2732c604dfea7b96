"""Model configs of the port (port of `repro.configs`): the schema, the
registry, and the JAX package's ten architectures."""
from .base import SHAPES, ModelConfig, ShapeConfig, shape_applicable
from .registry import cut_depth, get_config, get_smoke_config, list_archs

__all__ = ["SHAPES", "ModelConfig", "ShapeConfig", "shape_applicable",
           "cut_depth", "get_config", "get_smoke_config", "list_archs"]
