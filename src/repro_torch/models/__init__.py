"""The port's models: the dense causal LM with decode-time TAF (port of
`repro.models`; the other families come with the model zoo)."""
from . import attention, blocks, common, lm, mlp
from .lm import Model, build

__all__ = ["attention", "blocks", "common", "lm", "mlp", "Model", "build"]
