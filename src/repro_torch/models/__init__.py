"""Model substrate of the port: config, layers, Mamba-1 SSM, the LM
assembly, the registry, and ``convert`` (the reference's parameter trees
into the port's modules).  See ``repro_torch/configs`` for the
architectures."""

from . import config, layers, lm, registry, ssm  # noqa: F401
from .config import SHAPES, ModelConfig, ShapeConfig  # noqa: F401
from .registry import ModelBundle, build  # noqa: F401
