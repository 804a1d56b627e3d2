"""Model substrate of the port: config, layers, Mamba-1 SSM, the LM
assembly, the registry, and ``convert`` (the reference's parameter trees
into the port's modules).  See ``repro_torch/configs`` for the
architectures."""

from . import config, encdec, layers, lm, registry, shardings, ssm  # noqa: F401
from .config import SHAPES, ModelConfig, ShapeConfig  # noqa: F401
from .registry import ModelBundle, build, input_specs  # noqa: F401
