"""Layer substrate: initialisers and norms.

The port of ``repro/models/layers.py`` as far as the Mamba-1 LM needs it:
``dense_init``, ``norm_init`` and ``norm_apply``.  Attention, RoPE and the
MLPs come with the families that use them (``ROADMAP.md`` Queue 1 item 11).

Parameters live in ``nn.ParameterDict``s keyed by the reference's names, so
``p["scale"]`` reads as it does there; they do not require grad (serving
only).  Random draws come from an explicit ``torch.Generator`` and land on
its device.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .config import ModelConfig


def param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def dense_init(gen: torch.Generator, shape, scale: float | None = None,
               dtype=torch.float32) -> torch.Tensor:
    """N(0, 1) · scale (default 1/sqrt(fan_in)) drawn in fp32 on
    ``gen.device``, then cast to ``dtype``."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(tuple(shape), generator=gen, device=gen.device)
    return w.mul_(scale).to(dtype)


def norm_init(cfg: ModelConfig, dim: int | None = None,
              device=None) -> nn.ParameterDict:
    d = dim or cfg.d_model
    p = {"scale": param(torch.ones((d,), dtype=torch.float32, device=device))}
    if cfg.norm == "layernorm":
        p["bias"] = param(torch.zeros((d,), dtype=torch.float32,
                                      device=device))
    return nn.ParameterDict(p)


def norm_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMSNorm (or LayerNorm) computed in fp32, returned in x's dtype."""
    xf = x.float()
    if cfg.norm == "layernorm":
        xf = xf - xf.mean(-1, keepdim=True)
        var = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + 1e-6) * p["scale"] + p["bias"]
    else:
        var = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + 1e-6) * p["scale"]
    return out.to(x.dtype)
