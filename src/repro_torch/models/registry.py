"""Uniform per-architecture API: init / loss / prefill / decode /
init_cache.

``build(cfg)`` returns a ModelBundle whose entry points close over the
config, as in ``repro/models/registry.py``.  The port has the lm families'
Mamba-1 (ssm) member only; ``encdec`` and ``input_specs`` wait for their
slices (``ROADMAP.md`` Queue 1 item 11).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..core.api import resolve_device
from . import lm
from .config import ModelConfig


@dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    init: Callable[..., Any]
    loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    init_cache: Callable[..., Any]


def build(cfg: ModelConfig) -> ModelBundle:
    lm.require_mamba1(cfg)

    def init(seed: int = 0, device=None) -> lm.LM:
        """Random parameters from ``torch.Generator(device).manual_seed(seed)``
        on ``device`` (default ``cuda:0``; raises without CUDA)."""
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        return lm.init_params(gen, cfg)

    return ModelBundle(
        cfg=cfg,
        init=init,
        loss=lambda p, b: lm.lm_loss(p, cfg, b),
        prefill=lambda p, b, cache: lm.prefill(p, cfg, b["tokens"], cache),
        decode=lambda p, tok, cache, pos: lm.decode_step(p, cfg, tok, cache,
                                                         pos),
        init_cache=lambda batch, seq, device=None: lm.init_cache(
            cfg, batch, seq, device=device),
    )
