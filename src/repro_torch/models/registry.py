"""Uniform per-architecture API: init / loss / prefill / decode /
init_cache.

``build(cfg)`` returns a ModelBundle whose entry points close over the
config, as in ``repro/models/registry.py``, with its ``ring`` rule: a KV
cache shorter than the context (``lm.cache_len``, pure sliding-window
models) is a ring buffer; ``decode`` is told the context's total length
(the serve engine passes its ``max_len``, as the reference's does);
``prefill`` passes the batch's ``patches`` (vlm) when it has them.  The
port has the lm families (dense, moe, Mamba-1 ssm, Mamba-2 hybrid, vlm);
``encdec`` and ``input_specs`` wait for their slices (``ROADMAP.md`` Queue 1
items 11.4 and 11.5).
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
    lm.require_ported(cfg)
    ring = lambda seq: lm.cache_len(cfg, seq) < seq

    def init(seed: int = 0, device=None) -> lm.LM:
        """Random parameters from ``torch.Generator(device).manual_seed(seed)``
        on ``device`` (default ``cuda:0``; raises without CUDA)."""
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        return lm.init_params(gen, cfg)

    return ModelBundle(
        cfg=cfg,
        init=init,
        loss=lambda p, b: lm.lm_loss(p, cfg, b),
        prefill=lambda p, b, cache: lm.prefill(
            p, cfg, b["tokens"], cache, patches=b.get("patches"),
            ring=ring(b["tokens"].shape[1])),
        decode=lambda p, tok, cache, pos, total=None: lm.decode_step(
            p, cfg, tok, cache, pos,
            ring=ring(total) if total is not None else False),
        init_cache=lambda batch, seq, device=None: lm.init_cache(
            cfg, batch, seq, device=device),
    )
