"""Uniform per-architecture API: init / loss / prefill / decode /
init_cache, and the dry run's abstract stand-ins.

``build(cfg)`` returns a ModelBundle whose entry points close over the
config, as in ``repro/models/registry.py``: the encdec family through
``encdec.py`` (its ``init_cache(batch, seq)`` lays out ``dec_len = enc_len
= seq``), every other family through ``lm.py`` with its ``ring`` rule: a
KV cache shorter than the context (``lm.cache_len``, pure sliding-window
models) is a ring buffer; ``decode`` is told the context's total length
(the serve engine passes its ``max_len``, as the reference's does);
``prefill`` passes the batch's ``patches`` (vlm) when it has them.

``abstract_params``, :func:`input_specs` and :func:`cache_specs` are the
reference's ``eval_shape`` stand-ins: tensors on the ``meta`` device with
the shapes and dtypes the real ones have, drawn and allocated nowhere.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..core.api import resolve_device
from . import encdec, lm
from .config import ModelConfig, ShapeConfig
from .layers import MetaGenerator


@dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    init: Callable[..., Any]
    loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    init_cache: Callable[..., Any]

    def abstract_params(self):
        """The parameters ``init`` makes, on the ``meta`` device."""
        return self.init(device="meta")


def _init(make: Callable) -> Callable:
    def init(seed: int = 0, device=None):
        """Random parameters from ``torch.Generator(device).manual_seed(
        seed)`` on ``device`` (default ``cuda:0``; raises without CUDA), or,
        with ``device="meta"``, their shapes and dtypes."""
        dev = resolve_device(device, allow_meta=True)
        gen = MetaGenerator() if dev.type == "meta" else \
            torch.Generator(device=dev).manual_seed(seed)
        return make(gen)
    return init


def build(cfg: ModelConfig) -> ModelBundle:
    if cfg.family == "encdec":
        return ModelBundle(
            cfg=cfg,
            init=_init(lambda gen: encdec.init_params(gen, cfg)),
            loss=lambda p, b: encdec.encdec_loss(p, cfg, b),
            prefill=lambda p, b, cache: encdec.encdec_prefill(
                p, cfg, b["frames"], b["tokens"], cache),
            decode=lambda p, tok, cache, pos, total=None:
                encdec.encdec_decode_step(p, cfg, tok, cache, pos),
            init_cache=lambda batch, seq, device=None: encdec.init_cache(
                cfg, batch, seq, seq, device=device),
        )

    ring = lambda seq: lm.cache_len(cfg, seq) < seq
    return ModelBundle(
        cfg=cfg,
        init=_init(lambda gen: lm.init_params(gen, cfg)),
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


# ---------------------------------------------------------------------------
# input specs (dry-run stand-ins; no allocation)
# ---------------------------------------------------------------------------

def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                batch_override: int | None = None) -> dict:
    """Meta-tensor stand-ins for one (arch × shape) cell:

    train   → {'batch': {tokens[, patches, frames]}}
    prefill → {'batch': …, 'cache': the zeroed layout}
    decode  → {'token', 'cache', 'pos'}
    """
    b = batch_override or shape.global_batch
    t = shape.seq_len
    d = cfg.d_model
    i32, f32 = torch.int32, torch.float32

    if shape.kind == "train":
        batch: dict[str, Any] = {"tokens": _sds((b, t + 1), i32)}
        if cfg.family == "vlm":
            batch["patches"] = _sds((b, cfg.n_patches, d), f32)
        if cfg.family == "encdec":
            batch = {"frames": _sds((b, t, d), f32),
                     "tokens": _sds((b, t + 1), i32)}
        return {"batch": batch}

    cache = cache_specs(cfg, b, t)
    if shape.kind == "prefill":
        batch = {"tokens": _sds((b, t), i32)}
        if cfg.family == "vlm":
            batch["patches"] = _sds((b, cfg.n_patches, d), f32)
        if cfg.family == "encdec":
            batch = {"frames": _sds((b, t, d), f32),
                     "tokens": _sds((b, t), i32)}
        return {"batch": batch, "cache": cache}

    # decode
    return {"token": _sds((b, 1), i32), "cache": cache,
            "pos": _sds((), i32)}


def cache_specs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """The zeroed decode cache ``build(cfg).init_cache(batch, seq)`` makes,
    on the ``meta`` device."""
    return build(cfg).init_cache(batch, seq, device="meta")
