"""Decoder-only LM assembly: the dense family and the ssm family (Mamba-1).

The port of ``repro/models/lm.py`` for the families it has the layers of.
Parameters are modules: an :class:`LM` holds the embedding, one
:class:`Block` per layer in an ``nn.ModuleList`` (no stacked layer axis;
a block's ``nn.ParameterDict``s carry the reference's layer keys:
``norm_ssm``/``ssm``, or ``norm_attn``/``attn``/``norm_mlp``/``mlp`` and,
with ``post_norm``, ``post_attn``/``post_mlp``) and the LM head; the layer
stack is a Python loop where the reference has ``lax.scan``.  The per-layer
schedule (the reference's traced window and RoPE base) is
:func:`layer_schedule`, Python numbers a layer.

The decode cache keeps the reference's stacked layout: ``{"conv": (L, B,
K-1, Di), "ssm": (L, B, Di, N)}`` for the ssm family, for which every entry
point returns a new cache as the reference does, and ``{"k", "v": (L, B,
S_c, Hkv, D)}`` for the dense family, which prefill and decode write in
place (``layers.attn_apply``) and return.

Training runs :func:`lm_loss`: the reference's next-token loss, with each
layer under ``torch.utils.checkpoint`` (non-reentrant) when ``cfg.remat``,
as the reference wraps its layer body in ``jax.checkpoint``.  The
parameters' gradients reach the S6 scan through its autograd Function,
whose backward is a hand-written kernel on the card.  The dense family's
loss is held to the reference on the CPU; training it on the card is a
later slice.

The moe, hybrid, vlm and encdec families raise ``NotImplementedError``
(``ROADMAP.md`` Queue 1 item 11).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.api import resolve_device
from .config import ATTN_LOCAL, ModelConfig
from .layers import (attn_apply, attn_init, dense_init, mlp_apply, mlp_init,
                     norm_apply, norm_init, param)
from .ssm import mamba1_apply, mamba1_init

#: the window of a global layer: no lookback bound within any context
BIG_WINDOW = 1 << 30


def _dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def require_ported(cfg: ModelConfig) -> None:
    """Admit the families the port has: dense (no experts) and Mamba-1 ssm."""
    if cfg.family == "dense" and not cfg.n_experts:
        return
    if cfg.family == "ssm" and cfg.ssm_version == 1:
        return
    raise NotImplementedError(
        f"{cfg.name}: family {cfg.family!r} (ssm_version {cfg.ssm_version}, "
        f"{cfg.n_experts} experts) is not ported; repro_torch has the dense "
        "and the Mamba-1 ssm families (ROADMAP.md Queue 1 item 11)")


def in_place_cache(cfg: ModelConfig) -> bool:
    """True when prefill and decode write the cache they are given (a KV
    cache) rather than return a new one (the ssm family's state)."""
    return cfg.family != "ssm"


class Block(nn.Module):
    """One layer's parameters: an ``nn.ParameterDict`` per key of the
    reference's layer tree (``block.attn["wq"]`` is
    ``params["layers"]["attn"]["wq"][i]`` there)."""

    def __init__(self, **parts: nn.ParameterDict):
        super().__init__()
        self.parts = tuple(sorted(parts))
        for k, v in parts.items():
            setattr(self, k, v)


class LM(nn.Module):
    """The model's parameters: ``embed`` (V_pad, d), ``layers``,
    ``final_norm`` and ``lm_head`` (d, V_pad; None when tied)."""

    def __init__(self, embed: torch.Tensor, layers: list[nn.Module],
                 final_norm: nn.ParameterDict,
                 lm_head: torch.Tensor | None):
        super().__init__()
        self.embed = param(embed)
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.register_parameter(
            "lm_head", None if lm_head is None else param(lm_head))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def layer_init(gen: torch.Generator, cfg: ModelConfig) -> Block:
    require_ported(cfg)
    dtype, dev = _dt(cfg), gen.device
    if cfg.family == "ssm":
        return Block(norm_ssm=norm_init(cfg, device=dev),
                     ssm=mamba1_init(gen, cfg, dtype))
    parts = {"norm_attn": norm_init(cfg, device=dev),
             "attn": attn_init(gen, cfg, dtype),
             "norm_mlp": norm_init(cfg, device=dev),
             "mlp": mlp_init(gen, cfg, dtype)}
    if cfg.post_norm:
        parts["post_attn"] = norm_init(cfg, device=dev)
        parts["post_mlp"] = norm_init(cfg, device=dev)
    return Block(**parts)


def init_params(gen: torch.Generator, cfg: ModelConfig) -> LM:
    """Random parameters drawn from ``gen``, on its device."""
    require_ported(cfg)
    dtype = _dt(cfg)
    embed = dense_init(gen, (cfg.vocab_padded, cfg.d_model),
                       scale=cfg.d_model ** -0.5, dtype=dtype)
    layers = [layer_init(gen, cfg) for _ in range(cfg.n_layers)]
    lm_head = (None if cfg.tie_embeddings else
               dense_init(gen, (cfg.d_model, cfg.vocab_padded), dtype=dtype))
    return LM(embed, layers, norm_init(cfg, device=gen.device), lm_head)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def embed_tokens(params: LM, cfg: ModelConfig, tokens) -> torch.Tensor:
    h = params.embed[tokens].to(_dt(cfg))
    if cfg.embed_scale:
        h = h * math.sqrt(cfg.d_model)
    return h


def layer_schedule(cfg: ModelConfig) -> list[tuple[int, float]]:
    """(window, RoPE θ) of each layer: ``cfg.sliding_window`` on a local
    layer and :data:`BIG_WINDOW` on a global one; θ is
    ``cfg.rope_theta_global`` on a global layer where the config has one."""
    out = []
    for k in cfg.layer_kinds():
        local = k == ATTN_LOCAL
        out.append((cfg.sliding_window if local else BIG_WINDOW,
                    cfg.rope_theta if (local or cfg.rope_theta_global is None)
                    else cfg.rope_theta_global))
    return out


def _attn_block(lp: Block, h, cfg, *, positions, window, theta, cache=None,
                cache_pos=None, ring=False):
    x = norm_apply(lp.norm_attn, h, cfg)
    out, new_cache = attn_apply(lp.attn, x, cfg, positions=positions,
                                cache=cache, cache_pos=cache_pos,
                                window=window, theta=theta, ring=ring)
    if cfg.post_norm:
        out = norm_apply(lp.post_attn, out, cfg)
    return h + out, new_cache


def _mlp_block(lp: Block, h, cfg):
    out = mlp_apply(lp.mlp, norm_apply(lp.norm_mlp, h, cfg), cfg)
    if cfg.post_norm:
        out = norm_apply(lp.post_mlp, out, cfg)
    return h + out


def _ssm_block(layer: Block, h: torch.Tensor, cfg: ModelConfig):
    """One Mamba-1 layer without a cache (training): h + ssm(norm(h))."""
    out, _ = mamba1_apply(layer.ssm, norm_apply(layer.norm_ssm, h, cfg), cfg)
    return h + out


def _dense_block(layer: Block, h, cfg, positions, window, theta):
    """One dense layer without a cache (training)."""
    h, _ = _attn_block(layer, h, cfg, positions=positions, window=window,
                       theta=theta)
    return _mlp_block(layer, h, cfg)


def _positions(b: int, t: int, cache_pos, device) -> torch.Tensor:
    if cache_pos is None:
        return torch.arange(t, device=device).expand(b, t)
    cp = torch.as_tensor(cache_pos, device=device).long()
    return cp.reshape(-1, 1).expand(b, t) if cp.dim() == 1 \
        else cp.expand(b, t)


def forward_hidden(params: LM, cfg: ModelConfig, tokens, *, cache=None,
                   cache_pos=None, ring: bool = False):
    """Run the stack.  Returns (hidden (B, T, d), new_cache, aux_loss).

    ``cache_pos`` (a scalar or a per-row (B,) tensor) is the position of
    the first token; without it positions start at 0.  ``ring``: the KV
    cache is a ring buffer shorter than the context (pure sliding-window
    models).  Without a cache, under grad and with ``cfg.remat``, each
    layer is checkpointed: only its input is kept, and the backward
    recomputes it."""
    require_ported(cfg)
    h = embed_tokens(params, cfg, tokens)
    remat = cache is None and cfg.remat and torch.is_grad_enabled()
    if cfg.family == "ssm":
        return _forward_ssm(params, cfg, h, cache, remat)
    b, t, _ = h.shape
    if cache_pos is not None:   # on the device once, not once a layer
        cache_pos = torch.as_tensor(cache_pos, device=h.device).long()
    positions = _positions(b, t, cache_pos, h.device)
    for i, (layer, (window, theta)) in enumerate(
            zip(params.layers, layer_schedule(cfg))):
        if remat:
            h = checkpoint(_dense_block, layer, h, cfg, positions, window,
                           theta, use_reentrant=False)
            continue
        lcache = None if cache is None else {"k": cache["k"][i],
                                             "v": cache["v"][i]}
        h, _ = _attn_block(layer, h, cfg, positions=positions, window=window,
                           theta=theta, cache=lcache, cache_pos=cache_pos,
                           ring=ring)
        h = _mlp_block(layer, h, cfg)
    h = norm_apply(params.final_norm, h, cfg)
    return h, cache, torch.zeros((), dtype=torch.float32, device=h.device)


def _forward_ssm(params: LM, cfg: ModelConfig, h, cache, remat: bool):
    conv, ssm = [], []
    for i, layer in enumerate(params.layers):
        if remat:
            h = checkpoint(_ssm_block, layer, h, cfg, use_reentrant=False)
            continue
        lcache = None if cache is None else {"conv": cache["conv"][i],
                                             "ssm": cache["ssm"][i]}
        out, c = mamba1_apply(layer.ssm, norm_apply(layer.norm_ssm, h, cfg),
                              cfg, cache=lcache)
        h = h + out
        if c is not None:
            conv.append(c["conv"])
            ssm.append(c["ssm"])
    h = norm_apply(params.final_norm, h, cfg)
    new_cache = ({"conv": torch.stack(conv), "ssm": torch.stack(ssm)}
                 if cache is not None else None)
    return h, new_cache, torch.zeros((), dtype=torch.float32, device=h.device)


def logits_from_hidden(params: LM, cfg: ModelConfig, h) -> torch.Tensor:
    """fp32 logits over the PADDED vocab; the padded tail is masked to -1e30
    so softmax and sampling are exact with respect to the true vocab."""
    w = params.lm_head if params.lm_head is not None else params.embed.T
    logits = h.float() @ w.float()
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


# ---------------------------------------------------------------------------
# task-level entry points
# ---------------------------------------------------------------------------

def lm_loss(params: LM, cfg: ModelConfig, batch):
    """batch: {tokens (B, T+1)} → (loss, {"nll", "aux"}): the mean next-token
    negative log-likelihood of ``tokens[:, 1:]`` given ``tokens[:, :-1]``,
    over the padded vocab (its tail masked to -1e30), plus the aux loss (0
    for the ssm family), as ``repro.models.lm.lm_loss``.  The label's logit
    is gathered where the reference contracts a one-hot: the same value,
    without the (B, T, V) one-hot."""
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    h, _, aux = forward_hidden(params, cfg, inputs)
    logits = logits_from_hidden(params, cfg, h)
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = lse - label_logit
    loss = nll.mean() + aux
    return loss, {"nll": nll.mean(), "aux": aux}


def prefill(params: LM, cfg: ModelConfig, tokens, cache, *, ring=False):
    """Full-sequence pass that returns last-position logits + the populated
    decode cache.  ``cache`` supplies the state to start from (the ssm
    family) or the KV layout to fill in place (the dense family)."""
    h, new_cache, _ = forward_hidden(params, cfg, tokens, cache=cache,
                                     ring=ring)
    return logits_from_hidden(params, cfg, h[:, -1:]), new_cache


def decode_step(params: LM, cfg: ModelConfig, token, cache, cache_pos, *,
                ring=False):
    """One-token serve step.  token: (B, 1) int; cache: stacked per-layer
    state; cache_pos: the position of this token, a scalar or one per row
    (the ssm family does not read it: its state is O(1) in the sequence
    length)."""
    h, new_cache, _ = forward_hidden(params, cfg, token, cache=cache,
                                     cache_pos=cache_pos, ring=ring)
    return logits_from_hidden(params, cfg, h), new_cache


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------

def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    kinds = cfg.layer_kinds()
    if cfg.family in ("ssm",):
        return 0
    if cfg.sliding_window is not None and all(k == ATTN_LOCAL for k in kinds) \
            and cfg.family != "hybrid":
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None):
    """Zeroed stacked decode cache for every layer on ``device`` (default
    ``cuda:0``; raises without CUDA).  ``seq_len`` sizes a KV cache
    (:func:`cache_len` of it); the ssm family's state does not depend on
    it."""
    require_ported(cfg)
    device = resolve_device(device)
    l = cfg.n_layers
    if cfg.family == "ssm":
        di, n = cfg.d_inner, cfg.ssm_state
        return {"conv": torch.zeros((l, batch, cfg.ssm_conv - 1, di),
                                    dtype=_dt(cfg), device=device),
                "ssm": torch.zeros((l, batch, di, n), dtype=torch.float32,
                                   device=device)}
    shape = (l, batch, cache_len(cfg, seq_len), cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=_dt(cfg), device=device),
            "v": torch.zeros(shape, dtype=_dt(cfg), device=device)}
