"""Decoder-only LM assembly, ssm family (Mamba-1).

The port of ``repro/models/lm.py`` for the family it has the layers of.
Parameters are modules: an :class:`LM` holds the embedding, one
:class:`Mamba1Block` per layer in an ``nn.ModuleList`` (no stacked layer
axis) and the LM head; the layer stack is a Python loop where the reference
has ``lax.scan``.  The decode cache keeps the reference's stacked layout,
``{"conv": (L, B, K-1, Di), "ssm": (L, B, Di, N)}``, and every entry point
returns a new cache, as the reference does.

Training runs :func:`lm_loss`: the reference's next-token loss, with each
layer under ``torch.utils.checkpoint`` (non-reentrant) when ``cfg.remat``,
as the reference wraps its layer body in ``jax.checkpoint``.  The
parameters' gradients reach the S6 scan through its autograd Function,
whose backward is a hand-written kernel on the card.

Other families (dense, moe, hybrid, vlm, encdec) raise
``NotImplementedError`` (``ROADMAP.md`` Queue 1 item 11).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.api import resolve_device
from .config import ATTN_LOCAL, ModelConfig
from .layers import dense_init, norm_apply, norm_init, param
from .ssm import mamba1_apply, mamba1_init


def _dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def require_mamba1(cfg: ModelConfig) -> None:
    if cfg.family != "ssm" or cfg.ssm_version != 1:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (ssm_version "
            f"{cfg.ssm_version}) is not ported; repro_torch has the Mamba-1 "
            "ssm family only (ROADMAP.md Queue 1 item 11)")


class Mamba1Block(nn.Module):
    """One layer: ``norm_ssm`` then the Mamba-1 mixer ``ssm``, residual."""

    def __init__(self, norm_ssm: nn.ParameterDict, ssm: nn.ParameterDict):
        super().__init__()
        self.norm_ssm = norm_ssm
        self.ssm = ssm


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

def layer_init(gen: torch.Generator, cfg: ModelConfig) -> Mamba1Block:
    require_mamba1(cfg)
    return Mamba1Block(norm_init(cfg, device=gen.device),
                       mamba1_init(gen, cfg, _dt(cfg)))


def init_params(gen: torch.Generator, cfg: ModelConfig) -> LM:
    """Random parameters drawn from ``gen``, on its device."""
    require_mamba1(cfg)
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


def _block(layer: Mamba1Block, h: torch.Tensor, cfg: ModelConfig):
    """One layer without a cache (training): h + ssm(norm(h))."""
    out, _ = mamba1_apply(layer.ssm, norm_apply(layer.norm_ssm, h, cfg), cfg)
    return h + out


def forward_hidden(params: LM, cfg: ModelConfig, tokens, *, cache=None):
    """Run the stack.  Returns (hidden (B, T, d), new_cache, aux_loss).
    Without a cache, under grad and with ``cfg.remat``, each layer is
    checkpointed: only its input is kept, and the backward recomputes it."""
    require_mamba1(cfg)
    h = embed_tokens(params, cfg, tokens)
    remat = cache is None and cfg.remat and torch.is_grad_enabled()
    conv, ssm = [], []
    for i, layer in enumerate(params.layers):
        if remat:
            h = checkpoint(_block, layer, h, cfg, use_reentrant=False)
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


def prefill(params: LM, cfg: ModelConfig, tokens, cache):
    """Full-sequence pass that returns last-position logits + the populated
    decode cache.  ``cache`` supplies the state to start from."""
    h, new_cache, _ = forward_hidden(params, cfg, tokens, cache=cache)
    return logits_from_hidden(params, cfg, h[:, -1:]), new_cache


def decode_step(params: LM, cfg: ModelConfig, token, cache, cache_pos):
    """One-token serve step.  token: (B, 1) int; cache: stacked per-layer
    state; cache_pos: the position of this token per row (the ssm family
    does not read it: its state is O(1) in the sequence length)."""
    h, new_cache, _ = forward_hidden(params, cfg, token, cache=cache)
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
    ``cuda:0``; raises without CUDA).  ``seq_len`` sizes a KV cache; the ssm
    family's state does not depend on it."""
    require_mamba1(cfg)
    device = resolve_device(device)
    l, di, n = cfg.n_layers, cfg.d_inner, cfg.ssm_state
    return {"conv": torch.zeros((l, batch, cfg.ssm_conv - 1, di),
                                dtype=_dt(cfg), device=device),
            "ssm": torch.zeros((l, batch, di, n), dtype=torch.float32,
                               device=device)}
