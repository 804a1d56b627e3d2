"""Encoder-decoder backbone (seamless-m4t-medium).

The port of ``repro/models/encdec.py``.  The modality frontend is a stub,
as in the reference: the caller supplies precomputed frame embeddings
(B, T_enc, d_model); this module owns the transformer encoder
(bidirectional), the decoder (causal self-attention, then cross-attention
over the encoder's memory) and the tied text head.  "12L" is 12 encoder
and 12 decoder layers.

Parameters are modules in the reference's tree: :class:`EncDec` holds
``embed``, ``enc_layers`` (a :class:`~repro_torch.models.lm.Block` a layer
with ``norm_attn``/``attn``/``norm_mlp``/``mlp``), ``dec_layers``
(``norm_self``/``self_attn``/``norm_cross``/``cross_attn``/``norm_mlp``/
``mlp``), ``enc_norm`` and ``final_norm``; each stack is a Python loop
where the reference has ``lax.scan``, each layer under
``torch.utils.checkpoint`` when ``cfg.remat`` and autograd is on, as
``lm.py`` does.

The decode cache is ``{"k", "v": (L, B, S_dec, Hkv, D)}``, the decoder's
self-attention KV, written in place as every KV cache of the port is, and
``{"ck", "cv": (L, B, S_enc, Hkv, D)}``, each decoder layer's cross K/V of
the memory.  Prefill returns the cross K/V anew at the frames' length, as
the reference does, so the rows of one batch share ``T_enc``: the
reference's cross attention has no length mask, and a shorter row's padded
frames would be attended to.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import shardings
from .config import ModelConfig
from .layers import (attn_apply, attn_init, dense_init, mlp_apply, mlp_init,
                     norm_apply, norm_init, param)
from .lm import BIG_WINDOW, Block, _dt, _positions, logits_from_hidden


class EncDec(nn.Module):
    """The model's parameters: ``embed`` (V_pad, d), ``enc_layers``,
    ``dec_layers``, ``enc_norm``, ``final_norm``; ``lm_head`` is None (the
    head is tied to the embedding)."""

    def __init__(self, embed: torch.Tensor, enc_layers: list[Block],
                 dec_layers: list[Block], enc_norm: nn.ParameterDict,
                 final_norm: nn.ParameterDict):
        super().__init__()
        self.embed = param(embed)
        self.enc_layers = nn.ModuleList(enc_layers)
        self.dec_layers = nn.ModuleList(dec_layers)
        self.enc_norm = enc_norm
        self.final_norm = final_norm
        self.register_parameter("lm_head", None)


def enc_layer_init(gen, cfg: ModelConfig) -> Block:
    dtype, dev = _dt(cfg), gen.device
    return Block(norm_attn=norm_init(cfg, device=dev),
                 attn=attn_init(gen, cfg, dtype),
                 norm_mlp=norm_init(cfg, device=dev),
                 mlp=mlp_init(gen, cfg, dtype))


def dec_layer_init(gen, cfg: ModelConfig) -> Block:
    dtype, dev = _dt(cfg), gen.device
    return Block(norm_self=norm_init(cfg, device=dev),
                 self_attn=attn_init(gen, cfg, dtype),
                 norm_cross=norm_init(cfg, device=dev),
                 cross_attn=attn_init(gen, cfg, dtype),
                 norm_mlp=norm_init(cfg, device=dev),
                 mlp=mlp_init(gen, cfg, dtype))


def init_params(gen, cfg: ModelConfig) -> EncDec:
    """Random parameters drawn from ``gen``, on its device."""
    embed = dense_init(gen, (cfg.vocab_padded, cfg.d_model),
                       scale=cfg.d_model ** -0.5, dtype=_dt(cfg))
    enc = [enc_layer_init(gen, cfg) for _ in range(cfg.enc_layers)]
    dec = [dec_layer_init(gen, cfg) for _ in range(cfg.n_layers)]
    return EncDec(embed, enc, dec, norm_init(cfg, device=gen.device),
                  norm_init(cfg, device=gen.device))


def _enc_layer(lp: Block, h, cfg, positions):
    x = norm_apply(lp.norm_attn, h, cfg)
    out, _ = attn_apply(lp.attn, x, cfg, positions=positions, kind="bidir")
    h = h + out
    x = norm_apply(lp.norm_mlp, h, cfg)
    return h + mlp_apply(lp.mlp, x, cfg)


def encode(params: EncDec, cfg: ModelConfig, frames) -> torch.Tensor:
    """frames: (B, T_enc, d) stubbed frontend embeddings → the encoder's
    memory (B, T_enc, d) in the model's dtype."""
    h = shardings.constrain_batch(frames.to(_dt(cfg)))
    b, t, _ = h.shape
    positions = _positions(b, t, None, h.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params.enc_layers:
        if remat:
            h = checkpoint(_enc_layer, lp, h, cfg, positions,
                           use_reentrant=False)
        else:
            h = _enc_layer(lp, h, cfg, positions)
    return norm_apply(params.enc_norm, h, cfg)


def cross_kv(params: EncDec, cfg: ModelConfig, memory):
    """Each decoder layer's cross-attention K/V of the memory, stacked:
    (L, B, S, Hkv, D) each."""
    b, s, _ = memory.shape
    hkv, hd = cfg.n_kv_heads, cfg.hd
    ks = [shardings.split_heads(
        (memory @ lp.cross_attn["wk"]).reshape(b, s, hkv, hd), hkv)
        for lp in params.dec_layers]
    vs = [shardings.split_heads(
        (memory @ lp.cross_attn["wv"]).reshape(b, s, hkv, hd), hkv)
        for lp in params.dec_layers]
    return torch.stack(ks), torch.stack(vs)


def _dec_layer(lp: Block, h, cfg, positions, ck, cv, lcache=None,
               cache_pos=None):
    x = norm_apply(lp.norm_self, h, cfg)
    out, _ = attn_apply(lp.self_attn, x, cfg, positions=positions,
                        kind="win", window=BIG_WINDOW, cache=lcache,
                        cache_pos=cache_pos)
    h = h + out
    x = norm_apply(lp.norm_cross, h, cfg)
    out, _ = attn_apply(lp.cross_attn, x, cfg, positions=positions,
                        kind="cross", cross_kv=(ck, cv))
    h = h + out
    x = norm_apply(lp.norm_mlp, h, cfg)
    return h + mlp_apply(lp.mlp, x, cfg)


def embed_tokens(params: EncDec, cfg: ModelConfig, tokens) -> torch.Tensor:
    return shardings.take_rows(params.embed, tokens).to(_dt(cfg))


def decode_hidden(params: EncDec, cfg: ModelConfig, tokens, ckv, *,
                  cache=None, cache_pos=None):
    """The decoder stack over ``tokens`` (B, T) with the cross K/V ``ckv``
    (stacked per layer).  ``cache``: {k, v} (L, B, S_dec, Hkv, D), written in
    place (prefill without ``cache_pos``, decode with it: a scalar or one
    per row).  Returns (hidden (B, T, d), the cache or None)."""
    h = shardings.constrain_batch(embed_tokens(params, cfg, tokens))
    b, t, _ = h.shape
    if cache_pos is not None:
        cache_pos = torch.as_tensor(cache_pos, device=h.device).long()
    positions = _positions(b, t, cache_pos, h.device)
    remat = cache is None and cfg.remat and torch.is_grad_enabled()
    for i, lp in enumerate(params.dec_layers):
        if remat:
            h = checkpoint(_dec_layer, lp, h, cfg, positions, ckv[0][i],
                           ckv[1][i], use_reentrant=False)
            continue
        lcache = None if cache is None else {"k": cache["k"][i],
                                             "v": cache["v"][i]}
        h = _dec_layer(lp, h, cfg, positions, ckv[0][i], ckv[1][i], lcache,
                       cache_pos)
    return norm_apply(params.final_norm, h, cfg), cache


def encdec_loss(params: EncDec, cfg: ModelConfig, batch):
    """batch: {frames (B, T_enc, d), tokens (B, T_dec + 1)} → (loss, {"nll",
    "aux"}): the mean next-token negative log-likelihood over the padded
    vocab (its tail masked), as ``repro.models.encdec.encdec_loss``; the
    label's logit is gathered where the reference contracts a one-hot."""
    memory = encode(params, cfg, batch["frames"])
    ckv = cross_kv(params, cfg, memory)
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    h, _ = decode_hidden(params, cfg, inputs, ckv)
    logits = logits_from_hidden(params, cfg, h)
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = shardings.pick_last(logits, labels)
    nll = (lse - label_logit).mean()
    return nll, {"nll": nll, "aux": torch.zeros((), dtype=torch.float32,
                                                device=nll.device)}


def encdec_decode_step(params: EncDec, cfg: ModelConfig, token, cache,
                       cache_pos):
    """One decoder token a row.  cache: {k, v (L, B, S_dec, …), ck, cv (L,
    B, S_enc, …)}; k/v written in place.  Returns (logits (B, 1, V_pad),
    the cache)."""
    h, _ = decode_hidden(params, cfg, token, (cache["ck"], cache["cv"]),
                         cache={"k": cache["k"], "v": cache["v"]},
                         cache_pos=cache_pos)
    return logits_from_hidden(params, cfg, h), cache


def encdec_prefill(params: EncDec, cfg: ModelConfig, frames, tokens, cache):
    """Encode ``frames``, fill the decoder's KV cache with ``tokens``, and
    return the last position's logits and the cache with the cross K/V of
    this memory (new tensors at the frames' length)."""
    memory = encode(params, cfg, frames)
    ckv = cross_kv(params, cfg, memory)
    h, _ = decode_hidden(params, cfg, tokens, ckv,
                         cache={"k": cache["k"], "v": cache["v"]})
    logits = logits_from_hidden(params, cfg, h[:, -1:])
    return logits, dict(cache, ck=ckv[0], cv=ckv[1])


def init_cache(cfg: ModelConfig, batch: int, dec_len: int, enc_len: int,
               device=None):
    """Zeroed decode cache on ``device`` (default ``cuda:0``; raises
    without CUDA; ``"meta"`` for an abstract one)."""
    from ..core.api import resolve_device
    device = resolve_device(device, allow_meta=True)
    l, hkv, hd, dt = cfg.n_layers, cfg.n_kv_heads, cfg.hd, _dt(cfg)
    z = lambda s: torch.zeros((l, batch, s, hkv, hd), dtype=dt, device=device)
    return {"k": z(dec_len), "v": z(dec_len), "ck": z(enc_len),
            "cv": z(enc_len)}

