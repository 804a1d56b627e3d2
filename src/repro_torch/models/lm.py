"""Decoder-only LM assembly: the dense, moe, ssm (Mamba-1), hybrid
(Mamba-2 with zamba2's shared attention block) and vlm families.

The port of ``repro/models/lm.py``.  Parameters are modules: an :class:`LM`
holds the embedding, one :class:`Block` per layer in an ``nn.ModuleList``
(no stacked layer axis; a block's ``nn.ParameterDict``s carry the
reference's layer keys: ``norm_ssm``/``ssm``, or
``norm_attn``/``attn``/``norm_mlp`` with ``mlp`` or ``moe`` and, with
``post_norm``, ``post_attn``/``post_mlp``), the hybrid family's one
``shared`` block (``norm_attn``/``attn``/``norm_mlp``/``mlp``, held once,
not per layer), the vlm family's ``vis_proj``, and the LM head; the layer
stack is a Python loop where the reference has ``lax.scan``.  The per-layer
schedule (the reference's traced window and RoPE base) is
:func:`layer_schedule`, Python numbers a layer; the hybrid's shared-block
sites (``cfg.shared_attn_sites()``, the reference's ``lax.cond``) are a
Python ``if`` per layer, so a decode step captures with no device branch.

The decode cache keeps the reference's stacked layout: ``{"conv": (L, B,
K-1, Di), "ssm": (L, B, Di, N)}`` for the ssm family; ``{"k", "v": (L, B,
S_c, Hkv, D)}`` for the attention families; and for the hybrid family
``conv``, ``ssm`` (L, B, H, P, N) and ``k``/``v`` for every layer, of which
only the shared block's sites write theirs.  Entry points write the ``k``
and ``v`` entries in place (``layers.attn_apply``) and return a new
``conv`` and ``ssm`` (:func:`state_keys`), as the reference returns every
entry anew.

The vlm family's patches (B, Np, d) are projected by ``vis_proj`` and
placed before the text; positions run over both, and the loss is taken on
the text positions only.  The moe family's load-balance aux loss is summed
over the layers and added to the loss.

Training runs :func:`lm_loss`: the reference's next-token loss, with each
layer under ``torch.utils.checkpoint`` (non-reentrant) when ``cfg.remat``,
as the reference wraps its layer body in ``jax.checkpoint``.  The
parameters' gradients reach the S6 scan through its autograd Function,
whose backward is a hand-written kernel on the card.  The loss of the
dense, moe, hybrid and vlm families is held to the reference on the CPU;
training them on the card is a later slice.  The encdec family lives in
``encdec.py`` and shares this module's head (:func:`logits_from_hidden`).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.api import resolve_device
from . import shardings
from .config import ATTN_LOCAL, ModelConfig
from .layers import (attn_apply, attn_init, dense_init, mlp_apply, mlp_init,
                     norm_apply, norm_init, param)
from .moe import moe_apply, moe_init
from .ssm import mamba1_apply, mamba1_init, mamba2_apply, mamba2_init

#: the window of a global layer: no lookback bound within any context
BIG_WINDOW = 1 << 30


def _dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def state_keys(cfg: ModelConfig) -> tuple[str, ...]:
    """The cache keys whose entries prefill and decode return anew (a
    state-space layer's conv and SSM state); every other key (a KV cache)
    they write in place in the tensors they are given."""
    return ("conv", "ssm") if cfg.family in ("ssm", "hybrid") else ()


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
    ``final_norm``, ``lm_head`` (d, V_pad; None when tied), the hybrid
    family's ``shared`` block and the vlm family's ``vis_proj`` (d, d)
    (None elsewhere)."""

    def __init__(self, embed: torch.Tensor, layers: list[nn.Module],
                 final_norm: nn.ParameterDict,
                 lm_head: torch.Tensor | None, *,
                 shared: Block | None = None,
                 vis_proj: torch.Tensor | None = None):
        super().__init__()
        self.embed = param(embed)
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.register_parameter(
            "lm_head", None if lm_head is None else param(lm_head))
        self.shared = shared
        self.register_parameter(
            "vis_proj", None if vis_proj is None else param(vis_proj))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def layer_init(gen: torch.Generator, cfg: ModelConfig) -> Block:
    dtype, dev = _dt(cfg), gen.device
    if cfg.family in ("ssm", "hybrid"):
        init = mamba1_init if cfg.ssm_version == 1 else mamba2_init
        return Block(norm_ssm=norm_init(cfg, device=dev),
                     ssm=init(gen, cfg, dtype))
    parts = {"norm_attn": norm_init(cfg, device=dev),
             "attn": attn_init(gen, cfg, dtype),
             "norm_mlp": norm_init(cfg, device=dev)}
    if cfg.n_experts:
        parts["moe"] = moe_init(gen, cfg, dtype)
    else:
        parts["mlp"] = mlp_init(gen, cfg, dtype)
    if cfg.post_norm:
        parts["post_attn"] = norm_init(cfg, device=dev)
        parts["post_mlp"] = norm_init(cfg, device=dev)
    return Block(**parts)


def init_params(gen: torch.Generator, cfg: ModelConfig) -> LM:
    """Random parameters drawn from ``gen``, on its device."""
    dtype, dev = _dt(cfg), gen.device
    embed = dense_init(gen, (cfg.vocab_padded, cfg.d_model),
                       scale=cfg.d_model ** -0.5, dtype=dtype)
    layers = [layer_init(gen, cfg) for _ in range(cfg.n_layers)]
    shared = None
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        shared = Block(norm_attn=norm_init(cfg, device=dev),
                       attn=attn_init(gen, cfg, dtype),
                       norm_mlp=norm_init(cfg, device=dev),
                       mlp=mlp_init(gen, cfg, dtype))
    lm_head = (None if cfg.tie_embeddings else
               dense_init(gen, (cfg.d_model, cfg.vocab_padded), dtype=dtype))
    vis_proj = (dense_init(gen, (cfg.d_model, cfg.d_model), dtype=dtype)
                if cfg.family == "vlm" and cfg.n_patches else None)
    return LM(embed, layers, norm_init(cfg, device=dev), lm_head,
              shared=shared, vis_proj=vis_proj)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def embed_tokens(params: LM, cfg: ModelConfig, tokens,
                 patches=None) -> torch.Tensor:
    """The tokens' embeddings; for the vlm family with ``patches`` (B, Np,
    d), ``patches @ vis_proj`` in the model's dtype placed before them."""
    h = shardings.take_rows(params.embed, tokens).to(_dt(cfg))
    if cfg.embed_scale:
        h = h * math.sqrt(cfg.d_model)
    if cfg.family == "vlm" and patches is not None:
        if not shardings.is_distributed(patches):
            patches = torch.as_tensor(patches, device=h.device)
        vis = patches.to(_dt(cfg)) @ params.vis_proj
        h = torch.cat([vis, h], dim=1)
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
    """h + MLP (or experts) of norm(h); returns (h, the experts' aux loss
    or None without experts)."""
    x = norm_apply(lp.norm_mlp, h, cfg)
    aux = None
    if cfg.n_experts:
        out, aux = moe_apply(lp.moe, x, cfg)
    else:
        out = mlp_apply(lp.mlp, x, cfg)
    if cfg.post_norm:
        out = norm_apply(lp.post_mlp, out, cfg)
    return h + out, aux


def _ssm_block(layer: Block, h: torch.Tensor, cfg: ModelConfig, cache=None):
    """h + ssm(norm(h)) (Mamba-1 or Mamba-2); returns (h, new cache)."""
    apply = mamba1_apply if cfg.ssm_version == 1 else mamba2_apply
    out, new_cache = apply(layer.ssm, norm_apply(layer.norm_ssm, h, cfg),
                           cfg, cache=cache)
    return h + out, new_cache


def _shared_attn_block(sp: Block, h, cfg, *, positions, cache=None,
                       cache_pos=None):
    """zamba2's shared block: global attention at θ = ``cfg.rope_theta``
    on a linear cache, then the MLP, each with its residual."""
    x = norm_apply(sp.norm_attn, h, cfg)
    out, new_cache = attn_apply(sp.attn, x, cfg, positions=positions,
                                cache=cache, cache_pos=cache_pos,
                                window=BIG_WINDOW, theta=cfg.rope_theta)
    h = h + out
    x = norm_apply(sp.norm_mlp, h, cfg)
    return h + mlp_apply(sp.mlp, x, cfg), new_cache


def _dense_block(layer: Block, h, cfg, positions, window, theta):
    """One attention layer without a cache (training): (h, aux or
    None)."""
    h, _ = _attn_block(layer, h, cfg, positions=positions, window=window,
                       theta=theta)
    return _mlp_block(layer, h, cfg)


def _ssm_layer(layer: Block, shared, h, cfg, positions):
    """One ssm or hybrid layer without a cache (training): the Mamba
    block, then the shared block where ``shared`` is given (a site)."""
    h, _ = _ssm_block(layer, h, cfg)
    if shared is not None:
        h, _ = _shared_attn_block(shared, h, cfg, positions=positions)
    return h


def _positions(b: int, t: int, cache_pos, device) -> torch.Tensor:
    if cache_pos is None:
        return torch.arange(t, device=device).expand(b, t)
    cp = torch.as_tensor(cache_pos, device=device).long()
    return cp.reshape(-1, 1).expand(b, t) if cp.dim() == 1 \
        else cp.expand(b, t)


def forward_hidden(params: LM, cfg: ModelConfig, tokens, *, patches=None,
                   cache=None, cache_pos=None, ring: bool = False):
    """Run the stack.  Returns (hidden (B, T, d), new_cache, aux_loss).

    ``patches`` (vlm): (B, Np, d) placed before the text, T = Np + the
    tokens.  ``cache_pos`` (a scalar or a per-row (B,) tensor) is the
    position of the first token; without it positions start at 0.
    ``ring``: the KV cache is a ring buffer shorter than the context (pure
    sliding-window models).  Without a cache, under grad and with
    ``cfg.remat``, each layer is checkpointed: only its input is kept, and
    the backward recomputes it."""
    h = shardings.constrain_batch(embed_tokens(params, cfg, tokens, patches))
    remat = cache is None and cfg.remat and torch.is_grad_enabled()
    if cfg.family == "ssm":     # no attention: positions unread
        return _forward_ssm(params, cfg, h, None, cache, None, remat)
    b, t, _ = h.shape
    if cache_pos is not None:   # on the device once, not once a layer
        cache_pos = torch.as_tensor(cache_pos, device=h.device).long()
    positions = _positions(b, t, cache_pos, h.device)
    if cfg.family == "hybrid":
        return _forward_ssm(params, cfg, h, positions, cache, cache_pos,
                            remat)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, (layer, (window, theta)) in enumerate(
            zip(params.layers, layer_schedule(cfg))):
        if cfg.seq_shard_residual and t > 1:
            # sequence-parallel residual stream on a mesh
            h = shardings.constrain(h, (("pod", "data"), "model", None))
        if remat:
            h, aux_l = checkpoint(_dense_block, layer, h, cfg, positions,
                                  window, theta, use_reentrant=False)
        else:
            lcache = None if cache is None else {"k": cache["k"][i],
                                                 "v": cache["v"][i]}
            h, _ = _attn_block(layer, h, cfg, positions=positions,
                               window=window, theta=theta, cache=lcache,
                               cache_pos=cache_pos, ring=ring)
            h, aux_l = _mlp_block(layer, h, cfg)
        if aux_l is not None:
            aux = aux + aux_l
    h = norm_apply(params.final_norm, h, cfg)
    return h, cache, aux


def _forward_ssm(params: LM, cfg: ModelConfig, h, positions, cache,
                 cache_pos, remat: bool):
    """The ssm and hybrid stacks: each layer's Mamba block, and at the
    hybrid's sites the shared block on that layer's KV cache."""
    conv, ssm = [], []
    sites = cfg.shared_attn_sites()
    for i, layer in enumerate(params.layers):
        shared = params.shared if sites[i] else None
        if remat:
            h = checkpoint(_ssm_layer, layer, shared, h, cfg, positions,
                           use_reentrant=False)
            continue
        lcache = None if cache is None else {"conv": cache["conv"][i],
                                             "ssm": cache["ssm"][i]}
        h, c = _ssm_block(layer, h, cfg, cache=lcache)
        if c is not None:
            conv.append(c["conv"])
            ssm.append(c["ssm"])
        if shared is not None:
            ac = None if cache is None else {"k": cache["k"][i],
                                             "v": cache["v"][i]}
            h, _ = _shared_attn_block(shared, h, cfg, positions=positions,
                                      cache=ac, cache_pos=cache_pos)
    h = norm_apply(params.final_norm, h, cfg)
    new_cache = (dict(cache, conv=torch.stack(conv), ssm=torch.stack(ssm))
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
    """batch: {tokens (B, T+1), [patches (B, Np, d)]} → (loss, {"nll",
    "aux"}): the mean next-token negative log-likelihood of ``tokens[:,
    1:]`` given ``tokens[:, :-1]`` (and the patches before them, vlm; the
    loss on text positions only), over the padded vocab (its tail masked
    to -1e30), plus the aux loss (the moe family's, summed over layers; 0
    elsewhere), as ``repro.models.lm.lm_loss``.  The label's logit is
    gathered where the reference contracts a one-hot: the same value,
    without the (B, T, V) one-hot."""
    tokens = batch["tokens"]
    patches = batch.get("patches")
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    h, _, aux = forward_hidden(params, cfg, inputs, patches=patches)
    if cfg.family == "vlm" and patches is not None:
        h = h[:, patches.shape[1]:]
    logits = logits_from_hidden(params, cfg, h)
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = shardings.pick_last(logits, labels)
    nll = lse - label_logit
    loss = nll.mean() + aux
    return loss, {"nll": nll.mean(), "aux": aux}


def prefill(params: LM, cfg: ModelConfig, tokens, cache, *, patches=None,
            ring=False):
    """Full-sequence pass that returns last-position logits + the populated
    decode cache.  ``cache`` supplies the state to start from (``conv``,
    ``ssm``) and the KV layout to fill in place (``k``, ``v``);
    ``patches`` (vlm) go before the tokens."""
    h, new_cache, _ = forward_hidden(params, cfg, tokens, patches=patches,
                                     cache=cache, ring=ring)
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
    (:func:`cache_len` of it); a state-space layer's state does not depend
    on it.  The hybrid family keeps a KV cache for every layer, as the
    reference does, though only the shared block's sites write theirs."""
    device = resolve_device(device, allow_meta=True)
    l, dtype = cfg.n_layers, _dt(cfg)
    c = {}
    if cfg.family in ("ssm", "hybrid"):
        di, n = cfg.d_inner, cfg.ssm_state
        c["conv"] = torch.zeros((l, batch, cfg.ssm_conv - 1, di),
                                dtype=dtype, device=device)
        state = ((di, n) if cfg.ssm_version == 1 else
                 (cfg.ssm_heads, cfg.ssm_head_dim, n))
        c["ssm"] = torch.zeros((l, batch) + state, dtype=torch.float32,
                               device=device)
        if not (cfg.family == "hybrid" and cfg.shared_attn_every):
            return c
    shape = (l, batch, cache_len(cfg, seq_len), cfg.n_kv_heads, cfg.hd)
    c["k"] = torch.zeros(shape, dtype=dtype, device=device)
    c["v"] = torch.zeros(shape, dtype=dtype, device=device)
    return c
