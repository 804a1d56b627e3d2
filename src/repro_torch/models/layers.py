"""Layer substrate: initialisers, norms, RoPE, GQA attention, MLPs.

The port of ``repro/models/layers.py``.  Attention is blockwise (the
streaming softmax over KV blocks of ``block_kv`` keys, carrying the running
max, sum and accumulator, so a long prefill never holds a (T, S) score
matrix); decode takes the single-token path against a (possibly
ring-buffered) KV cache.  Sliding window, logit softcap (gemma2), qk-norm
(gemma3) and local:global layer kinds are mask- and transform-level options
on one implementation, as in the reference.  It computes in fp32 with plain
PyTorch operations, as the reference computes in jnp: no hand kernel and no
``scaled_dot_product_attention`` (which has no softcap before the mask).

A KV cache is written in place: prefill and decode store the new keys and
values into the cache tensors they are given (views of the serve engine's
cache) and return those same tensors, where the reference returns updated
copies.  The decode mask is built from device tensors, so a decode step
captures into a CUDA graph with no host sync.

Parameters live in ``nn.ParameterDict``s keyed by the reference's names, so
``p["scale"]`` reads as it does there; they are made without
``requires_grad`` (serving), and training turns it on
(``repro_torch.train.train_step.init_state``).  Random draws come from an
explicit ``torch.Generator`` and land on its device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
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


def rms_head_norm(x: torch.Tensor, scale) -> torch.Tensor:
    """Per-head RMSNorm (gemma3 qk-norm).  x: (..., D)."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

_FREQS: dict = {}


def rope_freqs(theta: float, half: int, device) -> torch.Tensor:
    """``exp(-i · log θ / half)`` for i < half in fp32, the reference's
    formula (not ``θ^(-i/half)``): the argument in fp32 as the reference
    forms it, its exponential taken in float64 and rounded once, so the
    frequencies do not depend on a library's fp32 ``exp`` (two such differ
    by an ulp, which shows at position 8191 as 5e-4 of |x|).  Computed once
    on the host per (θ, half) and kept on ``device``: a captured decode
    step then reads it."""
    key = (float(theta), half, str(device))
    f = _FREQS.get(key)
    if f is None:
        lt = torch.tensor(theta, dtype=torch.float32).log() / half
        arg = -torch.arange(half, dtype=torch.float32) * lt
        f = _FREQS[key] = torch.exp(arg.double()).float().to(device)
    return f


def rope(x: torch.Tensor, positions: torch.Tensor, theta) -> torch.Tensor:
    """x: (B, T, H, D); positions: (B, T).  Rotates the two halves of the
    head dim (not interleaved pairs), as the reference does."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(theta, half, x.device)
    ang = positions.float()[..., None] * freqs                 # (B, T, half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype
              ) -> nn.ParameterDict:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": dense_init(gen, (d, hq * hd), dtype=dtype),
         "wk": dense_init(gen, (d, hkv * hd), dtype=dtype),
         "wv": dense_init(gen, (d, hkv * hd), dtype=dtype),
         "wo": dense_init(gen, (hq * hd, d), dtype=dtype)}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=torch.float32, device=gen.device)
        p["k_norm"] = torch.ones((hd,), dtype=torch.float32, device=gen.device)
    return nn.ParameterDict({k: param(v) for k, v in p.items()})


def _softcap(x: torch.Tensor, cap) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap else x


#: the value masked scores take (the reference's)
MASKED = -1e30


def blockwise_attention(q, k, v, *, mask_fn, block_kv: int = 1024,
                        softcap: float | None = None) -> torch.Tensor:
    """Streaming softmax attention.  q: (B, T, Hq, D), k/v: (B, S, Hkv, D).

    ``mask_fn(t_idx, s_idx) -> bool (T, S_blk)`` gives position validity.
    The query heads of KV head j are j·g … j·g + g − 1 (q reshaped to (B,
    T, Hkv, g, D)).  Scores are softcapped, then masked to -1e30; the KV
    sweep carries the running (max, sum, acc) in fp32 and the output is
    ``acc / max(sum, 1e-30)``.  The last block is cut short instead of
    padded: a padded key's score is -1e30 and adds nothing.  Returns (B, T,
    Hq, D) fp32."""
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    # (B, Hkv, T·g, D): query rows of KV head j, t-major
    qg = (q.reshape(b, t, hkv, g, d).float() / math.sqrt(d)) \
        .permute(0, 2, 1, 3, 4).reshape(b, hkv, t * g, d)
    t_idx = torch.arange(t, device=q.device)
    in_place = not (torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v)))
    m = torch.full((b, hkv, t, g), float("-inf"), device=q.device)
    l = torch.zeros((b, hkv, t, g), device=q.device)
    acc = torch.zeros((b, hkv, t * g, d), device=q.device)
    for s0 in range(0, s, block_kv):
        s1 = min(s0 + block_kv, s)
        kb = _f32(k[:, s0:s1].permute(0, 2, 3, 1))             # (B, Hkv, D, n)
        vb = _f32(v[:, s0:s1].permute(0, 2, 1, 3))             # (B, Hkv, n, D)
        sc = torch.matmul(qg, kb).view(b, hkv, t, g, s1 - s0)
        valid = mask_fn(t_idx, torch.arange(s0, s1, device=q.device))
        if in_place:   # one block-sized buffer (a long prefill's scores)
            if softcap:
                sc = sc.div_(softcap).tanh_().mul_(softcap)
            sc.masked_fill_(~valid[None, None, :, None, :], MASKED)
            m_new = torch.maximum(m, sc.amax(-1))
            p = sc.sub_(m_new[..., None]).exp_()
        else:
            sc = _softcap(sc, softcap).masked_fill(
                ~valid[None, None, :, None, :], MASKED)
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr.view(b, hkv, t * g, 1) + torch.matmul(
            p.view(b, hkv, t * g, s1 - s0), vb)
        m = m_new
        del sc, p
    out = acc / torch.clamp(l.view(b, hkv, t * g, 1), min=1e-30)
    return out.view(b, hkv, t, g, d).permute(0, 2, 1, 3, 4).reshape(b, t, hq,
                                                                      d)


def _f32(x: torch.Tensor) -> torch.Tensor:
    """A bf16 ``x`` in fp32, laid out contiguously in its (permuted) order
    in one pass, where ``.float()`` keeps a permuted layout that the
    batched matmul would copy again (an fp32 ``x`` comes back as it is)."""
    return x.to(torch.float32, memory_format=torch.contiguous_format)


def _decode_attention(q, ck, cv, valid, softcap) -> torch.Tensor:
    """One token per row against the whole cache.  q: (B, 1, Hq, D); ck/cv:
    (B, S_c, Hkv, D); valid: (B, S_c) bool.  Returns (B, 1, Hq·D) fp32."""
    b, _, hq, d = q.shape
    hkv = ck.shape[2]
    g = hq // hkv
    qg = (q.reshape(b, hkv, g, d).float() / math.sqrt(d))
    sc = torch.matmul(qg, _f32(ck.permute(0, 2, 3, 1)))        # (B, Hkv, g, S)
    sc = _softcap(sc, softcap)
    sc = sc.masked_fill(~valid[:, None, None, :], MASKED)
    w = torch.softmax(sc, dim=-1)
    out = torch.matmul(w, _f32(cv.permute(0, 2, 1, 3)))        # (B, Hkv, g, D)
    return out.reshape(b, 1, hq * d)


def attn_apply(p, h: torch.Tensor, cfg: ModelConfig, *, positions,
               theta=None, window=None, cache=None, cache_pos=None,
               ring: bool = False, dtype=None, block_kv: int = 1024):
    """One causal attention block (no residual or norm: the caller owns
    those).

    ``window`` bounds the lookback (``lm.BIG_WINDOW`` for a global layer,
    None for none); ``theta`` is the layer's RoPE base.  ``cache``: {k, v}
    (B, S_c, Hkv, D).  T == 1 with ``cache_pos`` (a scalar or a per-row (B,)
    tensor) → decode: the token's k/v are written at its slot (``pos %
    S_c`` when ``ring``, else ``min(pos, S_c - 1)``) and the token attends
    over the cache.  T > 1 with a cache → prefill: the sequence's k/v fill
    slots 0 … T − 1 (a shorter ring keeps the last S_c tokens at their ring
    slots).  Returns (out (B, T, d), the cache or None)."""
    dtype = dtype or h.dtype
    b, t, _ = h.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if theta is None:
        theta = cfg.rope_theta
    q = (h @ p["wq"]).reshape(b, t, hq, hd)
    k = (h @ p["wk"]).reshape(b, t, hkv, hd)
    v = (h @ p["wv"]).reshape(b, t, hkv, hd)
    if cfg.qk_norm:
        q = rms_head_norm(q, p["q_norm"])
        k = rms_head_norm(k, p["k_norm"])
    q = rope(q, positions, theta)
    k = rope(k, positions, theta)

    if cache is not None and t == 1 and cache_pos is not None:
        ck, cv = cache["k"], cache["v"]
        s_c = ck.shape[1]
        cp = torch.as_tensor(cache_pos, device=h.device).long()
        cp = cp.expand(b) if cp.dim() == 0 else cp
        slot = cp % s_c if ring else torch.clamp(cp, max=s_c - 1)
        rows = torch.arange(b, device=h.device)
        ck.index_put_((rows, slot), k[:, 0].to(ck.dtype))
        cv.index_put_((rows, slot), v[:, 0].to(cv.dtype))
        idx = torch.arange(s_c, device=h.device)
        valid = idx[None, :] < torch.clamp(cp + 1, max=s_c)[:, None]
        if ring:
            valid = valid | (cp >= s_c)[:, None]
        elif window is not None:
            # a linear cache: the slot index is the absolute position
            valid = valid & ((cp[:, None] - idx[None, :]) < window)
        out = _decode_attention(q, ck, cv, valid, cfg.attn_softcap)
        return out.to(dtype) @ p["wo"], cache

    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        s_c = ck.shape[1]
        if s_c >= t:
            ck[:, :t] = k.to(ck.dtype)
            cv[:, :t] = v.to(cv.dtype)
        else:   # ring: the last s_c tokens at their ring slots
            slots = torch.arange(t - s_c, t, device=h.device) % s_c
            ck[:, slots] = k[:, t - s_c:].to(ck.dtype)
            cv[:, slots] = v[:, t - s_c:].to(cv.dtype)

    if window is not None:
        mask_fn = lambda ti, si: (si[None, :] <= ti[:, None]) & \
            ((ti[:, None] - si[None, :]) < window)
    else:
        mask_fn = lambda ti, si: si[None, :] <= ti[:, None]
    # (the reference's gqa_expand_kv and seq_shard_attn are sharding
    # layouts of the same values: nothing to do on one device)
    out = blockwise_attention(q, k, v, mask_fn=mask_fn, block_kv=block_kv,
                              softcap=cfg.attn_softcap)
    return out.reshape(b, t, hq * hd).to(dtype) @ p["wo"], cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, cfg: ModelConfig, dtype
             ) -> nn.ParameterDict:
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.act == "relu2":
        p = {"wi": dense_init(gen, (d, ff), dtype=dtype),
             "wo": dense_init(gen, (ff, d), dtype=dtype)}
    else:
        p = {"wi_gate": dense_init(gen, (d, ff), dtype=dtype),
             "wi_up": dense_init(gen, (d, ff), dtype=dtype),
             "wo": dense_init(gen, (ff, d), dtype=dtype)}
    return nn.ParameterDict({k: param(v) for k, v in p.items()})


def mlp_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """relu2: relu(x Wi)² Wo; gated: act(x Wg) · (x Wu) Wo, with gelu the
    tanh approximation (``jax.nn.gelu``'s default) or silu."""
    if cfg.act == "relu2":
        return torch.square(torch.relu(x @ p["wi"])) @ p["wo"]
    gate = x @ p["wi_gate"]
    act = F.gelu(gate, approximate="tanh") if cfg.act == "gelu" \
        else F.silu(gate)
    return (act * (x @ p["wi_up"])) @ p["wo"]
