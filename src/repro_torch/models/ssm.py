"""State-space layers: Mamba-1 (S6 selective scan).

The port of ``repro/models/ssm.py``'s Mamba-1 half.  Both branches of
:func:`mamba1_apply` run the hand-written selective-scan kernel
(:func:`repro_torch.kernels.s6_scan`): a prefill scans the prompt from the
cached state, and a decode step is the same scan at T = 1 from the cached
state, which is the reference's single-token recurrence.  The scan is the
step recurrence, not the reference's chunked ``_s6_scan``: that one
computes ``exp(-Σ dt·a)`` over a whole chunk, which overflows fp32 at
falcon-mamba's ``ssm_chunk = 256`` once a channel's mean dt exceeds about
0.022 (``ROADMAP.md`` Queue 3).  ``cfg.ssm_chunk`` is therefore unused here.

Decode carries (conv_state, ssm_state) per layer, O(1) in sequence length.
Mamba-2 (SSD) comes with zamba2 (``ROADMAP.md`` Queue 1 item 11).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import kernels
from .config import ModelConfig
from .layers import dense_init, param


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv.  x: (B, T, C), w: (K, C).  Returns (y, new_state)
    where state carries the last K-1 inputs for decode."""
    k = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    # a copy: a view would keep all of xp (B, T + K - 1, C) alive in the cache
    new_state = xp[:, -(k - 1):, :].clone() if k > 1 else None
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k)) + b
    return y, new_state


def mamba1_init(gen: torch.Generator, cfg: ModelConfig, dtype
                ) -> nn.ParameterDict:
    """One layer's Mamba-1 parameters, in the reference's names and
    layouts (projections as (in, out), so ``h @ p["in_proj"]``)."""
    d, di, n, ck = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    dt_rank = max(1, math.ceil(d / 16))
    dev = gen.device
    a = torch.arange(1, n + 1, dtype=torch.float32, device=dev).repeat(di, 1)
    return nn.ParameterDict({k: param(v) for k, v in {
        "in_proj": dense_init(gen, (d, 2 * di), dtype=dtype),
        "conv_w": dense_init(gen, (ck, di), scale=1.0 / math.sqrt(ck),
                             dtype=dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": dense_init(gen, (di, dt_rank + 2 * n), dtype=dtype),
        "dt_proj": dense_init(gen, (dt_rank, di), dtype=dtype),
        "dt_bias": torch.full((di,), -4.0, dtype=torch.float32, device=dev),
        "a_log": torch.log(a),
        "d_skip": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, (di, d), dtype=dtype),
    }.items()})


def mamba1_apply(p, h: torch.Tensor, cfg: ModelConfig, *, cache=None):
    """h: (B, T, d).  cache: {conv, ssm} decode state or None.  Returns
    (out (B, T, d), new cache or None)."""
    n = cfg.ssm_state
    dt_rank = p["dt_proj"].shape[0]
    xz = h @ p["in_proj"]
    x, z = xz.chunk(2, dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    x, new_conv = _causal_conv(x, p["conv_w"], p["conv_b"], conv_state)
    x = F.silu(x)

    proj = x @ p["x_proj"]
    # bmat and cmat stay column views of proj: the kernel takes their strides
    dt_in, bmat, cmat = proj.split([dt_rank, n, n], dim=-1)
    dt = F.softplus(dt_in @ p["dt_proj"] + p["dt_bias"])     # fp32
    a = -torch.exp(p["a_log"])

    y, h_fin = kernels.s6_scan(x, dt, bmat, cmat, a,
                               cache["ssm"] if cache is not None else None)
    new_cache = {"conv": new_conv, "ssm": h_fin} if cache is not None else None

    y = y.to(h.dtype) + x * p["d_skip"].to(h.dtype)
    y = y * F.silu(z)
    return y @ p["out_proj"], new_cache
