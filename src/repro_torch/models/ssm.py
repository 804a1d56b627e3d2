"""State-space layers: Mamba-1 (S6 selective scan) and Mamba-2 (SSD).

The port of ``repro/models/ssm.py``.  Both branches of
:func:`mamba1_apply` run the hand-written selective-scan kernel
(:func:`repro_torch.kernels.s6_scan`): a prefill scans the prompt from the
cached state, and a decode step is the same scan at T = 1 from the cached
state, which is the reference's single-token recurrence.  The scan is the
step recurrence, not the reference's chunked ``_s6_scan``: that one
computes ``exp(-Σ dt·a)`` over a whole chunk, which overflows fp32 at
falcon-mamba's ``ssm_chunk = 256`` once a channel's mean dt exceeds about
0.022 (``ROADMAP.md`` Queue 3).  Mamba-1 therefore leaves ``cfg.ssm_chunk``
unused.

In training the scan runs as the kernel's autograd Function
(``repro_torch.kernels.s6_scan.S6Scan``), whose backward is the
hand-written ``csrc/s6_scan_bwd.cu`` on the card.

Mamba-2 (:func:`mamba2_apply`, zamba2's backbone) computes in plain
PyTorch as the reference computes in jnp (no Pallas kernel there): a
prompt runs the chunked SSD scan (:func:`_ssd_scan`), a decode step the
one-token recurrence.  The scan differs from the reference's in one
deliberate point: it masks the intra-chunk decay's exponent (s > t to
-inf) before taking the exponential, where the reference takes
``exp(cum_t - cum_s)`` and then discards the upper triangle.  Every decay
is then exp(<= 0), so no intermediate overflows and no backward meets an
inf (``ROADMAP.md`` Queue 3).  The chunks' intra-chunk parts are computed
all at once; only the state carry runs chunk by chunk.

Decode carries (conv_state, ssm_state) per layer, O(1) in sequence length.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import kernels
from . import shardings
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
    x, z = shardings.chunk_last(xz, 2)
    conv_state = cache["conv"] if cache is not None else None
    x, new_conv = shardings.local_channels(
        _causal_conv, x, conv_state, p["conv_w"], p["conv_b"])
    x = F.silu(x)

    proj = shardings.whole(x @ p["x_proj"])
    # bmat and cmat stay column views of proj: the kernel takes their strides
    dt_in, bmat, cmat = proj.split([dt_rank, n, n], dim=-1)
    dt = F.softplus(dt_in @ p["dt_proj"] + p["dt_bias"])     # fp32
    a = -torch.exp(p["a_log"])

    y, h_fin = shardings.local_scan(
        kernels.s6_scan, x, dt, bmat, cmat, a,
        cache["ssm"] if cache is not None else None)
    new_cache = {"conv": new_conv, "ssm": h_fin} if cache is not None else None

    y = y.to(h.dtype) + x * p["d_skip"].to(h.dtype)
    y = y * F.silu(z)
    return y @ p["out_proj"], new_cache


# ---------------------------------------------------------------------------
# Mamba-2 (SSD)
# ---------------------------------------------------------------------------

def mamba2_init(gen: torch.Generator, cfg: ModelConfig, dtype
                ) -> nn.ParameterDict:
    """One layer's Mamba-2 parameters, in the reference's names and
    layouts: separate x/z, B/C and dt projections, the short conv on x
    only, one group; ``dt_bias`` -4, ``a_log`` 0 (A = -1) and ``d_skip`` 1
    per head."""
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh, ck = cfg.ssm_heads, cfg.ssm_conv
    dev = gen.device
    return nn.ParameterDict({k: param(v) for k, v in {
        "in_proj": dense_init(gen, (d, 2 * di), dtype=dtype),
        "conv_w": dense_init(gen, (ck, di), scale=1.0 / math.sqrt(ck),
                             dtype=dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "bc_proj": dense_init(gen, (d, 2 * n), dtype=dtype),
        "dt_proj": dense_init(gen, (d, nh), dtype=dtype),
        "dt_bias": torch.full((nh,), -4.0, dtype=torch.float32, device=dev),
        "a_log": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((nh,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, (di, d), dtype=dtype),
    }.items()})


def _ssd_scan(x, dt, bmat, cmat, a, chunk: int, h0=None):
    """Chunked SSD (Mamba-2).  x: (B, T, H, P); dt: (B, T, H); bmat/cmat:
    (B, T, N); a: (H,) negative.  Returns (y (B, T, H, P) fp32, the state
    after the last token (B, H, P, N) fp32).

    The sequence is padded to whole chunks (a zero dt decays nothing and a
    zero x adds nothing, so the padded tail leaves the state as it is).
    In chunk c, with cum the within-chunk cumulative sum of dt·a:
    ``y[t] = exp(cum_t) C_t·h_c + Σ_{s<=t} exp(cum_t - cum_s) (C_t·B_s)
    dt_s x_s``, and the state leaving it is ``exp(cum_L) h_c + Σ_s
    exp(cum_L - cum_s) dt_s x_s B_sᵀ``."""
    bsz, t, nh, pdim = x.shape
    n = bmat.shape[-1]
    nc = (t + chunk - 1) // chunk
    pad = nc * chunk - t
    f32 = lambda v: v.float()
    x, dt, bmat, cmat = f32(x), f32(dt), f32(bmat), f32(cmat)
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    xs = x.reshape(bsz, nc, chunk, nh, pdim)
    dts = dt.reshape(bsz, nc, chunk, nh)
    bs = bmat.reshape(bsz, nc, chunk, n)
    cs = cmat.reshape(bsz, nc, chunk, n)

    cum = torch.cumsum(dts * a, dim=2)                        # (B, C, L, H)
    # intra-chunk, all chunks at once, laid out (B, C, H, L, S): the
    # exponent masked to -inf above the diagonal before the exponential
    cum_h = cum.transpose(2, 3)                               # (B, C, H, L)
    expo = cum_h[..., :, None] - cum_h[..., None, :]
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    mdec = torch.exp(expo.masked_fill(~causal, float("-inf")))
    scores = torch.matmul(cs, bs.transpose(2, 3))             # (B, C, L, S)
    w = mdec * scores[:, :, None] * dts.transpose(2, 3)[:, :, :, None, :]
    y = torch.matmul(w, xs.permute(0, 1, 3, 2, 4))            # (B, C, H, L, P)
    y = y.permute(0, 1, 3, 2, 4)                              # (B, C, L, H, P)
    # each chunk's own contribution to the state leaving it
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)            # (B, C, L, H)
    s_own = torch.einsum("bclh,bclhp,bcln->bchpn", decay_out * dts, xs, bs)
    # the carry, chunk by chunk
    h = (torch.zeros((bsz, nh, pdim, n), dtype=torch.float32,
                     device=x.device) if h0 is None else h0.float())
    decay_in = torch.exp(cum)                                 # (B, C, L, H)
    y_h = []
    for c in range(nc):
        y_h.append(torch.einsum("bln,blh,bhpn->blhp", cs[:, c],
                                decay_in[:, c], h))
        h = decay_in[:, c, -1][:, :, None, None] * h + s_own[:, c]
    y = y + torch.stack(y_h, 1)
    return y.reshape(bsz, nc * chunk, nh, pdim)[:, :t], h


def mamba2_apply(p, h: torch.Tensor, cfg: ModelConfig, *, cache=None):
    """h: (B, T, d).  cache: {conv, ssm} decode state or None.  With a
    cache, T == 1 runs the one-token recurrence from the cached state and
    T > 1 the chunked scan from it.  Returns (out (B, T, d), new cache or
    None)."""
    bsz, t, _ = h.shape
    di, nh, pdim = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    xz = h @ p["in_proj"]
    x, z = shardings.chunk_last(xz, 2)
    conv_state = cache["conv"] if cache is not None else None
    x, new_conv = shardings.local_channels(
        _causal_conv, x, conv_state, p["conv_w"], p["conv_b"])
    x = F.silu(x)

    bmat, cmat = shardings.chunk_last(h @ p["bc_proj"], 2)
    dt = F.softplus(h @ p["dt_proj"] + p["dt_bias"])         # (B, T, H) fp32
    a = -torch.exp(p["a_log"])
    xh = x.reshape(bsz, t, nh, pdim)

    if cache is not None and t == 1:
        da = torch.exp(dt[:, 0] * a)                         # (B, H)
        upd = torch.einsum("bh,bhp,bn->bhpn", dt[:, 0].float(),
                           xh[:, 0].float(), bmat[:, 0].float())
        hnew = da[:, :, None, None] * cache["ssm"] + upd
        y = torch.einsum("bn,bhpn->bhp", cmat[:, 0].float(), hnew)[:, None]
        new_cache = {"conv": new_conv, "ssm": hnew}
    else:
        h0 = cache["ssm"] if cache is not None else None
        # (rows independent: on a mesh each device scans its own rows)
        y, h_fin = shardings.local_rows(
            lambda x_, d_, b_, c_, *h_: _ssd_scan(
                x_, d_, b_, c_, h_[-1], cfg.ssm_chunk,
                h0=h_[0] if len(h_) == 2 else None),
            (xh, dt, bmat, cmat) + (() if h0 is None else (h0,)), (a,))
        new_cache = ({"conv": new_conv, "ssm": h_fin} if cache is not None
                     else None)

    y = y + xh.float() * p["d_skip"][None, None, :, None]
    y = y.reshape(bsz, t, di).to(h.dtype)
    y = y * F.silu(z)
    return y @ p["out_proj"], new_cache
