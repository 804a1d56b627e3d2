"""Top-k routed Mixture-of-Experts with sort-based capacity dispatch.

The port of ``repro/models/moe.py``.  Dispatch is computed per group, one
group a batch row, as the reference vmaps it: every row sorts its own
(token, expert) entries and fills its own (E, C, d) buffer, so in a
decode step each slot is a group of one token at capacity ``max(4,
⌈k/E·cf⌉)`` and an inactive slot's dummy token can never take a live
slot's capacity.  The rows are batched tensor operations here, not a loop.

The dispatch keeps to device operations with no host sync (a stable
``argsort`` of the integer expert ids, counts by ``scatter_add_``, starts
by ``cumsum``; no ``bincount``, ``unique``, ``nonzero`` or mask
indexing), so a decode step captures into a CUDA graph.  A dropped entry
goes to the dummy row ``E·C`` of an ``(E·C + 1, d)`` buffer, which is
cut off, as in the reference.

The expert SwiGLU is three batched products over the expert axis in the
model's dtype (``torch.einsum``: plain products, outside any Pallas kernel
in the reference too).  The combine gathers each token's k expert outputs
and sums them in ascending expert id, the order in which the reference's
sorted scatter-add meets them, with dropped entries as zero: no atomic
``index_add_``, so a captured step is bitwise the eager one.

The reference's ``moe_capacity_sharding`` and ``moe_combine_shardmap``
branches are mesh layouts of the same values; on one card the port takes
the plain branch for every config.

Aux (load-balance) loss is the Switch formulation: coef · E · Σ_e f_e · p̄_e.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from . import shardings
from .config import ModelConfig
from .layers import dense_init, param

#: when a list, every :func:`moe_apply` appends its number of dropped
#: (token, expert) entries to it, a device scalar (see :func:`count_drops`)
_DROPS: list | None = None


@contextlib.contextmanager
def count_drops():
    """Collect the entries each :func:`moe_apply` drops by capacity while
    the context is open: yields a list that receives one int64 device
    scalar a call (summed over the batch's groups).  Reading them syncs
    the host, so keep it off a captured step."""
    global _DROPS
    prev, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = prev


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype
             ) -> nn.ParameterDict:
    """One layer's experts in the reference's names and layouts: the
    router (d, E) in fp32 at scale 1/sqrt(d), ``w_gate``/``w_up`` (E, d,
    ff) and ``w_down`` (E, ff, d) in ``dtype``."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return nn.ParameterDict({k: param(v) for k, v in {
        "router": dense_init(gen, (d, e), scale=1.0 / math.sqrt(d),
                             dtype=torch.float32),
        "w_gate": dense_init(gen, (e, d, ff), dtype=dtype),
        "w_up": dense_init(gen, (e, d, ff), dtype=dtype),
        "w_down": dense_init(gen, (e, ff, d), dtype=dtype),
    }.items()})


def capacity(t: int, cfg: ModelConfig) -> int:
    """Slots an expert has in a group of ``t`` tokens."""
    return max(4, int(math.ceil(t * cfg.top_k / cfg.n_experts
                                * cfg.capacity_factor)))


def _dispatch_group(x, router, e: int, k: int, cap: int):
    """Routing of every row of ``x`` (B, T, d) as its own group.

    Returns ``buf`` (B, E, C, d), the combine info ``(dest, stok, sp,
    keep)`` (each (B, T·k), in the row's sorted order) and ``(probs (B, T,
    E), top_e (B, T, k))``, the reference's outputs with a batch axis."""
    b, t, d = x.shape
    logits = x.float() @ router                               # (B, T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(b, t * k)
    flat_tok = torch.arange(t, device=x.device).repeat_interleave(k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(1, order)
    stok = flat_tok[order]                                    # (B, T·k)
    sp = top_p.reshape(b, t * k).gather(1, order)
    counts = torch.zeros((b, e), dtype=torch.long, device=x.device) \
        .scatter_add_(1, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 1) - counts
    slot = torch.arange(t * k, device=x.device) - starts.gather(1, se)
    keep = slot < cap
    dest = torch.where(keep, se * cap + slot, e * cap)

    rows = x.gather(1, stok[..., None].expand(b, t * k, d))
    buf = torch.zeros((b, e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.scatter(1, dest[..., None].expand(b, t * k, d), rows)
    buf = buf[:, :-1].reshape(b, e, cap, d)
    return buf, (dest, stok, sp, keep), (probs, top_e)


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, T, d) → (out (B, T, d), aux_loss scalar fp32)."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(t, cfg)
    buf, (dest, stok, sp, keep), (probs, top_e) = shardings.local_rows(
        lambda x_, r_: _dispatch_group(x_, r_, e, k, cap), (x,),
        (p["router"],))
    # re-pin the group dim on a mesh, so the expert GEMMs stay data-parallel
    buf = shardings.constrain_batch(buf)

    frac = shardings.value_counts(top_e, e) / (b * t * k)
    aux = cfg.router_aux_coef * e * torch.sum(frac * probs.mean((0, 1)))
    if _DROPS is not None:
        _DROPS.append((~keep).sum())
    if cfg.moe_capacity_sharding:
        # capacity-sharded TP on a mesh: slots split over 'model'
        buf = shardings.constrain(buf, (("pod", "data"), None, "model", None))
    y = _ffn_combine(p, buf, dest, stok, sp, keep, t, k)
    return shardings.constrain_batch(y), aux


def _ffn_combine(p, buf, dest, stok, sp, keep, t: int, k: int):
    """The expert SwiGLU on ``buf`` (B, E, C, d) and the combine: each
    token's k outputs, weighted by ``keep · sp`` in the model's dtype and
    summed one by one in ascending expert id from zero, as the
    reference's sorted scatter-add meets them."""
    b, e, cap, d = buf.shape
    gate = torch.einsum("becd,edf->becf", buf, p["w_gate"])
    up = torch.einsum("becd,edf->becf", buf, p["w_up"])
    out = torch.einsum("becf,efd->becd", F.silu(gate) * up, p["w_down"])
    out = out.reshape(b, e * cap, d)
    # a stable sort of the token ids puts each token's k entries together,
    # still in ascending expert id (the order of the expert sort)
    by_tok = torch.argsort(stok, dim=-1, stable=True).reshape(b, t, k)
    dst = dest.gather(1, by_tok.reshape(b, t * k))
    wgt = (keep * sp).gather(1, by_tok.reshape(b, t * k)).to(out.dtype)
    contrib = out.gather(1, torch.clamp(dst, max=e * cap - 1)[..., None]
                         .expand(b, t * k, d)) * wgt[..., None]
    contrib = contrib.reshape(b, t, k, d)
    y = torch.zeros((b, t, d), dtype=out.dtype, device=out.device)
    for j in range(k):
        y = y + contrib[:, :, j]
    return y
