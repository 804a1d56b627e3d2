"""Tucker gradient compression for data parallelism: the port of
``repro/optim/grad_compress.py``.

PowerSGD-style generalization of a-Tucker: keep *shared* Tucker factors
``U^(n)`` per eligible gradient tensor and exchange only the small core

    core_i = g_i ×_1 U^(1)ᵀ ··· ×_N U^(N)ᵀ        (linear in g_i)

so the all-reduce of the cores equals the core of the all-reduced
gradients, and moves ``∏R_n / ∏I_n`` of the dense bytes.  Error feedback
(per process) keeps the update unbiased over time; every
``refresh_every`` steps the factors are recomputed by a distributed
st-HOSVD: per-mode Grams, all-reduced, then ``eigh`` (the paper's EIG
solver, mode by mode with sequential shrinking).  Every process gets the
same summed Gram and ``eigh`` is deterministic, so all hold the same
factors without sending them.  Unlike the reference, ``eigh`` runs in
float64 on the fp32 Gram: in fp32 the eigenvectors of a Gram of side 8192
(falcon-mamba's d_inner) came out orthonormal only to about 1e-4 on an
H100.

Eligibility and ranks are reckoned on the reference's stacked tree
(:func:`repro_torch.models.convert.param_tree`): a per-layer gradient
counts as its stack over the layers, (L, d, f), whose first mode (the
layers) stays at full rank.  ``g_fb``, the stacked fp32 gradient plus the
error, is formed in the error buffer itself (its old value is not needed
again), and the reduced gradient comes back with the input's layout: a
layered leaf as one view per layer of the stacked result.

With a ``torch.distributed`` process group (one process per pod) the Grams
and the cores are all-reduced as the reference's ``psum`` does (the Grams
summed, the cores summed and divided by the world size); with ``group=None``
it is the reference's ``axis_name=None``, a single-process compressor.  The
reference's ``shard_map`` plumbing (``stack_for_pods``, ``localize``,
``delocalize``, ``state_specs``) has no counterpart: each pod is its own
process, so its error buffer is simply its own.  The contractions run on
:mod:`repro_torch.core.tensor_ops` (``matfree``), which plays the role of
the jnp ``tensor_ops`` the reference calls.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from ..core import tensor_ops as T
from ..models.convert import map_leaves, stacked_shape


@dataclass(frozen=True)
class CompressionConfig:
    rank_fraction: float = 0.25    # R_n = ceil(rank_fraction * I_n) on compressed modes
    max_rank: int = 64
    min_size: int = 65536          # below this, grads go dense
    min_ndim: int = 3
    refresh_every: int = 20        # factor refresh cadence (steps)
    skip_first_mode: bool = True   # (L, d, f): layer/scan mode stays full rank
    enabled: bool = True

    def ranks_for(self, shape: tuple[int, ...]) -> tuple[int, ...] | None:
        if not self.enabled or len(shape) < self.min_ndim:
            return None
        if math.prod(shape) < self.min_size:
            return None
        ranks = []
        for m, d in enumerate(shape):
            if self.skip_first_mode and m == 0:
                ranks.append(d)   # identity mode (scan/layer axis)
            else:
                ranks.append(max(1, min(self.max_rank,
                                        int(math.ceil(self.rank_fraction * d)))))
        if math.prod(ranks) >= math.prod(shape):
            return None           # no win — stay dense
        return tuple(ranks)


def _device(leaf) -> torch.device:
    return (leaf[0] if isinstance(leaf, list) else leaf).device


def init_state(cfg: CompressionConfig, grads_like: Any) -> Any:
    """Per-leaf state of the tree ``grads_like`` (the parameter tree):
    ``{"factors": [U^(n) | None per mode], "error": 0s}`` on an eligible
    leaf's stacked shape, None (the reference's ``EMPTY``) elsewhere.

    The factors start as zeros: the first step must run with
    ``refresh=True``."""
    def leaf_state(g):
        shape = stacked_shape(g)
        ranks = cfg.ranks_for(shape)
        if ranks is None:
            return None
        dev = _device(g)
        factors = [None if r == d else
                   torch.zeros((d, r), dtype=torch.float32, device=dev)
                   for d, r in zip(shape, ranks)]
        return {"factors": factors,
                "error": torch.zeros(shape, dtype=torch.float32, device=dev)}

    return map_leaves(leaf_state, grads_like)


def _project(g, factors):
    """core = g ×_n U^(n)ᵀ over compressed modes."""
    y = g
    for mode, u in enumerate(factors):
        if u is not None:
            y = T.ttm(y, u.T.to(y.dtype), mode)
    return y


def _expand(core, factors):
    y = core
    for mode, u in enumerate(factors):
        if u is not None:
            y = T.ttm(y, u.to(y.dtype), mode)
    return y


def _refresh_factors(g_fb, factors, group=None):
    """Distributed st-HOSVD-EIG refresh with sequential shrinking."""
    y = g_fb
    new_factors = []
    for mode, u in enumerate(factors):
        if u is None:
            new_factors.append(None)
            continue
        r = u.shape[1]
        s = T.gram(y, mode)
        if group is not None:
            torch.distributed.all_reduce(s, group=group)
        # eigh in float64: fp32's eigenvectors of a Gram of side 8192 came
        # out orthonormal only to 1.3e-4 (cuSOLVER on an H100); these to
        # fp32's own rounding
        _, vecs = torch.linalg.eigh(s.double())
        un = vecs[:, -r:].flip(-1).to(s.dtype).contiguous()
        new_factors.append(un)
        y = T.ttm(y, un.T, mode)     # sequential shrink (st-HOSVD semantics)
    return new_factors


def compressed_bytes(cfg: CompressionConfig,
                     shape: tuple[int, ...]) -> tuple[int, int]:
    """(dense, compressed) all-reduce bytes per step for a grad of ``shape``
    (fp32 wire format; Gram all-reduces amortized over the refresh
    interval)."""
    dense = 4 * math.prod(shape)
    ranks = cfg.ranks_for(shape)
    if ranks is None:
        return dense, dense
    core = 4 * math.prod(ranks)
    gram_amort = sum(4 * d * d for d, r in zip(shape, ranks) if r != d)
    return dense, core + gram_amort // max(1, cfg.refresh_every)


def _mean(t: torch.Tensor, group, n_peers: int) -> torch.Tensor:
    torch.distributed.all_reduce(t, group=group)
    return t.div_(n_peers)


@torch.no_grad()
def compress_psum(cfg: CompressionConfig, grads: Any, state: Any, *,
                  refresh: bool, group=None) -> tuple[Any, Any, dict]:
    """Compressed mean of ``grads`` over the processes of ``group`` (no
    reduction when None), with error feedback.

    ``grads`` has the parameter tree's layout (a layered leaf's gradients
    as a list).  Returns ``(reduced_grads, new_state, stats)``;
    ``reduced_grads`` has the same layout and each leaf's dtype.  ``refresh``
    recomputes the shared factors from this step's feedback-corrected
    gradients before projecting.  The error buffers of ``state`` are
    reused in place."""
    n_peers = torch.distributed.get_world_size(group) if group is not None else 1
    acc = {"dense": 0, "compressed": 0}

    def one(g, st):
        parts = g if isinstance(g, list) else [g]
        if st is None:
            b = sum(p.numel() * p.element_size() for p in parts)
            acc["dense"] += b
            acc["compressed"] += b
            if group is None:
                return g, None
            out = [_mean(p.clone(), group, n_peers) for p in parts]
            return out if isinstance(g, list) else out[0], None

        g_fb = st["error"]                      # becomes g + error in place
        if isinstance(g, list):
            for i, p in enumerate(parts):
                g_fb[i].add_(p)
        else:
            g_fb.add_(g)
        factors = (_refresh_factors(g_fb, st["factors"], group)
                   if refresh else st["factors"])
        core = _project(g_fb, factors)
        if group is None:
            g_hat = _expand(core, factors)
            err = g_fb.sub_(g_hat)
        else:
            err = g_fb.sub_(_expand(core, factors))
            g_hat = _expand(_mean(core, group, n_peers), factors)

        d, c = compressed_bytes(cfg, tuple(g_fb.shape))
        acc["dense"] += d
        acc["compressed"] += c
        out = g_hat.to(parts[0].dtype)
        del g_hat
        red = list(out.unbind(0)) if isinstance(g, list) else out
        return red, {"factors": factors, "error": err}

    outs = map_leaves(one, grads, state)
    new_grads = map_leaves(lambda o: o[0], outs)
    new_state = map_leaves(lambda o: o[1], outs)
    stats = {"bytes_dense": acc["dense"], "bytes_compressed": acc["compressed"],
             "ratio": acc["dense"] / max(1, acc["compressed"])}
    return new_grads, new_state, stats

