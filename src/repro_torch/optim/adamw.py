"""AdamW with global-norm clipping and schedules: the port of
``repro/optim/adamw.py``, with the reference's arithmetic.

It works on the reference's parameter tree
(:func:`repro_torch.models.convert.param_tree`): nested dicts whose
per-layer leaves are lists of the layers' tensors, standing for their
stack.  The moments ``m`` and ``v`` are that tree in fp32 with the
per-layer leaves stacked, as the reference keeps them.  The update clips by
the global norm, keeps bias-corrected moments in fp32, forms the step in
fp32 and casts the new parameter back to its dtype: there is no fp32 master
copy.  Unlike the reference it updates the parameters and the moments in
place (no second copy of a 7B model's state).

Weight decay follows the reference's rule, ``p.ndim >= 2`` on the STACKED
layout: every per-layer leaf decays (norm scales and ``dt_bias``
included, since stacking makes them 2-D); of the top-level leaves only the
matrices (``embed``, ``lm_head``) decay and ``final_norm`` does not.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from ..models.convert import leaves, map_leaves, stacked_shape


class AdamWState(NamedTuple):
    count: torch.Tensor      # int32, 0-d
    m: Any                   # the reference's tree, fp32, layers stacked
    v: Any


def _parts(leaf) -> list:
    return leaf if isinstance(leaf, list) else [leaf]


def decays(leaf) -> bool:
    """The reference's decay rule on the stacked layout."""
    return len(stacked_shape(leaf)) >= 2


@dataclass(frozen=True)
class AdamW:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float | None = 1.0

    def init(self, params: Any) -> AdamWState:
        """Zero moments for the parameter tree ``params``, on its devices
        (the count on the first leaf's)."""
        def zeros(leaf):
            return torch.zeros(stacked_shape(leaf), dtype=torch.float32,
                               device=_parts(leaf)[0].device)
        first = _parts(leaves(params)[0][1])[0]
        return AdamWState(count=torch.zeros((), dtype=torch.int32,
                                            device=first.device),
                          m=map_leaves(zeros, params),
                          v=map_leaves(zeros, params))

    def _lr(self, count: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(count)
        return torch.tensor(self.lr, dtype=torch.float32, device=count.device)

    @torch.no_grad()
    def update(self, grads: Any, state: AdamWState, params: Any):
        """One step: ``params`` (the parameter tree) and ``state``'s moments
        are updated in place; ``grads`` has the parameters' layout (a
        layered leaf's gradients as a list).  Returns (params, new_state,
        metrics)."""
        gnorm = global_norm(grads)
        scale = None
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
        count = state.count + 1
        cf = count.float()
        b1, b2 = self.b1, self.b2
        bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=cf.device) ** cf
        bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=cf.device) ** cf
        lr = self._lr(count)
        for (_, p), (_, g), (_, m), (_, v) in zip(
                leaves(params), leaves(grads), leaves(state.m),
                leaves(state.v)):
            decay = bool(self.weight_decay) and decays(p)
            layered = isinstance(p, list)
            for i, (pi, gi) in enumerate(zip(_parts(p), _parts(g))):
                self._one(pi, gi, m[i] if layered else m,
                          v[i] if layered else v, scale, bc1, bc2, lr, decay)
        return params, AdamWState(count, state.m, state.v), \
            {"grad_norm": gnorm, "lr": lr}

    def _one(self, p, g, m, v, scale, bc1, bc2, lr, decay: bool) -> None:
        gf = g.float() if scale is None else g.float() * scale
        m.mul_(self.b1).add_((1 - self.b1) * gf)
        v.mul_(self.b2).add_((1 - self.b2) * gf * gf)
        step = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
        if decay:
            step += self.weight_decay * p.float()
        p.copy_(p.float() - lr * step)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt(Σ g²) over every leaf (layered leaves' layers included), fp32."""
    total = None
    for _, leaf in leaves(tree):
        for g in _parts(leaf):
            sq = torch.sum(torch.square(g.float()))
            total = sq if total is None else total + sq
    return torch.sqrt(total)


def cosine_schedule(peak: float, warmup: int, total: int, floor: float = 0.1):
    """lr(count): linear warm-up to ``peak`` over ``warmup`` steps, then a
    cosine down to ``floor`` · peak at ``total``."""
    def lr(count):
        c = torch.as_tensor(count).float()
        warm = peak * c / max(1, warmup)
        frac = torch.clamp((c - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(c < warmup, warm, cos)
    return lr
