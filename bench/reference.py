"""The plain reference: st-HOSVD in plain PyTorch, and the numbers that
judge a decomposition against it.

Imports nothing of the program.  The reference takes the input the
benchmark made and works out the decomposition again, in the mode order
the cell's configuration states, in float64 for the truth (or, for the
control, in a lower precision).  Each mode's factor spans the leading
eigenvectors of the mode's Gram: ``eigh`` of the explicit Gram where the
mode is short, else subspace iteration on the Gram applied implicitly,
run until the leading subspace stops moving.

The judgement (:func:`gaps`) is invariant to the basis inside each factor's
span and to the solver that found it:

* ``subspace``: the largest ``||U_p - U_r (U_rᵀ U_p)||_F`` over the modes,
  the part of the program's factor outside the reference's span;
* ``recon``: ``||x̂_p - x̂_r||_F / ||x̂_r||_F``, the gap between the two
  reconstructions, worked out from the cores and small factor products.

A result of the wrong shape, or with a value that is not finite, reads
``inf`` on both.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch

#: modes up to this size take ``eigh`` of their explicit Gram
EXPLICIT_MAX = 1024
#: extra columns of the subspace iteration beyond the rank
OVERSAMPLE = 10
#: in float64 the iteration stops once the leading subspace moves by less
#: than this (Frobenius, per square root of the rank), or fails after
#: MAX_ITERS steps; a lower precision runs LOW_ITERS steps, since its own
#: rounding keeps the subspace moving above any such tolerance
CONVERGED = {torch.float64: 1e-13}
MAX_ITERS = 100
LOW_ITERS = 8


def mode_order(shape, ranks, rule) -> list[int]:
    """The order of the modes a configuration states: None is 0..N-1,
    ``"shrink"`` the modes by R_n / I_n ascending (ties in mode order), a
    list itself."""
    n = len(shape)
    if rule is None:
        return list(range(n))
    if rule == "shrink":
        return sorted(range(n), key=lambda m: ranks[m] / shape[m])
    order = [int(m) for m in rule]
    if sorted(order) != list(range(n)):
        raise ValueError(f"mode order {order} is not a permutation")
    return order


def unfold(y: torch.Tensor, n: int) -> torch.Tensor:
    """The mode-``n`` unfolding (I_n, J), a view where ``n`` is the last mode."""
    if n == y.ndim - 1:
        return y.reshape(-1, y.shape[n]).T
    return y.movedim(n, 0).reshape(y.shape[n], -1)


def ttm_t(y: torch.Tensor, u: torch.Tensor, n: int) -> torch.Tensor:
    """``y ×_n uᵀ`` for ``u`` (I_n, R): mode ``n`` shrinks to R."""
    z = torch.tensordot(y, u, dims=([n], [0]))
    return z if n == y.ndim - 1 else z.movedim(-1, n).contiguous()


def _top(w: torch.Tensor, v: torch.Tensor, r: int) -> torch.Tensor:
    return v[:, torch.argsort(w, descending=True)[:r]]


def leading_subspace(y: torch.Tensor, n: int, r: int,
                     gen: torch.Generator) -> torch.Tensor:
    """An orthonormal basis (I_n, r) of the leading eigenvectors of mode
    ``n``'s Gram."""
    yn = unfold(y, n)
    i_n = yn.shape[0]
    if i_n <= EXPLICIT_MAX or r + OVERSAMPLE >= i_n:
        w, v = torch.linalg.eigh(yn @ yn.T)
        return _top(w, v, r)
    k = r + OVERSAMPLE
    q = torch.linalg.qr(torch.randn((i_n, k), generator=gen, device=y.device,
                                    dtype=y.dtype))[0]
    tol = CONVERGED.get(y.dtype)
    prev = None
    for _ in range(MAX_ITERS if tol is not None else LOW_ITERS):
        z = yn @ (yn.T @ q)                       # the Gram applied to q
        w, v = torch.linalg.eigh(q.T @ z)         # Rayleigh-Ritz on span(q)
        lead = q @ _top(w, v, r)
        if tol is not None and prev is not None and float(
                (lead - prev @ (prev.T @ lead)).norm()) < tol * math.sqrt(r):
            return lead
        prev = lead
        q = torch.linalg.qr(z)[0]
    if tol is None:
        return lead
    raise RuntimeError(f"mode {n}: the subspace iteration did not settle in "
                       f"{MAX_ITERS} steps")


@contextmanager
def precision(tf32: bool):
    """Matrix products in TF32 (``tf32=True``) or in full float32 inside."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def sthosvd(x: torch.Tensor, ranks, order, *, dtype=torch.float64,
            tf32: bool = False, seed: int = 0):
    """(core, factors) of the st-HOSVD of ``x`` at ``ranks``, taking the
    modes in ``order``, computed in ``dtype`` (TF32 products if ``tf32``)."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    factors = [None] * x.ndim
    with precision(tf32):
        y = x.to(dtype)
        for n in order:
            u = leading_subspace(y, n, ranks[n], gen)
            y = ttm_t(y, u, n)
            factors[n] = u
    return y, factors


def _inner(ga, ua, gb, ub) -> float:
    """⟨ga ×_n ua, gb ×_n ub⟩ from the cores and the (R_b, R_a) products."""
    t = ga
    for n, (a, b) in enumerate(zip(ua, ub)):
        t = ttm_t(t, (b.T @ a).T, n)
    return float((t * gb).sum())


def gaps(core, factors, ref_core, ref_factors) -> dict:
    """The program's (core, factors) against the reference's: ``subspace``
    and ``recon`` as the module docstring defines them, in float64."""
    bad = {"subspace": math.inf, "recon": math.inf}
    n = ref_core.ndim
    if core is None or len(factors) != n or \
            tuple(core.shape) != tuple(ref_core.shape):
        return bad
    ur = [u.to(torch.float64) for u in ref_factors]
    up = []
    for u, r in zip(factors, ur):
        if tuple(u.shape) != tuple(r.shape):
            return bad
        up.append(u.detach().to(device=r.device, dtype=torch.float64))
    gp = core.detach().to(device=ref_core.device, dtype=torch.float64)
    gr = ref_core.to(torch.float64)
    if not (bool(torch.isfinite(gp).all())
            and all(bool(torch.isfinite(u).all()) for u in up)):
        return bad
    sub = max(float((a - b @ (b.T @ a)).norm()) for a, b in zip(up, ur))
    pp, rr, pr = (_inner(gp, up, gp, up), _inner(gr, ur, gr, ur),
                  _inner(gp, up, gr, ur))
    recon = math.sqrt(max(pp + rr - 2.0 * pr, 0.0) / rr)
    return {"subspace": sub, "recon": recon}
