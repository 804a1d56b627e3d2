"""Per-mode factor/core solvers for the flexible st-HOSVD (a-Tucker Sec. III).

Each solver consumes the current (partially shrunk) tensor ``y`` and a mode,
and returns ``(U, y_new)`` where ``U`` (I_n × R_n) has orthonormal columns
and ``y_new`` is the tensor with mode ``n`` shrunk to R_n:

  EIG  (paper Alg. 2 lines 6–8):  S = Y_(n)Y_(n)^T  → leading eigvecs → TTM.
  ALS  (paper Alg. 2 lines 10–13 + Alg. 3): rank-R_n alternating LS on
       Y_(n) ≈ L R^T, then QR(L) for orthonormality, core = TTM(R-tensor, R̂).
  SVD  (paper Alg. 1; baseline only — always slowest, kept for Fig. 2).

The randomized RAND solver ports with the rank-adaptive slice.

Everything but SVD is matricization-free (built on whichever registered
:mod:`repro_torch.core.backend` supplies TTM/TTT/Gram); ``impl`` names an
ops backend — ``matfree`` (torch contractions), ``explicit`` (unfold-based
baseline for the Fig. 8 comparison), ``hopper`` (hand-written CUDA kernels),
or any custom-registered name.  PyTorch runs eagerly: there is no jit, and
randomness comes from an explicit ``torch.Generator`` on the tensor's
device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import tensor_ops as T
from .backend import backend_ops, get_backend

DEFAULT_ALS_ITERS = 5  # paper Sec. III-B default


class SolveResult(NamedTuple):
    u: torch.Tensor       # (I_n, R_n) orthonormal factor
    y_new: torch.Tensor   # tensor with mode shrunk to R_n


def _accum(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


# ---------------------------------------------------------------------------
# EIG solver
# ---------------------------------------------------------------------------

def eig_solve(y: torch.Tensor, mode: int, rank: int, *,
              impl: str = "matfree") -> SolveResult:
    ttm, gram, _ = backend_ops(impl)
    s = gram(y, mode)                                   # (I_n, I_n), fp32+ accum
    _, vecs = torch.linalg.eigh(s.to(_accum(s.dtype)))  # ascending, like jnp
    u = vecs[:, -rank:].flip(1).to(y.dtype)             # leading R_n eigvecs
    y_new = ttm(y, u.T, mode)                           # core update
    return SolveResult(u, y_new)


# ---------------------------------------------------------------------------
# ALS solver (Alg. 3)
# ---------------------------------------------------------------------------

def als_solve(y: torch.Tensor, mode: int, rank: int, *,
              num_iters: int = DEFAULT_ALS_ITERS,
              seed: int = 0,
              impl: str = "matfree",
              l0: torch.Tensor | None = None) -> SolveResult:
    """``l0`` (I_n, R_n) overrides the random start, which is otherwise
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``y``'s device
    (tests inject the reference's own ``jax.random`` draw through it)."""
    if num_iters < 1:
        # the loop must run at least once: the R-tensor is only written
        # inside the body (zero iterations would return a zero core)
        raise ValueError(f"als_solve needs num_iters >= 1, got {num_iters}")
    ttm, gram, ttt = backend_ops(impl)
    i_n = y.shape[mode]
    # sub-fp32 inputs (bf16/fp16) iterate in fp32 (the peak_bytes model in
    # plan.py assumes exactly this); fp32/fp64 keep their own precision
    cdtype = _accum(y.dtype)
    if l0 is None:
        gen = torch.Generator(device=y.device).manual_seed(seed)
        l0 = torch.randn((i_n, rank), generator=gen, device=y.device,
                         dtype=cdtype)
    elif tuple(l0.shape) != (i_n, rank):
        raise ValueError(f"als_solve: l0 must be {(i_n, rank)}, got "
                         f"{tuple(l0.shape)}")
    l = l0.to(device=y.device, dtype=cdtype)
    yc = y.to(cdtype)
    r_t = None
    for _ in range(num_iters):
        # R_k ← (Y_(n)^T L)(L^T L)^{-1}; tensorized: R-tensor = TTM(y, L^T, n) ×_n (LᵀL)^{-1}
        r_t = ttm(yc, l.T, mode)
        r_t = ttm(r_t, _spd_inverse(l.T @ l), mode)
        # L_{k+1} ← (Y_(n) R)(RᵀR)^{-1};  Y_(n) R = TTT(y, R-tensor, n)
        yr = ttt(yc, r_t, mode)                          # (I_n, R_n)
        rtr = gram(r_t, mode)                            # (R_n, R_n)
        l = yr @ _spd_inverse(rtr)
    # the loop exits with (L_k, R_{k-1}), a consistent ALS pair — L_k is the
    # exact LS optimum FOR R_{k-1} — so the sweep ends on an L-update.
    # orthonormalize:  L = Q̂ R̂,  U ← Q̂,  core ← TTM(R-tensor, R̂)
    q, rhat = torch.linalg.qr(l)
    y_new = ttm(r_t, rhat, mode).to(y.dtype)
    return SolveResult(q.to(y.dtype), y_new)


#: escalating relative re-regularization ladder: the baseline 1e-12·tr(A)
#: jitter first, then two stronger rungs for genuinely ill-conditioned Grams
_SPD_JITTERS = (1e-12, 1e-8, 1e-4)


def _spd_inverse(a: torch.Tensor) -> torch.Tensor:
    """Inverse of a small SPD matrix via Cholesky (paper uses explicit inverse;
    Cholesky is the numerically robust equivalent at identical O(R³) cost).

    A Cholesky breakdown on a rank-deficient/ill-conditioned Gram is
    reported by ``torch.linalg.cholesky_ex`` in ``info`` (the reference's
    XLA sees NaNs); a failed rung counts as non-finite and the next,
    stronger jitter is tried.  The last rung adds an absolute floor so even
    an exactly-zero Gram yields a finite (pseudo-)inverse instead of
    poisoning the whole sweep.  The first finite rung is chosen on the
    device with ``torch.where`` — no host sync."""
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    scale = torch.trace(a)
    nan = torch.full_like(a, float("nan"))
    inv = nan
    for i, jitter in enumerate(_SPD_JITTERS):
        reg = jitter * scale
        if i == len(_SPD_JITTERS) - 1:
            reg = reg + 1e-6                             # absolute floor
        c, info = torch.linalg.cholesky_ex(a + reg * eye)
        cand = torch.where(info == 0, torch.cholesky_solve(eye, c), nan)
        ok = torch.isfinite(inv).all()
        inv = torch.where(ok, inv, cand)
    return inv


# ---------------------------------------------------------------------------
# SVD solver (original st-HOSVD; baseline)
# ---------------------------------------------------------------------------

def svd_solve(y: torch.Tensor, mode: int, rank: int, *,
              impl: str = "matfree") -> SolveResult:
    """SVD mode solve (paper Alg. 1 line 3): thin SVD of the unfolding.

    The SVD solver *inherently* matricizes — the decomposition is defined on
    the explicit I_n×J_n unfolding, so no backend can supply a
    matricization-free version.  ``impl`` is still validated against the
    registry so unknown backends are rejected here exactly as in the
    EIG/ALS solvers.
    """
    get_backend(impl)  # reject unknown backends; ops themselves unused
    y2 = T.unfold(y, mode)
    u, s, vh = torch.linalg.svd(y2.to(_accum(y.dtype)), full_matrices=False)
    u = u[:, :rank]
    core2 = s[:rank, None] * vh[:rank]                  # Σ V^T
    out_shape = tuple(y.shape[:mode]) + (rank,) + tuple(y.shape[mode + 1:])
    return SolveResult(u.to(y.dtype), T.fold(core2, mode, out_shape).to(y.dtype))


SOLVERS = {"eig": eig_solve, "als": als_solve, "svd": svd_solve}
EIG, ALS, SVD = "eig", "als", "svd"
