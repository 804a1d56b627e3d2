"""Per-mode factor/core solvers for the flexible st-HOSVD (a-Tucker Sec. III).

Each solver consumes the current (partially shrunk) tensor ``y`` and a mode,
and returns ``(U, y_new)`` where ``U`` (I_n × R_n) has orthonormal columns
and ``y_new`` is the tensor with mode ``n`` shrunk to R_n:

  EIG  (paper Alg. 2 lines 6–8):  S = Y_(n)Y_(n)^T  → leading eigvecs → TTM.
  ALS  (paper Alg. 2 lines 10–13 + Alg. 3): rank-R_n alternating LS on
       Y_(n) ≈ L R^T, then QR(L) for orthonormality, core = TTM(R-tensor, R̂).
  SVD  (paper Alg. 1; baseline only — always slowest, kept for Fig. 2).
  RAND (randomized range finder / sketched Gram, Minster–Saibaba–Kilmer
       [1905.07311]): Y_(n) Ω for a Gaussian test tensor Ω with
       ℓ = R_n + oversample columns → QR → optional power iterations →
       Rayleigh–Ritz rotation of the ℓ-dim sketch basis (an eig step on the
       ℓ×ℓ sketched Gram) truncated to R_n, all through the same TTM/TTT/Gram
       backend primitives.  Its eigenvalue tail is what rank-adaptive
       (``error_target``) plans read the per-mode rank off — see
       :func:`rand_sketch` and :meth:`repro_torch.core.api.TuckerPlan.resolve_ranks`.

Everything but SVD is matricization-free (built on whichever registered
:mod:`repro_torch.core.backend` supplies TTM/TTT/Gram); ``impl`` names an
ops backend — ``matfree`` (torch contractions), ``explicit`` (unfold-based
baseline for the Fig. 8 comparison), ``hopper`` (hand-written CUDA kernels),
or any custom-registered name.  EIG and ALS also take an ops triple
``(ttm, gram, ttt)`` in place of the name: the sharded runner
(:mod:`repro_torch.core.distributed`) passes the local backend's triple
with ``gram`` and ``ttt`` wrapped to all-reduce their partial sums over the
shard axis, since the schedule never shards the mode being solved.
Randomness comes from an explicit
``torch.Generator`` on the tensor's device.  The dense factorizations that
check their result on the host (``eigh``, ``svd``) and the seeded draws go
through :mod:`repro_torch.core.graphs`, so that a sweep captured into CUDA
graphs runs them between its graphs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import graphs as G
from . import tensor_ops as T
from .backend import backend_ops, get_backend

DEFAULT_ALS_ITERS = 5  # paper Sec. III-B default


class SolveResult(NamedTuple):
    u: torch.Tensor       # (I_n, R_n) orthonormal factor
    y_new: torch.Tensor   # tensor with mode shrunk to R_n


def _accum(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _ops(impl):
    """(ttm, gram, ttt) of a backend name, or ``impl`` itself when it is
    already such a triple."""
    return backend_ops(impl) if isinstance(impl, str) else tuple(impl)


# ---------------------------------------------------------------------------
# EIG solver
# ---------------------------------------------------------------------------

def eig_solve(y: torch.Tensor, mode: int, rank: int, *,
              impl="matfree") -> SolveResult:
    ttm, gram, _ = _ops(impl)
    s = gram(y, mode)                                   # (I_n, I_n), fp32+ accum
    _, vecs = G.eigh(s.to(_accum(s.dtype)))             # ascending, like jnp
    u = vecs[:, -rank:].flip(1).to(y.dtype)             # leading R_n eigvecs
    y_new = ttm(y, u.T, mode)                           # core update
    return SolveResult(u, y_new)


# ---------------------------------------------------------------------------
# ALS solver (Alg. 3)
# ---------------------------------------------------------------------------

def als_solve(y: torch.Tensor, mode: int, rank: int, *,
              num_iters: int = DEFAULT_ALS_ITERS,
              seed: int = 0,
              impl="matfree",
              l0: torch.Tensor | None = None,
              cols: int | None = None) -> SolveResult:
    """``l0`` (I_n, R_n) overrides the random start, which is otherwise
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``y``'s device
    (tests inject the reference's own ``jax.random`` draw through it).
    ``cols`` is the column count of the whole mode-n unfolding (the local
    ``y``'s by default; the sharded runner passes the step's ``j_n``).

    A rank above ``cols`` is improper: the unfolding has no more than
    ``cols`` directions, and ALS at the full rank would solve a singular
    least-squares problem whose surplus columns are rounding noise (on a
    tensor-core Gram they swamp the real directions).  ALS then runs at
    rank ``cols`` on the first ``cols`` columns of the start, and the
    factor is completed to R_n orthonormal columns from the rest of the
    start, with zero core slices: the same reconstruction, the asked
    shapes."""
    if num_iters < 1:
        # the loop must run at least once: the R-tensor is only written
        # inside the body (zero iterations would return a zero core)
        raise ValueError(f"als_solve needs num_iters >= 1, got {num_iters}")
    ttm, gram, ttt = _ops(impl)
    i_n = y.shape[mode]
    # sub-fp32 inputs (bf16/fp16) iterate in fp32 (the peak_bytes model in
    # plan.py assumes exactly this); fp32/fp64 keep their own precision
    cdtype = _accum(y.dtype)
    if l0 is None:
        l0 = G.seeded_randn((i_n, rank), seed=seed, dtype=cdtype,
                            device=y.device)
    elif tuple(l0.shape) != (i_n, rank):
        raise ValueError(f"als_solve: l0 must be {(i_n, rank)}, got "
                         f"{tuple(l0.shape)}")
    l = l0.to(device=y.device, dtype=cdtype)
    k = min(rank, y.numel() // i_n if cols is None else cols)
    l, rest = l[:, :k], l[:, k:]
    # the live set stays inside the step's modeled scratch (2 L + 2 R +
    # the output): the start is not kept beside the iterates, and the last
    # iteration's (I_n, R_n) product is dropped before the next TTT
    # allocates its own and the kernel's split-K workspace
    del l0
    yc = y.to(cdtype)
    r_t = None
    for _ in range(num_iters):
        # L's columns are first orthonormalized (QR), so LᵀL = I and
        # R_k ← Y_(n)^T L; tensorized: R-tensor = TTM(y, L^T, n).  Left
        # un-orthonormalized, an L whose start projects badly onto the
        # leading subspace keeps that basis: LᵀL and RᵀR stay at
        # condition ~1e6 and the fp32 solves stall ALS above its optimum
        l = torch.linalg.qr(l)[0]
        r_t = ttm(yc, l.T, mode)
        # L_{k+1} ← (Y_(n) R)(RᵀR)^{-1};  Y_(n) R = TTT(y, R-tensor, n)
        yr = ttt(yc, r_t, mode)                          # (I_n, R_n)
        rtr = gram(r_t, mode)                            # (R_n, R_n)
        l = yr @ _spd_inverse(rtr)
        del yr, rtr
    # the loop exits with (L_k, R_{k-1}), a consistent ALS pair — L_k is the
    # exact LS optimum FOR R_{k-1} — so the sweep ends on an L-update.
    # orthonormalize:  L = Q̂ R̂,  U ← Q̂,  core ← TTM(R-tensor, R̂)
    q, rhat = torch.linalg.qr(l)
    y_new = ttm(r_t, rhat, mode)
    if k < rank:
        q = torch.cat([q, _complement(q, rest)], 1)
        pad = list(y_new.shape)
        pad[mode] = rank - k
        y_new = torch.cat([y_new, y_new.new_zeros(pad)], mode)
    return SolveResult(q.to(y.dtype), y_new.to(y.dtype))


def _complement(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``w``'s columns made orthonormal and orthogonal to ``q``'s
    (orthonormal) columns: projected off ``q`` and orthonormalized, twice,
    so that fp32 leaves no component along ``q``."""
    for _ in range(2):
        w = torch.linalg.qr(w - q @ (q.T @ w))[0]
    return w


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
    u, s, vh = G.svd(y2.to(_accum(y.dtype)))
    u = u[:, :rank]
    core2 = s[:rank, None] * vh[:rank]                  # Σ V^T
    out_shape = tuple(y.shape[:mode]) + (rank,) + tuple(y.shape[mode + 1:])
    return SolveResult(u.to(y.dtype), T.fold(core2, mode, out_shape).to(y.dtype))


# ---------------------------------------------------------------------------
# RAND solver (randomized range finder, Minster–Saibaba–Kilmer 1905.07311)
# ---------------------------------------------------------------------------

DEFAULT_OVERSAMPLE = 8   # ℓ = R_n + oversample sketch columns
DEFAULT_POWER_ITERS = 1  # subspace iterations sharpening the sketch basis


#: elements per fp32 partial sum of :func:`_row_sq_norms`
_RUN = 256


def _row_sq_norms(m: torch.Tensor) -> torch.Tensor:
    """Σ m[i, :]² per row of a 2-D tensor, in float64: fp32 (or wider) norms
    of runs of 256 elements, squared and summed in float64, so that the
    partial sums take 1/256 of m's memory.  A single fp32 sum over a
    full-size tensor is off by ~1e-4 of itself, the order of a
    rank-adaptive step's whole budget."""
    k = m.shape[1] // _RUN
    out = m[:, k * _RUN:].double().square().sum(1)
    if k:
        runs = m[:, :k * _RUN].reshape(m.shape[0], k, _RUN)
        out = out + torch.linalg.vector_norm(
            runs, dim=2).double().square().sum(1)
    return out


def _sq_norm(x: torch.Tensor) -> torch.Tensor:
    """||x||_F² as a float64 0-d tensor (:func:`_row_sq_norms`; one pass
    over a contiguous x, no copy of it)."""
    return _row_sq_norms(x.reshape(1, -1))[0]


def mode_energies(z: torch.Tensor, mode: int) -> torch.Tensor:
    """(I_mode,) float64: the energy of each mode-``mode`` slice of ``z``,
    Σ over every other index of z², summed as :func:`_row_sq_norms` does."""
    return _row_sq_norms(z.movedim(mode, 0).reshape(z.shape[mode], -1))


def rand_sketch(y: torch.Tensor, mode: int, width: int, *,
                power_iters: int = DEFAULT_POWER_ITERS,
                seed: int = 0,
                impl: str = "matfree",
                omega: torch.Tensor | None = None,
                energy: torch.Tensor | None = None):
    """One-shot mode sketch: everything a rank decision needs, in one pass.

    Draws a Gaussian test tensor Ω (``y``'s shape with mode ``mode`` sized
    ``width`` = ℓ) from a ``torch.Generator`` seeded with ``seed`` on
    ``y``'s device, forms the range sample ``Y_(n) Ω_(n)ᵀ`` through the
    backend TTT (never materializing an unfolding), orthonormalizes it,
    runs ``power_iters`` subspace iterations (TTM project → TTT expand →
    QR), and Rayleigh–Ritz diagonalizes the ℓ×ℓ sketched Gram.  ``omega``
    overrides the draw (tests inject the reference's ``jax.random`` Ω
    through it).  ``energy`` is ``||y||_F²`` when the caller has measured
    it (the adaptive pass does so once a mode, not once a width); else it
    is measured here.

    Returns ``(q, b, evals, vecs, energy)``: ``q`` (I_n, ℓ) orthonormal
    sketch basis, ``b`` = ``TTM(y, qᵀ, mode)`` (mode shrunk to ℓ),
    ``evals`` (ℓ,) ascending eigenvalues of ``Gram(b, mode)``, ``vecs``
    (ℓ, ℓ) their eigenvectors, and ``energy`` = ``||y||_F²`` (a float64
    0-d tensor, :func:`_sq_norm`).  QR and eigh run in float64
    (:func:`_orthonormal`).

    In exact arithmetic the captured energy of a rank-r truncation of this
    basis is ``sum(evals[-r:])``, so ``energy - sum(evals[-r:])`` is the
    discarded energy of the factor that will really be used — what makes
    the per-mode budget check of rank-adaptive execution a guarantee (the
    adaptive pass sums it from the rotated core instead, see
    :meth:`repro_torch.core.api.TuckerPlan._sketch_pass`).
    """
    yc = y.to(_accum(y.dtype))
    energy = _sq_norm(yc) if energy is None else energy
    return (*_sketch(yc, mode, width, power_iters, seed, impl, omega),
            energy)


def _sketch(yc: torch.Tensor, mode: int, width: int, power_iters: int,
            seed: int, impl: str, omega: torch.Tensor | None):
    """:func:`rand_sketch` without the energy: ``(q, b, evals, vecs)`` of
    ``yc`` (already in its accumulation dtype)."""
    ttm, gram, ttt = backend_ops(impl)
    cdtype = yc.dtype
    w_shape = tuple(yc.shape[:mode]) + (width,) + tuple(yc.shape[mode + 1:])
    if omega is None:
        omega = G.seeded_randn(w_shape, seed=seed, dtype=cdtype,
                               device=yc.device)
    elif tuple(omega.shape) != w_shape:
        raise ValueError(f"rand_sketch: omega must be {w_shape}, got "
                         f"{tuple(omega.shape)}")
    w = omega.to(device=yc.device, dtype=cdtype).contiguous()
    q = _orthonormal(ttt(yc, w, mode), cdtype)           # (I_n, ℓ) range basis
    for _ in range(power_iters):
        b = ttm(yc, q.T, mode)                           # project: mode → ℓ
        q = _orthonormal(ttt(yc, b, mode), cdtype)       # expand: Y Yᵀ Q
    b = ttm(yc, q.T, mode)
    gb = gram(b, mode)                                   # (ℓ, ℓ) sketched Gram
    evals, vecs = G.eigh(gb.double())
    return q, b, evals.to(cdtype), vecs.to(cdtype)


def _orthonormal(a: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The Q of a's QR, computed in float64 and returned in ``dtype``.  The
    sketch's factor is Q·V (V from the float64 eigh of the sketched Gram),
    and its tail is exact only as far as Q·V is orthonormal: fp32 QR and
    eigh left 7e-6 at ℓ = 64 on the H100, which inflated the captured
    energy by ~5e-6 of ||X||², a twentieth of a 1%-noise input's tail;
    rounded from float64 they leave ~5e-8."""
    return torch.linalg.qr(a.double())[0].to(dtype)


def rand_solve(y: torch.Tensor, mode: int, rank: int, *,
               oversample: int = DEFAULT_OVERSAMPLE,
               power_iters: int = DEFAULT_POWER_ITERS,
               seed: int = 0,
               impl: str = "matfree",
               omega: torch.Tensor | None = None) -> SolveResult:
    """Randomized mode solve: sketch at width ℓ = rank + oversample (capped
    at I_n), then the Rayleigh–Ritz rotation — an eig step on the ℓ×ℓ
    sketched Gram — truncated to R_n.  ``omega`` as in :func:`rand_sketch`."""
    width = min(y.shape[mode], rank + oversample)
    q, b, _, vecs = _sketch(y.to(_accum(y.dtype)), mode, width, power_iters,
                            seed, impl, omega)
    v = vecs[:, -rank:].flip(1).to(q.dtype)              # leading R_n Ritz vecs
    ttm = backend_ops(impl)[0]
    u = q @ v
    y_new = ttm(b, v.T, mode)                            # rotate core: ℓ → R_n
    return SolveResult(u.to(y.dtype), y_new.to(y.dtype))


SOLVERS = {"eig": eig_solve, "als": als_solve, "svd": svd_solve,
           "rand": rand_solve}
EIG, ALS, SVD, RAND = "eig", "als", "svd", "rand"
