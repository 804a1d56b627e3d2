"""Shared helpers for the PyTorch port's parity tests against the JAX reference.

Inputs are made with numpy from a seed and the same arrays go to both
packages; results come back to numpy (float64) for comparison.  Factors are
compared by projector U·Uᵀ (eigenvector signs and the order within a
degenerate subspace are free) and decompositions by ``rel_error``.
"""

from __future__ import annotations

import numpy as np
import torch


def to_np(a) -> np.ndarray:
    """float64 numpy copy of a torch tensor or a jax/numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().double().numpy()
    return np.asarray(a).astype(np.float64)


def projector(u) -> np.ndarray:
    u = to_np(u)
    return u @ u.T


def max_projector_gap(us, vs) -> float:
    """max over modes of max|U Uᵀ − V Vᵀ|."""
    return max(float(np.abs(projector(a) - projector(b)).max())
               for a, b in zip(us, vs))


def reconstruct_np(core, factors) -> np.ndarray:
    """X̂ = G ×_1 U^(1) ··· ×_N U^(N) in float64 numpy."""
    y = to_np(core)
    for mode, u in enumerate(factors):
        y = np.moveaxis(np.tensordot(to_np(u), y, axes=(1, mode)), 0, mode)
    return y


def rel_error_np(x, core, factors) -> float:
    x = to_np(x)
    return float(np.linalg.norm(x - reconstruct_np(core, factors))
                 / np.linalg.norm(x))


def lowrank(dims, ranks, seed: int = 0, noise: float = 0.0) -> np.ndarray:
    """float32 low-rank tensor at ``ranks`` (orthonormal factors, Gaussian
    core) plus Gaussian noise at ``noise`` × its RMS."""
    rng = np.random.default_rng(seed)
    core = rng.standard_normal(ranks)
    us = [np.linalg.qr(rng.standard_normal((d, r)))[0]
          for d, r in zip(dims, ranks)]
    x = reconstruct_np(core, us)
    if noise:
        x = x + noise * np.sqrt(np.mean(x ** 2)) * rng.standard_normal(dims)
    return x.astype(np.float32)


def assert_tucker_close(x, got, want, *, proj_atol: float,
                        rel_atol: float, recon_atol: float | None = None):
    """Hold two decompositions of ``x`` to each other: per-mode projectors
    within ``proj_atol``, ``rel_error`` within ``rel_atol`` and, when given,
    the reconstructions within ``recon_atol`` × max|x|."""
    gap = max_projector_gap(got.factors, want.factors)
    assert gap <= proj_atol, f"projector gap {gap} > {proj_atol}"
    e_got = rel_error_np(x, got.core, got.factors)
    e_want = rel_error_np(x, want.core, want.factors)
    assert abs(e_got - e_want) <= rel_atol, (e_got, e_want)
    if recon_atol is not None:
        diff = np.abs(reconstruct_np(got.core, got.factors)
                      - reconstruct_np(want.core, want.factors)).max()
        bound = recon_atol * np.abs(to_np(x)).max()
        assert diff <= bound, f"reconstructions differ by {diff} > {bound}"
