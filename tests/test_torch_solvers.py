"""Port parity: repro_torch.core.solvers against repro.core.solvers.

One mode solve per solver on the same numpy input, at fp32 and fp64 (jax's
64-bit mode switched on only around the fp64 cases).  Factors are compared
by projector and the shrunk tensors through the sign-invariant projection
``y_new ×_n U``.  ALS gets the reference's own random start,
``jax.random.normal(PRNGKey(0), (I_n, R_n))``, injected through ``l0=``.
Tolerances: fp32 1e-4 (eigh/QR of fp32 Grams; the low-rank inputs keep the
leading subspaces well separated), fp64 1e-9.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import solvers as RS
from repro_torch.core import solvers as PS
from repro_torch.core import tensor_ops as PT
from torch_parity import lowrank, projector, to_np

TOL = {"float32": 1e-4, "float64": 1e-9}
CASES = [((12, 15, 10), (3, 4, 2), 0), ((12, 15, 10), (3, 4, 2), 1),
         ((12, 15, 10), (3, 4, 2), 2), ((6, 8, 7, 5), (2, 3, 3, 2), 2)]


def _x64(dtype):
    return jax.enable_x64(True) if dtype == "float64" \
        else contextlib.nullcontext()


def _lift(res, mode):
    """y_new ×_n U in float64 numpy: the projection of y on the factor's
    subspace, independent of the factor's signs and basis."""
    y, u = to_np(res.y_new), to_np(res.u)
    return np.moveaxis(np.tensordot(u, y, axes=(1, mode)), 0, mode)


def _check(got, want, mode, tol, scale):
    np.testing.assert_allclose(projector(got.u), projector(want.u),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(_lift(got, mode), _lift(want, mode),
                               rtol=0, atol=tol * scale)


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("shape,ranks,mode", CASES)
@pytest.mark.parametrize("solver", ["eig", "svd"])
def test_eig_and_svd_match_reference(solver, shape, ranks, mode, dtype):
    x = lowrank(shape, ranks, seed=1, noise=0.02).astype(dtype)
    scale = float(np.abs(x).max())
    with _x64(dtype):
        want = getattr(RS, f"{solver}_solve")(jnp.asarray(x), mode,
                                              ranks[mode])
    got = getattr(PS, f"{solver}_solve")(torch.from_numpy(x), mode,
                                         ranks[mode])
    assert got.u.dtype == torch.from_numpy(x).dtype
    _check(got, want, mode, TOL[dtype], scale)


@pytest.mark.parametrize("shape,ranks,mode", CASES)
@pytest.mark.parametrize("impl,dtype", [("matfree", "float32"),
                                        ("matfree", "float64"),
                                        ("hopper", "float32")])
def test_als_matches_reference_with_injected_start(impl, dtype, shape, ranks,
                                                   mode):
    x = lowrank(shape, ranks, seed=2, noise=0.02).astype(dtype)
    r = ranks[mode]
    with _x64(dtype):
        l0 = np.array(jax.random.normal(jax.random.PRNGKey(0),
                                        (shape[mode], r), dtype=dtype))
        want = RS.als_solve(jnp.asarray(x), mode, r)
    got = PS.als_solve(torch.from_numpy(x), mode, r, impl=impl,
                       l0=torch.from_numpy(l0))
    _check(got, want, mode, TOL[dtype], float(np.abs(x).max()))


def test_als_draws_its_own_start_deterministically():
    x = torch.from_numpy(lowrank((10, 9, 8), (3, 3, 2), seed=3, noise=0.02))
    a = PS.als_solve(x, 1, 3, seed=7)
    b = PS.als_solve(x, 1, 3, seed=7)
    assert torch.equal(a.u, b.u) and torch.equal(a.y_new, b.y_new)
    with pytest.raises(ValueError):
        PS.als_solve(x, 1, 3, num_iters=0)
    with pytest.raises(ValueError):
        PS.als_solve(x, 1, 3, l0=torch.zeros(4, 3))


def test_eig_leading_vectors_come_first():
    """vecs[:, -rank:] reversed: column 0 is the top eigenvector."""
    x = torch.from_numpy(lowrank((20, 30), (3, 3), seed=4))
    u = PS.eig_solve(x, 0, 3).u.double()
    s = (x.double() @ x.double().T)
    rayleigh = torch.diag(u.T @ s @ u)
    assert bool((rayleigh[:-1] >= rayleigh[1:]).all())


def _ill_started(seed, kappa, i=60, j=(20, 20), r=6):
    """A rank-r signal with 1e-3 noise, and an ALS start whose projection
    onto the signal's leading subspace has condition number ``kappa``."""
    rng = np.random.default_rng(seed)
    u = np.linalg.qr(rng.standard_normal((i, r)))[0]
    v = np.linalg.qr(rng.standard_normal((int(np.prod(j)), r)))[0]
    sig = np.linspace(3.0, 1.0, r)
    y = (u * sig) @ v.T
    y += 1e-3 * np.linalg.norm(sig) / np.sqrt(y.size) * \
        rng.standard_normal(y.shape)
    c = np.linalg.qr(rng.standard_normal((r, r)))[0] @ np.diag(
        np.logspace(0, -np.log10(kappa), r))
    perp = rng.standard_normal((i, r))
    perp -= u @ (u.T @ perp)
    return (torch.from_numpy(y.reshape((i,) + j).astype(np.float32)),
            torch.from_numpy((u @ c + perp).astype(np.float32)))


@pytest.mark.parametrize("kappa", [1e3, 1e4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_als_recovers_from_an_ill_conditioned_start(seed, kappa):
    """ALS orthonormalizes L each iteration: from a start that projects
    badly onto the leading subspace it still reaches EIG's discarded
    energy within 1e-4 of it in fp32 (without the QR, LᵀL and RᵀR stay at
    condition ~1e6 and the fp32 solves leave 5e-4 to 3% above it)."""
    y, l0 = _ill_started(seed, kappa)

    def tail(u):
        res = y - PT.ttm(PT.ttm(y, u.T, 0), u, 0)
        return float(PT.fro_norm(res.double())) ** 2

    best = tail(PS.eig_solve(y, 0, 6).u)
    assert tail(PS.als_solve(y, 0, 6, l0=l0).u) <= (1 + 1e-4) * best


class TestSpdInverse:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_zero_gram_is_finite(self, dtype):
        inv = PS._spd_inverse(torch.zeros(4, 4, dtype=dtype))
        assert bool(torch.isfinite(inv).all())
        # the absolute floor of the last rung: (0 + 1e-6 I)^{-1}
        np.testing.assert_allclose(to_np(inv), 1e6 * np.eye(4), rtol=1e-3)

    def test_rank_deficient_gram_is_finite(self):
        v = torch.randn(5, 2, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(0))
        inv = PS._spd_inverse(v @ v.T)
        assert bool(torch.isfinite(inv).all())

    @pytest.mark.parametrize("dtype", ["float32", "float64"])
    def test_well_posed_matches_reference(self, dtype):
        rng = np.random.default_rng(5)
        m = rng.standard_normal((6, 6))
        a = (m @ m.T + 6 * np.eye(6)).astype(dtype)
        with _x64(dtype):
            want = np.asarray(RS._spd_inverse(jnp.asarray(a)))
        got = to_np(PS._spd_inverse(torch.from_numpy(a)))
        np.testing.assert_allclose(got, want, rtol=TOL[dtype] * 10,
                                   atol=TOL[dtype])
        np.testing.assert_allclose(got @ a, np.eye(6), atol=TOL[dtype] * 10)


def test_unknown_backend_rejected():
    x = torch.zeros(3, 4, 5)
    for fn in (PS.eig_solve, PS.svd_solve):
        with pytest.raises(ValueError):
            fn(x, 0, 2, impl="magic")
    with pytest.raises(NotImplementedError):   # the reference's TPU backend
        PS.eig_solve(x, 0, 2, impl="pallas")


def _noisy_gram(rel, seed=0):
    """matfree's ops with a Gram whose entries carry a relative error of
    ``rel`` of their own scale sqrt(S_ii S_jj), as a tensor-core Gram's do."""
    ttm, gram, ttt = PS._ops("matfree")
    g = torch.Generator().manual_seed(seed)

    def noisy(y, mode):
        s = gram(y, mode)
        d = s.diagonal().clamp_min(0).sqrt()
        e = torch.randn(s.shape, generator=g, dtype=s.dtype)
        return s + rel * (e + e.T) / 2 * torch.outer(d, d)
    return ttm, noisy, ttt


@pytest.mark.parametrize("rel", [0.0, 2e-4])
@pytest.mark.parametrize("shape,mode,rank", [((4, 3, 256), 2, 64),
                                             ((5, 40, 2), 1, 16)])
def test_als_at_an_improper_rank_keeps_the_reconstruction(shape, mode, rank,
                                                          rel):
    """A rank above the unfolding's column count (12 and 10 here): ALS
    solves at the column count and completes the factor, so its leading
    columns and core slices are those of the solve at the column count
    (bitwise, from the same start and the same Gram noise), the factor is
    orthonormal at the asked rank and the surplus core slices are zero;
    without noise the shrunk tensor reconstructs y.  The noisy Gram is the
    tensor-core one's resolution, where the solve at the full rank, its
    RᵀR singular, lost percents of the energy."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(shape)
                         .astype(np.float32))
    cols = x.numel() // shape[mode]
    assert rank > cols
    l0 = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (shape[mode], rank)).astype(np.float32))
    res = PS.als_solve(x, mode, rank, impl=_noisy_gram(rel), l0=l0)
    proper = PS.als_solve(x, mode, cols, impl=_noisy_gram(rel),
                          l0=l0[:, :cols])
    assert res.u.shape == (shape[mode], rank)
    assert res.y_new.shape[mode] == rank
    assert torch.equal(res.u[:, :cols], proper.u)
    assert torch.equal(res.y_new.narrow(mode, 0, cols), proper.y_new)
    assert float(res.y_new.narrow(mode, cols, rank - cols).abs().max()) == 0
    assert float((res.u.T @ res.u - torch.eye(rank)).abs().max()) <= 1e-5
    if rel == 0:
        back = PT.ttm(res.y_new, res.u, mode)
        assert float((back - x).abs().max()) <= 1e-4 * float(x.abs().max())
    same = PS.als_solve(x, mode, rank, impl=_noisy_gram(rel), l0=l0,
                        cols=cols)
    assert torch.equal(same.u, res.u) and torch.equal(same.y_new, res.y_new)
