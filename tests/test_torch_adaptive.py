"""Port parity for the rank-adaptive path: the ``rand`` solver
(``rand_sketch``/``rand_solve``), error-targeted plans
(``TuckerConfig(error_target=...)``) and the schedule DP's rank axis, against
the reference on the same numpy inputs.

Tolerances:
- ``rand_sketch``/``rand_solve`` with the reference's own Ω,
  ``jax.random.normal(PRNGKey(seed), w_shape)``, injected through
  ``omega=``: projectors of q and of the factor within 1e-4, ``evals`` and
  ``energy`` within 1e-4 relative (of the largest eigenvalue, of the
  energy), the shrunk tensors lifted back (``y_new ×_n U``, sign-free)
  within 1e-4 of max|x| (fp32 QR/eigh of well-separated spectra).
- Adaptive executes (each package draws its own Ω): the same ranks, the
  bound ≤ ε, ``rel_error`` ≤ 1.05 × the bound (the reference's own limit)
  and, against the reference's ``rel_error`` and bound, within 1e-3.
Plans run on ``device="cpu"``.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import solvers as RS
from repro_torch.core import (RAND, TuckerConfig, TuckerPlan,
                              optimize_schedule, plan, rand_sketch,
                              rand_solve)
from repro_torch.core import solvers as PS
from repro_torch.core.backend import backend_ops
from torch_parity import lowrank, projector, rel_error_np, to_np

DIMS, TRUE_RANKS, EPS = (60, 40, 24), (6, 5, 4), 0.05
TOL = 1e-4


def ref_omega(shape, mode, width, seed=0):
    w_shape = shape[:mode] + (width,) + shape[mode + 1:]
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), w_shape,
                                      dtype=jnp.float32))


def lifted(y, u, mode):
    y, u = to_np(y), to_np(u)
    return np.moveaxis(np.tensordot(u, y, axes=(1, mode)), 0, mode)


class TestRandSketch:
    @pytest.mark.parametrize("shape,ranks,mode,width,power_iters", [
        ((30, 20, 16), (5, 4, 3), 0, 12, 1),
        ((30, 20, 16), (5, 4, 3), 1, 9, 0),
        ((30, 20, 16), (5, 4, 3), 2, 16, 2),
        ((12, 9, 10, 7), (3, 3, 2, 2), 2, 6, 1)])
    def test_matches_reference_with_its_omega(self, shape, ranks, mode,
                                              width, power_iters):
        x = lowrank(shape, ranks, seed=3, noise=0.05)
        om = ref_omega(shape, mode, width)
        want = RS.rand_sketch(jnp.asarray(x), mode, width,
                              power_iters=power_iters)
        got = rand_sketch(torch.from_numpy(x), mode, width,
                          power_iters=power_iters,
                          omega=torch.from_numpy(om))
        wq, wb, wev, _, wen = (to_np(a) for a in want)
        gq, gb, gev, _, gen = (to_np(a) for a in got)
        np.testing.assert_allclose(projector(gq), projector(wq), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(gev, wev, rtol=0, atol=TOL * wev.max())
        assert abs(float(gen) - float(wen)) <= TOL * float(wen)
        np.testing.assert_allclose(lifted(gb, gq, mode), lifted(wb, wq, mode),
                                   rtol=0, atol=TOL * np.abs(x).max())

    def test_tail_is_exact_for_the_used_factor(self):
        # energy minus the top-r sketched eigenvalues equals the true
        # discarded energy of u = q·v, at any width (the reference's test)
        x = torch.from_numpy(lowrank((30, 20, 16), (5, 4, 3), noise=0.05))
        q, b, evals, vecs, energy = rand_sketch(x, 0, 12)
        ttm = backend_ops("matfree")[0]
        for r in (2, 4, 8):
            u = q @ vecs[:, -r:].flip(1)
            resid = x - ttm(ttm(x, u.T, 0), u, 0)
            actual = float(torch.linalg.vector_norm(resid)) ** 2
            modeled = float(energy) - float(evals.flip(0)[:r].sum())
            assert actual == pytest.approx(modeled, rel=1e-3, abs=1e-2)

    def test_omega_shape_is_checked_and_the_draw_is_seeded(self):
        x = torch.from_numpy(lowrank((10, 8, 6), (3, 3, 2)))
        with pytest.raises(ValueError, match="omega"):
            rand_sketch(x, 0, 5, omega=torch.zeros(5, 8, 7))
        a, b = rand_sketch(x, 1, 5, seed=3), rand_sketch(x, 1, 5, seed=3)
        assert all(torch.equal(p, q) for p, q in zip(a, b))

    def test_a_given_energy_is_returned_and_changes_nothing_else(self):
        x = torch.from_numpy(lowrank((30, 20, 16), (5, 4, 3), noise=0.05))
        own = rand_sketch(x, 2, 8, seed=1)
        given = torch.tensor(123.0, dtype=torch.float64)
        got = rand_sketch(x, 2, 8, seed=1, energy=given)
        assert got[4] is given
        assert all(torch.equal(a, b) for a, b in zip(own[:4], got[:4]))

    @pytest.mark.parametrize("mode", [0, 1, 2])
    def test_hopper_backend_plain_versions_match_matfree(self, mode):
        x = torch.from_numpy(lowrank((30, 20, 16), (5, 4, 3), noise=0.05))
        m = rand_sketch(x, mode, 9, impl="matfree")
        h = rand_sketch(x, mode, 9, impl="hopper")
        np.testing.assert_allclose(projector(h[0]), projector(m[0]),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(to_np(h[2]), to_np(m[2]), rtol=0,
                                   atol=TOL * float(m[2].max()))


class TestEnergySums:
    """The sketch pass's energies, held to numpy float64 within 1e-6
    relative: the certificate needs them well inside 5e-6 of ||X||² (5% of
    the 1e-4 tail a 1%-noise input leaves), and a single fp32 reduction is
    off by ~1e-4 at these sizes."""

    def test_sq_norm(self):
        x = (np.random.default_rng(0).standard_normal((102, 134, 33, 8))
             * 3 + 1).astype(np.float32)
        want = float((x.astype(np.float64) ** 2).sum())
        got = PS._sq_norm(torch.from_numpy(x))
        assert got.dtype == torch.float64
        assert abs(float(got) - want) <= 1e-6 * want

    @pytest.mark.parametrize("mode", [0, 1, 2, 3])
    def test_mode_energies(self, mode):
        z = (np.random.default_rng(1).standard_normal((9, 40, 33, 300))
             + 0.5).astype(np.float32)
        axes = tuple(a for a in range(4) if a != mode)
        want = (z.astype(np.float64) ** 2).sum(axis=axes)
        got = to_np(PS.mode_energies(torch.from_numpy(z), mode))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)

    def test_bound_is_the_sketch_result_error(self):
        # st-HOSVD's squared error is the sum of its steps' discarded
        # energies, so a sketch-only result's rel_error IS its bound
        x = lowrank(DIMS, TRUE_RANKS, seed=7, noise=0.01)
        res = plan(DIMS, "float32", TuckerConfig(
            error_target=EPS, methods="rand"), device="cpu").execute(x)
        err = rel_error_np(x, res.tucker.core, res.tucker.factors)
        assert abs(err - res.error_bound) <= 1e-3 * err


class TestRandSolve:
    @pytest.mark.parametrize("mode", [0, 1, 2])
    def test_matches_reference_with_its_omega(self, mode):
        x = lowrank(DIMS, TRUE_RANKS, seed=1, noise=0.02)
        r = TRUE_RANKS[mode]
        width = min(DIMS[mode], r + PS.DEFAULT_OVERSAMPLE)
        want = RS.rand_solve(jnp.asarray(x), mode, r)
        got = rand_solve(torch.from_numpy(x), mode, r,
                         omega=torch.from_numpy(ref_omega(DIMS, mode, width)))
        np.testing.assert_allclose(projector(got.u), projector(want.u),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(
            lifted(got.y_new, got.u, mode), lifted(want.y_new, want.u, mode),
            rtol=0, atol=TOL * np.abs(x).max())

    def test_recovers_a_lowrank_tensor(self):
        x = torch.from_numpy(lowrank(DIMS, TRUE_RANKS, noise=0.0))
        y, factors = x, []
        for mode, r in enumerate(TRUE_RANKS):
            res = rand_solve(y, mode, r)
            factors.append(res.u)
            y = res.y_new
        for u in factors:
            np.testing.assert_allclose(to_np(u.T @ u), np.eye(u.shape[1]),
                                       atol=1e-4)
        assert rel_error_np(x, y, factors) < 1e-3

    def test_rand_is_exposed_as_a_solver(self):
        assert RAND == "rand" and PS.SOLVERS["rand"] is rand_solve


class TestAdaptiveConfig:
    def test_ranks_none_requires_error_target(self):
        with pytest.raises(ValueError):
            TuckerConfig()

    @pytest.mark.parametrize("eps", [0.0, 1.0, -0.1, 2.0])
    def test_error_target_range(self, eps):
        with pytest.raises(ValueError):
            TuckerConfig(error_target=eps)

    @pytest.mark.parametrize("kw", [dict(variant="hooi"),
                                    dict(mode_parallel="auto"),
                                    dict(impl="sharded")])
    def test_error_target_rejects_incompatible_modes(self, kw):
        with pytest.raises(ValueError):
            R.TuckerConfig(error_target=0.05, **kw)
        with pytest.raises(ValueError):
            TuckerConfig(error_target=0.05, **kw)

    def test_rank_grid_requires_error_target(self):
        with pytest.raises(ValueError):
            TuckerConfig(ranks=(4, 4, 4), rank_grid=(2, 4))

    @pytest.mark.parametrize("kw", [
        dict(error_target=0.05, rank_grid=[2, 4, 8], oversample=4,
             power_iters=2),
        dict(error_target=0.05, rank_grid=((2, 4), (3, 6), (2,))),
        dict(error_target=0.1, ranks=(5, 4, 3), methods="rand")])
    def test_normalization_and_dict_equal_reference(self, kw):
        c = TuckerConfig(**kw)
        assert c.to_dict() == R.TuckerConfig(**kw).to_dict()
        assert TuckerConfig.from_dict(c.to_dict()) == c


def adaptive_pair(x, **kw):
    """(port result, reference result) of the same adaptive config."""
    got = plan(x.shape, "float32", TuckerConfig(**kw),
               device="cpu").execute(x)
    want = R.plan(x.shape, jnp.float32, R.TuckerConfig(**kw)).execute(
        jnp.asarray(x))
    return got, want


class TestAdaptiveExecution:
    @pytest.mark.parametrize("kw", [
        dict(error_target=EPS),
        dict(error_target=EPS, methods="rand"),
        dict(error_target=EPS, methods="eig", mode_order="opt"),
        dict(error_target=EPS, methods="rand", oversample=4, power_iters=2),
        dict(error_target=0.02, methods="als")])
    def test_contract_and_parity(self, kw):
        x = lowrank(DIMS, TRUE_RANKS, seed=0, noise=0.01)
        got, want = adaptive_pair(x, **kw)
        err = rel_error_np(x, got.tucker.core, got.tucker.factors)
        assert got.tucker.ranks == want.tucker.ranks == TRUE_RANKS
        assert got.error_bound <= kw["error_target"]
        assert err <= 1.05 * got.error_bound
        assert abs(got.error_bound - want.error_bound) <= 1e-3
        assert abs(err - rel_error_np(x, want.tucker.core,
                                      want.tucker.factors)) <= 1e-3
        sketch_only = kw.get("methods") == "rand"
        assert all((t.method == "rand") == sketch_only for t in got.trace)
        assert (got.select_overhead_s > 0.0) != sketch_only
        assert all(t.tail_err > 0.0 for t in got.trace)

    @pytest.mark.parametrize("kw", [
        dict(rank_grid=(4, 8)),
        dict(rank_grid=((2, 6, 9), (5,), (1, 3, 4, 6))),
        dict(ranks=(5, 4, 3)),
        dict(ranks=(8, 8, 8), methods="rand")])
    def test_grids_and_rank_caps(self, kw):
        x = lowrank(DIMS, TRUE_RANKS, seed=0, noise=0.01)
        got, want = adaptive_pair(x, error_target=EPS, **kw)
        assert got.tucker.ranks == want.tucker.ranks
        p = plan(DIMS, "float32", TuckerConfig(error_target=EPS, **kw),
                 device="cpu")
        for s in p.schedule:
            assert got.tucker.ranks[s.mode] in s.rank_grid
            assert s.r_n == s.rank_grid[-1]

    def test_energy_is_measured_once_a_mode(self, monkeypatch):
        # a target below the noise makes every mode double its width up to
        # the cap; ||y||² is still read once a mode, not once a width
        calls = {"energy": 0, "sketch": 0}
        sq_norm, sketch = PS._sq_norm, PS.rand_sketch

        def counted_sq_norm(t):
            calls["energy"] += 1
            return sq_norm(t)

        def counted_sketch(*a, **kw):
            calls["sketch"] += 1
            return sketch(*a, **kw)
        monkeypatch.setattr(PS, "_sq_norm", counted_sq_norm)
        monkeypatch.setattr(PS, "rand_sketch", counted_sketch)
        x = lowrank(DIMS, TRUE_RANKS, seed=0, noise=0.01)
        p = plan(DIMS, "float32", TuckerConfig(error_target=0.005,
                                               methods="rand"), device="cpu")
        p._sketch_pass(torch.from_numpy(x))
        assert calls["sketch"] > len(DIMS)
        assert calls["energy"] == len(DIMS)

    def test_resolve_ranks(self):
        x = lowrank(DIMS, TRUE_RANKS, seed=4, noise=0.01)
        p = plan(DIMS, "float32", TuckerConfig(error_target=EPS),
                 device="cpu")
        ranks, bound = p.resolve_ranks(x)
        want = R.plan(DIMS, jnp.float32, R.TuckerConfig(
            error_target=EPS)).resolve_ranks(jnp.asarray(x))
        assert ranks == want[0] == TRUE_RANKS
        assert abs(bound - want[1]) <= 1e-3 and 0.0 <= bound <= EPS
        fixed = plan(DIMS, "float32", TuckerConfig(ranks=(4, 4, 4)),
                     device="cpu")
        with pytest.raises(ValueError):
            fixed.resolve_ranks(x)

    def test_hopper_impl_on_the_cpu_matches_matfree(self):
        x = lowrank(DIMS, TRUE_RANKS, seed=2, noise=0.01)
        res = [plan(DIMS, "float32", TuckerConfig(
            error_target=EPS, methods="rand", impl=impl),
            device="cpu").execute(x) for impl in ("matfree", "hopper")]
        assert res[0].tucker.ranks == res[1].tucker.ranks
        assert abs(res[0].error_bound - res[1].error_bound) <= 1e-4


class TestAdaptivePlans:
    @pytest.mark.parametrize("kw", [
        dict(error_target=EPS),
        dict(error_target=EPS, rank_grid=(4, 8), oversample=4,
             power_iters=2, mode_order="opt"),
        dict(error_target=EPS, ranks=(5, 4, 3), methods="rand",
             memory_cap_bytes=10 ** 6)])
    def test_schedule_equals_reference_and_round_trips(self, kw):
        p = plan(DIMS, "float32", TuckerConfig(**kw), device="cpu")
        want = R.plan(DIMS, jnp.float32, R.TuckerConfig(**kw))
        assert p.is_adaptive
        assert [s.to_dict() for s in p.schedule] == \
            [s.to_dict() for s in want.schedule]
        d, wd = p.to_dict(), want.to_dict()
        d.pop("select_seconds"), wd.pop("select_seconds")
        assert d == wd
        p2 = TuckerPlan.from_json(p.to_json(), device="cpu")
        assert p2.is_adaptive and p2.config == p.config
        assert p2.describe() == p.describe()
        x = lowrank(DIMS, TRUE_RANKS, seed=1, noise=0.01)
        assert p2.execute(x).tucker.ranks == p.execute(x).tucker.ranks

    def test_describe_names_the_policy(self):
        d = plan(DIMS, "float32", TuckerConfig(error_target=EPS),
                 device="cpu").describe()
        assert "error_target=0.05" in d and "rank-adaptive" in d
        assert "grid=" in d and "rank policy" in d

    def test_infeasible_cap_names_the_binding_step(self):
        for mod, kw in ((R, {}), (None, dict(device="cpu"))):
            with pytest.raises(ValueError, match="binding step"):
                (mod.plan if mod else plan)(
                    DIMS, jnp.float32 if mod else "float32",
                    (mod.TuckerConfig if mod else TuckerConfig)(
                        error_target=EPS, mode_order="opt",
                        memory_cap_bytes=1000), **kw)


class TestScheduleDPRankAxis:
    def test_fixed_ranks_unchanged(self):
        rs = optimize_schedule((30, 20, 10), (8, 6, 4))
        assert rs.ranks == tuple((8, 6, 4)[m] for m in rs.order)

    def test_grid_opens_the_rank_axis(self):
        grids = ((2, 4, 8), (2, 6), (1, 4))
        got = optimize_schedule((30, 20, 10), (8, 6, 4), methods=["rand"] * 3,
                                rank_grid=grids)
        want = R.optimize_schedule((30, 20, 10), (8, 6, 4),
                                   methods=["rand"] * 3, rank_grid=grids)
        assert got.to_dict() == want.to_dict()
        assert got.ranks == tuple(grids[m][0] for m in got.order)
        assert replace(got, ranks=()).ranks == ()
