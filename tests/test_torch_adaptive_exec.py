"""Port parity for the rank-adaptive path's execution: error-targeted plans
(``TuckerConfig(error_target=...)``) run end to end on both packages, each
drawing its own Ω: the same ranks, the bound ≤ ε, ``rel_error`` ≤ 1.05 ×
the bound (the reference's own limit) and, against the reference's
``rel_error`` and bound, within 1e-3.  The solver, the configs and the
plans are in ``test_torch_adaptive.py``.  Plans run on ``device="cpu"``.
"""

import jax.numpy as jnp
import pytest
import torch

import repro.core as R
from repro_torch.core import TuckerConfig, plan
from repro_torch.core import solvers as PS
from torch_parity import lowrank, rel_error_np

DIMS, TRUE_RANKS, EPS = (60, 40, 24), (6, 5, 4), 0.05


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
