"""Port parity for the schedule search: repro_torch.core.schedule_opt against
repro.core.schedule_opt.

The search is pure Python on the same cost model and the same peak-bytes
model, so results are held to be EQUAL: the whole ``ScheduleSearch``
(order, methods, total cost, states, groups, ranks), the text of every
infeasible-cap message, and an ``opt`` plan's JSON for ``matfree`` plans
with explicit methods.  Executes of ``opt`` plans are held to the
reference on the same numpy input: projectors within 1e-3 and rel_error
within 1e-4 (ALS draws its own start in each package).  Plans run on
``device="cpu"``.
"""

import itertools
import math

import jax.numpy as jnp
import pytest

import repro.core as R
from repro.core import schedule_opt as RSO
from repro.core.plan import _step_peak_bytes as r_step_peak_bytes
from repro_torch.core import (DEFAULT_COST_MODEL, MemoryCapError,
                              TuckerConfig, TuckerPlan, optimize_grouping,
                              optimize_schedule, plan, resolve_schedule)
from repro_torch.core import schedule_opt as PSO
from repro_torch.core.plan import _step_peak_bytes, resolve_mode_order
from torch_parity import assert_tucker_close, lowrank

BRUTE_CASES = [((30, 8, 22), (3, 6, 4)), ((16, 16, 16), (4, 4, 4)),
               ((40, 6, 12, 9), (5, 4, 3, 2))]


def brute_force(shape, ranks, *, methods=None, als_iters=5, itemsize=4,
                cap=None, cm=DEFAULT_COST_MODEL):
    """Every order × every per-step solver, priced by the port's model."""
    best = None
    for order in itertools.permutations(range(len(shape))):
        cands = [([methods[m]] if methods is not None
                  else list(PSO.SEARCH_METHODS)) for m in order]
        for meths in itertools.product(*cands):
            cur, cost, ok = list(shape), 0.0, True
            for m, meth in zip(order, meths):
                i_n, r_n = cur[m], ranks[m]
                j_n = math.prod(cur) // i_n
                if cap is not None and \
                        _step_peak_bytes(meth, i_n, r_n, j_n, itemsize) > cap:
                    ok = False
                    break
                cost += PSO.step_cost(cm, meth, i_n, r_n, j_n, als_iters)
                cur[m] = r_n
            if ok and (best is None or cost < best[0]):
                best = (cost, order, meths)
    return best


def least_cap(fn_name, *args, **kw) -> int:
    """The least ``memory_cap_bytes`` the port's search admits (bisection
    between an infeasible 1 and the uncapped schedule's feasible cap)."""
    fn = getattr(PSO, fn_name)
    lo, hi = 1, 1 << 40
    while hi - lo > 1:
        mid = (lo + hi) // 2
        try:
            fn(*args, memory_cap_bytes=mid, **kw)
            hi = mid
        except PSO.MemoryCapError:
            lo = mid
    return hi


def capped(edge, fn_name, *args, **kw):
    """The search at ``edge``: uncapped ("free"), at the least cap it
    admits ("least") or one byte below it ("below", infeasible)."""
    cap = None if edge == "free" else \
        least_cap(fn_name, *args, **kw) - (edge == "below")
    return both(fn_name, *args, memory_cap_bytes=cap, **kw)


EDGES = ["free", "least", "below"]


def both(fn_name, *args, **kw):
    """(port result or its MemoryCapError text, reference's likewise)."""
    out = []
    for mod in (PSO, RSO):
        try:
            out.append(getattr(mod, fn_name)(*args, **kw).to_dict())
        except mod.MemoryCapError as e:
            out.append(("infeasible", str(e)))
    return out


class TestPeakModel:
    @pytest.mark.parametrize("method", ["eig", "als", "svd", "rand"])
    @pytest.mark.parametrize("itemsize,n_shards", [(4, 1), (2, 1), (8, 1),
                                                   (4, 4), (2, 4)])
    def test_step_peak_bytes_equals_reference(self, method, itemsize,
                                              n_shards):
        for i_n, r_n, j_n in [(30, 3, 176), (1021, 10, 353760), (8, 5, 40)]:
            assert _step_peak_bytes(method, i_n, r_n, j_n, itemsize,
                                    n_shards) == \
                r_step_peak_bytes(method, i_n, r_n, j_n, itemsize, n_shards)


class TestDPParity:
    @pytest.mark.parametrize("shape,ranks", BRUTE_CASES)
    def test_search_equals_reference_and_brute_force(self, shape, ranks):
        got, want = both("optimize_schedule", shape, ranks)
        assert got == want
        assert math.isclose(got["total_cost"], brute_force(shape, ranks)[0],
                            rel_tol=1e-9)

    def test_pinned_methods(self):
        shape, ranks = (24, 10, 18), (4, 5, 3)
        got, want = both("optimize_schedule", shape, ranks,
                         methods=["eig"] * 3)
        assert got == want and got["methods"] == ["eig"] * 3
        assert math.isclose(got["total_cost"], brute_force(
            shape, ranks, methods=["eig"] * 3)[0], rel_tol=1e-9)

    @pytest.mark.parametrize("frac", [0.2, 0.35, 0.6, 0.9])
    @pytest.mark.parametrize("shape,ranks", BRUTE_CASES[::2])
    def test_cap_fractions(self, shape, ranks, frac):
        worst = max(_step_peak_bytes(m, shape[i], ranks[i],
                                     math.prod(shape) // shape[i], 4)
                    for i in range(len(shape)) for m in PSO.SEARCH_METHODS)
        cap = int(worst * frac)
        got, want = both("optimize_schedule", shape, ranks,
                         memory_cap_bytes=cap)
        assert got == want
        ref = brute_force(shape, ranks, cap=cap)
        if ref is None:
            assert got[0] == "infeasible"
        else:
            assert math.isclose(got["total_cost"], ref[0], rel_tol=1e-9)

    @pytest.mark.parametrize("edge", EDGES)
    def test_rank_grid_axis(self, edge):
        grid = ((2, 4, 8), (3, 6), (1, 2, 4))
        got, want = capped(edge, "optimize_schedule", (30, 20, 10),
                           (8, 6, 4), rank_grid=grid)
        assert got == want
        assert isinstance(got, dict) == (edge != "below")
        if isinstance(got, dict):
            assert all(r in grid[m] for m, r in zip(got["order"],
                                                     got["ranks"]))

    def test_rand_in_the_search_set(self):
        got, want = both("optimize_schedule", (60, 40, 24), (6, 5, 4),
                         search_methods=("eig", "als", "rand"))
        assert got == want

    @pytest.mark.parametrize("edge", EDGES)
    def test_sharded_groups(self, edge):
        got, want = capped(edge, "optimize_schedule", (40, 16, 24),
                           (4, 4, 6), n_shards=4, max_group=3)
        assert got == want
        assert isinstance(got, dict) == (edge != "below")

    @pytest.mark.parametrize("edge", EDGES)
    @pytest.mark.parametrize("order", [(0, 1, 2, 3), (3, 1, 0, 2)])
    def test_grouping_along_a_fixed_order(self, order, edge):
        got, want = capped(edge, "optimize_grouping", (40, 6, 12, 9),
                           (5, 4, 3, 2), order, n_shards=2)
        assert got == want
        assert isinstance(got, dict) == (edge != "below")

    def test_rank_axis_rejects_groups(self):
        with pytest.raises(ValueError):
            optimize_schedule((8, 8, 8), (2, 2, 2), max_group=2,
                              rank_grid=((1, 2),) * 3)
        with pytest.raises(ValueError):
            optimize_schedule((8, 8, 8), (2, 2, 2), rank_grid=((1, 2),) * 2)


class TestCapErrors:
    def test_infeasible_names_the_same_binding_step(self):
        got, want = both("optimize_schedule", (96, 16, 64), (4, 12, 8),
                         memory_cap_bytes=1000)
        assert got == want and got[0] == "infeasible"
        assert "binding step — mode" in got[1] and "1,000" in got[1]

    @pytest.mark.parametrize("shape,ranks", BRUTE_CASES + [
        ((16, 96, 64), (12, 4, 8))])
    def test_infeasible_just_below_the_least_cap(self, shape, ranks):
        got, want = capped("below", "optimize_schedule", shape, ranks)
        assert got == want and got[0] == "infeasible"

    def test_fixed_order_schedule_message(self):
        msgs = []
        for mod, kw in ((R, {}), (None, dict(platform="cpu"))):
            rs = mod.resolve_schedule if mod else resolve_schedule
            with pytest.raises(ValueError) as e:
                rs((96, 16, 64), (4, 12, 8), methods="eig",
                   memory_cap_bytes=1000, **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
        assert "step 0" in msgs[0] and "mode_order='opt'" in msgs[0]

    def test_config_validation(self):
        with pytest.raises(ValueError):
            TuckerConfig(ranks=(2, 2, 2), mode_order="fastest")
        with pytest.raises(ValueError):
            TuckerConfig(ranks=(2, 2, 2), memory_cap_bytes=0)
        with pytest.raises(ValueError):
            resolve_mode_order((4, 4, 4), (2, 2, 2), "opt")

    def test_cap_forces_smaller_solver(self):
        shape, ranks = (80, 64, 64), (4, 32, 32)
        free = resolve_schedule(shape, ranks, mode_order="opt",
                                cost_model=DEFAULT_COST_MODEL)
        worst = max(free, key=lambda s: s.peak_bytes)
        assert worst.method == "als"
        capped = resolve_schedule(shape, ranks, mode_order="opt",
                                  cost_model=DEFAULT_COST_MODEL,
                                  memory_cap_bytes=worst.peak_bytes - 1)
        want = R.resolve_schedule(shape, ranks, mode_order="opt",
                                  cost_model=R.DEFAULT_COST_MODEL,
                                  memory_cap_bytes=worst.peak_bytes - 1)
        assert [(s.mode, s.method, s.peak_bytes) for s in capped] == \
            [(s.mode, s.method, s.peak_bytes) for s in want]
        assert next(s for s in capped if s.mode == worst.mode).method == "eig"


class TestOptPlans:
    @pytest.mark.parametrize("cfg", [
        dict(ranks=(4, 6, 5), mode_order="opt", methods="eig"),
        dict(ranks=(4, 6, 5), mode_order="opt", methods=("als", "eig", "eig"),
             memory_cap_bytes=10_000_000),
        dict(ranks=(4, 6, 5), mode_order="opt", methods="rand"),
        dict(ranks=(4, 6, 5), mode_order=(2, 0, 1), methods="eig",
             memory_cap_bytes=200_000, donate_input=True),
        dict(ranks=(4, 6, 5), variant="hooi", mode_order="opt",
             methods="als", hooi_iters=2)])
    def test_plan_json_equals_reference(self, cfg):
        got = plan((40, 12, 30), "float32", TuckerConfig(**cfg), device="cpu")
        want = R.plan((40, 12, 30), jnp.float32, R.TuckerConfig(**cfg))
        assert got.to_json() == want.to_json()
        back = TuckerPlan.from_json(got.to_json(), device="cpu")
        assert back.to_dict() == got.to_dict()

    def test_auto_methods_schedule_equals_reference(self):
        cfg = dict(ranks=(4, 6, 5), mode_order="opt",
                   memory_cap_bytes=200_000)
        got = plan((40, 12, 30), "float32", TuckerConfig(**cfg), device="cpu")
        want = R.plan((40, 12, 30), jnp.float32, R.TuckerConfig(**cfg))
        assert [s.to_dict() for s in got.schedule] == \
            [s.to_dict() for s in want.schedule]

    def test_opt_plan_executes_like_the_reference(self):
        shape, ranks = (40, 12, 30), (4, 6, 5)
        x = lowrank(shape, ranks, seed=2, noise=0.01)
        cfg = dict(ranks=ranks, mode_order="opt")
        got = plan(shape, "float32", TuckerConfig(**cfg),
                   device="cpu").execute(x)
        want = R.plan(shape, jnp.float32, R.TuckerConfig(**cfg)).execute(
            jnp.asarray(x))
        assert_tucker_close(x, got.tucker, want.tucker, proj_atol=1e-3,
                            rel_atol=1e-4)

    def test_feasible_cap_respected_and_executes(self):
        # the natural order's bottleneck is avoidable by reordering
        shape, ranks = (16, 96, 64), (12, 4, 8)
        free = plan(shape, "float32", TuckerConfig(ranks=ranks), device="cpu")
        cap = int(max(s.peak_bytes for s in free.schedule) * 0.8)
        cfg = TuckerConfig(ranks=ranks, mode_order="opt",
                           memory_cap_bytes=cap)
        p = plan(shape, "float32", cfg, device="cpu")
        assert all(s.peak_bytes <= cap for s in p.schedule)
        with pytest.raises(MemoryCapError):
            plan(shape, "float32", TuckerConfig(ranks=ranks,
                                                memory_cap_bytes=cap),
                 device="cpu")
        x = lowrank(shape, ranks, seed=1, noise=0.01)
        assert float(p.execute(x).tucker.rel_error(x)) < 0.05
        assert "cap_headroom" in p.describe()

    def test_undonated_plan_cap_counts_held_input(self):
        # donate_input=False keeps the reference's plan-level check: every
        # step fits, but the held input beside the later steps does not
        shape, ranks = (32, 24, 20), (4, 4, 4)
        donated = plan(shape, "float32", TuckerConfig(ranks=ranks,
                                                      donate_input=True),
                       device="cpu")
        cap = donated.capped_peak_bytes + 1
        want = R.plan(shape, jnp.float32, R.TuckerConfig(
            ranks=ranks, donate_input=True, memory_cap_bytes=cap))
        got = plan(shape, "float32", TuckerConfig(
            ranks=ranks, donate_input=True, memory_cap_bytes=cap),
            device="cpu")
        assert got.capped_peak_bytes == want.peak_bytes <= cap
        for mod, kw in ((R, {}), (None, dict(device="cpu"))):
            with pytest.raises(ValueError, match="undonated"):
                (mod.plan if mod else plan)(
                    shape, jnp.float32 if mod else "float32",
                    (mod.TuckerConfig if mod else TuckerConfig)(
                        ranks=ranks, donate_input=False,
                        memory_cap_bytes=cap), **kw)
