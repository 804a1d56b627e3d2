"""The port's execute-time fallback ladder, held to the reference's rungs.

Failures are injected into the solvers (``solvers.SOLVERS``) or the Hopper
ops (``kernels.ops``) of a plan on ``device="cpu"``; every hop is read off
``fallback_hops()``.  The rungs are the reference's: als→eig on a
numerical breakdown (here a ``torch.linalg.LinAlgError``), a replan under
0.75 × the cap with ``mode_order="opt"`` on an out-of-memory (here a
``torch.OutOfMemoryError``), each at most once, and the rank-adaptive
rand→eig hop when a sketch-only plan misses its budget.  The reference's
``pallas→matfree`` rung has no counterpart: a failing Hopper op raises and
no ``matfree`` plan is made.  Recovered results are held to an untouched
``eig`` plan of the same input (projectors within 1e-4: fp32 eigh of
well-separated spectra), or, after a replan that reorders the sweep, to
the failed plan's own result (rel_error within 1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro_torch.core import (CancelledError, DeadlineError, InputError,
                              MemoryCapError, NumericalError, ResourceError,
                              TuckerConfig, fallback_hops, plan,
                              reset_fallback_hops)
from repro_torch.core import api as A
from repro_torch.core import solvers as S
from repro_torch.kernels import ops as K
from torch_parity import lowrank, max_projector_gap, rel_error_np

SHAPE, RANKS = (12, 10, 8), (3, 3, 3)
#: the natural order's bottleneck is avoidable by reordering, so a replan
#: under 0.75 × its peak exists (mode 0 barely compresses)
WIDE, WIDE_RANKS = (16, 96, 64), (12, 4, 8)
#: the same on ``hopper``, whose steps also hold their calls' workspace
#: (``eigh``'s alone is over a MiB) and, after the first step, the input:
#: WIDE's replan under 0.75 × its hopper peak is infeasible, this larger
#: tensor's is not
HOPPER_WIDE, HOPPER_WIDE_RANKS = (16, 32, 32, 64), (12, 4, 4, 4)


@pytest.fixture(autouse=True)
def _fresh_counter():
    reset_fallback_hops()
    yield
    reset_fallback_hops()


def failing(fn, exc, times=1):
    """``fn`` that raises ``exc`` on its first ``times`` calls (all calls
    when ``times`` is None); ``calls`` counts every call."""
    def wrapped(*a, **kw):
        wrapped.calls += 1
        if times is None or wrapped.calls <= times:
            raise exc
        return fn(*a, **kw)
    wrapped.calls = 0
    return wrapped


def eig_reference(x):
    return plan(SHAPE, "float32", TuckerConfig(ranks=RANKS, methods="eig"),
                device="cpu").execute(x)


class TestNumericalRung:
    def test_als_to_eig_on_a_linalg_error(self, monkeypatch):
        x = lowrank(SHAPE, RANKS, seed=1, noise=0.01)
        als = failing(S.SOLVERS["als"], torch.linalg.LinAlgError("failed"))
        monkeypatch.setitem(S.SOLVERS, "als", als)
        p = plan(SHAPE, "float32", TuckerConfig(ranks=RANKS, methods="als"),
                 device="cpu")
        res = p.execute(x)
        assert fallback_hops() == {("als_to_eig", "matfree"): 1}
        assert als.calls == 1                  # the eig replan never calls it
        assert res.methods == ("eig",) * 3
        assert max_projector_gap(res.tucker.factors,
                                 eig_reference(x).tucker.factors) <= 1e-4

    def test_non_finite_result_hops_once_then_raises(self, monkeypatch):
        # validate="finite" turns a NaN factor into a NumericalError: the
        # als→eig rung runs once; when eig breaks too, the ladder is spent
        nan = S.SolveResult(torch.full((SHAPE[0], 3), float("nan")),
                            torch.zeros((3,) + SHAPE[1:]))
        for name in ("als", "eig"):
            monkeypatch.setitem(S.SOLVERS, name,
                                lambda *a, **kw: nan)
        p = plan(SHAPE, "float32", TuckerConfig(ranks=RANKS, methods="als"),
                 device="cpu")
        with pytest.raises(NumericalError):
            p.execute(lowrank(SHAPE, RANKS, seed=2), validate="finite")
        assert fallback_hops() == {("als_to_eig", "matfree"): 1}

    def test_no_als_step_no_hop(self, monkeypatch):
        eig = failing(S.SOLVERS["eig"], torch.linalg.LinAlgError("failed"))
        monkeypatch.setitem(S.SOLVERS, "eig", eig)
        p = plan(SHAPE, "float32", TuckerConfig(ranks=RANKS, methods="eig"),
                 device="cpu")
        with pytest.raises(NumericalError) as e:
            p.execute(lowrank(SHAPE, RANKS, seed=3))
        assert isinstance(e.value.__cause__, torch.linalg.LinAlgError)
        assert fallback_hops() == {} and eig.calls == 1


class TestResourceRung:
    def test_replan_cap_on_out_of_memory(self, monkeypatch):
        x = lowrank(WIDE, WIDE_RANKS, seed=4, noise=0.01)
        p = plan(WIDE, "float32", TuckerConfig(ranks=WIDE_RANKS,
                                               methods="eig"), device="cpu")
        eig = failing(S.SOLVERS["eig"],
                      torch.OutOfMemoryError("CUDA out of memory"))
        monkeypatch.setitem(S.SOLVERS, "eig", eig)
        seen = []
        real_plan = A.plan
        monkeypatch.setattr(A, "plan", lambda *a, **kw: seen.append(a[2])
                            or real_plan(*a, **kw))
        res = p.execute(x)
        assert fallback_hops() == {("replan_cap", "matfree"): 1}
        (cfg,) = seen
        assert cfg.mode_order == "opt"
        assert cfg.memory_cap_bytes == int(0.75 * p.capped_peak_bytes)
        want = plan(WIDE, "float32", cfg, device="cpu")
        assert [s.mode for s in res.trace] == [s.mode for s in want.schedule]
        assert [s.mode for s in res.trace] != [0, 1, 2]
        assert abs(rel_error_np(x, res.tucker.core, res.tucker.factors)
                   - float(p.execute(x).tucker.rel_error(x))) <= 1e-4

    def test_tighter_cap_of_a_capped_plan(self, monkeypatch):
        cap = 10 ** 6
        p = plan(SHAPE, "float32", TuckerConfig(
            ranks=RANKS, methods="eig", memory_cap_bytes=cap), device="cpu")
        monkeypatch.setitem(S.SOLVERS, "eig", failing(
            S.SOLVERS["eig"], torch.OutOfMemoryError("out of memory")))
        seen = []
        real_plan = A.plan
        monkeypatch.setattr(A, "plan", lambda *a, **kw: seen.append(a[2])
                            or real_plan(*a, **kw))
        p.execute(lowrank(SHAPE, RANKS, seed=5))
        assert [c.memory_cap_bytes for c in seen] == [int(0.75 * cap)]

    def test_persistent_oom_is_classified_and_bounded(self, monkeypatch):
        eig = failing(S.SOLVERS["eig"],
                      torch.OutOfMemoryError("CUDA out of memory"), None)
        monkeypatch.setitem(S.SOLVERS, "eig", eig)
        p = plan(WIDE, "float32", TuckerConfig(ranks=WIDE_RANKS,
                                               methods="eig"), device="cpu")
        with pytest.raises(ResourceError):
            p.execute(lowrank(WIDE, WIDE_RANKS, seed=6))
        # one attempt, one replan: each rung at most once, no retry storm
        assert eig.calls == 2
        assert fallback_hops() == {("replan_cap", "matfree"): 1}

    def test_unplannable_cap_gives_up_with_the_original_error(self,
                                                              monkeypatch):
        # every first step holds the whole input, so no schedule of this
        # shape fits 0.75 × its peak: the replan fails and nothing hops
        p = plan(SHAPE, "float32", TuckerConfig(ranks=RANKS, methods="eig"),
                 device="cpu")
        monkeypatch.setitem(S.SOLVERS, "eig", failing(
            S.SOLVERS["eig"], torch.OutOfMemoryError("out of memory")))
        with pytest.raises(ResourceError):
            p.execute(lowrank(SHAPE, RANKS, seed=7))
        assert fallback_hops() == {}


class TestHopperOpsRaise:
    @pytest.mark.parametrize("op", ["ttm", "gram"])
    def test_a_failing_hopper_op_raises_and_no_matfree_plan_runs(
            self, monkeypatch, op):
        err = RuntimeError("ttm: CUDA error: an illegal memory access")
        monkeypatch.setattr(K, op, failing(getattr(K, op), err, None))
        p = plan(SHAPE, "float32", TuckerConfig(ranks=RANKS, methods="eig",
                                                impl="hopper"), device="cpu")
        plans = []
        real_plan = A.plan
        monkeypatch.setattr(A, "plan", lambda *a, **kw: plans.append(a[2])
                            or real_plan(*a, **kw))
        with pytest.raises(RuntimeError) as e:
            p.execute(lowrank(SHAPE, RANKS, seed=8))
        assert e.value is err
        assert plans == [] and fallback_hops() == {}

    def test_a_hopper_oom_replans_on_hopper(self, monkeypatch):
        monkeypatch.setattr(K, "gram", failing(
            K.gram, RuntimeError("CUDA error: out of memory")))
        p = plan(HOPPER_WIDE, "float32", TuckerConfig(
            ranks=HOPPER_WIDE_RANKS, methods="eig", impl="hopper"),
            device="cpu")
        res = p.execute(lowrank(HOPPER_WIDE, HOPPER_WIDE_RANKS, seed=9))
        assert fallback_hops() == {("replan_cap", "hopper"): 1}
        assert {t.backend for t in res.trace} == {"hopper"}

    def test_a_hopper_oom_without_a_replan_raises_the_resource_error(
            self, monkeypatch):
        """WIDE on hopper: no schedule fits 0.75 × its hopper peak (every
        step holds eigh's workspace, and every later one the input), so the
        rung is not taken and the classified error is raised; matfree
        plans of the same tensor still replan."""
        oom = RuntimeError("CUDA error: out of memory")
        monkeypatch.setattr(K, "gram", failing(K.gram, oom))
        p = plan(WIDE, "float32", TuckerConfig(
            ranks=WIDE_RANKS, methods="eig", impl="hopper"), device="cpu")
        with pytest.raises(MemoryCapError):
            plan(WIDE, "float32", TuckerConfig(
                ranks=WIDE_RANKS, methods="eig", impl="hopper",
                mode_order="opt",
                memory_cap_bytes=int(0.75 * p.capped_peak_bytes)),
                device="cpu")
        with pytest.raises(ResourceError) as e:
            p.execute(lowrank(WIDE, WIDE_RANKS, seed=9))
        assert e.value.__cause__ is oom
        assert fallback_hops() == {}


class TestNeverHops:
    @pytest.mark.parametrize("exc", [InputError("bad input"),
                                     DeadlineError("late"),
                                     CancelledError("retracted")])
    def test_caller_side_failures(self, monkeypatch, exc):
        als = failing(S.SOLVERS["als"], exc, None)
        monkeypatch.setitem(S.SOLVERS, "als", als)
        p = plan(SHAPE, "float32", TuckerConfig(ranks=RANKS, methods="als"),
                 device="cpu")
        with pytest.raises(type(exc)) as e:
            p.execute(lowrank(SHAPE, RANKS, seed=10))
        assert e.value is exc and als.calls == 1
        assert fallback_hops() == {}

    def test_unclassified_errors_raise_as_themselves(self, monkeypatch):
        err = KeyError("bug")
        monkeypatch.setitem(S.SOLVERS, "als",
                            failing(S.SOLVERS["als"], err, None))
        p = plan(SHAPE, "float32", TuckerConfig(ranks=RANKS, methods="als"),
                 device="cpu")
        with pytest.raises(KeyError):
            p.execute(lowrank(SHAPE, RANKS, seed=11))
        assert fallback_hops() == {}


class TestSketchMiss:
    def test_rand_to_eig_on_a_missed_budget(self):
        # an incompressible input and a one-rank grid: a sketch-only plan
        # misses every budget, refines with exact eig solves at the chosen
        # ranks, counts the hop and reports the measured (missed) bound
        x = np.random.default_rng(5).standard_normal((16, 12, 10)).astype(
            np.float32)
        cfg = dict(error_target=0.05, rank_grid=(2,), methods="rand")
        res = plan(x.shape, "float32", TuckerConfig(**cfg),
                   device="cpu").execute(x)
        want = R.plan(x.shape, jnp.float32, R.TuckerConfig(**cfg)).execute(
            jnp.asarray(x))
        assert fallback_hops() == {("rand_to_eig", "matfree"): 1}
        assert res.tucker.ranks == want.tucker.ranks == (2, 2, 2)
        assert all(t.method == "eig" for t in res.trace)
        # the bound is the sketch's own, which on an incompressible input
        # depends on each package's Ω; the eig refinement does not
        assert res.error_bound > 0.05 and want.error_bound > 0.05
        assert abs(rel_error_np(x, res.tucker.core, res.tucker.factors)
                   - float(want.tucker.rel_error(jnp.asarray(x)))) <= 1e-3

    def test_refining_plans_refine_without_a_hop(self):
        x = np.random.default_rng(6).standard_normal((16, 12, 10)).astype(
            np.float32)
        res = plan(x.shape, "float32", TuckerConfig(
            error_target=0.05, rank_grid=(2,)), device="cpu").execute(x)
        assert fallback_hops() == {}
        assert res.tucker.ranks == (2, 2, 2) and res.error_bound > 0.05
