"""The port's chaos harness (``repro_torch.chaos``) and the fallback ladder
driven through its seams, held to ``tests/test_resilience.py``.

The harness cases are the reference's ``TestChaosHarness``, with the
port's own copy and its own taxonomy (``SyntheticOOM`` must classify as a
``ResourceError`` through ``repro_torch.core.errors``); a rule installed in
one package does not reach the other.  The ladder cases are the chaos
cases of the reference's ``TestFallbackLadder``, on ``device="cpu"``: a
poisoned sweep output recovers through als→eig, an injected OOM through
the port's replan under a tighter cap (the reference's first OOM rung,
donate→undonated, has no counterpart: the port never donates), and a
persistent OOM ends as a classified ``ResourceError`` after a bounded
number of attempts.  Every hop is an obs ``fallback`` event and a count in
the metrics registry, which ``fallback_hops()`` reads.
"""

import numpy as np
import pytest

from repro import chaos as R_chaos
from repro_torch import chaos, obs
from repro_torch.core import (InputError, ResourceError, TuckerConfig,
                              classify_exception, fallback_hops, plan,
                              reset_fallback_hops)
from repro_torch.core import api as A
from repro_torch.obs import metrics as obs_metrics
from torch_parity import lowrank

F32 = "float32"
#: mode 0 barely compresses, so a replan under 0.75 × the natural order's
#: peak exists (the port's OOM rung needs one)
WIDE, WIDE_RANKS = (16, 96, 64), (12, 4, 8)


@pytest.fixture(autouse=True)
def _clean_chaos():
    chaos.reset()
    reset_fallback_hops()
    yield
    chaos.reset()
    reset_fallback_hops()
    obs.disable()


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


class TestChaosHarness:
    def test_schedule_at_and_times(self):
        chaos.install([chaos.Rule(seam="s", action="raise", at=1, times=1)])
        chaos.fire("s")                       # hit 0: not due
        with pytest.raises(chaos.ChaosFault):
            chaos.fire("s")                   # hit 1: due
        chaos.fire("s")                       # times=1 budget spent
        assert sum(chaos.fired().values()) == 1

    def test_match_filters_context(self):
        chaos.install([chaos.Rule(seam="s", action="raise", times=None,
                                  match={"rid": 2})])
        chaos.fire("s", rid=0)
        chaos.fire("s", rid=1)
        with pytest.raises(chaos.ChaosFault):
            chaos.fire("s", rid=2)

    def test_probability_is_seed_deterministic(self):
        def pattern(mod, seed):
            mod.reset()
            mod.install([mod.Rule(seam="s", action="raise", p=0.5,
                                  times=None, seed=seed)])
            out = []
            for _ in range(32):
                try:
                    mod.fire("s")
                    out.append(0)
                except mod.ChaosFault:
                    out.append(1)
            mod.reset()
            return out

        assert pattern(chaos, 7) == pattern(chaos, 7)
        assert pattern(chaos, 7) != pattern(chaos, 8)
        # the same seed addresses the same hits in the reference
        assert pattern(chaos, 7) == pattern(R_chaos, 7)

    def test_synthetic_oom_classifies_as_resource(self):
        chaos.install([chaos.Rule(seam="s", action="oom", times=1)])
        with pytest.raises(chaos.SyntheticOOM) as ei:
            chaos.fire("s")
        assert isinstance(classify_exception(ei.value), ResourceError)

    def test_profiles_install_and_bad_name_is_loud(self):
        chaos.install_profile("numerical")
        assert chaos.active()
        assert not R_chaos.active()          # the port keeps its own rules
        with pytest.raises(ValueError, match="numerical"):
            chaos.install_profile("no-such-profile")

    def test_poison_is_data_only_and_fire_is_control_only(self):
        chaos.install([chaos.Rule(seam="s", action="nan", times=None)])
        chaos.fire("s")                       # a nan rule never raises
        assert chaos.poison("s") and chaos.fired() == {"s:nan": 1}


class TestFallbackLadder:
    def test_als_to_eig_on_poisoned_sweep(self):
        # the sweep's output NaN once -> the ladder hops als->eig and
        # recovers
        chaos.install([chaos.Rule(seam="sweep_out", action="nan", at=0,
                                  times=1)])
        x = _rand((12, 10, 8), seed=1)
        cfg = TuckerConfig(ranks=(3, 3, 3), methods="als")
        with obs.capture() as buf:
            res = plan(x.shape, F32, cfg, device="cpu").execute(
                x, validate="finite")
        assert np.all(np.isfinite(res.tucker.core.numpy()))
        assert res.methods == ("eig",) * 3
        assert sum(chaos.fired().values()) >= 1
        assert fallback_hops() == {("als_to_eig", "matfree"): 1}
        (hop,) = [e for e in buf.events() if e["kind"] == "fallback"]
        assert hop["hop"] == "als_to_eig" and \
            hop["error"] == "NumericalError"

    def test_oom_hops_to_a_tighter_cap(self):
        chaos.install([chaos.Rule(seam="sweep", action="oom", at=0,
                                  times=1)])
        x = lowrank(WIDE, WIDE_RANKS, seed=2, noise=0.01)
        p = plan(WIDE, F32, TuckerConfig(ranks=WIDE_RANKS, methods="eig"),
                 device="cpu")
        res = p.execute(x)
        assert np.all(np.isfinite(res.tucker.core.numpy()))
        assert sum(chaos.fired().values()) == 1
        assert fallback_hops() == {("replan_cap", "matfree"): 1}
        # the registry holds the same count the view reads
        assert obs_metrics.REGISTRY.counter(A.HOPS_METRIC).value(
            hop="replan_cap", backend="matfree") == 1

    def test_persistent_oom_is_classified_and_bounded(self):
        # an OOM that never goes away must exhaust the (bounded) ladder and
        # surface as ResourceError — not loop forever, not escape raw
        chaos.install([chaos.Rule(seam="sweep", action="oom", times=None)])
        x = lowrank(WIDE, WIDE_RANKS, seed=3)
        p = plan(WIDE, F32, TuckerConfig(ranks=WIDE_RANKS), device="cpu")
        with pytest.raises(ResourceError):
            p.execute(x)
        assert sum(chaos.fired().values()) <= 4   # one attempt per rung

    def test_recorded_solve_seams(self):
        # the per-step runner carries the solve/solve_out seams: a raise
        # there is unclassified and raises as itself; a poisoned factor
        # is caught by its finite check and recovered by als->eig
        x = _rand((12, 10, 8), seed=4)
        p = plan(x.shape, F32, TuckerConfig(ranks=(3, 3, 3), methods="als"),
                 device="cpu")
        chaos.install([chaos.Rule(seam="solve", action="raise", at=1,
                                  message="solver seam")])
        with pytest.raises(chaos.ChaosFault, match="solver seam"):
            p.execute(x, record=True)
        chaos.reset()
        chaos.install([chaos.Rule(seam="solve_out", action="nan", at=0)])
        res = p.execute(x, record=True)
        assert res.methods == ("eig",) * 3
        assert fallback_hops() == {("als_to_eig", "matfree"): 1}

    def test_sketch_seam_is_classified(self):
        chaos.install([chaos.Rule(seam="sketch", action="oom", at=0)])
        x = _rand((16, 12, 10), seed=5)
        p = plan(x.shape, F32, TuckerConfig(error_target=0.3), device="cpu")
        with pytest.raises(ResourceError):
            p.execute(x)

    def test_nan_input_never_reaches_a_seam(self):
        chaos.install([chaos.Rule(seam="sweep", action="oom", times=None)])
        x = _rand((8, 8, 8), seed=6)
        x[2, :, :] = np.inf
        p = plan(x.shape, F32, TuckerConfig(ranks=(3, 3, 3)), device="cpu")
        with pytest.raises(InputError, match="mode 0"):
            p.execute(x, validate="finite")
        assert chaos.fired() == {}
