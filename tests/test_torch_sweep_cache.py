"""The port's sweep cache, ``execute_batch`` and ``for_shape``, held to the
reference's ``tests/test_api.py`` and to the reference itself.

On the CPU a cache entry is the eager sweep and ``CACHE_STATS["traces"]``
counts its first run, so the reference's counts hold as written.  On the
card an uncapped fixed-rank plan's entry is captured into CUDA graphs
(``repro_torch.core.graphs``); those tests need a CUDA device and skip
here.  ``execute_batch`` runs item by item through one cached sweep and
must equal a per-item loop of ``execute`` bitwise, and the reference's
``execute_batch`` (a vmapped program) at the kernel tests' fp32 tolerance,
2e-4 (``tests/test_kernels.py``), factors by projector.  ``for_shape``
plans must serialize exactly as the reference's.
"""

import json
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro_torch import kernels
from repro_torch.core import TuckerConfig, TuckerPlan, plan
from repro_torch.core import api as A
from repro_torch.core import graphs as G
from torch_parity import lowrank, max_projector_gap, reconstruct_np

TOL = dict(rtol=2e-4, atol=2e-4)   # tests/test_kernels.py, float32


@pytest.fixture(autouse=True)
def _fresh_cache():
    A.clear_sweep_cache()
    yield
    A.clear_sweep_cache()


class TestCacheStats:
    def test_plan_reuse_zero_retraces_zero_selections(self):
        selections = []

        def sel(*, i_n, r_n, j_n):
            selections.append((i_n, r_n, j_n))
            return "eig"

        x = lowrank((12, 10, 8), (3, 3, 2), noise=0.05)
        p = plan(x.shape, "float32", TuckerConfig(ranks=(3, 3, 2)),
                 selector=sel, device="cpu")
        assert len(selections) == 3
        p.execute(x)
        after_first = dict(A.CACHE_STATS)
        assert after_first["builds"] == 1 and after_first["traces"] == 1
        for s in range(5):
            p.execute(x + float(s))
        assert A.CACHE_STATS["traces"] == after_first["traces"]
        assert A.CACHE_STATS["builds"] == after_first["builds"]
        assert A.CACHE_STATS["hits"] == after_first["hits"] + 5
        assert len(selections) == 3   # zero at execute time

    def test_equivalent_plans_share_one_sweep(self):
        x = lowrank((10, 9, 8), (2, 3, 2))
        cfg = TuckerConfig(ranks=(2, 3, 2), methods="eig")
        plan(x.shape, "float32", cfg, device="cpu").execute(x)
        plan(x.shape, "float32", cfg, device="cpu").execute(x)
        assert A.CACHE_STATS == {"builds": 1, "hits": 1, "traces": 1}

    def test_batched_sweep_cached_separately(self):
        xs = np.stack([lowrank((10, 9, 8), (2, 3, 2), seed=s)
                       for s in range(2)])
        p = plan(xs.shape[1:], "float32",
                 TuckerConfig(ranks=(2, 3, 2), methods="eig"), device="cpu")
        p.execute_batch(xs)
        p.execute_batch(xs)
        assert A.CACHE_STATS == {"builds": 1, "hits": 1, "traces": 1}

    def test_cache_counts_equal_the_reference(self):
        x = lowrank((10, 9, 8), (2, 3, 2), seed=4)
        cfg = dict(ranks=(2, 3, 2), methods="eig")
        R.api.clear_sweep_cache()
        rp = R.plan(x.shape, jnp.float32, R.TuckerConfig(**cfg))
        p = plan(x.shape, "float32", TuckerConfig(**cfg), device="cpu")
        for _ in range(3):
            rp.execute(jnp.asarray(x))
            p.execute(x)
        rp.execute_batch(jnp.stack([jnp.asarray(x)] * 2))
        p.execute_batch(np.stack([x] * 2))
        assert A.CACHE_STATS == R.api.CACHE_STATS
        R.api.clear_sweep_cache()

    def test_key_separates_schedules_and_devices(self):
        p = plan((10, 9, 8), "float32",
                 TuckerConfig(ranks=(2, 3, 2), methods="eig"), device="cpu")
        q = plan((10, 9, 8), "float32",
                 TuckerConfig(ranks=(2, 3, 2), methods="als"), device="cpu")
        assert p._cache_key(False, False) != q._cache_key(False, False)
        assert p._cache_key(False, False) != p._cache_key(True, False)
        cuda = replace(p, device=torch.device("cuda", 0))
        assert cuda._cache_key(False, True) != p._cache_key(False, False)

    def test_clear_releases_entries(self):
        x = lowrank((10, 9, 8), (2, 3, 2))
        plan(x.shape, "float32", TuckerConfig(ranks=(2, 3, 2)),
             device="cpu").execute(x)
        assert A._SWEEP_CACHE
        A.clear_sweep_cache()
        assert not A._SWEEP_CACHE and A.CACHE_STATS == {
            "builds": 0, "hits": 0, "traces": 0}


class TestCaptureDecision:
    """Which plans capture is decided from the plan alone; on the CPU
    nothing captures (the checks build CUDA plans without running them)."""

    def _plan(self, **kw):
        return plan((12, 10, 8), "float32",
                    TuckerConfig(ranks=(3, 3, 3), **kw), device="cpu")

    def test_only_uncapped_fixed_rank_plans_on_the_card_capture(self):
        p = self._plan(methods=("eig", "als", "svd"))
        assert not p.captures
        assert replace(p, device=torch.device("cuda", 0)).captures
        capped = self._plan(methods="eig", memory_cap_bytes=1 << 30)
        assert not replace(capped, device=torch.device("cuda", 0)).captures
        adaptive = plan((12, 10, 8), "float32",
                        TuckerConfig(error_target=0.1), device="cpu")
        assert not replace(adaptive,
                           device=torch.device("cuda", 0)).captures

    @pytest.mark.parametrize("methods,segments", [
        ("als", 1), ("eig", 4), (("als", "eig", "als"), 2),
        (("svd", "rand", "als"), 3)])
    def test_segments_split_at_each_host_op(self, methods, segments):
        p = self._plan(methods=methods)
        assert p.graph_segments == segments == \
            1 + sum(G.HOST_OPS[m] for m in p.methods)
        text = replace(p, device=torch.device("cuda", 0)).describe()
        assert f"cuda graphs: {segments} segment(s)" in text
        assert "graph" not in p.describe()      # the CPU plan's text

    def test_describe_names_each_steps_segment(self):
        p = replace(self._plan(methods=("als", "eig", "als")),
                    device=torch.device("cuda", 0))
        steps = [ln for ln in p.describe().splitlines()
                 if ln.lstrip().startswith("step")]
        assert [ln.split()[-1] for ln in steps] == \
            ["graph=0", "graphs=0-1", "graph=1"]

    def test_graph_stats_is_none_without_a_captured_sweep(self):
        p = self._plan(methods="eig")
        p.execute(lowrank((12, 10, 8), (3, 3, 3)))
        assert p.graph_stats() is None


class TestCaptureHelpers:
    def test_seeded_draws_replay_from_the_warm_up(self):
        rec = G._Recorder(None)
        with G._active(rec):
            a = G.seeded_randn((4, 3), seed=0, dtype=torch.float32,
                               device=torch.device("cpu"))
        rec.capturing = True
        with G._active(rec):
            b = G.seeded_randn((4, 3), seed=0, dtype=torch.float32,
                               device=torch.device("cpu"))
            with pytest.raises(RuntimeError, match="warm-up"):
                rec.constants.append(torch.zeros(2))
                G.seeded_randn((4, 3), seed=0, dtype=torch.float32,
                               device=torch.device("cpu"))
        assert b is a
        fresh = G.seeded_randn((4, 3), seed=0, dtype=torch.float32,
                               device=torch.device("cpu"))
        assert torch.equal(fresh, a) and fresh is not a

    def test_host_ops_run_eagerly_outside_a_capture(self):
        a = torch.tensor([[2.0, 1.0], [1.0, 3.0]])
        w, v = G.eigh(a)
        torch.testing.assert_close(w, torch.linalg.eigh(a)[0])
        u, s, vh = G.svd(torch.eye(3)[:, :2])
        assert s.shape == (2,)

    def test_launch_deltas_round_trip(self):
        before = kernels.launch_snapshot()
        kernels.add_launches({("ttt", None): 2, ("ttt", "tile16/gram"): 2,
                              ("s6_scan", None): 64})
        delta = kernels.launches_since(before)
        assert delta == {("ttt", None): 2, ("ttt", "tile16/gram"): 2,
                         ("s6_scan", None): 64}
        kernels.add_launches(delta, -1)
        assert kernels.launch_snapshot() == before


EXEC_CASES = [
    ("sthosvd", "eig", "matfree"), ("sthosvd", "als", "matfree"),
    ("sthosvd", ("eig", "als", "svd"), "hopper"),
    ("thosvd", "eig", "hopper"), ("hooi", "eig", "matfree")]


class TestExecuteBatch:
    @pytest.mark.parametrize("variant,methods,impl", EXEC_CASES)
    def test_bitwise_equal_to_a_per_item_loop(self, variant, methods, impl):
        xs = torch.from_numpy(np.stack([
            lowrank((10, 9, 8), (2, 3, 2), seed=s, noise=0.05)
            for s in range(3)]))
        p = plan(xs.shape[1:], "float32", TuckerConfig(
            ranks=(2, 3, 2), variant=variant, methods=methods, impl=impl,
            hooi_iters=1), device="cpu")
        batch = p.execute_batch(xs)
        assert len(batch) == 3
        for b, got in enumerate(batch):
            want = p.execute(xs[b])
            assert torch.equal(got.tucker.core, want.tucker.core)
            for u, v in zip(got.tucker.factors, want.tucker.factors):
                assert torch.equal(u, v)
            assert [t.method for t in got.trace] == \
                [s.method for s in p.schedule]
            assert got.trace[0].backend == impl

    @pytest.mark.parametrize("variant", ["sthosvd", "thosvd", "hooi"])
    def test_matches_the_references_execute_batch(self, variant):
        xs = np.stack([lowrank((12, 10, 8), (3, 3, 2), seed=10 + s,
                               noise=0.02) for s in range(3)])
        cfg = dict(ranks=(3, 3, 2), variant=variant, methods="eig",
                   hooi_iters=1)
        got = plan(xs.shape[1:], "float32", TuckerConfig(**cfg),
                   device="cpu").execute_batch(xs)
        want = R.plan(xs.shape[1:], jnp.float32,
                      R.TuckerConfig(**cfg)).execute_batch(jnp.asarray(xs))
        for b in range(xs.shape[0]):
            g, w = got[b].tucker, want[b].tucker
            assert max_projector_gap(g.factors, w.factors) <= TOL["atol"]
            np.testing.assert_allclose(
                reconstruct_np(g.core, g.factors),
                reconstruct_np(w.core, w.factors), rtol=TOL["rtol"],
                atol=TOL["atol"] * float(np.abs(xs[b]).max()))

    def test_adaptive_plans_run_item_by_item(self):
        xs = np.stack([lowrank((12, 10, 8), (3, 3, 2), seed=s, noise=0.01)
                       for s in range(2)])
        p = plan(xs.shape[1:], "float32",
                 TuckerConfig(error_target=0.1, methods="rand"),
                 device="cpu")
        for b, got in enumerate(p.execute_batch(xs)):
            want = p.execute(xs[b])
            assert got.tucker.ranks == want.tucker.ranks
            assert got.error_bound == want.error_bound
            assert torch.equal(got.tucker.core, want.tucker.core)

    def test_validation_is_the_references(self):
        p = plan((10, 12, 9), "float32",
                 TuckerConfig(ranks=(2, 2, 2), methods="eig"), device="cpu")
        with pytest.raises(ValueError, match="batches of shape"):
            p.execute_batch(np.zeros((2, 10, 12, 8), np.float32))
        with pytest.raises(ValueError, match="dtype"):
            p.execute_batch(np.zeros((2, 10, 12, 9), np.float64))
        rp = R.plan((10, 12, 9), jnp.float32,
                    R.TuckerConfig(ranks=(2, 2, 2), methods="eig"))
        with pytest.raises(ValueError, match="batches of shape"):
            rp.execute_batch(jnp.zeros((2, 10, 12, 8), jnp.float32))


FOR_SHAPE_CASES = [
    (dict(ranks=(4, 4, 4), methods="auto"), (16, 16, 16), (13, 12, 11)),
    (dict(ranks=(4, 4, 4), mode_order="shrink"), (16, 16, 16),
     (12, 11, 10)),
    (dict(ranks=(3, 5, 2), methods="auto", mode_order="opt"), (24, 40, 16),
     (20, 33, 12)),
    (dict(ranks=(3, 3, 3), variant="hooi", hooi_iters=2), (16, 14, 12),
     (15, 13, 11)),
    (dict(error_target=0.1, rank_grid=(2, 4, 6)), (16, 16, 16),
     (12, 14, 10)),
]


class TestForShape:
    @pytest.mark.parametrize("keep_methods", [False, True])
    @pytest.mark.parametrize("cfg,base_shape,shape", FOR_SHAPE_CASES)
    def test_plan_json_equals_the_references(self, cfg, base_shape, shape,
                                             keep_methods):
        base = plan(base_shape, "float32", TuckerConfig(**cfg),
                    device="cpu")
        rbase = R.plan(base_shape, jnp.float32, R.TuckerConfig(**cfg))
        got = base.for_shape(shape, keep_methods=keep_methods)
        want = rbase.for_shape(shape, keep_methods=keep_methods)
        d, w = got.to_dict(), want.to_dict()
        d.pop("select_seconds")
        w.pop("select_seconds")
        assert d == w
        assert got.device == base.device
        if not keep_methods:     # the same plan a direct plan() gives
            direct = plan(shape, "float32", TuckerConfig(**cfg),
                          device="cpu").to_dict()
            direct.pop("select_seconds")
            assert d == direct

    def test_same_shape_is_the_plan_and_order_must_match(self):
        base = plan((16, 16, 16), "float32",
                    TuckerConfig(ranks=(4, 4, 4)), device="cpu")
        assert base.for_shape((16, 16, 16)) is base
        with pytest.raises(ValueError, match="order-3"):
            base.for_shape((16, 16))

    def test_keep_methods_makes_no_selector_call(self):
        calls = []

        def sel(*, i_n, r_n, j_n):
            calls.append(i_n)
            return "als"

        base = plan((16, 16, 16), "float32",
                    TuckerConfig(ranks=(4, 4, 4)), selector=sel,
                    device="cpu")
        n = len(calls)
        pinned = base.for_shape((12, 11, 10), keep_methods=True)
        assert len(calls) == n and pinned.methods == ("als",) * 3
        json.loads(pinned.to_json())


class TestOnTheCard:
    """Capture needs a CUDA device (chip_smoke.py's graphs phase runs the
    full-size check); these skip elsewhere."""

    def test_captured_sweep_is_bitwise_the_eager_one(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
        x = torch.from_numpy(lowrank((40, 36, 30), (4, 5, 3), seed=1,
                                     noise=0.05)).cuda()
        for methods in ("als", ("eig", "als", "svd")):
            A.clear_sweep_cache()
            p = plan(x.shape, "float32", TuckerConfig(
                ranks=(4, 5, 3), methods=methods, impl="hopper"))
            assert p.captures
            eager = p._run(x, False).tucker
            kernels.reset_launch_counts()
            p._run(x, False)
            eager_counts = kernels.launch_counts()
            for _ in range(3):
                got = p.execute(x).tucker
            kernels.reset_launch_counts()
            got = p.execute(x).tucker
            assert kernels.launch_counts() == eager_counts
            assert torch.equal(got.core, eager.core)
            for u, v in zip(got.factors, eager.factors):
                assert torch.equal(u, v)
            stats = p.graph_stats()
            assert stats["segments"] == p.graph_segments
            assert A.CACHE_STATS == {"builds": 1, "hits": 3,
                                     "traces": p.graph_segments}

    def test_execute_returns_clones(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
        xs = [torch.from_numpy(lowrank((20, 18, 16), (3, 3, 3), seed=s))
              .cuda() for s in range(2)]
        p = plan(xs[0].shape, "float32", TuckerConfig(ranks=(3, 3, 3),
                                                     methods="als"))
        first = p.execute(xs[0]).tucker.core.clone()
        kept = p.execute(xs[0]).tucker.core
        p.execute(xs[1])
        assert torch.equal(kept, first)
        assert isinstance(p, TuckerPlan)
