"""The port's streaming Tucker service (``repro_torch.serve``), held to the
reference's ``tests/test_service.py`` class by class and to the reference
itself.

Every service here runs on ``device="cpu"``.  Bitwise claims hold the port
against the port: a request padded up to a shape bucket in exact mode comes
back bitwise-equal to the port's unpadded ``decompose``.  Cross-package
claims feed the same numpy stream (``torch_parity.lowrank`` inputs) to
``repro.serve.TuckerService`` and the port's: equal bucket labels,
counters and ranks, factors within a projector gap of 1e-3 and
``rel_error`` within 1e-4.

Two standing differences from the reference are pinned here:
``TestLaneBounding`` (the port's batched sweep runs item by item, so waves
carry no zero-filled lanes and a bucket has ONE batched cache entry
whatever the wave size) and the ``device=`` argument (None = ``cuda:0``,
raising without CUDA).  Also here: the engine cases of the reference's
``test_api.py``/``test_backend.py``, the error-targeted request of
``test_adaptive.py`` and the serve slice of ``test_obs.py``.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.serve as RS
from _hypothesis_compat import given, settings, st
from repro_torch import obs
from repro_torch.core import TuckerConfig, decompose, plan as make_plan
from repro_torch.core import api as A
from repro_torch.core.cost_model import CostModel
from repro_torch.core.schedule_opt import MemoryCapError
from repro_torch.obs import drift as drift_mod
from repro_torch.obs import export as export_mod
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serve import (
    BucketPolicy,
    RejectedError,
    ServiceClosed,
    TuckerBatchEngine,
    TuckerRequest,
    TuckerService,
    pad_block,
    pad_waste,
    slice_valid,
    trim_result,
)
from torch_parity import lowrank, max_projector_gap, rel_error_np

CPU = "cpu"
CFG = TuckerConfig(ranks=(3, 3, 3), methods="eig")
#: cross-package limits (the port's parity tests: projector, rel_error)
PROJ_ATOL, REL_ATOL = 1e-3, 1e-4


def tensor(shape, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dtype)


def service(**kw):
    return TuckerService(device=CPU, **kw)


def parts(res):
    return [res.tucker.core, *res.tucker.factors]


def bitwise_equal(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(parts(a), parts(b)))


@pytest.fixture(autouse=True)
def _clean():
    A.clear_sweep_cache()
    yield
    obs.disable()
    A.clear_sweep_cache()


# ---------------------------------------------------------------------------
# bucket policy
# ---------------------------------------------------------------------------

class TestBucketPolicy:
    def test_rounds_each_dim_up_to_grid(self):
        pol = BucketPolicy(grid=8, max_pad_ratio=10.0)
        assert pol.bucket_shape((13, 10, 9)) == (16, 16, 16)
        assert pol.bucket_shape((16, 8, 24)) == (16, 8, 24)

    def test_per_mode_grid(self):
        pol = BucketPolicy(grid=(4, 8, 16), max_pad_ratio=10.0)
        assert pol.bucket_shape((5, 5, 5)) == (8, 8, 16)
        with pytest.raises(ValueError):
            pol.bucket_shape((5, 5, 5, 5))   # no grid entry for mode 3

    def test_max_pad_ratio_falls_back_to_exact_bucket(self):
        pol = BucketPolicy(grid=8, max_pad_ratio=2.0)
        assert pol.bucket_shape((9, 9, 9)) == (9, 9, 9)
        assert pol.bucket_shape((15, 14, 13)) == (16, 16, 16)  # 1.5x: ok

    def test_exact_policy_is_identity(self):
        pol = BucketPolicy.exact()
        assert pol.bucket_shape((13, 10, 9)) == (13, 10, 9)
        assert pol.wave_slots is None
        assert pol.lanes_for(5) == 5

    def test_lane_pow2_rounds_up_and_caps_at_wave_slots(self):
        pol = BucketPolicy(wave_slots=8)
        assert [pol.lanes_for(n) for n in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]

    def test_validation(self):
        with pytest.raises(ValueError):
            BucketPolicy(grid=0)
        with pytest.raises(ValueError):
            BucketPolicy(pad_mode="clip")
        with pytest.raises(ValueError):
            BucketPolicy(max_pad_ratio=0.5)
        with pytest.raises(ValueError):
            BucketPolicy(wave_slots=0)

    def test_pad_slice_roundtrip_is_bitwise_lossless(self):
        x = tensor((7, 6, 5), seed=3)
        padded = pad_block(x, (8, 8, 8))
        assert tuple(padded.shape) == (8, 8, 8)
        assert torch.equal(slice_valid(padded, x.shape), x)
        assert pad_waste(x.shape, (8, 8, 8)) == pytest.approx(1 - 210 / 512)
        with pytest.raises(ValueError):
            pad_block(x, (6, 8, 8))   # does not fit

    def test_pad_widths_follow_mode_order(self):
        """A different pad per mode: F.pad takes its pairs from the last
        dim backwards, the reference's jnp.pad widths are in mode order."""
        x = tensor((7, 5, 3, 2), seed=4)
        bucket = (8, 9, 12, 6)
        got = pad_block(x, bucket)
        want = np.pad(x.numpy(), [(0, b - s) for s, b in zip(x.shape, bucket)])
        assert tuple(got.shape) == bucket
        assert np.array_equal(got.numpy(), want)
        ref = RS.pad_block(jnp.asarray(x.numpy()), bucket)
        assert np.array_equal(got.numpy(), np.asarray(ref))

    @pytest.mark.parametrize("grid,ratio,shapes", [
        (8, 2.0, [(13, 10, 9), (9, 9, 9), (15, 14, 13), (16, 8, 24)]),
        ((8, 8, 1, 1), 2.0, [(505, 512, 33, 8), (511, 506, 33, 8)]),
        (8, 8.0, [(43, 35, 27), (64, 48, 32), (59, 45, 29)]),
    ])
    def test_bucket_shapes_equal_the_reference(self, grid, ratio, shapes):
        pol = BucketPolicy(grid=grid, max_pad_ratio=ratio)
        ref = RS.BucketPolicy(grid=grid, max_pad_ratio=ratio)
        for s in shapes:
            assert pol.bucket_shape(s) == ref.bucket_shape(s)
        for n in range(1, 10):
            assert pol.lanes_for(n) == ref.lanes_for(n)


# ---------------------------------------------------------------------------
# padding parity (exact mode: bitwise the port's unpadded execution)
# ---------------------------------------------------------------------------

class TestPaddingBitwise:
    @pytest.mark.parametrize("method,dtype", [
        ("eig", torch.float32), ("als", torch.float32),
        ("eig", torch.bfloat16), ("als", torch.bfloat16),
    ])
    @settings(max_examples=10, deadline=None)
    @given(dims=st.tuples(st.integers(9, 15), st.integers(9, 15),
                          st.integers(9, 15)))
    def test_padded_request_bitwise_equals_unpadded_execution(
            self, method, dtype, dims):
        cfg = TuckerConfig(ranks=(3, 3, 3), methods=(method,) * 3)
        x = tensor(dims, seed=sum(dims), dtype=dtype)
        svc = service(policy=BucketPolicy(grid=8, max_pad_ratio=8.0))
        t = svc.submit(x, cfg)
        assert t.bucket == (16, 16, 16) and t.padded == (dims != (16,) * 3)
        svc.drain()
        res = svc.poll(t)
        ref = decompose(x, cfg, device=CPU)   # unpadded singleton execution
        assert bitwise_equal(res, ref)

    def test_padded_and_exact_members_mix_in_one_bucket(self):
        svc = service(policy=BucketPolicy(grid=8, max_pad_ratio=8.0))
        xs = [tensor((16, 16, 16), seed=1), tensor((12, 11, 10), seed=2),
              tensor((16, 16, 16), seed=3), tensor((9, 16, 13), seed=4)]
        ts = [svc.submit(x, CFG) for x in xs]
        svc.drain()
        for x, t in zip(xs, ts):
            assert bitwise_equal(svc.poll(t), decompose(x, CFG, device=CPU))
        st_ = svc.stats()
        assert st_["requests"] == 4 and st_["n_buckets"] == 1
        (bucket,) = st_["buckets"].values()
        assert bucket["padded"] == 2
        assert 0.0 < bucket["pad_waste"] < 1.0


# ---------------------------------------------------------------------------
# mask mode (throughput path: one batched wave, trimmed factors)
# ---------------------------------------------------------------------------

class TestMaskMode:
    @pytest.mark.parametrize("method", ["eig", "als"])
    def test_slack_rows_come_back_exactly_zero(self, method):
        cfg = TuckerConfig(ranks=(3, 3, 3), methods=(method,) * 3)
        x = tensor((13, 12, 11), seed=5)
        p = make_plan((16, 16, 16), x.dtype, cfg, device=CPU)
        res = p.execute(pad_block(x, (16, 16, 16)))
        for u, s in zip(res.tucker.factors, x.shape):
            assert bool((u[s:] == 0.0).all())   # zero slack propagates

    def test_mixed_wave_fuses_and_matches_unpadded_quality(self):
        svc = service(policy=BucketPolicy(grid=8, max_pad_ratio=8.0,
                                          pad_mode="mask"))
        xs = [tensor((13, 12, 11), seed=6), tensor((16, 16, 16), seed=7),
              tensor((10, 15, 9), seed=8)]
        ts = [svc.submit(x, CFG) for x in xs]
        svc.drain()
        st_ = svc.stats()
        assert st_["batches"] == 1          # the whole mixed wave fused
        for x, t in zip(xs, ts):
            res = svc.poll(t)
            for u, s in zip(res.tucker.factors, x.shape):
                assert u.shape[0] == s      # trimmed to the true shape
                g = u.T @ u                 # orthonormal columns kept
                assert float((g - torch.eye(g.shape[0])).abs().max()) < 1e-4
            ref = decompose(x, CFG, device=CPU)
            assert float(res.tucker.rel_error(x)) < \
                float(ref.tucker.rel_error(x)) + 1e-4

    def test_trim_result_preserves_trace(self):
        x = tensor((13, 12, 11), seed=9)
        p = make_plan((16, 16, 16), x.dtype, CFG, device=CPU)
        res = p.execute(pad_block(x, (16, 16, 16)))
        trimmed = trim_result(res, x.shape)
        assert trimmed.tucker.core.shape == res.tucker.core.shape
        assert trimmed.trace is res.trace


# ---------------------------------------------------------------------------
# plan reuse hook
# ---------------------------------------------------------------------------

class TestForShape:
    def test_default_matches_direct_plan(self):
        base = make_plan((16, 16, 16), "float32", CFG, device=CPU)
        derived = base.for_shape((13, 12, 11))
        direct = make_plan((13, 12, 11), "float32", CFG, device=CPU)
        assert derived.shape == (13, 12, 11)
        assert derived.schedule == direct.schedule
        assert derived._cache_key(False, False) == \
            direct._cache_key(False, False)

    def test_same_shape_returns_self(self):
        base = make_plan((16, 16, 16), "float32", CFG, device=CPU)
        assert base.for_shape((16, 16, 16)) is base

    def test_keep_methods_pins_bucket_solvers_and_order(self):
        cfg = TuckerConfig(ranks=(3, 3, 3), methods=("als", "eig", "als"),
                           mode_order=(2, 0, 1))
        base = make_plan((16, 16, 16), "float32", cfg, device=CPU)
        derived = base.for_shape((12, 11, 10), keep_methods=True)
        assert derived.methods == base.methods
        assert tuple(s.mode for s in derived.schedule) == \
            tuple(s.mode for s in base.schedule)

    def test_order_mismatch_raises(self):
        base = make_plan((16, 16, 16), "float32", CFG, device=CPU)
        with pytest.raises(ValueError):
            base.for_shape((16, 16))


# ---------------------------------------------------------------------------
# admission: backpressure, validation, lifecycle, device
# ---------------------------------------------------------------------------

class TestAdmission:
    def test_reject_policy_raises_and_counts(self):
        svc = service(max_queue=2)
        x = tensor((8, 8, 8))
        svc.submit(x, CFG)
        svc.submit(x, CFG)
        with pytest.raises(RejectedError):
            svc.submit(x, CFG)
        assert svc.stats()["rejected"] == 1
        svc.drain()
        svc.submit(x, CFG)   # space again after the wave completed
        svc.drain()
        assert svc.stats()["requests"] == 3

    def test_block_policy_pumps_inline_without_worker(self):
        svc = service(max_queue=1, backpressure="block")
        x = tensor((8, 8, 8))
        ts = [svc.submit(x, CFG) for _ in range(3)]   # each submit frees space
        svc.drain()
        assert all(svc.poll(t) is not None for t in ts)

    def test_bad_ranks_fail_at_submit(self):
        svc = service()
        with pytest.raises(ValueError):
            svc.submit(tensor((8, 8, 8)), TuckerConfig(ranks=(9, 2, 2)))
        assert svc.stats()["submitted"] == 0

    def test_closed_service_refuses_submissions(self):
        svc = service()
        t = svc.submit(tensor((8, 8, 8)), CFG)
        svc.close()
        assert svc.poll(t) is not None   # close() drained
        with pytest.raises(ServiceClosed):
            svc.submit(tensor((8, 8, 8)), CFG)

    def test_plan_failure_surfaces_through_poll(self):
        svc = service(memory_cap_bytes=64)   # nothing fits 64 bytes
        t = svc.submit(tensor((8, 8, 8)), CFG)
        svc.drain()
        with pytest.raises(MemoryCapError):
            svc.poll(t)
        assert svc.stats()["failed"] == 1

    def test_wave_slots_bound_batch_size(self):
        svc = service(policy=BucketPolicy(grid=1, wave_slots=2,
                                          lane_pow2=False))
        ts = [svc.submit(tensor((8, 8, 8), seed=i), CFG) for i in range(5)]
        svc.drain()
        assert svc.stats()["batches"] == 3   # ceil(5 / 2)
        assert all(svc.poll(t) is not None for t in ts)

    def test_default_device_is_cuda0_and_raises_without_cuda(self):
        if torch.cuda.is_available():
            assert TuckerService().device == torch.device("cuda", 0)
            assert TuckerBatchEngine().service.device == \
                torch.device("cuda", 0)
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                TuckerService()
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                TuckerBatchEngine()

    def test_numpy_input_is_placed_and_plans_get_the_device(self):
        svc = service()
        x = lowrank((8, 7, 6), (2, 2, 2), seed=1)
        t = svc.submit(x, TuckerConfig(ranks=(2, 2, 2), methods="eig"))
        assert isinstance(t._job.x, torch.Tensor)
        assert t._job.x.device == torch.device(CPU)
        svc.drain()
        assert svc.poll(t).tucker.core.device == torch.device(CPU)
        assert all(p.device == torch.device(CPU) for p in svc._plans.values())

    def test_input_that_requires_grad_is_served_detached(self):
        x = tensor((8, 8, 8), seed=2).requires_grad_()
        svc = service()
        svc.start()
        res = svc.wait(svc.submit(x, CFG), timeout=120)
        svc.stop()
        assert not res.tucker.core.requires_grad
        assert bitwise_equal(res, decompose(x.detach(), CFG, device=CPU))


# ---------------------------------------------------------------------------
# async worker
# ---------------------------------------------------------------------------

class TestAsync:
    def test_submit_poll_wait_through_worker(self, tmp_path):
        trace = tmp_path / "trace.jsonl"
        with service(policy=BucketPolicy(grid=8, max_pad_ratio=8.0),
                     max_queue=64, trace_path=trace) as svc:
            svc.start()
            xs = [tensor((13, 12, 11), seed=i) for i in range(5)]
            ts = [svc.submit(x, CFG) for x in xs]
            res = [svc.wait(t, timeout=120) for t in ts]
            assert all(r is not None for r in res)
            for x, r in zip(xs, res):
                assert bitwise_equal(r, decompose(x, CFG, device=CPU))
            st_ = svc.stats()
            assert st_["requests"] == 5 and st_["pending"] == 0
            assert st_["latency"]["p95_ms"] > 0.0
        kinds = [json.loads(l)["kind"] for l in trace.read_text().splitlines()]
        assert kinds.count("submit") == 5 and kinds.count("done") == 5
        assert "wave" in kinds

    def test_block_backpressure_against_worker(self):
        with service(max_queue=2, backpressure="block") as svc:
            svc.start()
            ts = [svc.submit(tensor((8, 8, 8), seed=i), CFG)
                  for i in range(6)]   # submits block until the worker frees space
            assert all(svc.wait(t, timeout=120) is not None for t in ts)

    def test_stop_drains_by_default(self):
        svc = service()
        svc.start()
        t = svc.submit(tensor((8, 8, 8)), CFG)
        svc.stop()
        assert svc.poll(t) is not None


# ---------------------------------------------------------------------------
# engine compatibility wrapper
# ---------------------------------------------------------------------------

class TestEngineParity:
    def test_results_and_stats_match_grouped_execution(self):
        """The engine reproduces grouped execution exactly: same grouping,
        same plan reuse, the same batched-sweep results, same counters."""
        cfg_a = TuckerConfig(ranks=(2, 3, 2), methods="eig")
        cfg_b = TuckerConfig(ranks=(2, 2, 2), methods="eig")
        reqs = [TuckerRequest(x=tensor((10, 9, 8), seed=s), config=cfg_a,
                              rid=s) for s in range(4)]
        reqs += [TuckerRequest(x=tensor((6, 7, 5), seed=9), config=cfg_b,
                               rid=99)]
        eng = TuckerBatchEngine(device=CPU)
        eng.run(reqs)
        p_a = make_plan((10, 9, 8), "float32", cfg_a, device=CPU)
        p_b = make_plan((6, 7, 5), "float32", cfg_b, device=CPU)
        ref_batch = p_a.execute_batch(torch.stack([r.x for r in reqs[:4]]))
        ref_single = p_b.execute(reqs[4].x)
        for r, ref in zip(reqs[:4], ref_batch):
            assert bitwise_equal(r.result, ref)
        assert bitwise_equal(reqs[4].result, ref_single)
        stats = eng.stats
        assert stats["plans_built"] == 2
        assert stats["requests"] == 5
        assert stats["batches"] == 2
        assert stats["backends"] == {p_a.backend: 5}
        # second wave, same shapes: no new plans (warm-path parity)
        eng.run([TuckerRequest(x=tensor((10, 9, 8), seed=7), config=cfg_a)])
        assert eng.stats["plans_built"] == 2
        assert eng.stats["batches"] == 3

    def test_engine_never_pads(self):
        eng = TuckerBatchEngine(device=CPU)
        r = TuckerRequest(x=tensor((13, 11, 9), seed=1), config=CFG)
        eng.run([r])
        (bucket,) = eng.stats["buckets"].values()
        assert bucket["padded"] == 0 and bucket["pad_waste"] == 0.0

    def test_engine_propagates_plan_errors(self):
        eng = TuckerBatchEngine(memory_cap_bytes=64, device=CPU)
        with pytest.raises(MemoryCapError):
            eng.run([TuckerRequest(x=tensor((8, 8, 8)), config=CFG)])

    # -- the reference's test_api.py TestServeEngine ------------------------
    def test_groups_by_shape_and_reuses_plans(self):
        eng = TuckerBatchEngine(device=CPU)
        cfg = TuckerConfig(ranks=(2, 3, 2), methods="eig")
        reqs = [TuckerRequest(x=lowrank((10, 9, 8), (2, 3, 2), seed=s),
                              config=cfg, rid=s) for s in range(5)]
        reqs += [TuckerRequest(x=lowrank((6, 7, 5), (2, 2, 2), seed=9),
                               config=TuckerConfig(ranks=(2, 2, 2),
                                                   methods="eig"), rid=99)]
        done = eng.run(reqs)
        assert all(r.result is not None for r in done)
        assert eng.stats["plans_built"] == 2       # one per (shape, config)
        for r in done:
            assert float(r.result.tucker.rel_error(r.x)) < 1e-3
        eng.run([TuckerRequest(x=lowrank((10, 9, 8), (2, 3, 2), seed=7),
                               config=cfg, rid=7)])
        assert eng.stats["plans_built"] == 2

    # -- the reference's test_backend.py engine cases -----------------------
    def test_engine_backend_axis(self):
        eng = TuckerBatchEngine(impl="hopper", device=CPU)
        cfg = TuckerConfig(ranks=(2, 2, 2), methods="eig")
        reqs = [TuckerRequest(x=lowrank((8, 7, 6), (2, 2, 2), seed=s),
                              config=cfg, rid=s) for s in range(3)]
        eng.run(reqs)
        assert eng.stats["backends"] == {"hopper": 3}
        assert all(r.result is not None for r in reqs)

    def test_engine_pin_merges_mixed_impl_groups(self):
        """Requests differing only in the overridden impl field batch as one
        wave under an engine-level pin."""
        eng = TuckerBatchEngine(impl="matfree", device=CPU)
        reqs = [TuckerRequest(x=lowrank((8, 7, 6), (2, 2, 2), seed=s),
                              config=TuckerConfig(ranks=(2, 2, 2),
                                                  methods="eig", impl=impl),
                              rid=s)
                for s, impl in enumerate(("auto", "explicit", "matfree"))]
        eng.run(reqs)
        assert eng.stats["batches"] == 1
        assert eng.stats["plans_built"] == 1
        assert all(r.result is not None for r in reqs)


# ---------------------------------------------------------------------------
# autotune flywheel integration
# ---------------------------------------------------------------------------

class TestRecordFlywheel:
    def test_service_record_feeds_store_roundtrip(self, tmp_path):
        from repro_torch.tune import RecordStore
        from repro_torch.tune.records import HARVEST

        store = RecordStore(tmp_path / "records.jsonl")
        svc = service(policy=BucketPolicy(grid=8, max_pad_ratio=8.0),
                      record=True, record_store=store)
        x = tensor((13, 12, 11), seed=4)
        t = svc.submit(x, CFG)
        t2 = svc.submit(tensor((16, 16, 16), seed=5), CFG)
        svc.drain()
        assert svc.poll(t) is not None and svc.poll(t2) is not None
        ms = store.load()
        assert len(ms) == 6                      # 2 requests x 3 modes
        assert all(m.source == HARVEST for m in ms)
        assert all(m.seconds > 0 for m in ms)
        # the padded request is recorded at its TRUE per-mode sizes
        assert {m.i_n for m in ms} == {13, 12, 11, 16}

    def test_ambient_recording_context_reaches_waves(self, tmp_path):
        from repro_torch.tune import RecordStore, recording

        store = RecordStore(tmp_path / "records.jsonl")
        svc = service()
        t = svc.submit(tensor((8, 8, 8)), CFG)
        with recording(store):
            svc.drain()
        assert svc.poll(t) is not None
        assert len(store.load()) == 3            # one per mode

    def test_engine_record_passthrough(self, tmp_path):
        from repro_torch.tune import RecordStore

        store = RecordStore(tmp_path / "records.jsonl")
        eng = TuckerBatchEngine(record=True, record_store=store, device=CPU)
        eng.run([TuckerRequest(x=tensor((8, 8, 8), seed=i), config=CFG)
                 for i in range(2)])
        assert len(store.load()) == 6


# ---------------------------------------------------------------------------
# batched-sweep bounding (the port's counterpart of lane fill)
# ---------------------------------------------------------------------------

class TestLaneBounding:
    def test_one_batched_sweep_per_bucket_whatever_the_wave_size(self):
        """Waves of 3, 5, 6, 7 requests run through ONE batched cache entry
        (built and first run once) with no zero-filled lanes: the port's
        batched sweep runs item by item, so the reference's power-of-two
        lane fill would only add whole decompositions of zeros."""
        cfg = TuckerConfig(ranks=(2, 2, 2), methods="eig")
        svc = service(policy=BucketPolicy(grid=8, wave_slots=8))
        before = dict(A.CACHE_STATS)
        for n in (3, 5, 6, 7):
            ts = [svc.submit(tensor((8, 8, 8), seed=100 + n + i), cfg)
                  for i in range(n)]
            svc.drain()
            assert all(svc.poll(t) is not None for t in ts)
        assert A.CACHE_STATS["builds"] - before["builds"] == 1
        assert A.CACHE_STATS["traces"] - before["traces"] == 1
        assert A.CACHE_STATS["hits"] - before["hits"] == 3
        (snap,) = svc.stats()["buckets"].values()
        assert snap["waves"] == 4 and snap["occupancy"] == 1.0


# ---------------------------------------------------------------------------
# cross-wave pipelining
# ---------------------------------------------------------------------------

class TestPipelining:
    def test_inflight_depth_validated(self):
        for bad in (0, -1):
            with pytest.raises(ValueError):
                service(max_inflight_waves=bad)

    def test_stats_expose_depth_and_occupancy(self):
        svc = service(max_inflight_waves=3)
        t = svc.submit(tensor((8, 8, 8)), CFG)
        svc.drain()
        s = svc.stats()
        assert s["max_inflight_waves"] == 3
        (snap,) = s["buckets"].values()
        assert {"pipelined_waves", "pipeline_occupancy",
                "avg_inflight"} <= snap.keys()
        assert snap["pipelined_waves"] == 0
        assert snap["pipeline_occupancy"] == 0.0
        assert svc.poll(t) is not None

    def _run(self, depth, n=6):
        svc = service(policy=BucketPolicy(grid=1, wave_slots=2,
                                          lane_pow2=False),
                      max_inflight_waves=depth)
        ts = [svc.submit(tensor((8, 8, 8), seed=s), CFG) for s in range(n)]
        svc.drain()
        res = [svc.poll(t) for t in ts]
        assert all(r is not None for r in res)
        return svc, res

    def test_serial_and_pipelined_results_bitwise_equal(self):
        _, serial = self._run(depth=1)
        _, piped = self._run(depth=3)
        for a, b in zip(serial, piped):
            assert bitwise_equal(a, b)

    def test_pipelined_waves_counted(self):
        svc1, _ = self._run(depth=1)
        (snap1,) = svc1.stats()["buckets"].values()
        assert snap1["waves"] == 3
        assert snap1["pipelined_waves"] == 0      # depth 1 = serial dispatch
        assert snap1["avg_inflight"] == 0.0

        svc3, _ = self._run(depth=3)
        (snap3,) = svc3.stats()["buckets"].values()
        assert snap3["waves"] == 3
        assert snap3["pipelined_waves"] >= 1      # later waves overlapped
        assert 0.0 < snap3["pipeline_occupancy"] <= 1.0
        assert snap3["avg_inflight"] > 0.0


# ---------------------------------------------------------------------------
# error-targeted requests (the reference's test_adaptive.py TestServeAdaptive)
# ---------------------------------------------------------------------------

class TestServeAdaptive:
    def test_service_serves_error_targeted_requests(self):
        eps = 0.05
        x = lowrank((60, 40, 24), (6, 5, 4), noise=0.01)
        cfg = TuckerConfig(error_target=eps)
        with service() as svc:
            svc.start()
            res = svc.wait(svc.submit(x, cfg), timeout=120)
            stats = svc.stats()
        assert float(res.tucker.rel_error(x)) <= eps
        assert res.error_bound is not None and res.error_bound <= eps
        labels = list(stats["buckets"])
        assert any(label.endswith(f"/re{eps:g}") for label in labels), labels


# ---------------------------------------------------------------------------
# observability (the serve slice of the reference's test_obs.py)
# ---------------------------------------------------------------------------

class TestServiceObservability:
    SHAPE, RANKS = (16, 18, 20), (4, 4, 4)

    def _x(self, seed=0):
        return tensor(self.SHAPE, seed=seed)

    def test_absorb_service_stats(self):
        svc = service(policy=BucketPolicy(grid=8, wave_slots=2))
        svc.submit(self._x(), TuckerConfig(ranks=self.RANKS, methods="eig"))
        svc.drain()
        stats = svc.stats()
        svc.stop()
        reg = obs_metrics.MetricsRegistry()
        obs_metrics.absorb_service_stats(stats, reg)
        text = reg.render()
        assert 'atucker_serve_submitted{service="tucker"} 1' in text
        assert "atucker_serve_latency_ms" in text
        assert "atucker_bucket_completed" in text

    def test_stats_exposes_sweep_cache_and_drift(self):
        svc = service()
        try:
            stats = svc.stats()
            assert {"builds", "hits"} <= stats["sweep_cache"].keys()
            assert {"cells", "observations", "stale"} \
                <= stats["drift"].keys()
        finally:
            svc.stop()

    def test_serve_slice_yields_one_perfetto_trace(self, tmp_path):
        """submit → wave → done around plan/compile/execute, with per-mode
        solve spans from a recorded wave, in a single Chrome trace."""
        cfg = TuckerConfig(ranks=self.RANKS, methods="eig")
        policy = BucketPolicy(grid=8, wave_slots=2, pad_mode="mask")
        with obs.capture() as buf:
            A.clear_sweep_cache()
            for record in (False, True):
                with service(policy=policy, record=record) as svc:
                    for seed in range(2):
                        svc.submit(self._x(seed=seed), cfg)
                    svc.drain()
        path = tmp_path / "trace.json"
        doc = export_mod.write_chrome(buf.events(), path)
        names = {e["name"].split(" ")[0] for e in doc["traceEvents"]}
        assert {"submit", "wave", "solve", "compile", "plan",
                "execute", "done"} <= names
        json.loads(path.read_text())   # loadable
        solves = [e for e in doc["traceEvents"] if e["name"] == "solve"]
        assert all(e["args"]["solver"] == "eig" and "rank" in e["args"]
                   for e in solves)

    def test_wave_drift_attribution_from_fused_serve(self):
        """Un-recorded waves amortize wave wall-clock over their jobs and
        feed the drift monitor with source="serve", platform the plan's
        device type, when plans carry a calibrated prediction."""
        class BogusSelector:
            cost_model = CostModel(eig_scale=1.0, source="calibrated")

        drift_mod.MONITOR.reset()
        try:
            cfg = TuckerConfig(ranks=self.RANKS, methods="eig")
            with service(selector=BogusSelector(),
                         policy=BucketPolicy(grid=8, wave_slots=2)) as svc:
                for seed in range(3):
                    svc.submit(self._x(seed=seed), cfg)
                svc.drain()
            cells = drift_mod.MONITOR.cells()
            assert cells, "fused serve waves fed no drift observations"
            key, cell = next(iter(cells.items()))
            assert cell.sources.get("serve", 0) > 0
            assert "cpu" in key
        finally:
            drift_mod.MONITOR.reset()

    def test_concurrent_submit_and_stats(self):
        """Hammer submit() and stats() from threads: no torn reads, no
        exceptions, and the final counters balance exactly."""
        cfg = TuckerConfig(ranks=self.RANKS, methods="eig")
        svc = service(policy=BucketPolicy(grid=8, wave_slots=4),
                      max_queue=None)
        svc.start()
        n_threads, per_thread = 4, 4
        errors = []
        snapshots = [[], []]
        stop = threading.Event()

        def submitter(tid):
            try:
                for i in range(per_thread):
                    svc.submit(self._x(seed=tid * 100 + i), cfg)
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        def reader(k):
            while not stop.is_set():
                c = svc.stats()
                if not (c["submitted"] >= c["requests"] >= 0
                        and c["failed"] == 0 and c["rejected"] == 0):
                    errors.append(AssertionError(c))
                snapshots[k].append(c["submitted"])
                time.sleep(0.001)

        readers = [threading.Thread(target=reader, args=(k,))
                   for k in range(2)]
        writers = [threading.Thread(target=submitter, args=(t,))
                   for t in range(n_threads)]
        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)   # interleave the threads finely
        try:
            for th in readers + writers:
                th.start()
            for th in writers:
                th.join(timeout=120)
                assert not th.is_alive()
            svc.drain()
        finally:
            stop.set()
            sys.setswitchinterval(switch)
        for th in readers:
            th.join(timeout=30)
            assert not th.is_alive()
        svc.stop()
        assert not errors, errors
        final = svc.stats()
        assert final["submitted"] == final["requests"] == \
            n_threads * per_thread
        assert final["failed"] == 0
        # each reader saw a monotone non-decreasing submitted counter
        for snaps in snapshots:
            assert all(a <= b for a, b in zip(snaps, snaps[1:]))


# ---------------------------------------------------------------------------
# the same stream through the reference's service and the port's
# ---------------------------------------------------------------------------

STREAM_SHAPES = [(13, 12, 11), (16, 16, 16), (10, 15, 9), (16, 16, 16),
                 (24, 14, 16), (16, 16, 16), (12, 16, 13), (21, 16, 10)]


def _stream(n=len(STREAM_SHAPES)):
    return [lowrank(s, (3, 3, 3), seed=40 + i, noise=0.01)
            for i, s in enumerate(STREAM_SHAPES[:n])]


def _run_both(xs, cfg_kw, policy_kw, *, ref_cfg_kw=None):
    port = service(policy=BucketPolicy(**policy_kw))
    ref = RS.TuckerService(policy=RS.BucketPolicy(**policy_kw))
    cfg = TuckerConfig(**cfg_kw)
    rcfg = R.TuckerConfig(**(ref_cfg_kw or cfg_kw))
    pt = [port.submit(x, cfg, rid=i) for i, x in enumerate(xs)]
    rt = [ref.submit(jnp.asarray(x), rcfg, rid=i) for i, x in enumerate(xs)]
    port.drain()
    ref.drain()
    return (port, [port.poll(t) for t in pt]), (ref, [ref.poll(t) for t in rt])


COUNTERS = ("submitted", "requests", "batches", "plans_built", "failed",
            "n_buckets")
BUCKET_COUNTERS = ("submitted", "completed", "padded", "waves", "failed")


class TestReferenceParity:
    @pytest.mark.parametrize("pad_mode", ["exact", "mask"])
    @pytest.mark.parametrize("methods", ["eig", "als"])
    def test_same_stream_same_buckets_counters_and_factors(self, pad_mode,
                                                           methods):
        xs = _stream()
        (port, got), (ref, want) = _run_both(
            xs, dict(ranks=(3, 3, 3), methods=methods),
            dict(grid=8, max_pad_ratio=8.0, pad_mode=pad_mode,
                 wave_slots=4))
        ps, rs = port.stats(), ref.stats()
        for k in COUNTERS:
            assert ps[k] == rs[k], k
        assert set(ps["buckets"]) == set(rs["buckets"])
        for label, b in ps["buckets"].items():
            for k in BUCKET_COUNTERS:
                assert b[k] == rs["buckets"][label][k], (label, k)
        for x, g, w in zip(xs, got, want):
            assert g.tucker.ranks == tuple(int(s) for s in
                                           w.tucker.core.shape)
            assert [u.shape[0] for u in g.tucker.factors] == list(x.shape)
            gap = max_projector_gap(g.tucker.factors, w.tucker.factors)
            assert gap <= PROJ_ATOL, gap
            e_g = rel_error_np(x, g.tucker.core, g.tucker.factors)
            e_w = rel_error_np(x, w.tucker.core, w.tucker.factors)
            assert abs(e_g - e_w) <= REL_ATOL, (e_g, e_w)

    def test_exact_policy_engine_counts_equal_the_reference(self):
        xs = _stream(6)
        cfg = TuckerConfig(ranks=(3, 3, 3), methods="eig")
        rcfg = R.TuckerConfig(ranks=(3, 3, 3), methods="eig")
        eng = TuckerBatchEngine(device=CPU)
        reng = RS.TuckerBatchEngine()
        eng.run([TuckerRequest(x=x, config=cfg, rid=i)
                 for i, x in enumerate(xs)])
        reng.run([RS.TuckerRequest(x=jnp.asarray(x), config=rcfg, rid=i)
                  for i, x in enumerate(xs)])
        ps, rs = eng.stats, reng.stats
        for k in COUNTERS:
            assert ps[k] == rs[k], k
        assert set(ps["buckets"]) == set(rs["buckets"])

    def test_error_targeted_requests_equal_ranks(self):
        xs = [lowrank((30, 20, 16), (4, 3, 3), seed=s, noise=0.01)
              for s in range(3)]
        (port, got), (ref, want) = _run_both(
            xs, dict(error_target=0.05), dict(grid=8, max_pad_ratio=8.0))
        assert set(port.stats()["buckets"]) == set(ref.stats()["buckets"])
        for g, w in zip(got, want):
            assert g.tucker.ranks == tuple(int(s) for s in
                                           w.tucker.core.shape)


# ---------------------------------------------------------------------------
# isolation: the port's serve package imports nothing of jax or repro
# ---------------------------------------------------------------------------

def test_serve_imports_without_jax_or_repro():
    src = Path(__file__).resolve().parent.parent / "src"
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch.serve as S\n"
            "print(sorted(S.__all__))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True,
                         env={**os.environ, "PYTHONPATH": str(src)},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "TuckerService" in out.stdout
    assert not [m for m in ("jax", "repro") if f"'{m}'" in out.stderr]
