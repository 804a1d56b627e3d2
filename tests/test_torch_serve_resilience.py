"""Failure isolation in the port's serve service, held to the reference's
``tests/test_resilience.py`` (serve isolation, the breaker unit, the env
profile).

Faults are injected through the port's chaos harness (``repro_torch.chaos``)
at the serve seams ``wave``, ``wave_job``, ``wave_job_data`` and ``worker``;
every test asserts one of the two allowed outcomes — the fault is
RECOVERED (degraded but correct results) or CLASSIFIED (a ``TuckerError``
subclass).  Every service runs on ``device="cpu"``; bitwise claims hold the
port against the port.

Run under ``ATUCKER_CHAOS=numerical|oom|serve-poison`` the env-profile test
additionally exercises the shipped profiles end to end.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro_torch import chaos
from repro_torch.core import (CancelledError, DeadlineError, InputError,
                              ResourceError, TuckerConfig, TuckerError, plan)
from repro_torch.serve import BucketPolicy, TuckerService
from repro_torch.serve.service import _Breaker

CPU = "cpu"
_CFG = TuckerConfig(ranks=(3, 3, 3))


@pytest.fixture(autouse=True)
def _clean_chaos():
    chaos.reset()
    yield
    chaos.reset()


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _mask_service(**kw):
    kw.setdefault("policy", BucketPolicy(grid=8, pad_mode="mask",
                                         wave_slots=8))
    kw.setdefault("max_queue", 64)
    return TuckerService(device=CPU, **kw)


def _job_shapes(n):
    # mixed true shapes in one (8, 8, 8) mask bucket (>=1 padded member,
    # so waves take the fused path)
    return [(8 - (i % 2), 8, 8 - (i % 3)) for i in range(n)]


def _run_stream(svc, shapes, **submit_kw):
    tickets = [svc.submit(_rand(s, seed=100 + i), _CFG, rid=i, **submit_kw)
               for i, s in enumerate(shapes)]
    svc.drain()
    out = []
    for t in tickets:
        try:
            out.append(svc.poll(t))
        except Exception as e:  # noqa: BLE001 - collected for assertions
            out.append(e)
    return out


def _same(a, b) -> bool:
    return torch.equal(a.tucker.core, b.tucker.core) and all(
        torch.equal(u, v) for u, v in zip(a.tucker.factors, b.tucker.factors))


class TestServeIsolation:
    def test_deadline_expires_prewave(self):
        svc = _mask_service()
        t = svc.submit(_rand((7, 8, 8)), _CFG, deadline_s=0.01)
        time.sleep(0.05)
        svc.drain()
        with pytest.raises(DeadlineError):
            svc.poll(t)
        assert svc.stats()["resilience"]["deadline_expired"] == 1

    def test_deadline_validation(self):
        svc = _mask_service()
        with pytest.raises(ValueError):
            svc.submit(_rand((7, 8, 8)), _CFG, deadline_s=0.0)

    def test_cancel_before_dispatch(self):
        svc = _mask_service()
        t0 = svc.submit(_rand((7, 8, 8), seed=1), _CFG)
        t1 = svc.submit(_rand((8, 8, 7), seed=2), _CFG)
        assert svc.cancel(t0) is True
        svc.drain()
        with pytest.raises(CancelledError):
            svc.poll(t0)
        assert svc.poll(t1) is not None
        assert svc.cancel(t1) is False      # already completed
        s = svc.stats()
        assert s["resilience"]["cancelled"] == 1
        assert s["requests"] == 1

    def test_submit_rejects_nonfinite_input(self):
        svc = _mask_service()
        x = _rand((7, 8, 8))
        x[:, 2, :] = np.nan
        with pytest.raises(InputError, match="mode 1"):
            svc.submit(x, _CFG)
        # trusted traffic can opt out of the admission check
        t = svc.submit(x, _CFG, validate="none")
        svc.drain()
        with pytest.raises(TuckerError):    # classified downstream instead
            svc.poll(t)

    def test_poisoned_job_fails_alone_others_bitwise_clean(self):
        shapes = _job_shapes(5)
        clean = _run_stream(_mask_service(), shapes)
        assert all(not isinstance(r, Exception) for r in clean)
        # rid 2 raises on EVERY attempt (dispatch, bisection, isolation)
        chaos.install([chaos.Rule(seam="wave_job", action="raise",
                                  times=None, match={"rid": 2},
                                  message="synthetic poisoned request")])
        svc = _mask_service()
        poisoned = _run_stream(svc, shapes)
        assert isinstance(poisoned[2], TuckerError)
        for i in (0, 1, 3, 4):
            assert not isinstance(poisoned[i], Exception)
            assert _same(clean[i], poisoned[i])
        assert svc.stats()["resilience"]["bisections"] >= 1

    @settings(max_examples=5, deadline=None)
    @given(n=st.integers(2, 6), poison=st.integers(0, 5))
    def test_bisection_bitwise_property(self, n, poison):
        poison = poison % n
        shapes = _job_shapes(n)
        chaos.reset()
        clean = _run_stream(_mask_service(), shapes)
        chaos.install([chaos.Rule(seam="wave_job", action="raise",
                                  times=None, match={"rid": poison})])
        got = _run_stream(_mask_service(), shapes)
        chaos.reset()
        assert isinstance(got[poison], TuckerError)
        for i in range(n):
            if i == poison:
                continue
            assert _same(clean[i], got[i])

    def test_nan_lane_quarantined_and_recovered(self):
        # transient data poison in ONE fused lane: that lane re-derives in
        # isolation from the intact input; nobody else re-runs
        shapes = _job_shapes(4)
        chaos.install([chaos.Rule(seam="wave_job_data", action="nan",
                                  times=1, match={"rid": 1})])
        svc = _mask_service()
        out = _run_stream(svc, shapes)
        assert all(not isinstance(r, Exception) for r in out)
        assert all(bool(torch.isfinite(r.tucker.core).all()) for r in out)
        res = svc.stats()["resilience"]
        assert res["quarantined"] >= 1
        assert res["recovered"] >= 1

    def test_retry_budget_recovers_transient_fault(self):
        # the fault persists through dispatch + bisection + isolation of
        # wave 1 (3 firings), then goes away; retries=1 re-enqueues the job
        chaos.install([chaos.Rule(seam="wave_job", action="raise", times=3,
                                  match={"rid": 0})])
        svc = _mask_service()
        t = svc.submit(_rand((7, 8, 8)), _CFG, rid=0, retries=1)
        svc.drain()
        assert svc.poll(t) is not None
        assert svc.stats()["resilience"]["retried"] == 1
        assert sum(chaos.fired().values()) == 3

    def test_retry_budget_exhausts_to_classified(self):
        chaos.install([chaos.Rule(seam="wave_job", action="raise",
                                  times=None, match={"rid": 0})])
        svc = _mask_service()
        t = svc.submit(_rand((7, 8, 8)), _CFG, rid=0, retries=2)
        svc.drain()
        with pytest.raises(TuckerError):
            svc.poll(t)
        assert svc.stats()["resilience"]["retried"] == 2

    def test_breaker_trips_isolates_and_recovers(self):
        # every fused wave "fails" (recovery succeeds, but the fused path
        # itself keeps breaking) -> breaker opens after 2 waves; requests
        # keep completing through bisection and then isolation
        chaos.install([chaos.Rule(seam="wave", action="raise", times=None)])
        svc = _mask_service(breaker_threshold=2, breaker_cooldown_s=0.05)
        for wave in range(3):
            out = _run_stream(svc, _job_shapes(2))
            assert all(not isinstance(r, Exception) for r in out)
        s = svc.stats()
        assert s["resilience"]["breaker_trips"] == 1
        assert s["resilience"]["isolated_waves"] >= 1
        assert svc.health()["status"] == "degraded"
        # fault clears; after the cooldown one fused probe re-closes it
        chaos.reset()
        time.sleep(0.06)
        out = _run_stream(svc, _job_shapes(2))
        assert all(not isinstance(r, Exception) for r in out)
        s = svc.stats()
        assert s["resilience"]["probe_waves"] >= 1
        assert s["resilience"]["breakers_open"] == 0
        assert svc.health()["status"] == "ok"

    def test_stop_force_abandons_with_classified_error(self):
        chaos.install([chaos.Rule(seam="wave", action="slow", times=None,
                                  delay_s=0.3)])
        svc = _mask_service(breaker_cooldown_s=60.0)
        svc.start()
        tickets = [svc.submit(_rand(s, seed=i), _CFG)
                   for i, s in enumerate(_job_shapes(6))]
        time.sleep(0.05)
        svc.stop(force=True, join_timeout=5.0)
        for t in tickets:
            assert t._job.event.wait(timeout=5.0)
            with pytest.raises((ResourceError, TuckerError)):
                svc.poll(t)

    def test_stop_warns_naming_wedged_bucket(self):
        chaos.install([chaos.Rule(seam="wave", action="slow", times=None,
                                  delay_s=1.5)])
        svc = _mask_service()
        svc.start()
        worker = svc._thread
        svc.submit(_rand((7, 8, 8)), _CFG)
        time.sleep(0.3)          # let the worker enter the slow wave
        with pytest.warns(RuntimeWarning, match="8x8x8"):
            svc.stop(drain=False, force=True, join_timeout=0.2)
        # the daemonic worker was abandoned mid-wave; reap it
        worker.join(timeout=10.0)
        assert not worker.is_alive()

    def test_worker_death_fails_jobs_classified(self):
        svc = _mask_service()
        t = svc.submit(_rand((7, 8, 8)), _CFG)
        chaos.install([chaos.Rule(seam="worker", action="raise", times=1)])
        svc.start()
        assert t._job.event.wait(timeout=10.0)
        with pytest.raises(ResourceError, match="worker died"):
            svc.poll(t)
        assert svc.health()["status"] == "unhealthy"

    def test_no_unclassified_escape_under_poison_profile(self):
        chaos.install_profile("serve-poison")
        out = _run_stream(_mask_service(), _job_shapes(5))
        for i, r in enumerate(out):
            if isinstance(r, Exception):
                assert isinstance(r, TuckerError), (
                    f"rid {i}: unclassified {type(r).__name__} escaped")
            else:
                assert bool(torch.isfinite(r.tucker.core).all())
        assert isinstance(out[2], TuckerError)   # the profile poisons rid 2


class TestBreakerUnit:
    def test_concurrent_failures_trip_exactly_once(self):
        br = _Breaker(threshold=1, cooldown_s=10.0)
        lock = threading.RLock()
        start = threading.Barrier(8)

        def hammer():
            start.wait()
            for _ in range(200):
                with lock:
                    br.on_result(False, 0.0)
        threads = [threading.Thread(target=hammer) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
            assert not th.is_alive(), "breaker hammer deadlocked"
        assert br.trips == 1
        assert br.state == "open"

    def test_probe_cycle(self):
        br = _Breaker(threshold=2, cooldown_s=1.0)
        assert br.route(0.0) == "fused"
        br.on_result(False, 0.0)
        assert br.on_result(False, 0.0) is True   # trip
        assert br.route(0.5) == "isolated"        # cooling down
        assert br.route(1.5) == "probe"           # cooldown elapsed
        assert br.route(1.6) == "isolated"        # probe slot claimed
        br.on_probe(False, 1.7)                   # probe failed: reopen
        assert br.reopens == 1 and br.trips == 1
        assert br.route(3.0) == "probe"
        br.on_probe(True, 3.1)
        assert br.state == "closed"
        assert br.route(3.2) == "fused"


# -- shipped profiles end to end (run with ATUCKER_CHAOS set) ----------------

PROFILE = os.environ.get("ATUCKER_CHAOS")


@pytest.mark.skipif(PROFILE is None,
                    reason="set ATUCKER_CHAOS=numerical|oom|serve-poison")
def test_env_profile_recovers_or_classifies():
    chaos.install_profile(PROFILE)   # the autouse fixture cleared the env rules
    if PROFILE == "serve-poison":
        out = _run_stream(_mask_service(), _job_shapes(5))
        for r in out:
            assert not isinstance(r, Exception) or isinstance(r, TuckerError)
        assert isinstance(out[2], TuckerError)
    else:
        # recovered by the ladder, or classified: the port's ladder has no
        # donate_off rung, and under "oom" the replan at 0.75 of this
        # shape's peak admits no schedule, so the ResourceError comes back
        x = _rand((12, 10, 8), seed=11)
        p = plan(x.shape, "float32", TuckerConfig(ranks=(3, 3, 3)),
                 device=CPU)
        try:
            res = p.execute(x, validate="finite")
        except TuckerError:
            pass
        else:
            assert bool(torch.isfinite(res.tucker.core).all())
        assert sum(chaos.fired().values()) >= 1
