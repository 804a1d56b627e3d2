"""The Tucker service's background worker on a mesh: rank 0 decides.

Every rank of a 1-D gloo mesh on the CPU (2 and 4 ranks, one process
each, spawned by ``torch_parity.run_ranks``) runs a ``TuckerService`` on
the mesh and submits the same requests with the same ``rid``s.  Rank 0
picks the waves, expires requests and steps the breaker on its own clock,
and broadcasts each decision; the other ranks follow.  The rank bodies
below record, per rank, the waves it dispatched (rid lists), each rid's
outcome (a digest of its factors and core, or the error's class) and the
service's counters; the tests hold them equal across ranks, hold each
result to the reference's single-device decomposition of the same numpy
input (projector gap <= 1e-3, |d rel_error| <= 1e-4, fp32) and to the
synchronous mesh service's bitwise.  Every rank has 120 s: a hang fails
the test instead of the suite.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as R
from repro_torch.core import TuckerConfig
from repro_torch.serve import TuckerService
from torch_parity import lowrank, max_projector_gap, rel_error_np, run_ranks

SHAPES = ((24, 40, 16), (16, 24, 20))
RANKS = (4, 4, 4)
PROJ_TOL, REL_TOL = 1e-3, 1e-4
N_REQ = 12

BODY = '''
import hashlib, time
from repro_torch import chaos
from repro_torch.core import TuckerConfig
from repro_torch.serve import BucketPolicy, TuckerService

CFG = TuckerConfig(ranks=(4, 4, 4), methods="eig")
EXACT = BucketPolicy(grid=1)     # each shape its own bucket, 8 slots
XS = data["xs"]
last = world - 1

def npy(t):
    return t.detach().cpu().double().numpy()

def outcome(svc, t):
    try:
        r = svc.poll(t)
    except Exception as e:
        return ("error", type(e).__name__)
    h = hashlib.sha256()
    for a in [r.tucker.core, *r.tucker.factors]:
        h.update(npy(a).tobytes())
    return ("ok", h.hexdigest())

def results(svc, ts):
    out = {}
    for t in ts:
        try:
            r = svc.poll(t)
        except Exception:
            continue
        out[t.rid] = {"core": npy(r.tucker.core),
                      "factors": [npy(u) for u in r.tucker.factors]}
    return out

def spied(svc):
    waves = []
    real = svc._dispatch_wave
    def spy(bs, jobs, inflight=0, decided=None):
        waves.append([j.rid for j in jobs])
        return real(bs, jobs, inflight, decided)
    svc._dispatch_wave = spy
    return waves

def record(name, svc, ts, waves):
    st = svc.stats()
    out[name] = dict(waves=waves, outcomes={t.rid: outcome(svc, t) for t in ts},
                     results=results(svc, ts), resilience=st["resilience"],
                     requests=st["requests"], failed=st["failed"],
                     health=svc.health()["status"])

# 1) the synchronous mesh service: the bitwise baseline
svc = TuckerService(mesh=mesh, device="cpu", max_queue=None, policy=EXACT)
waves = spied(svc)
ts = [svc.submit(x, CFG, rid=i) for i, x in enumerate(XS)]
svc.drain()
record("sync", svc, ts, waves)
svc.close()

# 2) the worker: the last rank's submissions lag; four requests carry a
#    deadline that rank 0 expires (rank 0 gives them 1 us, the others an
#    hour: every rank follows rank 0's clock) and the last rank plants a
#    wave fault before its first collective at the second wave
svc = TuckerService(mesh=mesh, device="cpu", max_queue=None,
                    policy=BucketPolicy(grid=1, wave_slots=4))
waves = spied(svc)
if rank == last:
    chaos.install([chaos.Rule(seam="wave", action="raise", at=1)])
svc.start()
expire = set(data["expire"])
ts = []
for i, x in enumerate(XS):
    if rank == last:
        time.sleep(0.02)
    dl = None if i not in expire else (1e-6 if rank == 0 else 3600.0)
    ts.append(svc.submit(x, CFG, rid=i, deadline_s=dl))
for t in ts:
    try:
        svc.wait(t, timeout=100)
    except Exception:
        pass
svc.stop()
out["fired"] = chaos.fired()
chaos.reset()
record("worker", svc, ts, waves)
out["worker_running"] = svc.health()["worker"]
svc.close()

# 3) the breaker on rank 0's clock: a wave fault on the last rank trips it
#    (threshold 1), the next wave runs isolated, and after rank 0 alone has
#    slept past the cooldown the next is a probe that closes it
svc = TuckerService(mesh=mesh, device="cpu", max_queue=None, policy=EXACT,
                    breaker_threshold=1, breaker_cooldown_s=2.0)
waves = spied(svc)
states = []
ts = []
for k in range(3):
    if k == 0 and rank == last:
        chaos.install([chaos.Rule(seam="wave", action="raise", at=0)])
    if k == 2 and rank == 0:
        time.sleep(2.5)
    ts += [svc.submit(XS[i], CFG, rid=i) for i in range(3 * k, 3 * k + 3)]
    svc.drain()
    chaos.reset()
    states.append(svc.health()["status"])
record("breaker", svc, ts, waves)
out["breaker"]["states"] = states
svc.close()

# 3b) the per-lane seams on the last rank: a lane's stacking raises
#     (wave_job) in one wave and a lane's data is poisoned (wave_job_data)
#     in the next; both waves recover alike on every rank
svc = TuckerService(mesh=mesh, device="cpu", max_queue=None, policy=EXACT)
waves = spied(svc)
ts = []
for k, seam in enumerate(("wave_job", "wave_job_data")):
    if rank == last:
        chaos.install([chaos.Rule(seam=seam, at=1,
                                  action="raise" if k == 0 else "nan")])
    ts += [svc.submit(XS[i], CFG, rid=i) for i in (k, k + 2)]
    svc.drain()
    out.setdefault("lane_fired", []).append(chaos.fired())
    chaos.reset()
record("lanes", svc, ts, waves)
svc.close()

# 4) cancel on rank 0 reaches every rank; a cancel elsewhere is refused
svc = TuckerService(mesh=mesh, device="cpu", max_queue=None)
waves = spied(svc)
ts = [svc.submit(x, CFG, rid=i) for i, x in enumerate(XS[:4])]
out["cancel_returned"] = svc.cancel(ts[2])
svc.drain()
record("cancel", svc, ts, waves)
svc.close()

# 5) a rank that lags past decision_timeout_s: the wave fails on every rank
#    with one agreed error, and the late request fails on arrival
svc = TuckerService(mesh=mesh, device="cpu", max_queue=None,
                    decision_timeout_s=1.0)
waves = spied(svc)
svc.start()
ts = [svc.submit(XS[0], CFG, rid=0)]
svc.wait(ts[0], timeout=100)
if rank == last:
    time.sleep(2.5)
ts.append(svc.submit(XS[1], CFG, rid=1))
try:
    svc.wait(ts[1], timeout=100)
except Exception:
    pass
svc.stop()
record("late", svc, ts, waves)
svc.close()

# 6) stop(force=True) on rank 0 abandons the unfinished work on every rank,
#    after the wave in flight has finished everywhere
svc = TuckerService(mesh=mesh, device="cpu", max_queue=None,
                    policy=BucketPolicy(grid=1, wave_slots=2))
waves = spied(svc)
ts = [svc.submit(x, CFG, rid=i) for i, x in enumerate(XS)]
dist.barrier()
svc.start()
svc.stop(force=True)
record("force", svc, ts, waves)
svc.close()

# 7) a follower's worker dies on rank 0's first decision, and that rank
#    keeps its service open for 8 s more: rank 0's next collective on the
#    decision group gives up after twice decision_timeout_s (2 s), so its
#    worker dies and fails its jobs, as every other rank's does; nobody
#    waits for the dead rank's close or for gloo's default half hour
svc = TuckerService(mesh=mesh, device="cpu", max_queue=None,
                    decision_timeout_s=1.0)
waves = spied(svc)
if rank == last:
    def dead(msg):
        raise RuntimeError("planted: this rank's worker dies")
    svc._follow = dead
svc.start()
t0 = time.monotonic()
ts = [svc.submit(x, CFG, rid=i) for i, x in enumerate(XS[:2])]
for t in ts:
    try:
        svc.wait(t, timeout=100)
    except Exception:
        pass
out["dead_s"] = time.monotonic() - t0
if rank == last:
    time.sleep(8.0)
svc.stop()
record("dead", svc, ts, waves)
svc.close()
'''


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def mesh_run(request, tmp_path_factory):
    """One run of BODY on ``world`` ranks: (world, inputs, outs)."""
    world = request.param
    rng = np.random.default_rng(7)
    xs = [lowrank(SHAPES[i % 2], RANKS, seed=int(rng.integers(1 << 30)),
                  noise=1e-3) for i in range(N_REQ)]
    outs = run_ranks(tmp_path_factory.mktemp(f"svc{world}"), world, BODY,
                     timeout=120, xs=xs, expire=[3, 6, 9, 10])
    return world, xs, outs


def reference(x):
    cfg = R.TuckerConfig(ranks=RANKS, methods="eig")
    return R.plan(x.shape, jnp.float32, cfg).execute(jnp.asarray(x)).tucker


def hold_to_reference(x, got):
    want = reference(x)
    gap = max_projector_gap(got["factors"], want.factors)
    assert gap <= PROJ_TOL, gap
    e_got = rel_error_np(x, got["core"], got["factors"])
    e_want = rel_error_np(x, want.core, want.factors)
    assert abs(e_got - e_want) <= REL_TOL, (e_got, e_want)


CASES = ("sync", "worker", "breaker", "lanes", "cancel", "late", "force",
         "dead")


@pytest.mark.parametrize("case", CASES)
def test_every_rank_dispatches_the_same_waves(mesh_run, case):
    _, _, outs = mesh_run
    for o in outs[1:]:
        assert o[case]["waves"] == outs[0][case]["waves"]


@pytest.mark.parametrize("case", CASES)
def test_every_rid_has_one_outcome_on_every_rank(mesh_run, case):
    """The same result digest or error class for each rid on every rank,
    and the same counters."""
    _, _, outs = mesh_run
    first = outs[0][case]
    for o in outs[1:]:
        assert o[case]["outcomes"] == first["outcomes"]
        assert o[case]["resilience"] == first["resilience"]
        assert (o[case]["requests"], o[case]["failed"]) == \
            (first["requests"], first["failed"])


@pytest.mark.parametrize("case", ("sync", "worker", "breaker", "lanes",
                                  "cancel"))
def test_results_hold_the_reference(mesh_run, case):
    _, xs, outs = mesh_run
    for rid, got in outs[0][case]["results"].items():
        hold_to_reference(xs[rid], got)


class TestWorker:
    def test_unexpired_results_are_bitwise_the_sync_service(self, mesh_run):
        _, _, outs = mesh_run
        for o in outs:
            sync, worker = o["sync"]["outcomes"], o["worker"]["outcomes"]
            for rid, got in worker.items():
                if got[0] == "ok":
                    assert got == sync[rid]

    def test_rank0_expires_by_its_own_clock(self, mesh_run):
        """Rank 0 gave the four a microsecond, the others an hour: they
        expire on every rank; nothing else fails."""
        _, _, outs = mesh_run
        for o in outs:
            got = o["worker"]["outcomes"]
            assert {r for r, v in got.items() if v[0] == "error"} == \
                {3, 6, 9, 10}
            assert all(got[r] == ("error", "DeadlineError")
                       for r in (3, 6, 9, 10))
            assert o["worker"]["resilience"]["deadline_expired"] == 4

    def test_planted_wave_fault_is_agreed_and_recovered(self, mesh_run):
        """The fault fired on the last rank only, before the wave's first
        collective; every rank left the wave and recovered its lanes."""
        world, _, outs = mesh_run
        for r, o in enumerate(outs):
            assert o["fired"] == ({"wave:raise": 1} if r == world - 1
                                  else {})
            res = o["worker"]["resilience"]
            assert res["recovered"] >= 1 and res["quarantined"] == 0
            assert o["worker"]["requests"] == N_REQ - 4
        assert outs[0]["worker_running"] == "stopped"

    def test_waves_respect_the_slots_and_cover_every_request(self, mesh_run):
        _, _, outs = mesh_run
        waves = outs[0]["worker"]["waves"]
        assert all(1 <= len(w) <= 4 for w in waves)
        assert sorted({r for w in waves for r in w}) == list(range(N_REQ))


class TestBreaker:
    def test_trip_isolated_then_probe_closes(self, mesh_run):
        _, _, outs = mesh_run
        for o in outs:
            b = o["breaker"]
            assert b["states"] == ["degraded", "degraded", "ok"]
            assert b["resilience"]["breaker_trips"] == 1
            assert b["resilience"]["isolated_waves"] == 1
            assert b["resilience"]["probe_waves"] == 1
            assert b["resilience"]["breakers_open"] == 0
            assert b["requests"] == 9 and b["failed"] == 0


class TestLaneSeams:
    def test_lane_faults_on_one_rank_recover_everywhere(self, mesh_run):
        """wave_job raised while the last rank stacked a lane (agreed
        before the sweep: every rank re-runs the wave's lanes); wave_job_data
        poisoned a lane there (the sweep's collectives carry the NaNs to
        every rank, whose lane is quarantined)."""
        world, _, outs = mesh_run
        for r, o in enumerate(outs):
            want = ([{"wave_job:raise": 1}, {"wave_job_data:nan": 1}]
                    if r == world - 1 else [{}, {}])
            assert o["lane_fired"] == want
            res = o["lanes"]["resilience"]
            # wave 1: both lanes re-run fused; wave 2: the poisoned one
            assert res["recovered"] == 3 and res["quarantined"] == 1
            assert o["lanes"]["requests"] == 4 and o["lanes"]["failed"] == 0
            assert o["lanes"]["outcomes"] == {
                i: o["sync"]["outcomes"][i] for i in (0, 2, 1, 3)}


class TestRefusals:
    def test_cancel_takes_effect_through_rank0(self, mesh_run):
        _, _, outs = mesh_run
        for r, o in enumerate(outs):
            assert o["cancel_returned"] is (r == 0)
            assert o["cancel"]["outcomes"][2] == ("error", "CancelledError")
            assert o["cancel"]["resilience"]["cancelled"] == 1
            assert o["cancel"]["requests"] == 3

    def test_reject_backpressure_is_refused_on_a_mesh(self):
        with pytest.raises(ValueError, match="ROADMAP.md"):
            TuckerService(mesh=object(), device="cpu", max_queue=8,
                          backpressure="reject")

    def test_lagging_rank_fails_the_wave_everywhere(self, mesh_run):
        _, _, outs = mesh_run
        for o in outs:
            got = o["late"]["outcomes"]
            assert got[0][0] == "ok"
            assert got[1] == ("error", "MeshError")

    def test_a_dead_follower_fails_every_rank_within_the_limit(
            self, mesh_run):
        """The decision group's limit is 2 s (decision_timeout_s = 1):
        every rank's waiters fail with the dying worker's ResourceError,
        the live ranks' within 6 s, before the dead rank closes its
        service at 8 s; no wave was dispatched."""
        _, _, outs = mesh_run
        for o in outs:
            assert o["dead"]["outcomes"] == {
                0: ("error", "ResourceError"), 1: ("error", "ResourceError")}
            assert o["dead"]["waves"] == []
            assert o["dead"]["health"] == "unhealthy"
        for o in outs[:-1]:
            assert o["dead_s"] < 6.0, o["dead_s"]

    def test_force_stop_abandons_alike(self, mesh_run):
        _, _, outs = mesh_run
        kinds = {v[0] for v in outs[0]["force"]["outcomes"].values()}
        assert kinds <= {"ok", "error"}
        for v in outs[0]["force"]["outcomes"].values():
            assert v[0] == "ok" or v[1] == "ResourceError"


def test_a_pinned_single_device_impl_makes_no_decision_group():
    """Its plans drop the mesh, so each rank runs alone: no group is
    created (``object()`` is no mesh) and ``reject`` is allowed."""
    svc = TuckerService(mesh=object(), impl="matfree", device="cpu",
                        max_queue=8, backpressure="reject")
    assert svc._chan is None
    svc.close()


def test_decision_timeout_below_the_heartbeat_is_refused():
    with pytest.raises(ValueError, match="heartbeat"):
        TuckerService(mesh=object(), device="cpu", decision_timeout_s=0.5)


def test_no_mesh_service_keeps_reject_as_its_default():
    svc = TuckerService(device="cpu", max_queue=1)
    svc.submit(np.ones((4, 4, 4), np.float32),
               TuckerConfig(ranks=(2, 2, 2)))
    with pytest.raises(RuntimeError, match="queue full"):
        svc.submit(np.ones((4, 4, 4), np.float32),
                   TuckerConfig(ranks=(2, 2, 2)))
