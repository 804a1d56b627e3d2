"""Port parity for mode-parallel sweeps: repro_torch's grouped schedules,
grouped DP and group execution against repro.core.

Plan time runs in process and is held EQUAL to the reference: group-aware
shard picking, ``resolve_schedule(..., backend="sharded", n_shards=k,
mode_parallel=...)`` for k ∈ {2, 4, 8} (every ModeStep field, per-device
group peaks on the CPU), and ``optimize_schedule``/``optimize_grouping``
with ``max_group > 1`` (the whole ``ScheduleSearch``, and its total against
the reference's own brute force over order × solver × grouping).

Execution runs in 2 and 4 gloo ranks on the CPU (one process each, a
``FileStore`` under the test's tmp dir): replicated groups, sharded groups
(one all-reduce for the group's Grams, a chain of local TTMs) and mixed
eig/als groups, in fp32 and bf16, against the reference's single-device
``matfree`` plan on the same numpy input — projectors within 1e-3 (fp32) /
3e-2 (bf16), rel_error within 1e-4 (fp32) — with every rank's factors
bitwise equal to rank 0's.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core.distributed import pick_shard_mode_group as r_pick_group
from repro.core.plan import _group_peak_bytes as r_group_peak_bytes
from repro.core.plan import resolve_schedule as r_resolve_schedule
from repro_torch.core import (MemoryCapError, TuckerConfig, TuckerPlan,
                              optimize_grouping, optimize_schedule, plan)
from repro_torch.core.distributed import (pick_shard_mode,
                                          pick_shard_mode_group)
from repro_torch.core.plan import (ModeStep, _group_peak_bytes,
                                   _step_peak_bytes, iter_groups,
                                   resolve_schedule)
from torch_parity import lowrank, max_projector_gap, rel_error_np, run_ranks

CPU = "cpu"


def steps_dict(steps):
    return [s.to_dict() for s in steps]


# ---------------------------------------------------------------------------
# Group-aware shard picking (pure function)
# ---------------------------------------------------------------------------

class TestPickShardModeGroup:
    @pytest.mark.parametrize("shape,group,k,want", [
        ((64, 16, 16), (1, 2), 8, 0), ((64, 16, 16), (0, 1), 8, 2),
        ((32, 32, 32), (0, 1, 2), 8, None), ((9, 32, 32), (1, 2), 8, None)])
    def test_equals_the_reference(self, shape, group, k, want):
        got = pick_shard_mode_group(shape, group, k)
        assert got == r_pick_group(shape, group, k) == want

    def test_singleton_group_matches_pick_shard_mode(self):
        for shape in ((24, 40, 16), (64, 15, 8), (5, 7, 9), (4, 5, 16)):
            for m in range(3):
                for n in (1, 4, 8):
                    assert pick_shard_mode(shape, m, n) == \
                        pick_shard_mode_group(shape, (m,), n)


# ---------------------------------------------------------------------------
# Grouped schedule resolution, field by field against the reference
# ---------------------------------------------------------------------------

GROUP_SHAPES = [((64, 16, 16), (4, 4, 4)), ((32, 32, 32), (4, 4, 4)),
                ((30, 8, 22), (3, 6, 4)), ((24, 40, 16), (4, 5, 6)),
                ((40, 16, 24, 8), (4, 4, 6, 2))]


class TestGroupSchedule:
    @pytest.mark.parametrize("k", [2, 4, 8])
    @pytest.mark.parametrize("shape,ranks", GROUP_SHAPES)
    @pytest.mark.parametrize("mp", [2, 3, "auto"])
    @pytest.mark.parametrize("mode_order", [None, "opt"])
    @pytest.mark.parametrize("methods", ["eig", "als", None])
    def test_equals_the_reference(self, k, shape, ranks, mp, mode_order,
                                  methods):
        kw = dict(methods=methods or ("eig", "als") * 2,
                  mode_order=mode_order, backend="sharded", n_shards=k,
                  mode_parallel=mp)
        if methods is None:
            kw["methods"] = kw["methods"][:len(shape)]
        got = resolve_schedule(shape, ranks, platform=CPU, **kw)
        want = r_resolve_schedule(shape, ranks, **kw)
        assert steps_dict(got) == steps_dict(want)

    @pytest.mark.parametrize("k", [2, 4, 8])
    def test_capped_auto_equals_the_reference(self, k):
        shape, ranks = (32, 32, 32), (4, 4, 4)
        free = r_resolve_schedule(shape, ranks, methods="eig",
                                  backend="sharded", n_shards=k,
                                  mode_order="opt", mode_parallel="auto")
        cap = max(s.peak_bytes for s in free) - 1
        kw = dict(methods="eig", backend="sharded", n_shards=k,
                  mode_order="opt", mode_parallel="auto",
                  memory_cap_bytes=cap)
        got = resolve_schedule(shape, ranks, platform=CPU, **kw)
        assert steps_dict(got) == steps_dict(r_resolve_schedule(
            shape, ranks, **kw))
        assert all(s.peak_bytes <= cap for s in got)

    def test_int_forces_leading_group(self):
        steps = resolve_schedule((64, 16, 16), (4, 4, 4), methods="eig",
                                 backend="sharded", n_shards=8,
                                 mode_parallel=2)
        assert [s.group for s in steps] == [0, 0, None]
        g = steps[:2]
        assert g[0].j_n == 16 * 16 and g[1].j_n == 64 * 16
        assert g[0].shard_mode == g[1].shard_mode == 2
        assert g[0].peak_bytes == g[1].peak_bytes
        assert steps[2].j_n == 4 * 4

    def test_group_peak_is_shared_input_plus_concurrent_scratch(self):
        steps = resolve_schedule((64, 16, 16), (4, 4, 4), methods="eig",
                                 backend="sharded", n_shards=8,
                                 mode_parallel=2)
        entries = [(s.method, s.i_n, s.r_n, s.j_n) for s in steps[:2]]
        assert steps[0].peak_bytes == _group_peak_bytes(
            entries, 64 * 16 * 16, 4 * 4 * 16, 4, 8) == r_group_peak_bytes(
            entries, 64 * 16 * 16, 4 * 4 * 16, 4, 8)

    def test_singleton_group_peak_reduces_to_step_peak(self):
        for meth in ("eig", "als"):
            for i_n, r_n, j_n, eff in ((64, 4, 256, 8), (33, 5, 77, 1)):
                one = _group_peak_bytes([(meth, i_n, r_n, j_n)],
                                        i_n * j_n, r_n * j_n, 4, eff)
                assert one == _step_peak_bytes(meth, i_n, r_n, j_n, 4, eff)

    def test_off_and_one_are_sequential(self):
        ref = resolve_schedule((64, 16, 16), (4, 4, 4), methods="eig",
                               backend="sharded", n_shards=8)
        for mp in ("off", 1):
            steps = resolve_schedule((64, 16, 16), (4, 4, 4), methods="eig",
                                     backend="sharded", n_shards=8,
                                     mode_parallel=mp)
            assert steps == ref and all(s.group is None for s in steps)

    def test_auto_single_device_silently_sequential(self):
        steps = resolve_schedule((32, 32, 32), (4, 4, 4), methods="eig",
                                 mode_parallel="auto")
        assert all(s.group is None for s in steps)

    def test_int_single_device_rejected(self):
        with pytest.raises(ValueError, match="n_shards"):
            resolve_schedule((32, 32, 32), (4, 4, 4), methods="eig",
                             mode_parallel=2)

    @pytest.mark.parametrize("bad", ["on", 0, -1, True, 2.5])
    def test_invalid_values_rejected(self, bad):
        with pytest.raises(ValueError):
            resolve_schedule((32, 32, 32), (4, 4, 4), methods="eig",
                             backend="sharded", n_shards=8,
                             mode_parallel=bad)

    @pytest.mark.parametrize("variant", ["thosvd", "hooi"])
    def test_non_sthosvd_rejected(self, variant):
        with pytest.raises(ValueError, match="sequential st-HOSVD"):
            resolve_schedule((32, 32, 32), (4, 4, 4), methods="eig",
                             variant=variant, mode_parallel="auto")

    def test_svd_member_rejected_from_group(self):
        with pytest.raises(ValueError, match="svd"):
            resolve_schedule((64, 16, 16), (4, 4, 4), methods="svd",
                             backend="sharded", n_shards=8, mode_parallel=2)

    def test_auto_groups_symmetric_shape(self):
        steps = resolve_schedule((32, 32, 32), (4, 4, 4), methods="eig",
                                 backend="sharded", n_shards=8,
                                 mode_parallel="auto")
        assert [s.group for s in steps] == [0, 0, 0]
        assert all(s.shard_mode is None for s in steps)

    def test_iter_groups_batches_consecutive_ids(self):
        steps = resolve_schedule((64, 16, 16), (4, 4, 4), methods="eig",
                                 backend="sharded", n_shards=8,
                                 mode_parallel=2)
        assert [len(b) for b in iter_groups(steps)] == [2, 1]
        seq = resolve_schedule((64, 16, 16), (4, 4, 4), methods="eig")
        assert [len(b) for b in iter_groups(seq)] == [1, 1, 1]

    def test_hopper_local_groups_add_held_and_workspace(self):
        """On the card a group's peak adds the kernels' workspace at the
        rank's view (and, after the first group, what is held)."""
        ref = resolve_schedule((64, 16, 16), (4, 4, 4), methods="eig",
                               backend="sharded", n_shards=8,
                               mode_parallel=2)
        hop = resolve_schedule((64, 16, 16), (4, 4, 4), methods="eig",
                               backend="sharded", n_shards=8,
                               mode_parallel=2, local_backend="hopper")
        assert [(s.group, s.shard_mode) for s in hop] == \
            [(s.group, s.shard_mode) for s in ref]
        assert all(h.peak_bytes > r.peak_bytes for h, r in zip(hop, ref))
        assert hop[0].peak_bytes == hop[1].peak_bytes


# ---------------------------------------------------------------------------
# Grouped DP against the reference's search and its brute force
# ---------------------------------------------------------------------------

DP_SHAPES = [((32, 32, 32), (4, 4, 4)), ((64, 16, 16), (4, 4, 4)),
             ((30, 8, 22), (3, 6, 4)), ((24, 40, 16), (4, 5, 6))]


class TestGroupedDP:
    @pytest.mark.parametrize("shape,ranks", DP_SHAPES)
    @pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
    def test_equals_the_reference_and_its_brute_force(self, shape, ranks,
                                                      n_shards):
        from test_modepar import brute_force_grouped
        got = optimize_schedule(shape, ranks, n_shards=n_shards, max_group=3)
        want = R.optimize_schedule(shape, ranks, n_shards=n_shards,
                                   max_group=3)
        assert got.to_dict() == want.to_dict()
        ref = brute_force_grouped(shape, ranks, n_shards=n_shards)
        assert math.isclose(got.total_cost, ref[0], rel_tol=1e-9)

    @pytest.mark.parametrize("frac", [0.3, 0.6, 0.9, 1.2])
    def test_capped_search_equals_the_reference(self, frac):
        from test_modepar import _initial_state_peaks
        shape, ranks, n_shards = (64, 16, 16), (4, 4, 4), 8
        cap = int(max(_initial_state_peaks(shape, ranks, n_shards)) * frac)
        kw = dict(n_shards=n_shards, max_group=3, memory_cap_bytes=cap)
        try:
            want = R.optimize_schedule(shape, ranks, **kw).to_dict()
        except R.MemoryCapError as e:
            with pytest.raises(MemoryCapError) as ei:
                optimize_schedule(shape, ranks, **kw)
            assert str(ei.value) == str(e)
        else:
            assert optimize_schedule(shape, ranks, **kw).to_dict() == want

    def test_infeasible_cap_names_binding_group(self):
        shape, ranks = (4, 4, 4096), (2, 2, 2)
        kw = dict(max_group=3, memory_cap_bytes=1000)
        with pytest.raises(MemoryCapError) as ei:
            optimize_schedule(shape, ranks, **kw)
        with pytest.raises(R.MemoryCapError) as ri:
            R.optimize_schedule(shape, ranks, **kw)
        assert str(ei.value) == str(ri.value)
        assert "binding group — modes" in str(ei.value)

    @pytest.mark.parametrize("order", [(2, 1, 0), (0, 1, 2), (1, 2, 0)])
    @pytest.mark.parametrize("n_shards", [2, 8])
    def test_optimize_grouping_equals_the_reference(self, order, n_shards):
        shape, ranks = (64, 16, 16), (4, 4, 4)
        got = optimize_grouping(shape, ranks, order, n_shards=n_shards)
        want = R.optimize_grouping(shape, ranks, order, n_shards=n_shards)
        assert got.to_dict() == want.to_dict()
        assert tuple(m for g in got.groups for m in g) == order

    def test_grouping_spans_plan_dp_grouping(self):
        from repro_torch import obs
        with obs.capture() as buf:
            optimize_grouping((64, 16, 16), (4, 4, 4), (0, 1, 2),
                              n_shards=8)
        names = [e.get("name") for e in buf.events()]
        assert "plan.dp_grouping" in names


# ---------------------------------------------------------------------------
# Plan plumbing: config serde, plan JSON, cache key, describe, peak model
# ---------------------------------------------------------------------------

def _grouped_plan():
    cfg = TuckerConfig(ranks=(4, 4, 4), methods="eig", mode_parallel=2)
    steps = resolve_schedule((64, 16, 16), (4, 4, 4), methods="eig",
                             backend="sharded", n_shards=8, mode_parallel=2)
    return TuckerPlan(shape=(64, 16, 16), dtype="float32", config=cfg,
                      schedule=steps, device=torch.device("cpu"))


class TestPlanPlumbing:
    def test_config_roundtrip_and_validation(self):
        for mp in ("off", "auto", 2):
            c = TuckerConfig(ranks=(2, 2, 2), methods="eig",
                             mode_parallel=mp)
            assert TuckerConfig.from_dict(c.to_dict()).mode_parallel == mp
            assert c.to_dict() == R.TuckerConfig(
                ranks=(2, 2, 2), methods="eig", mode_parallel=mp).to_dict()
        d = TuckerConfig(ranks=(2, 2, 2), methods="eig").to_dict()
        del d["mode_parallel"]
        assert TuckerConfig.from_dict(d).mode_parallel == "off"
        for bad in ("on", 0, True, 1.5):
            with pytest.raises(ValueError):
                TuckerConfig(ranks=(2, 2, 2), mode_parallel=bad)

    def test_modestep_roundtrip_keeps_group(self):
        steps = resolve_schedule((64, 16, 16), (4, 4, 4), methods="eig",
                                 backend="sharded", n_shards=8,
                                 mode_parallel=2)
        for s in steps:
            assert ModeStep.from_dict(s.to_dict()) == s
        d = steps[0].to_dict()
        del d["group"]
        assert ModeStep.from_dict(d).group is None

    def test_plan_single_device_auto_is_silent_int_is_loud(self):
        p = plan((16, 16, 16), "float32",
                 TuckerConfig(ranks=(4, 4, 4), methods="eig",
                              mode_parallel="auto"), device=CPU)
        assert all(s.group is None for s in p.schedule)
        with pytest.raises(ValueError, match="mesh"):
            plan((16, 16, 16), "float32",
                 TuckerConfig(ranks=(4, 4, 4), methods="eig",
                              mode_parallel=2), device=CPU)

    def test_plan_json_roundtrip_keeps_groups(self):
        p = _grouped_plan()
        p2 = TuckerPlan.from_json(p.to_json(), device=CPU)
        assert p2.schedule == p.schedule
        assert [s.group for s in p2.schedule] == [0, 0, None]
        assert p2.config.mode_parallel == 2

    def test_cache_key_distinguishes_grouping(self):
        p = _grouped_plan()
        seq = resolve_schedule((64, 16, 16), (4, 4, 4), methods="eig",
                               backend="sharded", n_shards=8)
        ps = TuckerPlan(shape=(64, 16, 16), dtype="float32",
                        config=p.config, schedule=seq,
                        device=torch.device("cpu"))
        assert p._cache_key(False, False) != ps._cache_key(False, False)

    def test_describe_marks_groups(self):
        text = _grouped_plan().describe()
        assert "∥group=0" in text
        assert "mode_parallel=2" in text
        assert "shard_mode=2/8" in text and "(per device)" in text

    def test_peak_bytes_charges_dead_input_after_the_leading_group(self):
        p = _grouped_plan()
        steps = p.schedule
        assert p.input_bytes == 64 * 16 * 16 * 4 // 8
        k0_peak = max(s.peak_bytes for s in steps[:2])
        tail = max(s.peak_bytes + p.input_bytes for s in steps[2:])
        assert p.peak_bytes == max(k0_peak, tail)


# ---------------------------------------------------------------------------
# Execution parity in 2 and 4 gloo ranks on the CPU
# ---------------------------------------------------------------------------

CASES = [((32, 32, 32), "auto"), ((64, 16, 16), 2), ((64, 16, 16), "auto")]

RANK_BODY = '''
from repro_torch.core import CACHE_STATS, TuckerConfig, clear_sweep_cache, plan
from repro_torch.core.distributed import sthosvd_distributed

def npy(t):
    return t.detach().cpu().double().numpy()

def res(r, p=None):
    d = {"core": npy(r.tucker.core),
         "factors": [npy(u) for u in r.tucker.factors]}
    if p is not None:
        d["groups"] = [s.group for s in p.schedule]
        d["shards"] = [s.shard_mode for s in p.schedule]
    return d

for i, (dims, mp) in enumerate(CASES):
    x32 = torch.from_numpy(data["x"][i])
    for dt in ("float32", "bfloat16"):
        x = x32.to(getattr(torch, dt))
        for m in ("eig", "als"):
            p = plan(dims, dt, TuckerConfig(ranks=(4, 4, 4), methods=m,
                                            impl="sharded", mesh=mesh,
                                            mode_parallel=mp), device="cpu")
            out[(i, dt, m)] = res(p.execute(x), p)
xm = torch.from_numpy(data["x"][1])
p = plan(xm.shape, "float32", TuckerConfig(
    ranks=(4, 4, 4), methods=("eig", "als", "eig"), impl="sharded",
    mesh=mesh, mode_parallel=2), device="cpu")
out["mixed"] = res(p.execute(xm), p)
clear_sweep_cache()
cfg = TuckerConfig(ranks=(4, 4, 4), methods="eig", impl="sharded",
                   mesh=mesh, mode_parallel=2)
p = plan(xm.shape, "float32", cfg, device="cpu")
for j in range(3):
    p.execute(xm + float(j))
stats = [dict(CACHE_STATS)]
plan(xm.shape, "float32", cfg, device="cpu").execute(xm)
stats.append(dict(CACHE_STATS))
plan(xm.shape, "float32", TuckerConfig(ranks=(4, 4, 4), methods="eig",
                                       impl="sharded", mesh=mesh),
     device="cpu").execute(xm)
stats.append(dict(CACHE_STATS))
out["cache"] = stats
xe = data["exact"]
seq = sthosvd_distributed(xe, (4, 4, 4), mesh, methods="eig", device="cpu")
par = sthosvd_distributed(xe, (4, 4, 4), mesh, methods="eig",
                          mode_parallel=2, device="cpu")
out["legacy"] = (res(seq), res(par), [t.seconds for t in par.trace])
'''


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks_run(request, tmp_path_factory):
    world = request.param
    data = dict(x=[lowrank(dims, (4, 4, 4), seed=i)
                   for i, (dims, _) in enumerate(CASES)],
                exact=lowrank((64, 16, 16), (4, 4, 4), seed=5))
    body = f"CASES = {CASES!r}\n" + RANK_BODY
    outs = run_ranks(tmp_path_factory.mktemp(f"w{world}"), world, body,
                     timeout=120, **data)
    return world, data, outs


def reference(x, methods, dtype):
    cfg = R.TuckerConfig(ranks=(4, 4, 4), methods=methods)
    return R.plan(x.shape, dtype, cfg).execute(jnp.asarray(x, dtype))


def same_on_every_rank(outs, key):
    first = outs[0][key]
    for o in outs[1:]:
        assert all(np.array_equal(a, b)
                   for a, b in zip(o[key]["factors"], first["factors"]))
        assert np.array_equal(o[key]["core"], first["core"])


class TestModeParallelExecution:
    @pytest.mark.parametrize("case", range(len(CASES)),
                             ids=[f"{d[0]}x{d[1]}x{d[2]}-{mp}"
                                  for d, mp in CASES])
    @pytest.mark.parametrize("dt", ["float32", "bfloat16"])
    @pytest.mark.parametrize("methods", ["eig", "als"])
    def test_matches_reference_matfree(self, ranks_run, case, dt, methods):
        world, data, outs = ranks_run
        x = data["x"][case]
        want = reference(x, methods, getattr(jnp, dt))
        tol = 1e-3 if dt == "float32" else 3e-2
        for o in outs:
            got = o[(case, dt, methods)]
            assert any(g is not None for g in got["groups"])
            assert max_projector_gap(got["factors"],
                                     want.tucker.factors) <= tol
            if dt == "float32":
                e1 = rel_error_np(x, got["core"], got["factors"])
                e2 = rel_error_np(x, want.tucker.core, want.tucker.factors)
                assert abs(e1 - e2) <= 1e-4, (e1, e2)
        same_on_every_rank(outs, (case, dt, methods))

    def test_group_shards_equal_the_reference(self, ranks_run):
        world, data, outs = ranks_run
        for i, (dims, mp) in enumerate(CASES):
            want = r_resolve_schedule(dims, (4, 4, 4), methods="eig",
                                      backend="sharded", n_shards=world,
                                      mode_parallel=mp)
            got = outs[0][(i, "float32", "eig")]
            assert got["groups"] == [s.group for s in want]
            assert got["shards"] == [s.shard_mode for s in want]

    def test_mixed_solver_group(self, ranks_run):
        _, data, outs = ranks_run
        x = data["x"][1]
        want = reference(x, ("eig", "als", "eig"), jnp.float32)
        for o in outs:
            got = o["mixed"]
            assert got["groups"] == [0, 0, None]
            assert max_projector_gap(got["factors"],
                                     want.tucker.factors) <= 1e-3
        same_on_every_rank(outs, "mixed")

    def test_plan_reuse_builds_one_eager_sweep(self, ranks_run):
        _, _, outs = ranks_run
        for o in outs:
            s3, s4, s5 = o["cache"]
            assert s3 == {"builds": 1, "hits": 2, "traces": 1}
            assert s4["builds"] == 1     # a re-built plan shares the sweep
            assert s5["builds"] == 2     # the sequential plan is another

    def test_legacy_wrapper_takes_mode_parallel(self, ranks_run):
        _, data, outs = ranks_run
        x = data["exact"]
        for o in outs:
            seq, par, seconds = o["legacy"]
            assert all(t > 0 for t in seconds)
            assert rel_error_np(x, seq["core"], seq["factors"]) < 1e-4
            assert rel_error_np(x, par["core"], par["factors"]) < 1e-4
        same_on_every_rank([{"k": o["legacy"][1]} for o in outs], "k")
