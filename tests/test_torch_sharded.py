"""Port parity for the sharded backend: repro_torch.core.distributed and the
``mesh=`` plans against repro.core.

The reference's own sharded execution does not run on this JAX (its
8-virtual-device tests fail), so the port is held three ways:

  * plan time, in process: ``pick_shard_mode``, ``resolve_schedule(...,
    backend="sharded", n_shards=k)`` for k ∈ {2, 4, 8} and ``mesh_spec``
    JSON EQUAL to the reference's (every ModeStep field; per-device
    ``peak_bytes`` on the CPU, whose ranks compute on ``matfree``);
  * execution, in 2 and 4 gloo ranks on the CPU (one process each, a
    ``FileStore`` under the test's tmp dir): the same numpy input through
    the port's sharded plan and the reference's single-device ``matfree``
    plan — projectors within 1e-3 (fp32) / 3e-2 (bf16), rel_error within
    1e-4, and every rank's factors bitwise equal to rank 0's;
  * a 1-rank gloo group in this process (a fixture, destroyed after the
    module): mesh validation, plan JSON round trip and execute, equal to the
    port's ``matfree`` plan.
"""

import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.core as R
from repro.core.distributed import pick_shard_mode as r_pick_shard_mode
from repro.core.plan import ModeStep as RModeStep
from repro.core.plan import resolve_schedule as r_resolve_schedule
from repro_torch.core import (TuckerConfig, TuckerPlan, mesh_from_spec,
                              mesh_spec, plan)
from repro_torch.core.backend import get_backend, resolve_backend
from repro_torch.core.distributed import pick_shard_mode
from repro_torch.core.plan import ModeStep, resolve_schedule
from torch_parity import lowrank, max_projector_gap, rel_error_np, run_ranks

CPU = "cpu"
PROJ_TOL = {"float32": 1e-3, "bfloat16": 3e-2}
REL_TOL = 1e-4


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """A 1-rank gloo process group in this process and its DeviceMesh."""
    from torch.distributed.device_mesh import init_device_mesh
    store = dist.FileStore(str(tmp_path_factory.mktemp("pg") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


def steps_dict(steps):
    return [s.to_dict() for s in steps]


# ---------------------------------------------------------------------------
# pick_shard_mode edge cases (pure function)
# ---------------------------------------------------------------------------

class TestPickShardMode:
    CASES = [((24, 40, 16), 0, 8, 1), ((64, 16, 8), 0, 8, 1),
             ((64, 15, 8), 0, 8, 2), ((5, 7, 9), 0, 4, None),
             ((8, 7, 9), 0, 8, None), ((4, 5, 16), 2, 8, None),
             ((3, 5, 7), 2, 1, 1)]

    @pytest.mark.parametrize("shape,exclude,k,want", CASES)
    def test_equals_the_reference(self, shape, exclude, k, want):
        got = pick_shard_mode(shape, exclude=exclude, n_shards=k)
        assert got == r_pick_shard_mode(shape, exclude=exclude, n_shards=k)
        assert got == want

    def test_importable_from_the_search(self):
        from repro_torch.core.schedule_opt import (pick_shard_mode as p1,
                                                   pick_shard_mode_group)
        assert p1 is pick_shard_mode
        assert pick_shard_mode_group((64, 16, 16), (1, 2), 8) == 0


# ---------------------------------------------------------------------------
# Shard-aware schedule resolution, field by field against the reference
# ---------------------------------------------------------------------------

SCHED_SHAPES = [((24, 40, 16), (4, 5, 6)), ((64, 48, 40), (8, 6, 5)),
                ((5, 7, 9), (2, 2, 2)), ((32, 32, 32), (4, 4, 4)),
                ((64, 16, 16), (4, 4, 4)), ((24, 20, 16, 8), (3, 4, 5, 2))]


class TestShardedSchedule:
    @pytest.mark.parametrize("k", [2, 4, 8])
    @pytest.mark.parametrize("shape,ranks", SCHED_SHAPES)
    @pytest.mark.parametrize("methods", ["eig", "als", "svd", "auto"])
    @pytest.mark.parametrize("mode_order", [None, "shrink", "opt"])
    def test_equals_the_reference(self, k, shape, ranks, methods,
                                  mode_order):
        kw = dict(methods=methods, mode_order=mode_order,
                  backend="sharded", n_shards=k)
        got = resolve_schedule(shape, ranks, platform=CPU, **kw)
        want = r_resolve_schedule(shape, ranks, **kw)
        assert steps_dict(got) == steps_dict(want)

    @pytest.mark.parametrize("k", [2, 4, 8])
    def test_bf16_and_capped_equal_the_reference(self, k):
        shape, ranks = (64, 48, 40), (8, 6, 5)
        cap = max(s.peak_bytes for s in r_resolve_schedule(
            shape, ranks, methods="eig", mode_order="opt", backend="sharded",
            n_shards=k, itemsize=2))
        kw = dict(methods="eig", mode_order="opt", backend="sharded",
                  n_shards=k, itemsize=2, memory_cap_bytes=cap)
        assert steps_dict(resolve_schedule(shape, ranks, platform=CPU, **kw)) \
            == steps_dict(r_resolve_schedule(shape, ranks, **kw))

    def test_shard_modes_follow_the_shrinking_tensor(self):
        steps = resolve_schedule((24, 40, 16), (4, 5, 6), methods="eig",
                                 backend="sharded", n_shards=8)
        assert [s.shard_mode for s in steps] == [1, 2, None]
        assert [s.n_shards for s in steps] == [8, 8, 1]

    def test_peak_bytes_divide_by_shard_count(self):
        single = resolve_schedule((64, 48, 40), (8, 8, 8), methods="eig")
        shard = resolve_schedule((64, 48, 40), (8, 8, 8), methods="eig",
                                 backend="sharded", n_shards=8)
        s1, s8 = single[0], shard[0]
        io1 = (s1.i_n * s1.j_n + s1.r_n * s1.j_n) * 4
        assert s8.peak_bytes == io1 // 8 + s1.i_n * s1.i_n * 4
        assert s8.peak_bytes < s1.peak_bytes

    def test_replicated_steps_keep_single_device_model(self):
        steps = resolve_schedule((5, 7, 9), (2, 2, 2), methods="eig",
                                 backend="sharded", n_shards=4)
        ref = resolve_schedule((5, 7, 9), (2, 2, 2), methods="eig")
        assert all(s.shard_mode is None and s.n_shards == 1 for s in steps)
        assert [s.peak_bytes for s in steps] == [s.peak_bytes for s in ref]

    def test_svd_and_rand_steps_never_shard(self):
        for m in ("svd", "rand"):
            steps = resolve_schedule((24, 40, 16), (4, 5, 6), methods=m,
                                     backend="sharded", n_shards=8)
            assert all(s.shard_mode is None and s.n_shards == 1
                       for s in steps)

    def test_sharded_rejects_non_sthosvd_variants(self):
        for variant in ("thosvd", "hooi"):
            with pytest.raises(ValueError, match="sthosvd"):
                resolve_schedule((8, 8, 8), (2, 2, 2), methods="eig",
                                 variant=variant, backend="sharded",
                                 n_shards=4)

    def test_modestep_dict_roundtrip_keeps_shard_fields(self):
        steps = resolve_schedule((24, 40, 16), (4, 5, 6), methods="eig",
                                 backend="sharded", n_shards=8)
        for s in steps:
            assert ModeStep.from_dict(s.to_dict()) == s
            assert RModeStep.from_dict(s.to_dict()).to_dict() == s.to_dict()
        d = steps[0].to_dict()
        del d["shard_mode"], d["n_shards"]
        s = ModeStep.from_dict(d)
        assert s.shard_mode is None and s.n_shards == 1

    def test_hopper_local_steps_add_the_rank_view_workspace(self):
        """On the card a sharded step is priced as a ``hopper`` step at the
        rank's view: never below the reference's per-device figure, and the
        first step (nothing held yet, no reshard) exactly that figure plus
        the kernels' workspace at the slab and the failure code's element
        after the Gram, which the all-reduce sums in place."""
        from repro_torch.core.plan import (H100_SMS, _all_reduce_bytes,
                                           _hopper_workspace_bytes, _slab)
        shape, ranks, k = (64, 48, 40), (8, 6, 5), 4
        ref = resolve_schedule(shape, ranks, methods="eig",
                               backend="sharded", n_shards=k)
        hop = resolve_schedule(shape, ranks, methods="eig",
                               backend="sharded", n_shards=k,
                               local_backend="hopper")
        assert [s.shard_mode for s in hop] == [s.shard_mode for s in ref]
        assert all(h.peak_bytes > r.peak_bytes for h, r in zip(hop, ref))
        s0 = hop[0]
        view = _slab(shape, s0.shard_mode, k)
        assert s0.peak_bytes == ref[0].peak_bytes + _hopper_workspace_bytes(
            "eig", 1, 64, 8, view[1] * view[2], 4, H100_SMS,
            first_mode=True) + _all_reduce_bytes([("eig", 64, 8)], 4)
        assert _all_reduce_bytes([("eig", 64, 8)], 4) == 4


class TestShardedSearch:
    @pytest.mark.parametrize("k", [2, 4, 8])
    def test_per_device_cap_feasible_only_when_sharded(self, k):
        from repro_torch.core.schedule_opt import (MemoryCapError,
                                                   optimize_schedule)
        shape, ranks = (64, 48, 40), (8, 6, 5)
        steps1 = resolve_schedule(shape, ranks, methods="eig",
                                  mode_order="opt")
        cap = max(s.peak_bytes for s in steps1) // 4
        with pytest.raises(MemoryCapError):
            optimize_schedule(shape, ranks, methods=["eig"] * 3,
                              memory_cap_bytes=cap)
        got = optimize_schedule(shape, ranks, methods=["eig"] * 3,
                                n_shards=8, memory_cap_bytes=cap)
        want = R.optimize_schedule(shape, ranks, methods=["eig"] * 3,
                                   n_shards=8, memory_cap_bytes=cap)
        assert got.to_dict() == want.to_dict()
        steps = resolve_schedule(shape, ranks, methods="eig",
                                 mode_order="opt", backend="sharded",
                                 n_shards=k, memory_cap_bytes=cap * 8 // k)
        assert all(s.peak_bytes <= cap * 8 // k for s in steps)

    @pytest.mark.parametrize("shape,ranks,methods,mode_parallel", [
        ((64, 48, 40), (8, 6, 5), "eig", "off"),
        ((64, 48, 40), (8, 6, 5), "als", "off"),
        ((64, 48, 40), (8, 6, 5), None, "off"),
        ((32, 24, 16, 8), (4, 4, 4, 4), "eig", "off"),
        ((32, 24, 16, 8), (4, 4, 4, 4), "eig", "auto"),
        ((64, 48, 40), (8, 6, 5), "eig", "auto"),
        ((64, 48, 40), (8, 6, 5), "als", "auto"),
    ])
    def test_hopper_search_least_cap_is_admitted_by_the_plan(
            self, shape, ranks, methods, mode_parallel):
        """With ``hopper`` computing each rank's slab, the search prices a
        candidate as the plan prices its step (the rank's slab of the held
        input, the reshard from the previous shard mode): at the least cap
        the search admits, the plan resolves the same schedule, every step
        fits, and the binding step sits exactly on the cap."""
        from repro_torch.core.schedule_opt import (MemoryCapError,
                                                   optimize_schedule,
                                                   validate_schedule_cap)
        k, n = 4, len(shape)
        kw = dict(methods=None if methods is None else (methods,) * n,
                  n_shards=k, backend="hopper",
                  max_group=n if mode_parallel == "auto" else 1)
        lo, hi = 1, 1 << 40
        while hi - lo > 1:
            mid = (lo + hi) // 2
            try:
                optimize_schedule(shape, ranks, memory_cap_bytes=mid, **kw)
                hi = mid
            except MemoryCapError:
                lo = mid
        search = optimize_schedule(shape, ranks, memory_cap_bytes=hi, **kw)
        steps = resolve_schedule(shape, ranks, methods=methods or "auto",
                                 selector=(lambda **_: "eig")
                                 if methods is None else None,
                                 mode_order="opt", backend="sharded",
                                 n_shards=k, local_backend="hopper",
                                 memory_cap_bytes=hi,
                                 mode_parallel=mode_parallel)
        validate_schedule_cap(steps, hi)
        assert tuple(s.mode for s in steps) == search.order
        assert tuple(s.method for s in steps) == search.methods
        assert max(s.peak_bytes for s in steps) == hi

    def test_opt_schedule_first_step_shards(self):
        steps = resolve_schedule((64, 48, 40), (8, 6, 5), methods="eig",
                                 mode_order="opt", backend="sharded",
                                 n_shards=8)
        assert sorted(s.mode for s in steps) == [0, 1, 2]
        assert steps[0].n_shards == 8


# ---------------------------------------------------------------------------
# Backend registry and config validation
# ---------------------------------------------------------------------------

class TestShardedBackendRegistry:
    def test_registered_with_capabilities(self):
        b = get_backend("sharded")
        assert b.requires_mesh and not b.matricizes
        assert b.native_on("cpu") and b.native_on("cuda")

    def test_explicit_name_without_mesh_rejected(self):
        with pytest.raises(ValueError, match="requires a mesh"):
            resolve_backend("sharded", platform=CPU)

    def test_auto_without_mesh_never_picks_sharded(self):
        assert resolve_backend("auto", platform=CPU).name == "matfree"
        assert resolve_backend("auto", platform="cuda").name == "hopper"

    def test_local_backend_is_the_device_auto(self):
        from repro_torch.core.backend import local_backend
        assert local_backend("cpu", "float32") == "matfree"
        assert local_backend("cuda", "float32") == "hopper"
        assert local_backend("cuda", "float64") == "matfree"

    def test_plan_without_mesh_rejected(self):
        with pytest.raises(ValueError, match="requires a mesh"):
            plan((8, 8, 8), "float32",
                 TuckerConfig(ranks=(2, 2, 2), methods="eig",
                              impl="sharded"), device=CPU)

    def test_not_a_device_mesh_rejected(self):
        with pytest.raises(ValueError, match="DeviceMesh"):
            TuckerConfig(ranks=(2, 2, 2), mesh=object(), impl="sharded")

    def test_shard_axis_must_be_a_mesh_axis(self, mesh1):
        with pytest.raises(ValueError, match="shard_axis"):
            TuckerConfig(ranks=(2, 2, 2), mesh=mesh1, shard_axis="model",
                         impl="sharded")

    def test_mesh_with_single_device_impl_rejected(self, mesh1):
        for impl in ("matfree", "explicit", "hopper"):
            with pytest.raises(ValueError, match="single device"):
                TuckerConfig(ranks=(2, 2, 2), mesh=mesh1, impl=impl)
        TuckerConfig(ranks=(2, 2, 2), mesh=mesh1, impl="sharded")
        c = TuckerConfig(ranks=(2, 2, 2), mesh=mesh1, impl="auto")
        assert c.resolved_shard_axis == "data" and c.n_shards == 1

    def test_rank_adaptive_with_a_mesh_rejected(self, mesh1):
        with pytest.raises(ValueError, match="replicated"):
            TuckerConfig(error_target=0.1, mesh=mesh1, impl="auto")

    def test_engine_drops_mesh_for_single_device_pin(self, mesh1):
        from repro_torch.serve import TuckerBatchEngine
        eng = TuckerBatchEngine(impl="matfree", mesh=mesh1, device=CPU)
        cfg = eng._pinned(TuckerConfig(ranks=(2, 2, 2), methods="eig"))
        assert cfg.impl == "matfree" and cfg.mesh is None
        eng = TuckerBatchEngine(mesh=mesh1, device=CPU)
        cfg = eng._pinned(TuckerConfig(ranks=(2, 2, 2), methods="eig"))
        assert cfg.impl == "sharded" and cfg.mesh is mesh1

    def test_sharded_variant_guard_at_plan_time(self, mesh1):
        for variant in ("thosvd", "hooi"):
            with pytest.raises(ValueError, match="sthosvd"):
                plan((8, 8, 8), "float32",
                     TuckerConfig(ranks=(2, 2, 2), methods="eig",
                                  variant=variant, impl="sharded",
                                  mesh=mesh1), device=CPU)

    def test_mesh_device_default_raises_without_cuda(self, mesh1):
        if torch.cuda.is_available():
            pytest.skip("the default device exists on a CUDA host")
        with pytest.raises(RuntimeError, match="CUDA"):
            plan((8, 8, 8), "float32",
                 TuckerConfig(ranks=(2, 2, 2), methods="eig", mesh=mesh1,
                              impl="auto"))


# ---------------------------------------------------------------------------
# Mesh spec + plan JSON round trip on a 1-rank group in this process
# ---------------------------------------------------------------------------

class TestMeshSerialization:
    def test_mesh_spec_roundtrip_equals_the_reference(self, mesh1):
        spec = mesh_spec(mesh1)
        assert spec == {"axis_names": ["data"], "shape": [1]}
        assert spec == R.mesh_spec(jax.make_mesh((1,), ("data",)))
        rebuilt = mesh_from_spec(spec)
        assert rebuilt is not None and mesh_spec(rebuilt) == spec
        assert mesh_spec(None) is None and mesh_from_spec(None) is None

    def test_oversized_spec_degrades_to_none(self, mesh1):
        assert mesh_from_spec({"axis_names": ["data"],
                               "shape": [10 ** 6]}) is None

    def test_config_dict_roundtrip_with_mesh(self, mesh1):
        c = TuckerConfig(ranks=(2, 2, 2), methods="eig", impl="sharded",
                         mesh=mesh1, shard_axis="data")
        d = c.to_dict()
        rc = R.TuckerConfig(ranks=(2, 2, 2), methods="eig", impl="sharded",
                            mesh=jax.make_mesh((1,), ("data",)),
                            shard_axis="data")
        assert d == rc.to_dict()
        c2 = TuckerConfig.from_dict(d)
        assert c2.shard_axis == "data" and c2.impl == "sharded"
        assert mesh_spec(c2.mesh) == mesh_spec(mesh1)

    def test_plan_json_roundtrip_and_execute_on_one_rank(self, mesh1,
                                                         tmp_path):
        x = np.random.default_rng(0).standard_normal((8, 7, 6)) \
            .astype(np.float32)
        cfg = TuckerConfig(ranks=(2, 3, 2), methods="eig", impl="sharded",
                           mesh=mesh1)
        p = plan(x.shape, "float32", cfg, device=CPU)
        assert p.backend == "sharded" and p.local_backend == "matfree"
        path = tmp_path / "p.json"
        p.save(path)
        p2 = TuckerPlan.load(path, device=CPU)
        assert p2.schedule == p.schedule
        assert p2.config.shard_axis == cfg.shard_axis
        assert mesh_spec(p2.config.mesh) == mesh_spec(mesh1)
        r1, r2 = p.execute(x), p2.execute(x)
        for a, b in zip([r1.tucker.core, *r1.tucker.factors],
                        [r2.tucker.core, *r2.tucker.factors]):
            assert torch.equal(a, b)
        # a 1-rank mesh is degenerate sharding: equal to the matfree plan
        ref = plan(x.shape, "float32", TuckerConfig(ranks=(2, 3, 2),
                                                    methods="eig"),
                   device=CPU).execute(x)
        for a, b in zip([r1.tucker.core, *r1.tucker.factors],
                        [ref.tucker.core, *ref.tucker.factors]):
            assert torch.equal(a, b)

    def test_plan_loaded_without_its_mesh_raises_on_execute(self, mesh1):
        p = plan((8, 8, 8), "float32",
                 TuckerConfig(ranks=(2, 2, 2), methods="eig",
                              impl="sharded", mesh=mesh1), device=CPU)
        d = p.to_dict()
        d["config"]["mesh"] = {"axis_names": ["data"], "shape": [4]}
        p2 = TuckerPlan.from_dict(d, device=CPU)
        assert p2.config.mesh is None and p2.schedule == p.schedule
        with pytest.raises(RuntimeError, match="requires a mesh"):
            p2.execute(np.ones((8, 8, 8), np.float32))

    def test_describe_and_record(self, mesh1):
        p = plan((8, 8, 8), "float32",
                 TuckerConfig(ranks=(2, 2, 2), methods="eig",
                              impl="sharded", mesh=mesh1), device=CPU)
        text = p.describe()
        assert "mesh={'axis_names': ['data'], 'shape': [1]}" in text
        assert "local_backend=matfree" in text
        assert not p.captures
        with pytest.raises(ValueError, match="record"):
            p.execute(np.ones((8, 8, 8), np.float32), record=True)


# ---------------------------------------------------------------------------
# Execution parity in 2 and 4 gloo ranks on the CPU
# ---------------------------------------------------------------------------

SHAPE, RANKS = (24, 40, 16), (4, 5, 6)
SHAPE2 = (24, 40, 15)
METHODS = ("eig", "als", "auto")

RANK_BODY = '''
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.core import (CACHE_STATS, InputError, MemoryCapError,
                              TuckerConfig, TuckerPlan, clear_sweep_cache,
                              mesh_spec, plan)
from repro_torch.core.distributed import sthosvd_distributed
from repro_torch.serve import TuckerBatchEngine, TuckerRequest

def npy(t):
    return t.detach().cpu().double().numpy()

def res(r):
    return {"core": npy(r.tucker.core),
            "factors": [npy(u) for u in r.tucker.factors],
            "methods": r.methods}

X, Y = data["x"], data["y"]
cfg = dict(ranks=(4, 5, 6), impl="sharded", mesh=mesh)
for m in ("eig", "als", "auto"):
    p = plan(X.shape, "float32", TuckerConfig(methods=m, **cfg), device="cpu")
    out["plan_" + m] = dict(res(p.execute(X)), backend=p.backend,
                            steps=[s.to_dict() for s in p.schedule])
    xb = torch.from_numpy(X).to(torch.bfloat16)
    pb = plan(X.shape, "bfloat16", TuckerConfig(methods=m, **cfg),
              device="cpu")
    out["bf16_" + m] = res(pb.execute(xb))
p = plan(X.shape, "float32", TuckerConfig(ranks=(4, 5, 6), methods="eig",
                                          impl="auto", mesh=mesh),
         device="cpu")
out["auto_backend"] = (p.backend, p.local_backend)
clear_sweep_cache()
p = plan(X.shape, "float32", TuckerConfig(methods="eig", **cfg), device="cpu")
for i in range(3):
    p.execute(X + float(i))
out["cache"] = dict(CACHE_STATS)
base = p.execute(X)
p2 = TuckerPlan.from_json(p.to_json(), device="cpu")
out["json"] = (p2.schedule == p.schedule, mesh_spec(p2.config.mesh),
               [s.shard_mode for s in p2.schedule])
out["json_res"] = res(p2.execute(X))
out["global"] = res(base)
xt = torch.from_numpy(X)
sm = p.schedule[0].shard_mode
c = X.shape[sm] // world
out["dt_first"] = res(p.execute(DTensor.from_local(
    xt.narrow(sm, rank * c, c).contiguous(), mesh, [Shard(sm)])))
c0 = X.shape[0] // world
out["dt_other"] = res(p.execute(DTensor.from_local(
    xt.narrow(0, rank * c0, c0).contiguous(), mesh, [Shard(0)])))
out["dt_rep"] = res(p.execute(DTensor.from_local(xt.clone(), mesh,
                                                 [Replicate()])))
bad = xt.narrow(sm, rank * c, c).clone()
if rank == world - 1:
    bad[0, 0, 0] = float("nan")
try:
    p.execute(DTensor.from_local(bad, mesh, [Shard(sm)]), validate="finite")
    out["nan"] = None
except InputError as e:
    out["nan"] = str(e)
for m in ("eig", "als", "auto"):
    r = sthosvd_distributed(X, (4, 5, 6), mesh, methods=m, device="cpu")
    out["legacy_" + m] = dict(res(r), seconds=[t.seconds for t in r.trace],
                              backends=[t.backend for t in r.trace])
out["legacy_opt"] = res(sthosvd_distributed(X, (4, 5, 6), mesh,
                                            methods="eig", mode_order="opt",
                                            device="cpu"))
try:
    sthosvd_distributed(X, (4, 5, 6), mesh, methods="eig",
                        memory_cap_bytes=1000, device="cpu")
    out["cap_msg"] = None
except MemoryCapError as e:
    out["cap_msg"] = str(e)
po = plan(X.shape, "float32", TuckerConfig(methods="eig", mode_order="opt",
                                           memory_cap_bytes=64 << 20, **cfg),
          device="cpu")
out["opt"] = res(po.execute(X))
d = p.for_shape(SHAPE2)
direct = plan(SHAPE2, "float32", p.config, device="cpu")
out["for_shape"] = dict(same=d.schedule == direct.schedule,
                        spec=mesh_spec(d.config.mesh), backend=d.backend,
                        shard_modes=[s.shard_mode for s in d.schedule],
                        identity=p.for_shape(X.shape) is p)
out["for_shape_res"] = (res(d.execute(Y)), res(direct.execute(Y)))
pa = plan(X.shape, "float32", TuckerConfig(methods=("als", "eig", "als"),
                                           **cfg), device="cpu")
pinned = pa.for_shape(SHAPE2, keep_methods=True)
out["pinned"] = (pinned.methods, pa.methods,
                 [s.mode for s in pinned.schedule],
                 [s.mode for s in pa.schedule])
eng = TuckerBatchEngine(mesh=mesh, device="cpu")
ecfg = TuckerConfig(ranks=(4, 5, 6), methods="eig")
reqs = [TuckerRequest(x=z, config=ecfg, rid=i)
        for i, z in enumerate(data["reqs"])]
eng.run(reqs)
st = eng.stats
eng.close()
out["engine"] = dict(backends=st["backends"], plans=st["plans_built"],
                     batches=st["batches"],
                     results=[res(r.result) for r in reqs])
# an OOM planted on rank 0 alone at the plan's "sweep" seam, before the
# sweep's first collective: every rank reads rank 0's code in that
# collective and takes the ladder's replan_cap rung together (the cap
# leaves it room to replan); the plan runs clean again afterwards
from repro_torch import chaos
from repro_torch.core import fallback_hops, reset_fallback_hops
p = plan(X.shape, "float32", TuckerConfig(methods="eig",
                                          memory_cap_bytes=64 << 20, **cfg),
         device="cpu")
want = res(p.execute(X))
reset_fallback_hops()
err = None
if rank == 0:
    chaos.install([chaos.Rule(seam="sweep", action="oom", times=1)])
try:
    hop = res(p.execute(X))
except Exception as e:
    err, hop = type(e).__name__, None
chaos.reset()
got = res(p.execute(X))
out["oom"] = dict(err=err, hops=fallback_hops(), want=want, got=got, hop=hop)
'''


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks_run(request, tmp_path_factory):
    """One run of RANK_BODY in ``world`` ranks: (world, data, outs)."""
    world = request.param
    data = dict(x=lowrank(SHAPE, RANKS, seed=0, noise=1e-3),
                y=lowrank(SHAPE2, RANKS, seed=1, noise=1e-3),
                reqs=[lowrank(SHAPE, RANKS, seed=10 + i, noise=1e-3)
                      for i in range(4)])
    body = f"SHAPE2 = {SHAPE2!r}\n" + RANK_BODY
    outs = run_ranks(tmp_path_factory.mktemp(f"w{world}"), world, body,
                     timeout=120, **data)
    return world, data, outs


def reference(x, methods, dtype=jnp.float32):
    cfg = R.TuckerConfig(ranks=RANKS, methods=methods)
    return R.plan(x.shape, dtype, cfg).execute(jnp.asarray(x, dtype))


def check(x, got, want, dtype="float32"):
    """Hold one rank's result to the reference's decomposition of x."""
    gap = max_projector_gap(got["factors"], want.tucker.factors)
    assert gap <= PROJ_TOL[dtype], gap
    e_got = rel_error_np(x, got["core"], got["factors"])
    e_want = rel_error_np(x, want.tucker.core, want.tucker.factors)
    assert abs(e_got - e_want) <= REL_TOL, (e_got, e_want)


def same_on_every_rank(outs, key, sub=None):
    """Every rank's factors (and core) bitwise equal to rank 0's."""
    def get(o):
        v = o[key]
        return v if sub is None else v[sub]
    first = get(outs[0])
    for o in outs[1:]:
        v = get(o)
        assert all(np.array_equal(a, b)
                   for a, b in zip(v["factors"], first["factors"]))
        assert np.array_equal(v["core"], first["core"])


class TestShardedExecution:
    @pytest.mark.parametrize("methods", METHODS)
    def test_plan_matches_reference_matfree(self, ranks_run, methods):
        world, data, outs = ranks_run
        want = reference(data["x"], methods)
        for o in outs:
            got = o["plan_" + methods]
            assert got["backend"] == "sharded"
            assert got["steps"][0]["n_shards"] == world
            assert tuple(got["methods"]) == tuple(want.methods)
            check(data["x"], got, want)
        same_on_every_rank(outs, "plan_" + methods)

    @pytest.mark.parametrize("methods", METHODS)
    def test_bf16_matches_reference_matfree(self, ranks_run, methods):
        _, data, outs = ranks_run
        want = reference(data["x"], methods, jnp.bfloat16)
        for o in outs:
            gap = max_projector_gap(o["bf16_" + methods]["factors"],
                                    want.tucker.factors)
            assert gap <= PROJ_TOL["bfloat16"], gap
        same_on_every_rank(outs, "bf16_" + methods)

    def test_schedule_equals_the_reference(self, ranks_run):
        """The executed plan's steps equal the reference's sharded
        resolution, its predictions priced by the ranks' local backend's
        calibration (the port's plan selects and prices with the backend
        each rank computes on, ``matfree`` here)."""
        world, data, outs = ranks_run
        cm = R.default_selector(backend="matfree").cost_model
        for m in ("eig", "als"):
            want = R.plan(SHAPE, jnp.float32, R.TuckerConfig(
                ranks=RANKS, methods=m, impl="matfree"))
            steps = r_resolve_schedule(SHAPE, RANKS, methods=m,
                                       backend="sharded", n_shards=world,
                                       cost_model=cm)
            assert outs[0]["plan_" + m]["steps"] == steps_dict(steps)
            assert [s["method"] for s in outs[0]["plan_" + m]["steps"]] \
                == [s.method for s in want.schedule]

    def test_auto_with_a_mesh_resolves_to_sharded(self, ranks_run):
        _, _, outs = ranks_run
        assert all(o["auto_backend"] == ("sharded", "matfree") for o in outs)

    def test_plan_reuse_builds_one_eager_sweep(self, ranks_run):
        _, _, outs = ranks_run
        for o in outs:
            assert o["cache"] == {"builds": 1, "hits": 2, "traces": 1}

    def test_json_roundtrip_rebuilds_mesh(self, ranks_run):
        world, _, outs = ranks_run
        for o in outs:
            same, spec, _ = o["json"]
            assert same and spec == {"axis_names": ["data"],
                                     "shape": [world]}
            for a, b in zip(o["json_res"]["factors"],
                            o["global"]["factors"]):
                assert np.array_equal(a, b)

    @pytest.mark.parametrize("key", ["dt_first", "dt_other", "dt_rep"])
    def test_dtensor_input_equals_global_input(self, ranks_run, key):
        world, data, outs = ranks_run
        want = reference(data["x"], "eig")
        for o in outs:
            check(data["x"], o[key], want)
            if key == "dt_first":   # no data move: the same slabs
                assert all(np.array_equal(a, b) for a, b in
                           zip(o[key]["factors"], o["global"]["factors"]))
        same_on_every_rank(outs, key)

    def test_non_finite_slab_fails_every_rank(self, ranks_run):
        world, _, outs = ranks_run
        for r, o in enumerate(outs):
            assert o["nan"] is not None
            if r == world - 1:
                assert "mode" in o["nan"]
            else:
                assert "other ranks" in o["nan"]

    @pytest.mark.parametrize("methods", METHODS)
    def test_legacy_wrapper_records_wall_clock(self, ranks_run, methods):
        _, data, outs = ranks_run
        want = reference(data["x"], methods)
        for o in outs:
            got = o["legacy_" + methods]
            assert all(t > 0 for t in got["seconds"])
            assert all(b == "sharded" for b in got["backends"])
            assert got["core"].shape == RANKS
            check(data["x"], got, want)
        same_on_every_rank(outs, "legacy_" + methods)

    def test_legacy_wrapper_takes_mode_order_and_cap(self, ranks_run):
        _, data, outs = ranks_run
        want = reference(data["x"], "eig")
        for o in outs:
            check(data["x"], o["legacy_opt"], want)
            assert o["cap_msg"] is not None and "bytes" in o["cap_msg"]

    def test_opt_plan_executes_on_mesh(self, ranks_run):
        _, data, outs = ranks_run
        want = reference(data["x"], "eig")
        for o in outs:
            check(data["x"], o["opt"], want)
        same_on_every_rank(outs, "opt")

    def test_for_shape_rederives_sharded_plans(self, ranks_run):
        world, data, outs = ranks_run
        for o in outs:
            f = o["for_shape"]
            assert f["same"] and f["identity"] and f["backend"] == "sharded"
            assert f["spec"] == {"axis_names": ["data"], "shape": [world]}
            want = [s.shard_mode for s in r_resolve_schedule(
                SHAPE2, RANKS, methods="eig", backend="sharded",
                n_shards=world)]
            assert f["shard_modes"] == want
            a, b = o["for_shape_res"]
            for u, v in zip(a["factors"], b["factors"]):
                assert np.array_equal(u, v)
            pm, am, pmodes, amodes = o["pinned"]
            assert tuple(pm) == tuple(am) and pmodes == amodes

    def test_oom_on_one_rank_takes_no_rung(self, ranks_run):
        """An OOM on rank 0 alone: no rank takes a rung of its own.  Every
        rank takes the same agreed rung (replan_cap), no rank raises, the
        degraded results are bitwise equal across ranks, and the plan then
        runs as before."""
        _, data, outs = ranks_run
        for o in outs:
            f = o["oom"]
            assert f["err"] is None
            assert f["hops"] == {("replan_cap", "sharded"): 1}
            for a, b in zip([f["got"]["core"], *f["got"]["factors"]],
                            [f["want"]["core"], *f["want"]["factors"]]):
                assert np.array_equal(a, b)
            check(data["x"], f["hop"], reference(data["x"], "eig"))
        same_on_every_rank(outs, "oom", "got")
        same_on_every_rank(outs, "oom", "hop")

    def test_engine_executes_sharded_with_mesh(self, ranks_run):
        _, data, outs = ranks_run
        for o in outs:
            e = o["engine"]
            assert e["backends"] == {"sharded": 4}
            assert e["plans"] == 1 and e["batches"] == 1
            for z, got in zip(data["reqs"], e["results"]):
                check(z, got, reference(z, "eig"))
        for i in range(4):
            first = outs[0]["engine"]["results"][i]
            for o in outs[1:]:
                assert all(np.array_equal(a, b) for a, b in
                           zip(o["engine"]["results"][i]["factors"],
                               first["factors"]))


# ---------------------------------------------------------------------------
# A rank-local failure after the sweep's first collectives: the agreed rung
# ---------------------------------------------------------------------------

FAULT_BODY = '''
from repro_torch import chaos
from repro_torch.core import (TuckerConfig, fallback_hops, plan,
                              reset_fallback_hops)
from repro_torch.core.distributed import (collective_stats,
                                          planned_collectives,
                                          reset_collective_stats)
from repro_torch.serve import TuckerService

def npy(t):
    return t.detach().cpu().double().numpy()

def res(r):
    return {"core": npy(r.tucker.core),
            "factors": [npy(u) for u in r.tucker.factors],
            "methods": r.methods, "order": [t.mode for t in r.trace]}

X = data["x"]
cfg = dict(ranks=(4, 5, 6), impl="sharded", mesh=mesh)
faulty = world - 1
# a healthy sweep issues exactly the planned collectives
p = plan(X.shape, "float32", TuckerConfig(methods="als", **cfg), device="cpu")
reset_collective_stats()
p.execute(X)
planned = planned_collectives(X.shape, torch.float32, p.schedule, world,
                              p.schedule[0].shard_mode, p.config.als_iters,
                              p.local_backend)
out["planned"] = dict(
    n=len(planned), kinds=sorted({k for k, _, _ in planned}),
    calls=sum(int(v["calls"]) for v in collective_stats().values()),
    bytes=sum(int(v["bytes"]) for v in collective_stats().values()),
    want_bytes=sum((n + (world if k == "all_to_all" else 1)) * 4
                   for k, n, _ in planned))
cases = {
    # an OOM at the start of step 1 on the last rank: every rank takes
    # replan_cap (the cap leaves it room)
    "oom": (TuckerConfig(methods="eig", memory_cap_bytes=64 << 20, **cfg),
            chaos.Rule(seam="solve", action="oom", at=1)),
    # a numerical breakdown there on an ALS plan: every rank takes als_to_eig
    "numerical": (TuckerConfig(methods="als", **cfg),
                  chaos.Rule(seam="solve", action="raise", at=1,
                             message="Cholesky failed: non-finite Gram")),
}
for name, (c, rule) in cases.items():
    p = plan(X.shape, "float32", c, device="cpu")
    reset_fallback_hops()
    reset_collective_stats()
    if rank == faulty:
        chaos.install([rule])
    r = p.execute(X)
    out[name] = dict(res(r), hops=fallback_hops(), fired=chaos.fired(),
                     collectives=collective_stats())
    chaos.reset()
# an OOM after the failing step has allocated (its second partial-sum
# buffer, step 1's Gram): the rank drops what the step holds before it
# allocates the buffer with which it joins the next collective
import weakref
from repro_torch.core import distributed as D
late, alive = [], []
real_sums, real_join = D.partial_sums, D._Link.join
def sums(shape, dtype, device):
    buf, t = real_sums(shape, dtype, device)
    late.append(weakref.ref(buf))
    if len(late) == 2:
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (planted)")
    return buf, t
def join(self, *args):
    alive.append(late[1]() is not None)
    return real_join(self, *args)
if rank == faulty:
    D.partial_sums, D._Link.join = sums, join
p = plan(X.shape, "float32", cases["oom"][0], device="cpu")
reset_fallback_hops()
try:
    r = p.execute(X)
finally:
    D.partial_sums, D._Link.join = real_sums, real_join
out["oom_late"] = dict(res(r), hops=fallback_hops(), alive=alive)
# the mesh service's synchronous waves: a numerical breakdown planted in
# the first lane's step 1 on one rank quarantines that lane on every rank,
# whose bisection re-runs it clean; its wave-mates keep their results
svc = TuckerService(mesh=mesh, device="cpu")
ecfg = TuckerConfig(ranks=(4, 5, 6), methods="eig")
reset_fallback_hops()
if rank == faulty:
    chaos.install([chaos.Rule(seam="solve", action="raise", at=1,
                              message="non-finite Gram")])
tickets = [svc.submit(z, ecfg, rid=i) for i, z in enumerate(data["reqs"])]
svc.drain()
chaos.reset()
st = svc.stats()
out["service"] = dict(results=[res(svc.poll(t)) for t in tickets],
                      resilience=st["resilience"], requests=st["requests"],
                      failed=st["failed"], hops=fallback_hops())
svc.close()
'''


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def fault_run(request, tmp_path_factory):
    """One run of FAULT_BODY in ``world`` ranks: (world, data, outs)."""
    world = request.param
    data = dict(x=lowrank(SHAPE, RANKS, seed=0, noise=1e-3),
                reqs=[lowrank(SHAPE, RANKS, seed=20 + i, noise=1e-3)
                      for i in range(4)])
    outs = run_ranks(tmp_path_factory.mktemp(f"fault{world}"), world,
                     FAULT_BODY, timeout=120, **data)
    return world, data, outs


def matfree_of(x, got):
    """The port's single-device ``matfree`` plan of the degraded config:
    the methods and mode order the ranks ran."""
    order = tuple(got["order"])
    cfg = TuckerConfig(ranks=RANKS, methods=tuple(got["methods"]),
                       mode_order=order, impl="matfree")
    r = plan(x.shape, "float32", cfg, device=CPU).execute(x)
    return r.tucker


def hold_to_matfree(x, got):
    """Factors within PROJ_TOL of the single-device plan's (projectors),
    rel_error within REL_TOL, the core of the same shape."""
    want = matfree_of(x, got)
    gap = max_projector_gap(got["factors"], [u.numpy() for u in want.factors])
    assert gap <= PROJ_TOL["float32"], gap
    e_got = rel_error_np(x, got["core"], got["factors"])
    e_want = rel_error_np(x, want.core.numpy(),
                          [u.numpy() for u in want.factors])
    assert abs(e_got - e_want) <= REL_TOL, (e_got, e_want)
    assert got["core"].shape == tuple(want.core.shape)


class TestAgreedFallback:
    """A failure planted on one rank through the ``solve`` chaos seam at
    step 1, after step 0's collectives: every rank reads it in the next
    collective, leaves the sweep there and takes the same rung; nobody
    waits on a peer that has left (each rank process has a 120 s limit)."""

    def test_healthy_sweep_runs_the_planned_collectives(self, fault_run):
        """planned_collectives lists every collective a healthy sweep
        issues, each one flag element larger (k for an all-to-all)."""
        _, _, outs = fault_run
        for o in outs:
            pl = o["planned"]
            assert pl["n"] == pl["calls"] > 0
            assert pl["bytes"] == pl["want_bytes"]

    @pytest.mark.parametrize("case,hop", [("oom", "replan_cap"),
                                          ("numerical", "als_to_eig")])
    def test_every_rank_takes_the_same_rung(self, fault_run, case, hop):
        world, _, outs = fault_run
        for r, o in enumerate(outs):
            assert o[case]["hops"] == {(hop, "sharded"): 1}
            assert sum(o[case]["fired"].values()) == (r == world - 1)
        if case == "numerical":
            assert all(m == "eig" for m in outs[0][case]["methods"])

    @pytest.mark.parametrize("case", ["oom", "numerical"])
    def test_results_bitwise_equal_across_ranks(self, fault_run, case):
        _, _, outs = fault_run
        same_on_every_rank(outs, case)
        for o in outs[1:]:
            assert o[case]["order"] == outs[0][case]["order"]

    @pytest.mark.parametrize("case", ["oom", "numerical"])
    def test_degraded_result_matches_single_device_matfree(self, fault_run,
                                                           case):
        _, data, outs = fault_run
        for o in outs:
            hold_to_matfree(data["x"], o[case])

    def test_oom_after_the_steps_allocations(self, fault_run):
        """An OOM raised once the step has allocated its partial sums: the
        failing rank releases them before it joins the next collective
        (its join would otherwise stack its buffer on the step's), and
        every rank takes replan_cap with results bitwise equal."""
        world, data, outs = fault_run
        for r, o in enumerate(outs):
            assert o["oom_late"]["hops"] == {("replan_cap", "sharded"): 1}
            assert o["oom_late"]["alive"] == ([False] if r == world - 1
                                              else [])
            hold_to_matfree(data["x"], o["oom_late"])
        same_on_every_rank(outs, "oom_late")

    def test_mesh_service_wave_recovers_on_every_rank(self, fault_run):
        _, data, outs = fault_run
        first = outs[0]["service"]
        for o in outs:
            sv = o["service"]
            assert sv["requests"] == 4 and sv["failed"] == 0
            assert sv["resilience"]["quarantined"] == 1
            assert sv["resilience"]["recovered"] == 1
            assert sv["resilience"] == first["resilience"]
            assert sv["hops"] == {}
            for z, got, mine in zip(data["reqs"], first["results"],
                                    sv["results"]):
                assert all(np.array_equal(a, b) for a, b in
                           zip(mine["factors"], got["factors"]))
                assert np.array_equal(mine["core"], got["core"])
                check(z, mine, reference(z, "eig"))
