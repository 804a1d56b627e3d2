"""Port parity for the front door: repro_torch ``plan → execute`` against repro.

Schedules must equal the reference's step for step (method, order, sizes,
flops, peak_bytes, predicted_s): the selector models and cost model are the
reference's, copied as data.  Executes are held to the reference on the
same numpy inputs — EIG (deterministic): reconstruction within 1e-4 of
max|x| and rel_error within 1e-5; ALS, whose random start each package
draws itself: projectors within 1e-3 and rel_error within 1e-4.  Plans run
on ``device="cpu"`` here (the default device is the card).
"""

import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro_torch.core import (InputError, MemoryCapError, NumericalError,
                              TuckerConfig, TuckerPlan, decompose, plan)
from repro_torch.core import tensor_ops as PT
from torch_parity import assert_tucker_close, lowrank

DATA = Path(__file__).parent / "data"
SRC = Path(__file__).resolve().parent.parent / "src"


def _step_key(s):
    return (s.mode, s.method, s.i_n, s.r_n, s.j_n, s.flops, s.peak_bytes,
            s.predicted_s, s.backend)


SCHEDULE_CASES = [((10, 12, 8), (3, 4, 2)), ((48, 224, 128), (40, 8, 12)),
                  ((20, 6, 8), (2, 3, 2)), ((30, 40, 9, 5), (5, 6, 3, 2)),
                  ((320, 240, 70), (10, 10, 10)),
                  ((102, 134, 33, 8), (10, 10, 10, 5))]


class TestSchedules:
    @pytest.mark.parametrize("shape,ranks", SCHEDULE_CASES)
    @pytest.mark.parametrize("methods,mode_order", [
        ("auto", None), ("eig", None), ("als", None), ("auto", "shrink"),
        (("eig", "als", "eig"), (2, 0, 1))])
    def test_schedule_equals_reference(self, shape, ranks, methods,
                                       mode_order):
        if not isinstance(methods, str) and len(methods) != len(shape):
            methods = tuple(methods[m % 3] for m in range(len(shape)))
            mode_order = tuple(reversed(range(len(shape))))
        cfg = dict(ranks=ranks, methods=methods, mode_order=mode_order)
        got = plan(shape, "float32", TuckerConfig(**cfg), device="cpu")
        want = R.plan(shape, jnp.float32, R.TuckerConfig(**cfg))
        assert [_step_key(s) for s in got.schedule] == \
            [_step_key(s) for s in want.schedule]

    @pytest.mark.parametrize("variant", ["thosvd", "hooi"])
    @pytest.mark.parametrize("impl", ["matfree", "explicit"])
    def test_variant_schedules_equal_reference(self, variant, impl):
        cfg = dict(ranks=(3, 4, 2), variant=variant, methods="auto",
                   hooi_iters=2, impl=impl)
        got = plan((10, 12, 8), "float32", TuckerConfig(**cfg), device="cpu")
        want = R.plan((10, 12, 8), jnp.float32, R.TuckerConfig(**cfg))
        assert [_step_key(s) for s in got.schedule] == \
            [_step_key(s) for s in want.schedule]

    def test_bf16_and_compute_dtype_itemsizes(self):
        for dtype, cd in [("bfloat16", None), ("bfloat16", "float32"),
                          ("float64", None)]:
            cfg = dict(ranks=(3, 4, 2), methods="als", compute_dtype=cd)
            got = plan((10, 12, 8), dtype, TuckerConfig(**cfg), device="cpu")
            want = R.plan((10, 12, 8), getattr(jnp, dtype),
                          R.TuckerConfig(**cfg))
            assert [_step_key(s) for s in got.schedule] == \
                [_step_key(s) for s in want.schedule]

    def test_cuda_platform_without_a_model_uses_textbook_costs(
            self, tmp_path, monkeypatch):
        # a model dir holding no cuda model (the shipped dir has trained
        # ones: tests/test_torch_tune.py holds them)
        from repro_torch.core import default_selector
        from repro_torch.core import selector as sel_mod
        monkeypatch.setattr(sel_mod, "_DEFAULT_MODEL_DIR", tmp_path)
        monkeypatch.setattr(sel_mod, "_DEFAULT_BY_PLATFORM", {})
        sel = default_selector("cuda", backend="hopper")
        assert sel.tree is None and sel.cost_model.source == "textbook"


class TestExecuteParity:
    @pytest.mark.parametrize("impl", ["matfree", "hopper"])
    @pytest.mark.parametrize("variant,shape,ranks", [
        ("sthosvd", (12, 15, 10), (3, 4, 2)),
        ("sthosvd", (8, 9, 7, 6), (2, 3, 2, 2)),
        ("thosvd", (10, 9, 8), (2, 3, 2)),
        ("hooi", (10, 9, 8), (2, 3, 2))])
    def test_eig(self, variant, shape, ranks, impl):
        x = lowrank(shape, ranks, seed=1, noise=0.05)
        cfg = dict(ranks=ranks, variant=variant, methods="eig", hooi_iters=2)
        got = plan(shape, "float32", TuckerConfig(impl=impl, **cfg),
                   device="cpu").execute(x)
        want = R.plan(shape, jnp.float32, R.TuckerConfig(**cfg)).execute(
            jnp.asarray(x))
        assert got.tucker.ranks == want.tucker.ranks
        assert_tucker_close(x, got.tucker, want.tucker, proj_atol=1e-3,
                            rel_atol=1e-5, recon_atol=1e-4)

    @pytest.mark.parametrize("impl", ["matfree", "hopper"])
    @pytest.mark.parametrize("variant,shape,ranks,order", [
        ("sthosvd", (12, 15, 10), (3, 4, 2), None),
        ("sthosvd", (20, 6, 8), (2, 3, 2), "shrink"),
        ("thosvd", (10, 9, 8), (2, 3, 2), None),
        ("hooi", (10, 9, 8), (2, 3, 2), None)])
    def test_als(self, variant, shape, ranks, order, impl):
        x = lowrank(shape, ranks, seed=2, noise=0.02)
        cfg = dict(ranks=ranks, variant=variant, methods="als", hooi_iters=2,
                   mode_order=order, als_iters=8)
        got = plan(shape, "float32", TuckerConfig(impl=impl, **cfg),
                   device="cpu").execute(x)
        want = R.plan(shape, jnp.float32, R.TuckerConfig(**cfg)).execute(
            jnp.asarray(x))
        assert_tucker_close(x, got.tucker, want.tucker, proj_atol=1e-3,
                            rel_atol=1e-4)

    def test_auto_methods_and_record(self):
        x = lowrank((24, 30, 16), (4, 5, 3), seed=3, noise=0.05)
        cfg = dict(ranks=(4, 5, 3), methods="auto", mode_order="shrink")
        p = plan(x.shape, "float32", TuckerConfig(**cfg), device="cpu")
        ref = R.plan(x.shape, jnp.float32, R.TuckerConfig(**cfg))
        assert p.methods == ref.methods
        got = p.execute(x, record=True)
        assert all(t.seconds > 0 for t in got.trace)
        assert [t.mode for t in got.trace] == [s.mode for s in p.schedule]
        want = ref.execute(jnp.asarray(x))
        assert_tucker_close(x, got.tucker, want.tucker, proj_atol=1e-3,
                            rel_atol=1e-4)
        assert abs(float(got.tucker.rel_error(x))
                   - float(want.tucker.rel_error(jnp.asarray(x)))) <= 1e-4

    def test_bfloat16_hopper_plan_runs(self):
        x = lowrank((12, 15, 10), (3, 4, 2), seed=4, noise=0.05)
        xb = torch.from_numpy(x).bfloat16()
        for impl in ("hopper", "matfree"):
            res = plan(x.shape, torch.bfloat16, TuckerConfig(
                ranks=(3, 4, 2), methods="eig", impl=impl),
                device="cpu").execute(xb)
            assert res.tucker.core.dtype == torch.bfloat16
            assert float(res.tucker.rel_error(x)) < 0.1

    def test_bfloat16_numpy_input_from_jax(self):
        """A jax bf16 array, as numpy, is taken bit for bit."""
        x = lowrank((12, 15, 10), (3, 4, 2), seed=6, noise=0.05)
        xj = np.asarray(jnp.asarray(x, jnp.bfloat16))
        p = plan(x.shape, "bfloat16", TuckerConfig(
            ranks=(3, 4, 2), methods="eig", impl="matfree"), device="cpu")
        res = p.execute(xj)
        ref = p.execute(torch.from_numpy(x).bfloat16())
        assert torch.equal(res.tucker.core, ref.tucker.core)

    def test_decompose_and_compute_dtype(self):
        x = lowrank((12, 10, 8), (3, 3, 2))
        res = decompose(torch.from_numpy(x), TuckerConfig(
            ranks=(3, 3, 2), methods="eig"), device="cpu")
        assert float(res.tucker.rel_error(x)) < 1e-4
        res = plan(x.shape, "float32", TuckerConfig(
            ranks=(3, 3, 2), methods="eig", compute_dtype="float64"),
            device="cpu").execute(x)
        assert res.tucker.core.dtype == torch.float64


class TestPlanFiles:
    def test_fixture_loads_describes_and_runs(self):
        p = TuckerPlan.load(DATA / "plan_pr7_fixed_rank.json", device="cpu")
        assert p.shape == (48, 224, 128) and p.methods == ("eig", "als", "eig")
        assert p.describe() == (DATA / "plan_pr7_describe.txt") \
            .read_text().rstrip("\n")
        assert json.loads(p.to_json()) == json.loads(
            (DATA / "plan_pr7_fixed_rank.json").read_text())
        x = np.random.default_rng(0).standard_normal(p.shape).astype(
            np.float32)
        res = p.execute(x)
        assert res.tucker.ranks == (40, 8, 12)
        assert [t.mode for t in res.trace] == [2, 1, 0]

    @pytest.mark.parametrize("shape,ranks,methods,order", [
        ((48, 224, 128), (40, 8, 12), ("eig", "als", "eig"), (2, 1, 0)),
        ((10, 12, 8), (3, 4, 2), "als", "shrink"),
        ((8, 9, 7, 6), (2, 3, 2, 2), "eig", None)])
    def test_explicit_methods_json_is_byte_identical(self, shape, ranks,
                                                     methods, order):
        cfg = dict(ranks=ranks, methods=methods, mode_order=order,
                   donate_input=False)
        got = plan(shape, "float32", TuckerConfig(**cfg), device="cpu")
        want = R.plan(shape, jnp.float32, R.TuckerConfig(**cfg))
        assert got.to_json() == want.to_json()

    def test_save_load_round_trip(self, tmp_path):
        p = plan((10, 12, 8), "float32", TuckerConfig(ranks=(3, 4, 2)),
                 device="cpu")
        p.save(tmp_path / "p.json")
        q = TuckerPlan.load(tmp_path / "p.json", device="cpu")
        assert q.schedule == p.schedule and q.config == p.config
        assert TuckerConfig.from_dict(p.config.to_dict()) == p.config

    def test_opt_order_plan_from_the_reference_runs_here(self):
        ref = R.plan((20, 16, 12), jnp.float32, R.TuckerConfig(
            ranks=(4, 3, 2), methods="eig", mode_order="opt"))
        p = TuckerPlan.from_json(ref.to_json(), device="cpu")
        assert [s.to_dict() for s in p.schedule] == \
            [s.to_dict() for s in ref.schedule]
        x = lowrank((20, 16, 12), (4, 3, 2), seed=5, noise=0.05)
        assert_tucker_close(x, p.execute(x).tucker,
                            ref.execute(jnp.asarray(x)).tucker,
                            proj_atol=1e-3, rel_atol=1e-5)


class TestDevicesAndErrors:
    def test_default_device_raises_without_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default device works")
        cfg = TuckerConfig(ranks=(2, 2, 2))
        with pytest.raises(RuntimeError, match="CUDA"):
            plan((4, 5, 6), "float32", cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            TuckerPlan.load(DATA / "plan_pr7_fixed_rank.json")
        with pytest.raises(RuntimeError, match="CUDA"):
            decompose(np.zeros((4, 5, 6), np.float32), cfg)

    def test_direct_construction_defaults_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default device works")
        p = plan((6, 5, 4), "float32", TuckerConfig(
            ranks=(2, 2, 2), methods="eig"), device="cpu")
        fields = dict(shape=p.shape, dtype=p.dtype, config=p.config,
                      schedule=p.schedule)
        with pytest.raises(RuntimeError, match="CUDA"):
            TuckerPlan(**fields)
        q = TuckerPlan(**fields, device=torch.device("cpu"))
        x = lowrank((6, 5, 4), (2, 2, 2), seed=3, noise=0.05)
        assert q.execute(x).tucker.core.shape == (2, 2, 2)

    def test_input_errors(self):
        p = plan((10, 12, 8), "float32", TuckerConfig(
            ranks=(3, 4, 2), methods="eig"), device="cpu")
        with pytest.raises(InputError):
            p.execute(np.zeros((10, 12, 9), np.float32))
        with pytest.raises(InputError):
            p.execute(torch.zeros((10, 12, 8), dtype=torch.bfloat16))
        bad = np.ones((10, 12, 8), np.float32)
        bad[:, 3, :] = np.nan
        with pytest.raises(InputError) as ei:
            p.execute(bad, validate="finite")
        assert ei.value.mode == 1
        with pytest.raises(ValueError):
            p.execute(bad, validate="maybe")

    def test_non_finite_result_is_a_numerical_error(self):
        p = plan((6, 5, 4), "float32", TuckerConfig(
            ranks=(2, 2, 2), methods="eig"), device="cpu")
        x = np.ones((6, 5, 4), np.float32)
        x[0, 0, 0] = np.inf
        with pytest.raises(NumericalError):
            p.execute(x, record=True)

    @pytest.mark.parametrize("kw,exc", [
        (dict(mesh=object()), ValueError),
        (dict(error_target=1.5), ValueError),
        (dict(impl="pallas"), NotImplementedError),
        (dict(impl="magic"), ValueError),
        (dict(variant="cp"), ValueError),
        (dict(als_iters=0), ValueError),
        (dict(mode_order="best"), ValueError)])
    def test_config_rejects(self, kw, exc):
        with pytest.raises(exc):
            TuckerConfig(ranks=(2, 2, 2), **kw)

    @pytest.mark.parametrize("kw,exc", [
        (dict(mode_order="opt", memory_cap_bytes=1000), MemoryCapError),
        (dict(memory_cap_bytes=1000), MemoryCapError),
        (dict(methods=("rand", "eig")), ValueError),
        (dict(mode_parallel=2), ValueError),
        (dict(variant="thosvd", mode_order=(2, 0, 1)), ValueError)])
    def test_plan_rejects(self, kw, exc):
        with pytest.raises(exc):
            plan((10, 12, 8), "float32", TuckerConfig(ranks=(3, 4, 2), **kw),
                 device="cpu")

    @pytest.mark.parametrize("kw", [
        dict(ranks=(3, 4, 2), mode_order="opt"),
        dict(ranks=(3, 4, 2), memory_cap_bytes=10 ** 9),
        dict(ranks=(3, 4, 2), methods="rand"),
        dict(error_target=0.1)])
    def test_search_and_adaptive_configs_plan_and_execute(self, kw):
        """The configs the port once refused now plan and execute: the
        result is within 0.1 of the input (noise 1e-2) and, for the error
        target, within 1.05 × its certified bound (the reference's limit)."""
        x = lowrank((10, 12, 8), (3, 4, 2), seed=5, noise=1e-2)
        p = plan(x.shape, "float32", TuckerConfig(**kw), device="cpu")
        res = p.execute(x)
        err = float(res.tucker.rel_error(x))
        assert err <= 0.1
        if "error_target" in kw:
            assert res.error_bound <= 0.1 and err <= 1.05 * res.error_bound
        else:
            assert res.tucker.ranks == (3, 4, 2)

    def test_single_device_mode_parallel_stays_sequential(self):
        for mp in ("auto", 1):
            p = plan((10, 12, 8), "float32", TuckerConfig(
                ranks=(3, 4, 2), mode_parallel=mp), device="cpu")
            assert all(s.group is None for s in p.schedule)

    def test_classify_torch_errors(self):
        from repro_torch.core import (ResourceError, classify_exception)
        assert isinstance(classify_exception(torch.cuda.OutOfMemoryError(
            "CUDA out of memory")), ResourceError)
        assert isinstance(classify_exception(torch.linalg.LinAlgError(
            "failed")), NumericalError)
        assert classify_exception(KeyError("x")) is None


def test_import_pulls_in_neither_jax_nor_repro():
    code = ("import sys; import repro_torch, repro_torch.core, "
            "repro_torch.kernels, repro_torch.obs, repro_torch.obs.__main__, "
            "repro_torch.chaos, repro_torch.core.variants, "
            "repro_torch.core.graphs, repro_torch.core.distributed, "
            "repro_torch.serve; "
            "bad = [m for m in sys.modules if m in ('jax', 'repro') "
            "or m.startswith(('jax.', 'repro.'))]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr


def test_matfree_ttm_keeps_the_input_dtype():
    x = torch.zeros(3, 4, 5, dtype=torch.bfloat16)
    assert PT.ttm(x, torch.zeros(2, 4, dtype=torch.bfloat16), 1).dtype == \
        torch.bfloat16
