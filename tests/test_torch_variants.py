"""The port's legacy entry points — ``sthosvd``, ``sthosvd_eig``,
``sthosvd_als``, ``sthosvd_svd``, ``variants.thosvd`` and
``variants.hooi`` — held to the reference's on the same numpy inputs.

They are thin wrappers over ``plan`` → ``execute`` and run on
``device="cpu"`` here (the default is the card).  Tolerances are those of
``tests/test_torch_api.py``: EIG and SVD (deterministic) projectors within
1e-3 and rel_error within 1e-5; ALS, whose random start each package draws
itself, projectors within 1e-3 and rel_error within 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import variants as RV
from repro_torch import core as C
from repro_torch.core import MemoryCapError, TuckerConfig, plan, variants
from torch_parity import assert_tucker_close, lowrank

TOLS = {"eig": dict(proj_atol=1e-3, rel_atol=1e-5),
        "svd": dict(proj_atol=1e-3, rel_atol=1e-5),
        "als": dict(proj_atol=1e-3, rel_atol=1e-4),
        "auto": dict(proj_atol=1e-3, rel_atol=1e-4)}


def _pair(x):
    return x, jnp.asarray(x)


class TestSthosvd:
    @pytest.mark.parametrize("fn", ["sthosvd_eig", "sthosvd_als",
                                    "sthosvd_svd"])
    @pytest.mark.parametrize("shape,ranks", [((12, 15, 10), (3, 4, 2)),
                                             ((8, 9, 7, 6), (2, 3, 2, 2))])
    def test_baselines(self, fn, shape, ranks):
        x, xj = _pair(lowrank(shape, ranks, seed=1, noise=0.02))
        got = getattr(C, fn)(x, ranks, device="cpu")
        want = getattr(R, fn)(xj, ranks)
        method = fn.split("_")[1]
        assert got.methods == want.methods == (method,) * len(shape)
        assert_tucker_close(x, got.tucker, want.tucker, **TOLS[method])

    @pytest.mark.parametrize("mode_order", [None, "shrink", "opt",
                                            (2, 0, 1)])
    def test_auto_selects_as_the_reference(self, mode_order):
        x, xj = _pair(lowrank((24, 30, 16), (4, 5, 3), seed=2, noise=0.05))
        got = C.sthosvd(x, (4, 5, 3), mode_order=mode_order, device="cpu")
        want = R.sthosvd(xj, (4, 5, 3), mode_order=mode_order)
        assert got.methods == want.methods
        assert [t.mode for t in got.trace] == [t.mode for t in want.trace]
        # the search picks solvers itself: no selector call under "opt"
        assert (got.select_overhead_s > 0.0) == (want.select_overhead_s > 0.0)
        assert_tucker_close(x, got.tucker, want.tucker, **TOLS["auto"])

    def test_block_until_ready_times_every_step(self):
        x = lowrank((12, 10, 8), (3, 3, 2), seed=3)
        res = C.sthosvd(x, (3, 3, 2), "eig", block_until_ready=True,
                        device="cpu")
        assert all(t.seconds > 0 for t in res.trace)
        fused = C.sthosvd(x, (3, 3, 2), "eig", device="cpu")
        assert all(t.seconds == 0.0 for t in fused.trace)
        assert torch.equal(fused.tucker.core, res.tucker.core)

    def test_wrapper_is_plan_then_execute(self):
        x = lowrank((12, 10, 8), (3, 3, 2), seed=4, noise=0.05)
        got = C.sthosvd(x, (3, 3, 2), ("eig", "als", "eig"), impl="hopper",
                        device="cpu")
        want = plan(x.shape, "float32", TuckerConfig(
            ranks=(3, 3, 2), methods=("eig", "als", "eig"), impl="hopper"),
            device="cpu").execute(x)
        assert torch.equal(got.tucker.core, want.tucker.core)
        assert got.trace[0].backend == "hopper"

    def test_memory_cap_refused_as_in_the_reference(self):
        x, xj = _pair(lowrank((16, 96, 64), (12, 4, 8), seed=5))
        with pytest.raises(MemoryCapError):
            C.sthosvd(x, (12, 4, 8), "eig", memory_cap_bytes=1000,
                      device="cpu")
        with pytest.raises(R.MemoryCapError):
            R.sthosvd(xj, (12, 4, 8), "eig", memory_cap_bytes=1000)

    def test_runs_on_the_card_by_default(self):
        if torch.cuda.is_available():
            pytest.skip("CUDA is available here: the default device works")
        x = lowrank((8, 8, 8), (2, 2, 2))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            C.sthosvd(x, (2, 2, 2))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            variants.hooi(x, (2, 2, 2))


class TestThosvd:
    @pytest.mark.parametrize("methods", ["eig", "als", "svd"])
    def test_against_the_reference(self, methods):
        x, xj = _pair(lowrank((10, 9, 8), (2, 3, 2), seed=6, noise=0.05))
        got = variants.thosvd(x, (2, 3, 2), methods, device="cpu")
        want = RV.thosvd(xj, (2, 3, 2), methods)
        assert got.methods == want.methods
        assert_tucker_close(x, got.tucker, want.tucker, **TOLS[methods])

    def test_auto_and_recorded(self):
        x, xj = _pair(lowrank((20, 16, 12), (4, 3, 2), seed=7, noise=0.05))
        got = variants.thosvd(x, (4, 3, 2), block_until_ready=True,
                              device="cpu")
        want = RV.thosvd(xj, (4, 3, 2))
        assert got.methods == want.methods
        assert all(t.seconds > 0 for t in got.trace)
        assert_tucker_close(x, got.tucker, want.tucker, **TOLS["auto"])


class TestHooi:
    @pytest.mark.parametrize("methods", ["eig", "als"])
    @pytest.mark.parametrize("n_iters", [1, 3])
    def test_against_the_reference(self, methods, n_iters):
        x, xj = _pair(lowrank((10, 9, 8), (2, 3, 2), seed=8, noise=0.05))
        got = variants.hooi(x, (2, 3, 2), n_iters=n_iters, methods=methods,
                            device="cpu")
        want = RV.hooi(xj, (2, 3, 2), n_iters=n_iters, methods=methods)
        assert len(got.trace) == len(want.trace) == 3 * (n_iters + 1)
        assert [t.mode for t in got.trace] == [t.mode for t in want.trace]
        assert_tucker_close(x, got.tucker, want.tucker, **TOLS[methods])

    def test_init_replaces_the_init_sweep(self):
        x, xj = _pair(lowrank((12, 10, 8), (3, 3, 2), seed=9, noise=0.05))
        init = C.sthosvd_eig(x, (3, 3, 2), device="cpu")
        got = variants.hooi(x, (3, 3, 2), n_iters=2, methods="eig",
                            init=init, device="cpu")
        full = variants.hooi(x, (3, 3, 2), n_iters=2, methods="eig",
                             device="cpu")
        assert got.trace[:3] == init.trace and len(got.trace) == 9
        assert torch.equal(got.tucker.core, full.tucker.core)
        want = RV.hooi(xj, (3, 3, 2), n_iters=2, methods="eig",
                       init=R.sthosvd_eig(xj, (3, 3, 2)))
        assert_tucker_close(x, got.tucker, want.tucker, **TOLS["eig"])

    def test_error_does_not_increase_over_sthosvd(self):
        x = lowrank((14, 12, 10), (3, 3, 3), seed=10, noise=0.2)
        base = float(C.sthosvd_eig(x, (3, 3, 3), device="cpu")
                     .tucker.rel_error(x))
        refined = float(variants.hooi(x, (3, 3, 3), methods="eig",
                                      device="cpu").tucker.rel_error(x))
        assert refined <= base + 1e-6

    def test_shrink_ordered_init(self):
        x, xj = _pair(lowrank((20, 6, 8), (2, 3, 2), seed=11, noise=0.05))
        got = variants.hooi(x, (2, 3, 2), mode_order="shrink",
                            methods="eig", n_iters=1, device="cpu")
        want = RV.hooi(xj, (2, 3, 2), mode_order="shrink", methods="eig",
                       n_iters=1)
        assert [t.mode for t in got.trace[:3]] == \
            [t.mode for t in want.trace[:3]]
        assert_tucker_close(x, got.tucker, want.tucker, **TOLS["eig"])
