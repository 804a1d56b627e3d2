"""The wide (tensor-core) route of the interior TTM, on the CPU.

``csrc/ttm.cu`` runs every interior-mode TTM with R > 16 (u (R, I), x (A,
I, B)) as a batch of A first-mode GEMMs out[a] = u @ x[a] sharing u, in one
pass over x on split-TF32 ``wgmma`` -- the wide route of ``csrc/wgmma.cuh``
that the boundary GEMM's first mode runs too.  The kernel runs only on the
card (``chip_smoke.py`` holds it against ``ttm_interior_ref`` and
``ttm_tf32x3_ref`` at every route and load path); here its arithmetic,
written out as ``ref.ttm_tf32x3_ref`` (split TF32 with hi on each
stage's grid, every stage's hi·hi summed exactly in the truncating
accumulator and added in fp32), is held against the reference's ``ttm_interior`` Pallas kernel
in interpret mode -- reached through ``repro.kernels.ops.ttm`` as
``tests/test_kernels.py`` reaches it -- on the same seeded numpy inputs, at
``tests/test_kernels.py``'s tolerances (fp32 2e-4, bf16 4e-2).  The routes
and loads that ``kernels/ttm.py`` mirrors from the C code, the image
workspace and its price in the ``hopper`` plans are pinned too.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as R_ops
from repro_torch.core import TuckerConfig, plan
from repro_torch.core.plan import H100_SMS, _hopper_workspace_bytes
from repro_torch.kernels import _build, ref
from repro_torch.kernels.matmul import workspace_bytes as gemm_workspace_bytes
from repro_torch.kernels.ttm import (ROUTES, loads, route, workspace_bytes)

#: tests/test_kernels.py:17-18
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=4e-2, atol=4e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: the wrapper module (the package attribute ``ttm_interior`` is the function)
TM = importlib.import_module("repro_torch.kernels.ttm")


def rnd(shape, seed) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


class TestTf32x3Arithmetic:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("b", [1, 8, 264])
    @pytest.mark.parametrize("r", [20, 40, 64])
    def test_against_the_pallas_kernel(self, r, b, dtype):
        """Both packages take the same numpy values, rounded to the dtype
        by each: the reference's interior TTM in interpret mode against the
        wide route's arithmetic."""
        x, u = rnd((3, 70, b), 40 + r), rnd((r, 70), 41 + b)
        want = np.asarray(R_ops.ttm(jnp.asarray(x, JNP[dtype]),
                                    jnp.asarray(u, JNP[dtype]), 1,
                                    interpret=True))
        got = ref.ttm_tf32x3_ref(torch.from_numpy(u).to(TORCH[dtype]),
                                 torch.from_numpy(x).to(TORCH[dtype]))
        assert got.shape == (3, r, b) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])

    @pytest.mark.parametrize("r", [20, 64, 100])
    def test_each_item_is_the_wide_gemm(self, r):
        """out[a] is the boundary GEMM's wide-route arithmetic on x[a]: the
        batch only lays the columns of every a side by side."""
        x, u = torch.from_numpy(rnd((4, 45, 33), 43)), \
            torch.from_numpy(rnd((r, 45), 44))
        got = ref.ttm_tf32x3_ref(u, x)
        for a in range(4):
            want = ref.matmul_tf32x3_ref(u, x[a], truncate=True,
                                         scheme="grid")
            assert torch.equal(got[a], want)

    def test_sums_are_unbiased(self):
        """Stage sums that the truncating accumulator holds exactly leave
        the energy unbiased within 3e-8 at the sketch's interior projection
        depth (I = 1340, R = 64), where the stage sums of the GEMM's old
        route lose about 2e-7."""
        x, u = rnd((4, 1340, 264), 45), rnd((64, 1340), 46)
        exact = np.einsum("ri,aib->arb", u.astype(np.float64),
                          x.astype(np.float64))
        energy = (exact ** 2).sum()
        bias = {}
        for scheme in ("grid", "stage"):
            got = ref.ttm_tf32x3_ref(torch.from_numpy(u), torch.from_numpy(x),
                                     scheme=scheme).double().numpy()
            bias[scheme] = ((got ** 2).sum() - energy) / energy
        assert abs(bias["grid"]) < 3e-8
        assert bias["stage"] < -1e-7


class TestRouteMirror:
    @pytest.mark.parametrize("r,b,dtype,aligned,want", [
        (10, 264, "float32", True, "slab"),     # the main path's HSI TTM
        (16, 264, "float32", True, "slab"),
        (16, 32, "float32", True, "slab"),      # a row of 128 bytes
        (16, 16, "float32", True, "plain"),     # 64 bytes: below the ring's
        (10, 1, "float32", True, "plain"),      # B = 1
        (10, 33, "float32", True, "plain"),     # odd B
        (10, 264, "float32", False, "plain"),   # misaligned x
        (10, 64, "bfloat16", True, "slab"),
        (17, 264, "float32", True, "wide"),     # the first wide R
        (64, 264, "float32", True, "wide"),     # the sketch's projection
        (64, 1, "float32", True, "wide"),       # any B, dtype, alignment
        (64, 33, "bfloat16", False, "wide"),
        (300, 8, "float32", True, "wide"),
    ])
    def test_routes(self, r, b, dtype, aligned, want):
        assert route(r, b, dtype, aligned) == want

    @pytest.mark.parametrize("b,dtype,aligned,want", [
        (264, "float32", True, "tma"), (32, "float32", True, "tma"),
        (8, "float32", True, "plain"), (1, "float32", True, "plain"),
        (264, "bfloat16", True, "tma"), (33, "float32", True, "plain"),
        (264, "float32", False, "plain")])
    def test_loads(self, b, dtype, aligned, want):
        assert loads(b, dtype, aligned) == want

    def test_route_codes_follow_the_c_library(self):
        """atucker_ttm_interior takes the image workspace after out and
        picks the route itself (route_of, which route() mirrors);
        atucker_ttm_interior_info reports the route as its index in
        ROUTES."""
        assert ROUTES == ("slab", "plain", "wide")
        sig = _build.SIGNATURES["ttm"]
        assert sig["atucker_ttm_interior"] == (_build._P,) * 4 + \
            (_build._I,) * 5 + (_build._P,)
        assert sig["atucker_ttm_interior_info"] == (_build._P,) + \
            (_build._I,) * 5 + (_build._P,)

    @pytest.mark.parametrize("r,b", [(10, 264), (10, 1), (20, 8), (64, 264)])
    def test_cpu_runs_the_plain_version_on_every_route(self, r, b):
        """On the CPU the wrapper runs ttm_interior_ref whatever route the
        shape would take on the card, and counts no launch."""
        g = torch.Generator().manual_seed(r * b)
        u, x = torch.randn((r, 9), generator=g), \
            torch.randn((2, 9, b), generator=g)
        before, launches = dict(TM.ROUTE_LAUNCHES), TM.LAUNCHES
        assert torch.equal(TM.ttm_interior(u, x), ref.ttm_interior_ref(u, x))
        assert TM.ROUTE_LAUNCHES == before and TM.LAUNCHES == launches


class TestWorkspace:
    def test_image_of_the_sketch_projection(self):
        """R = 64, I = 1340: 42 stages of hi and lo tiles of 64 rows x 128
        bytes, 0.69 MB -- the boundary GEMM's image of the same u."""
        assert workspace_bytes(64, 1340) == 42 * 2 * 64 * 128 == 688128
        assert workspace_bytes(64, 1340) == \
            gemm_workspace_bytes(64, 10 ** 6, 1340)
        assert workspace_bytes(40, 1340) == 688128           # 40 -> 64 rows
        assert workspace_bytes(64, 1340, "bfloat16") == 344064
        assert workspace_bytes(16, 1340) == 0                # FFMA routes
        assert workspace_bytes(130, 1340) == workspace_bytes(128, 1340)

    def test_an_interior_step_prices_the_image(self):
        """Where the image is the largest buffer of an interior step's calls
        (an ALS step at I = 100,000 and R = 17), the hopper step's workspace
        is the image; on the first mode it is the GEMM's image of the same u
        (x wide enough), on the last mode nothing of the kind."""
        i, r = 100_000, 17
        got = _hopper_workspace_bytes("als", 2, i, r, 2, 4, H100_SMS,
                                      interior=True)
        assert got == workspace_bytes(r, i) > _hopper_workspace_bytes(
            "als", 2, i, r, 2, 4, H100_SMS)
        assert _hopper_workspace_bytes("als", 1, i, r, 2 * 10 ** 6, 4,
                                       H100_SMS, first_mode=True) == got

    @pytest.mark.parametrize("methods", ["eig", "als"])
    def test_plan_charges_interior_steps(self, methods):
        """Each hopper step of a plan adds _hopper_workspace_bytes at its
        view, with ``interior`` set on the interior modes: the step peaks
        of a wide interior rank equal the matfree step's plus that figure
        and what the step holds."""
        shape, ranks = (30, 200, 40), (10, 24, 12)
        hs = plan(shape, "float32", TuckerConfig(ranks=ranks, methods=methods,
                                                 impl="hopper"),
                  device="cpu").schedule
        ms = plan(shape, "float32", TuckerConfig(ranks=ranks, methods=methods,
                                                 impl="matfree"),
                  device="cpu").schedule
        cur, held = list(shape), 0
        for h, m in zip(hs, ms):
            mode = h.mode
            a, b = math.prod(cur[:mode]), math.prod(cur[mode + 1:])
            extra = _hopper_workspace_bytes(
                h.method, a, h.i_n, h.r_n, b, 4, H100_SMS,
                first_mode=mode == 0, interior=0 < mode < len(shape) - 1)
            assert h.peak_bytes == m.peak_bytes + extra + held
            cur[mode] = h.r_n
            held = 4 * (math.prod(shape) + sum(shape[s.mode] * s.r_n
                                               for s in hs[:hs.index(h) + 1]))
        assert any(route(s.r_n, 1) == "wide" and 0 < s.mode < 2 for s in hs)
