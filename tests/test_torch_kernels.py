"""Port parity for the Hopper kernels' plain versions and their dispatch.

On the CPU every wrapper runs its kernel's plain version; these are held
against the reference's Pallas kernels (``repro.kernels.ops`` in interpret
mode, as tests/test_kernels.py runs them) and its jnp oracles
(``repro.kernels.ref``) on that file's shapes and tolerances: 2e-4 for the
TTM, 3e-4 for Gram/TTT in fp32, 4e-2 in bf16.  The views with B = 1 (last
mode) and A = 1 (first mode) that the kernels take without padding are
covered too.  The kernels themselves run only on the card: the CUDA test
below skips here, and ``chip_smoke.py`` holds every kernel against its
plain version on the H100.
"""

import ctypes
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as R_ops, ref as R_ref
from repro_torch import kernels as K
from repro_torch.core import TuckerConfig, plan, resolve_backend
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.ttt import _path, call_route as ttt_route, route, split_plan
from torch_parity import lowrank, to_np

TOL = {"float32": 2e-4, "bfloat16": 4e-2}


def arr(shape, seed, dtype="float32"):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (torch.from_numpy(a).to(getattr(torch, dtype)),
            jnp.asarray(a, getattr(jnp, dtype)))


def close(got, want, tol):
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=tol, atol=tol)


class TestPlainVersionsAgainstPallas:
    @pytest.mark.parametrize("shape,mode,r", [
        ((5, 37, 19), 1, 7), ((33, 12, 50), 0, 9), ((13, 21, 40), 2, 5),
        ((4, 9, 11, 6), 2, 3), ((130, 140, 3), 0, 64), ((3, 200, 129), 1, 130),
        ((260, 7, 5), 0, 11), ((2, 3, 4, 5, 6), 2, 2),
    ])
    def test_ttm(self, shape, mode, r):
        xt, xj = arr(shape, 1)
        ut, uj = arr((r, shape[mode]), 2)
        got = ops.ttm(xt, ut, mode)
        assert got.dtype == torch.float32 and got.is_contiguous()
        close(got, R_ops.ttm(xj, uj, mode), 2e-4)
        close(got, R_ref.ttm_full_ref(xj, uj, mode), 2e-4)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_ttm_dtypes(self, dtype):
        xt, xj = arr((8, 40, 24), 3, dtype)
        ut, uj = arr((6, 40), 4, dtype)
        close(ops.ttm(xt, ut, 1), R_ops.ttm(xj, uj, 1), TOL[dtype])

    @pytest.mark.parametrize("shape,mode", [
        ((5, 37, 19), 1), ((33, 12, 50), 0), ((13, 21, 40), 2),
        ((4, 9, 11, 6), 3), ((129, 6, 7), 0),
    ])
    def test_gram(self, shape, mode):
        xt, xj = arr(shape, 5)
        got = ops.gram(xt, mode)
        close(got, R_ops.gram(xj, mode), 3e-4)
        close(got, R_ref.gram_full_ref(xj, mode), 3e-4)

    @pytest.mark.parametrize("shape,mode,r", [
        ((5, 37, 19), 1, 7), ((13, 21, 40), 2, 5), ((9, 8, 7), 0, 3),
    ])
    def test_ttt(self, shape, mode, r):
        xt, xj = arr(shape, 6)
        yshape = shape[:mode] + (r,) + shape[mode + 1:]
        yt, yj = arr(yshape, 7)
        got = ops.ttt(xt, yt, mode)
        close(got, R_ops.ttt(xj, yj, mode), 3e-4)
        a = math.prod(shape[:mode])
        close(got, R_ref.ttt_ref(xj.reshape(a, shape[mode], -1),
                                 yj.reshape(a, r, -1)), 3e-4)


class TestPlainVersionsAgainstOracles:
    """Each plain function of kernels/ref.py against its reference oracle,
    including the unpadded B = 1 and A = 1 views."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("m,k,n", [(128, 128, 128), (37, 19, 5),
                                       (1, 64, 300), (300, 7, 1)])
    def test_matmul_ref(self, m, k, n, dtype):
        at, aj = arr((m, k), 8, dtype)
        bt, bj = arr((k, n), 9, dtype)
        close(K.matmul(at, bt), R_ref.matmul_ref(aj, bj), TOL[dtype])
        close(ref.matmul_ref(at, bt), R_ref.matmul_ref(aj, bj), TOL[dtype])

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("a,i,b,r", [(4, 9, 11, 3), (1, 20, 33, 5),
                                         (7, 13, 1, 4), (3, 200, 129, 130)])
    def test_ttm_interior_ref(self, a, i, b, r, dtype):
        ut, uj = arr((r, i), 10, dtype)
        xt, xj = arr((a, i, b), 11, dtype)
        close(K.ttm_interior(ut, xt), R_ref.ttm_interior_ref(uj, xj),
              TOL[dtype])

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("a,i,b,r", [(50, 30, 1, 7), (1, 30, 50, 7),
                                         (6, 17, 9, 17), (1, 5, 1, 3)])
    def test_ttt_and_gram_ref(self, a, i, b, r, dtype):
        xt, xj = arr((a, i, b), 12, dtype)
        yt, yj = arr((a, r, b), 13, dtype)
        tol = 3e-4 if dtype == "float32" else TOL[dtype]
        close(K.ttt3(xt, yt), R_ref.ttt_ref(xj, yj), tol)
        close(K.ttt3(xt, xt), R_ref.gram_ref(xj), tol)

    def test_full_refs(self):
        xt, xj = arr((4, 9, 11, 6), 14)
        ut, uj = arr((3, 11), 15)
        close(ref.ttm_full_ref(xt, ut, 2), R_ref.ttm_full_ref(xj, uj, 2), 2e-4)
        close(ref.gram_full_ref(xt, 3), R_ref.gram_full_ref(xj, 3), 3e-4)


class TestWrapperChecks:
    def test_rejects_bad_dtypes(self):
        x64 = torch.zeros(2, 3, 4, dtype=torch.float64)
        with pytest.raises(TypeError):
            K.ttt3(x64, x64)
        with pytest.raises(TypeError):
            K.matmul(torch.zeros(2, 3, dtype=torch.int32),
                     torch.zeros(3, 4, dtype=torch.int32))
        with pytest.raises(TypeError):   # mixed dtypes
            K.ttm_interior(torch.zeros(2, 3), torch.zeros(4, 3, 5,
                                                          dtype=torch.bfloat16))
        with pytest.raises(TypeError):
            K.ttt3(np.zeros((2, 3, 4), np.float32), np.zeros((2, 3, 4),
                                                             np.float32))

    def test_rejects_bad_shapes(self):
        with pytest.raises(ValueError):   # inner dims differ
            K.matmul(torch.zeros(2, 3), torch.zeros(4, 5))
        with pytest.raises(ValueError):   # wrong ndim
            K.matmul(torch.zeros(2, 3, 1), torch.zeros(3, 5))
        with pytest.raises(ValueError):   # contracted axis differs
            K.ttm_interior(torch.zeros(2, 3), torch.zeros(4, 5, 6))
        with pytest.raises(ValueError):   # A/B of x and y differ
            K.ttt3(torch.zeros(2, 3, 4), torch.zeros(2, 3, 5))
        with pytest.raises(ValueError):   # empty
            K.ttt3(torch.zeros(0, 3, 4), torch.zeros(0, 3, 4))

    def test_ops_reject_non_contiguous_x(self):
        x = torch.zeros(5, 4, 3).transpose(0, 2)
        with pytest.raises(ValueError, match="contiguous"):
            ops.gram(x, 1)
        with pytest.raises(ValueError, match="contiguous"):
            ops.ttm(x, torch.zeros(2, 4), 1)

    def test_cpu_runs_count_no_launches(self):
        K.reset_launch_counts()
        ops.ttm(torch.zeros(3, 4, 5), torch.zeros(2, 4), 1)
        ops.gram(torch.zeros(3, 4, 5), 0)
        assert K.launch_counts() == {"ttt": 0, "matmul": 0,
                                     "ttm_interior": 0, "s6_scan": 0}

    @pytest.mark.parametrize("i,r,k,b,sym", [
        (7000, 10, 76800, 1, False), (1340, 1340, 269544, 264, True),
        (1340, 10, 269544, 264, False), (10, 10, 76800, 1, True),
        (5, 3, 1, 1, False), (33, 4, 800, 8, False),
        (200, 300, 5000, 50, False)])
    def test_split_plan_covers_the_reduction(self, i, r, k, b, sym):
        """The splits cover the route's reduction, padded (the TMA route's
        runs of 32) or not, with no empty split."""
        splits, per = split_plan(i, r, k, b, sym, 132)
        assert 1 <= splits <= 65535
        tk = 64 if b == 1 and r <= 16 else 32
        assert per % tk == 0
        extent = _path(i, r, k // b, b, sym, route(r, b), "float32")[3] * tk
        assert extent >= k
        assert splits * per >= extent > (splits - 1) * per

    @pytest.mark.parametrize("i,r,k,b,sym", [
        (100000, 100000, 3_000_000_000, 1000, False),
        (90000, 90000, 2 ** 31 + 17, 1, True)])
    def test_split_plan_beyond_int32(self, i, r, k, b, sym):
        """A reduction longer than 2**31 in one split: k_per_split crosses
        to C as a long long."""
        splits, per = split_plan(i, r, k, b, sym, 132)
        assert splits * per >= k > (splits - 1) * per
        assert per > 2 ** 31 - 1 and per % 16 == 0
        argtypes = _build.SIGNATURES["ttt"]["atucker_ttt"]
        assert argtypes[10] is ctypes.c_longlong
        assert argtypes[10](per).value == per

    def test_operands_beyond_int32_elements(self):
        """The kernels index memory in 64 bits: only each extent must fit an
        int, not the element count."""
        big = torch.zeros(1, 1, 1).expand(70000, 70000, 1)   # 4.9e9 elements
        assert _build.check_operands("ttt", {"x3": 3}, big) == "cpu"
        too_wide = torch.zeros(1, 1, 1).expand(1, 2 ** 31, 1)
        with pytest.raises(ValueError, match="2\\*\\*31"):
            _build.check_operands("ttt", {"x3": 3}, too_wide)

    def test_library_names_follow_source_hash(self):
        paths = {n: _build.lib_path(n) for n in _build.SOURCES}
        assert len(set(paths.values())) == len(_build.SOURCES)
        for n, p in paths.items():
            assert p.parent == _build.BUILD_DIR and p.name.startswith(f"lib{n}_")
            assert p == _build.lib_path(n)          # stable for one source


class TestHopperDispatchOnCpu:
    def test_auto_resolution(self):
        for dt in ("float32", "bfloat16"):
            assert resolve_backend("auto", platform="cuda",
                                   dtype=dt).name == "hopper"
            assert resolve_backend("auto", platform="cpu",
                                   dtype=dt).name == "matfree"
        assert resolve_backend("auto", platform="cuda",
                               dtype="float64").name == "matfree"
        with pytest.raises(ValueError):
            resolve_backend("hopper", platform="cuda", dtype="float64")
        # named explicitly, hopper runs on the CPU (as its plain versions)
        assert resolve_backend("hopper", platform="cpu",
                               dtype="float32").name == "hopper"

    @pytest.mark.parametrize("shape,auto", [
        ((320, 240, 7000), "hopper"), ((1021, 1340, 33, 8), "hopper"),
        ((4, 50000, 50000), "matfree"), ((70000, 70000, 2), "matfree"),
        ((2, 2 ** 31), "matfree")])
    def test_auto_resolution_respects_int_extents(self, shape, auto):
        """auto takes hopper only where every (A, I_n, B) view extent fits
        the kernels' int arguments; an explicit hopper refuses the rest at
        plan time."""
        assert resolve_backend("auto", platform="cuda", dtype="float32",
                               shape=shape).name == auto
        if auto == "matfree":
            with pytest.raises(ValueError, match="extent"):
                resolve_backend("hopper", platform="cuda", dtype="float32",
                                shape=shape)

    @pytest.mark.parametrize("methods", ["eig", "als"])
    def test_hopper_plan_routes_through_the_wrappers(self, methods,
                                                     monkeypatch):
        calls = {"matmul": 0, "ttm_interior": 0, "ttt3": 0}
        for name in calls:
            real = getattr(ops, name)

            def counted(*a, _real=real, _name=name):
                calls[_name] += 1
                return _real(*a)
            monkeypatch.setattr(ops, name, counted)
        x = lowrank((12, 10, 9, 8), (3, 3, 2, 2), noise=0.05)
        cfg = TuckerConfig(ranks=(3, 3, 2, 2), methods=methods, impl="hopper")
        p = plan(x.shape, "float32", cfg, device="cpu")
        assert p.backend == "hopper"
        res = p.execute(x)
        assert all(v > 0 for v in calls.values()), calls
        ref_res = plan(x.shape, "float32", TuckerConfig(
            ranks=(3, 3, 2, 2), methods=methods, impl="matfree"),
            device="cpu").execute(x)
        for a, b in zip(res.tucker.factors, ref_res.tucker.factors):
            np.testing.assert_allclose(to_np(a @ a.T), to_np(b @ b.T),
                                       atol=1e-4)


def test_kernels_match_plain_versions_on_the_card():
    """The CUDA kernels against their plain versions on the card (the full
    check, at the main path's sizes, is chip_smoke.py phase 3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((7, 33, 19), generator=g, device="cuda").to(dtype)
        u = torch.randn((5, 33), generator=g, device="cuda").to(dtype)
        y = torch.randn((7, 4, 19), generator=g, device="cuda").to(dtype)
        w = torch.randn((33, 40), generator=g, device="cuda").to(dtype)
        for got, want in [
                (K.ttt3(x, y), ref.ttt_ref(x, y)),
                (K.ttm_interior(u, x), ref.ttm_interior_ref(u, x)),
                (K.matmul(u, w), ref.matmul_ref(u, w))]:
            assert float((got - want).abs().max()) <= \
                1e-4 * float(want.abs().max())
        # the tensor-core routes (R > 16), per entry in units of
        # sqrt(ttt(x∘x, y∘y)): TMA Gram and TTT, rows of odd length, B = 1
        # and a misaligned base on the plain-load route
        flat = torch.randn(3 * 150 * 264 + 1, generator=g, device="cuda").to(dtype)
        xm = flat[1:].view(3, 150, 264)
        wide = [torch.randn(s, generator=g, device="cuda").to(dtype)
                for s in ((5, 200, 264), (5, 40, 264), (3, 150, 70), (90, 40, 1))]
        cases = [(wide[0], wide[0]), (wide[0], wide[1]), (wide[2], wide[2]),
                 (wide[3], wide[3]), (xm, xm)]
        routes = set()
        for a3, b3 in cases:
            routes.add(ttt_route(a3, b3))
            want = ref.ttt_ref(a3, b3)
            scale = ref.ttt_ref(a3.float() ** 2, b3.float() ** 2).sqrt()
            assert float(((K.ttt3(a3, b3) - want).abs() / scale).max()) <= 2e-4
        assert routes == {"wgmma_tma", "wgmma_plain"}


def test_kernels_take_operands_beyond_int32_elements_on_the_card():
    """Each kernel path on a 2.25e9-element operand (9 GB in fp32): memory
    is indexed in 64 bits (chip_smoke.py phase kernels_large runs the same)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((2048, 1100, 1000), generator=g, device="cuda")
    xc = x.view(-1, 1000, 1)
    y = torch.randn((2048, 10, 1000), generator=g, device="cuda")
    yc = torch.randn((xc.shape[0], 10, 1), generator=g, device="cuda")
    u0 = torch.randn((10, 2048), generator=g, device="cuda")
    u1 = torch.randn((10, 1100), generator=g, device="cuda")
    u2 = torch.randn((1000, 10), generator=g, device="cuda")
    for got, want in [
            (K.ttt3(x, y), ref.ttt_ref(x, y)),
            (K.ttt3(xc, yc), ref.ttt_ref(xc, yc)),
            (K.matmul(u0, x.view(2048, -1)), ref.matmul_ref(u0, x.view(2048, -1))),
            (K.matmul(x.view(-1, 1000), u2), ref.matmul_ref(x.view(-1, 1000), u2)),
            (K.ttm_interior(u1, x), ref.ttm_interior_ref(u1, x))]:
        assert float((got - want).abs().max()) <= \
            1e-4 * float(want.abs().max())
