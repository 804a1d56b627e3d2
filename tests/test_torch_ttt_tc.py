"""The tensor-core (wgmma) route of the TTT/Gram kernel: its arithmetic and
its routing, on the CPU.

``csrc/ttt.cu`` runs every R > 16 on the tensor cores: fp32 operands split
into hi = rna_tf32(x) and lo = rna_tf32(x - hi) and three TF32 products
(hi·hi + hi·lo + lo·hi), bf16 operands one product.  The kernel itself runs
only on the card (``chip_smoke.py`` holds it per entry against ``ttt_ref``);
here its arithmetic, written out in PyTorch as ``ref.ttt_tf32x3_ref``, is
held against the reference's ``repro.kernels.ref.gram_ref``/``ttt_ref`` on
the same seeded numpy inputs, and the route and tiling that
``kernels/ttt.py`` mirrors from the C code are pinned.

Errors are per entry, in units of the entry's own scale
sqrt(ttt(x∘x, y∘y)) (sqrt(gram(x∘x)) for a Gram): a Gram's diagonal is
~sqrt(K) times its off-diagonal entries, so a relative-to-max check would
not see a single TF32 product's error.  Limit: 2e-4, the port's fp32 Gram
tolerance.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R_ref
from repro_torch.kernels import _build, ref
from repro_torch.kernels.ttt import (ROUTES, _path, route, split_plan,
                                     tile_r, workspace_bytes)

LIMIT = 2e-4
#: the Gram and TTT cases of chip_smoke.py's kernels_small phase:
#: (shape, mode) and (shape, mode, R)
GRAM_CASES = [((5, 37, 19), 1), ((33, 12, 50), 0), ((13, 21, 40), 2),
              ((4, 9, 11, 6), 3), ((129, 6, 7), 0), ((3, 150, 70), 1),
              ((50, 300, 40), 1), ((600, 7, 13), 2)]
TTT_CASES = [((5, 37, 19), 1, 7), ((13, 21, 40), 2, 5), ((9, 8, 7), 0, 3),
             ((6, 300, 5), 1, 20), ((600, 7, 130), 2, 9),
             ((40, 260, 33), 1, 30)]


def view3(a: np.ndarray, mode: int) -> np.ndarray:
    return a.reshape(math.prod(a.shape[:mode]), a.shape[mode], -1)


def rnd(shape, seed) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def entry_err(got, want, x3: np.ndarray, y3: np.ndarray) -> np.ndarray:
    """|got - want| / sqrt(ttt(x∘x, y∘y)) per entry (float64)."""
    x2, y2 = x3.astype(np.float64) ** 2, y3.astype(np.float64) ** 2
    scale = np.sqrt(np.einsum("aib,arb->ir", x2, y2))
    diff = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    return np.abs(diff) / scale


def normalized_close(got, want, x3, y3):
    """allclose at rtol = atol = LIMIT in units of the entries' scales."""
    x2, y2 = x3.astype(np.float64) ** 2, y3.astype(np.float64) ** 2
    scale = np.sqrt(np.einsum("aib,arb->ir", x2, y2))
    np.testing.assert_allclose(np.asarray(got, np.float64) / scale,
                               np.asarray(want, np.float64) / scale,
                               rtol=LIMIT, atol=LIMIT)


class TestSplitTf32Arithmetic:
    def test_rna_rounds_to_nearest_ties_away(self):
        ulp = 2.0 ** -10
        x = torch.tensor([1.0, 1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4,
                          1 + 3 * ulp / 4, 2 - ulp / 4, 0.0, -0.0])
        want = [1.0, 1 + ulp, -(1 + ulp), 1.0, 1 + ulp, 2.0, 0.0, -0.0]
        assert ref.tf32_rna(x).tolist() == want

    def test_hi_lo_keep_fp32_class_accuracy(self):
        x = torch.from_numpy(rnd(100_000, 1) * 10.0 ** rnd(100_000, 2))
        hi = ref.tf32_rna(x)
        lo = ref.tf32_rna(x - hi)
        bits = torch.cat([hi, lo]).view(torch.int32)
        assert int((bits & 0x1FFF).abs().max()) == 0      # both are TF32
        assert float(((hi - x).abs() / x.abs()).max()) <= 2.0 ** -11
        # hi + lo misses x by at most half a TF32 unit of lo: ~2^-22 of x
        assert float(((hi.double() + lo.double() - x.double()).abs()
                      / x.double().abs()).max()) <= 2.0 ** -21

    @pytest.mark.parametrize("shape,mode", GRAM_CASES)
    def test_gram_cases_against_the_reference(self, shape, mode):
        x3 = view3(rnd(shape, 11), mode)
        xt = torch.from_numpy(x3)
        got = ref.ttt_tf32x3_ref(xt, xt)
        want = R_ref.gram_ref(jnp.asarray(x3))
        assert entry_err(got, want, x3, x3).max() <= LIMIT
        normalized_close(got, want, x3, x3)

    @pytest.mark.parametrize("shape,mode,r", TTT_CASES)
    def test_ttt_cases_against_the_reference(self, shape, mode, r):
        x3 = view3(rnd(shape, 12), mode)
        y3 = view3(rnd(shape[:mode] + (r,) + shape[mode + 1:], 13), mode)
        got = ref.ttt_tf32x3_ref(torch.from_numpy(x3), torch.from_numpy(y3))
        want = R_ref.ttt_ref(jnp.asarray(x3), jnp.asarray(y3))
        assert entry_err(got, want, x3, y3).max() <= LIMIT
        normalized_close(got, want, x3, y3)

    def test_full_reduction_depth(self):
        """The main path's depth, A·B = 1021·264 = 269,544, in the kernel's
        two splits: three products stay under the limit (9.5e-5 in the CPU
        emulation), one TF32 product exceeds it five times over."""
        x3 = rnd((1021, 48, 264), 14)
        xt = torch.from_numpy(x3)
        want = R_ref.gram_ref(jnp.asarray(x3))
        three = ref.ttt_tf32x3_ref(xt, xt, products=3, splits=2)
        one = ref.ttt_tf32x3_ref(xt, xt, products=1, splits=2)
        assert entry_err(three, want, x3, x3).max() <= LIMIT
        normalized_close(three, want, x3, x3)
        assert entry_err(one, want, x3, x3).max() > 4 * LIMIT
        with pytest.raises(AssertionError):
            normalized_close(one, want, x3, x3)

    @pytest.mark.parametrize("scheme", ["stage", "grid"])
    @pytest.mark.parametrize("shape,mode", GRAM_CASES[:4])
    def test_the_cards_sums_hold_the_limit(self, shape, mode, scheme):
        """The sums as the card makes them (``truncate``: the tensor cores'
        accumulator rounds toward zero; ``ttt.cu``'s stage scheme and the
        wide GEMM's grid) stay within the limit of the reference's Gram."""
        x3 = view3(rnd(shape, 16), mode)
        xt = torch.from_numpy(x3)
        got = ref.ttt_tf32x3_ref(xt, xt, truncate=True, scheme=scheme)
        want = R_ref.gram_ref(jnp.asarray(x3))
        assert entry_err(got, want, x3, x3).max() <= LIMIT

    def test_bf16_operands_need_one_product(self):
        """bf16 values are exact in TF32: lo is zero and the split adds
        nothing, which is why the bf16 route takes one product."""
        x = torch.from_numpy(rnd((7, 30, 50), 15)).bfloat16()
        assert int(ref.tf32_rna(x.float() - ref.tf32_rna(x)).abs().max()) == 0
        assert torch.equal(ref.ttt_tf32x3_ref(x, x, products=1),
                           ref.ttt_tf32x3_ref(x, x, products=3))


class TestRouteMirror:
    @pytest.mark.parametrize("r,b,dtype,aligned,want", [
        (1340, 264, "float32", True, "wgmma_tma"),      # the main-path Gram
        (1340, 264, "bfloat16", True, "wgmma_tma"),
        (40, 32, "float32", True, "wgmma_tma"),         # 128-byte rows
        (40, 28, "float32", True, "wgmma_plain"),       # 112 bytes: short
        (40, 70, "float32", True, "wgmma_plain"),       # 280: not 16-byte
        (40, 1, "float32", True, "wgmma_cols"),         # B == 1: the wide GEMM
        (40, 264, "float32", False, "wgmma_plain"),     # misaligned base
        (40, 40, "bfloat16", True, "wgmma_plain"),      # 80 bytes: short
        (40, 64, "bfloat16", True, "wgmma_tma"),
        (40, 68, "bfloat16", True, "wgmma_plain"),      # 136: not 16-byte
        (17, 264, "float32", True, "wgmma_tma"),        # the first wide R
    ])
    def test_wide_routes(self, r, b, dtype, aligned, want):
        assert route(r, b, dtype, aligned) == want

    @pytest.mark.parametrize("r,b,sym,dtype,want", [
        (20, 1, False, "float32", "wgmma_cols"),   # Cavity's last-mode ALS TTT
        (20, 1, False, "bfloat16", "wgmma_cols"),
        (40, 1, True, "float32", "wgmma_plain"),   # a B = 1 Gram keeps its tiles
        (273, 1, True, "bfloat16", "wgmma_plain"),
        (142, 10, False, "float32", "wgmma_plain"),  # MNIST's mode-1 ALS TTT
        (65, 1420, False, "float32", "wgmma_tma"),   # MNIST's mode-0 TTT
        (65, 1420, False, "bfloat16", "wgmma_plain")])  # 2,840 B rows
    def test_b1_ttt_takes_the_wide_gemm(self, r, b, sym, dtype, want):
        """A TTT of B = 1 (y ≠ x) runs on the wide GEMM whatever its
        alignment (which picks that route's loads); a Gram of B = 1 and
        every B > 1 keep the tiled routes."""
        assert route(r, b, dtype, True, sym) == want
        if b == 1:
            assert route(r, b, dtype, False, sym) == want

    @pytest.mark.parametrize("r,b,aligned,want", [
        (10, 1, True, "cols"), (16, 1, False, "cols"), (10, 264, True, "tile16"),
        (16, 70, False, "tile16"), (1, 1, True, "cols")])
    def test_skinny_routes_unchanged(self, r, b, aligned, want):
        for dtype in ("float32", "bfloat16"):
            assert route(r, b, dtype, aligned) == want

    def test_route_codes_follow_the_c_library(self):
        """atucker_ttt_info reports the route as its index in ROUTES, after
        the two operand pointers it inspects for alignment."""
        assert ROUTES == ("cols", "tile16", "wgmma_tma", "wgmma_plain",
                          "wgmma_cols")
        argtypes = _build.SIGNATURES["ttt"]["atucker_ttt_info"]
        assert argtypes[:2] == (_build._P, _build._P) and len(argtypes) == 11


class TestTiling:
    @pytest.mark.parametrize("i,r,k,b,sym,want", [
        (7000, 10, 76800, 1, False, (20, 3840)),    # Boats' ALS TTT
        (1340, 10, 269544, 264, False, (48, 5632)),  # HSI's ALS TTT
        (10, 10, 76800, 1, True, (150, 512)), (33, 4, 800, 8, False, (3, 288)),
        (5, 3, 1, 1, False, (1, 64)), (16, 16, 4000, 25, True, (14, 288))])
    def test_skinny_split_plans_unchanged(self, i, r, k, b, sym, want):
        """R <= 16 keeps the FFMA routes and the splits they had before the
        tensor-core route (cols: TK 64, 8 blocks per SM; tile16: TK 32, 4)."""
        for dtype in ("float32", "bfloat16"):
            assert split_plan(i, r, k, b, sym, 132, dtype) == want

    def test_upper_tiles_of_the_main_path_gram(self):
        tiles, tk, per_sm, n_k = _path(1340, 1340, 1021, 264, True,
                                       "wgmma_tma", "float32")
        assert (tiles, tk, per_sm) == (66, 32, 1)
        assert n_k == 1021 * 9                   # 264 = 8 runs of 32 + 8
        # 24 of every 288 copied k are the boxes' zero fill
        assert (288 - 264) / 288 == pytest.approx(0.0833, abs=1e-4)

    def test_main_path_gram_fills_one_wave(self):
        splits, per = split_plan(1340, 1340, 1021 * 264, 264, True, 132)
        assert (splits, per) == (2, 4595 * 32)
        assert 66 * splits == 132

    @pytest.mark.parametrize("i,r,a,b,sym,dtype,aligned", [
        (1340, 1340, 1021, 264, True, "float32", True),
        (1340, 1340, 1021, 264, True, "bfloat16", True),
        (1340, 1340, 1021, 264, True, "float32", False),
        (33, 33, 1, 1340 * 264, True, "float32", True),
        (1021, 1021, 1, 1340 * 264, True, "float32", True),
        (300, 40, 6, 48, False, "float32", True),
        (70, 200, 4, 264, False, "bfloat16", True),
        (150, 150, 3, 70, True, "float32", True),
        (40, 40, 273, 1, True, "float32", True),
        (130, 20, 300, 1, False, "bfloat16", True),
        (10000, 20, 10000, 1, False, "float32", True),   # Cavity: wgmma_cols
        (5000, 142, 784, 10, False, "float32", True),    # MNIST mode 1
        (7, 300, 5, 37, False, "float32", True),
    ])
    def test_splits_cover_k_exactly(self, i, r, a, b, sym, dtype, aligned):
        """Every split is non-empty and together they cover the route's
        reduction, in whole TK-deep stages; the grid is one wave of 132
        SMs, short of it only where longer splits could not be halved
        without dropping below eight stages."""
        rt = route(r, b, dtype, aligned, sym)
        assert rt.startswith("wgmma")
        splits, per = split_plan(i, r, a * b, b, sym, 132, dtype, aligned)
        tiles, tk, _, n_k = _path(i, r, a, b, sym, rt, dtype)
        extent = n_k * tk    # whole stages: A·ceil(B/TK)·TK on TMA, ≥ A·B
        assert extent >= a * b
        assert per % tk == 0
        assert (splits - 1) * per < extent <= splits * per
        if rt == "wgmma_cols":   # persistent blocks: the busiest one's stages
            busiest = math.ceil(splits * tiles / 132) * (per // tk)
            assert busiest <= 1.05 * min(
                math.ceil(s * tiles / 132) * math.ceil(n_k / s)
                for s in range(1, max(1, min(n_k // 8, 64)) + 1))
            return
        assert tiles * splits < 132 + tiles
        assert tiles * splits >= 132 or per <= 16 * tk


class TestFittedTiles:
    """The wide routes' tiling at the R of the paper's Table III: Cavity's
    last mode (I = 10,000, R = 20, B = 1: wgmma_cols), MNIST's mode 1 (I =
    5,000, R = 142, B = 10) and the sketch's R = 64, against the reduction
    of A = 10,000 (B = 1) or 784 (B = 10)."""

    @pytest.mark.parametrize("r,want", [(17, 32), (20, 32), (32, 32),
                                        (33, 64), (64, 64), (65, 128),
                                        (142, 128), (1340, 128)])
    def test_tile_r_fits_r(self, r, want):
        assert tile_r(r, False) == want
        assert tile_r(r, True) == 128        # a Gram's tiles stay square

    @pytest.mark.parametrize("r,b,a,want", [
        # (R, B, A): (output tiles, TK, blocks per SM, stages)
        (20, 1, 10000, (79, 32, 1, 313)),     # 128 x 32 outputs a tile
        (64, 1, 10000, (79, 32, 1, 313)),
        (142, 1, 10000, (157, 32, 1, 313)),   # the warpgroups split R: 64 x
        (20, 10, 784, (40, 32, 1, 245)),      # 40 row tiles x 1 of 32
        (64, 10, 784, (40, 32, 1, 245)),      # x 1 of 64
        (142, 10, 784, (80, 32, 1, 245)),     # x 2 of 128
    ])
    def test_path(self, r, b, a, want):
        i = 10000 if b == 1 else 5000
        rt = route(r, b, "float32", True)
        assert rt == ("wgmma_cols" if b == 1 else "wgmma_plain")
        assert _path(i, r, a, b, False, rt, "float32") == want

    def test_the_tiles_at_r64_are_full(self):
        """The sketch's range sample at R = 64 (y ≠ x, B = 264): one 64-wide
        column tile a row tile, where the 128-wide tile was half zeros."""
        assert _path(1340, 64, 1021, 264, False, "wgmma_tma",
                     "float32")[0] == 11

    @pytest.mark.parametrize("r,b,a,want", [
        (20, 1, 10000, (5, 63 * 32)),        # 5 x 79 tiles: 3 a block
        (64, 1, 10000, (5, 63 * 32)),
        (142, 1, 10000, (5, 63 * 32)),
        (20, 10, 784, (4, 62 * 32)),          # 40 tiles: 4 splits fill 132
        (64, 10, 784, (4, 62 * 32)),
        (142, 10, 784, (2, 123 * 32)),        # 80 tiles: 2 splits
    ])
    def test_split_plan(self, r, b, a, want):
        i = 10000 if b == 1 else 5000
        for dtype in ("float32", "bfloat16") if b == 1 else ("float32",):
            assert split_plan(i, r, a * b, b, False, 132, dtype) == want

    @pytest.mark.parametrize("r,b,a,dtype,want", [
        # splits x I x R fp32 partial sums; B = 1 also y's image after them:
        # splits x 63 stages of (hi, lo) tiles of 32/64/128 rows x 128 bytes
        (20, 1, 10000, "float32", 4_000_000 + 5 * 63 * 2 * 32 * 128),
        (20, 1, 10000, "bfloat16", 4_000_000 + 5 * 63 * 32 * 128),
        (64, 1, 10000, "float32", 5 * 10000 * 64 * 4 + 5 * 63 * 2 * 64 * 128),
        (142, 1, 10000, "float32",                 # 256-byte aligned
         28_400_128 + 5 * 63 * 2 * 128 * 128),
        (20, 10, 784, "float32", 4 * 5000 * 20 * 4),
        (142, 10, 784, "float32", 2 * 5000 * 142 * 4),
    ])
    def test_workspace(self, r, b, a, dtype, want):
        i = 10000 if b == 1 else 5000
        assert workspace_bytes(a, i, r, b, False, 132, dtype) == want

    def test_an_unsplit_b1_ttt_holds_only_the_image(self):
        """A reduction too short to split writes z directly: the workspace
        is y's image alone (2 stages of 64-row tiles)."""
        assert split_plan(1021, 40, 64, 1, False, 132) == (1, 64)
        assert workspace_bytes(64, 1021, 40, 1, False, 132) == \
            2 * 2 * 64 * 128


def _reference_ladder(a: torch.Tensor) -> torch.Tensor:
    """The reference's ``_spd_inverse`` ladder without the port's resolution
    gate: the first jitter rung whose Cholesky succeeds, however small its
    pivots."""
    eye = torch.eye(a.shape[0], dtype=a.dtype)
    scale = torch.trace(a)
    nan = torch.full_like(a, float("nan"))
    inv = nan
    for i, jitter in enumerate((1e-12, 1e-8, 1e-4)):
        reg = jitter * scale + (1e-6 if i == 2 else 0.0)
        c, info = torch.linalg.cholesky_ex(a + reg * eye)
        cand = torch.where(info == 0, torch.cholesky_solve(eye, c), nan)
        inv = torch.where(torch.isfinite(inv).all(), inv, cand)
    return inv


class TestNearRankOneLeaf:
    """The codec's stacked a_log at a cut width: log(1..16) on every channel
    of (16 layers, 512 channels, 16 states) plus a rank-16 perturbation
    whose norm is 1.5e-4 of the leaf's (entries ~3e-4; the trained leaf's
    is 1.7e-4 of its norm), through the codec's schedule at ranks_for's
    (16, 64, 4): EIG, ALS, EIG.  Mode 1's unfolding has numerical rank ~1
    in fp32 squared terms, so ALS at rank 64 meets RᵀR whose trailing
    eigenvalues are its own rounding noise.

    The card's arithmetic is emulated: the TTT and Gram at R > 16 as
    ``ttt.cu`` sums them (split TF32, each 32-deep stage from zero in the
    truncating accumulator: ``ttt_tf32x3_ref(..., truncate=True)``), the
    interior TTM at R > 16 as ``wgmma.cuh`` (``ttm_tf32x3_ref``), the rest
    in fp32.  With the reference's ladder the Cholesky inverse amplifies
    that noise, and whichever rung happens to succeed decides the subspace:
    the emulated card and fp32 ``matfree`` alike lose the leading direction
    itself (rel_error 4e-2 to 9 here, against 1e-4 in float64; on the H100
    the trained leaf read 0.56 on ``hopper`` and 0.18 on ``matfree``).  With
    the resolution gate of ``solvers._spd_inverse`` (a rung whose pivot² is
    under eps·tr fails), the emulated card and fp32 ``matfree`` agree within
    1e-5 and both stay within 1e-4 of float64 ``matfree``."""

    RANKS = (16, 64, 4)
    METHODS = ("eig", "als", "eig")

    @pytest.fixture(autouse=True)
    def one_thread(self):
        """One thread: fp32 LAPACK's sums then come in one order."""
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(n)

    @staticmethod
    def leaf(seed: int) -> torch.Tensor:
        rng = np.random.default_rng(seed)
        x = np.broadcast_to(np.log(np.arange(1, 17.0)), (16, 512, 16)).copy()
        p = np.einsum("lr,dr,nr->ldn", *(rng.standard_normal((s, 16))
                                         for s in (16, 512, 16)))
        x += 1.5e-4 * np.linalg.norm(x) / np.linalg.norm(p) * p
        return torch.from_numpy(x.astype(np.float32))

    @staticmethod
    def card_ops():
        """(ttm, gram, ttt) in the card's arithmetic at R > 16, else fp32."""
        from repro_torch.core import tensor_ops as T

        def as3(x, mode):
            return x.reshape(math.prod(x.shape[:mode]), x.shape[mode], -1)

        def ttm(x, u, mode):
            if u.shape[0] <= 16 or mode in (0, x.ndim - 1):
                return T.ttm(x, u, mode)
            shape = list(x.shape)
            shape[mode] = u.shape[0]
            return ref.ttm_tf32x3_ref(u, as3(x, mode)).reshape(shape)

        def ttt(x, y, mode):
            if y.shape[mode] <= 16:
                return T.ttt(x, y, mode)
            return ref.ttt_tf32x3_ref(as3(x, mode), as3(y, mode),
                                      truncate=True)

        def gram(x, mode):
            return ttt(x, x, mode)
        return ttm, gram, ttt

    def rel_error(self, x, ops) -> float:
        from repro_torch.core import solvers
        from repro_torch.core import tensor_ops as T
        y, us = x, []
        for mode, (meth, r) in enumerate(zip(self.METHODS, self.RANKS)):
            u, y = solvers.SOLVERS[meth](y, mode, r, impl=ops)
            us.append(u)
        return float(T.rel_error(x.double(), y.double(),
                                 [u.double() for u in us]))

    @pytest.mark.parametrize("seed", [0, 1])
    @pytest.mark.parametrize("arith", ["card", "matfree"])
    def test_the_references_ladder_loses_the_leaf(self, monkeypatch, arith,
                                                  seed):
        from repro_torch.core import solvers
        x = self.leaf(seed)
        exact = self.rel_error(x.double(), "matfree")
        monkeypatch.setattr(solvers, "_spd_inverse", _reference_ladder)
        ops = self.card_ops() if arith == "card" else "matfree"
        assert self.rel_error(x, ops) > exact + 1e-3

    @pytest.mark.parametrize("seed", [0, 1])
    def test_the_gate_holds_the_leaf(self, seed):
        x = self.leaf(seed)
        exact = self.rel_error(x.double(), "matfree")
        card = self.rel_error(x, self.card_ops())
        fp32 = self.rel_error(x, "matfree")
        assert abs(card - exact) <= 1e-4
        assert abs(card - fp32) <= 1e-5
