"""The wide (tensor-core) route of the boundary GEMM, and the ``hopper``
plans' memory model of the kernels' workspaces, on the CPU.

``csrc/matmul.cu`` runs every boundary GEMM with R > 16 (the first mode, u
(R, K) @ x (K, N), N > R, and the last, x (M, K) @ uᵀ (K, R), R <= M) in
one pass over x on the tensor cores: fp32 operands split
into hi = rna_tf32(v) and lo = rna_tf32(v - hi) and three TF32 products
(hi·hi + hi·lo + lo·hi), bf16 operands one product.  hi is cut to a grid
on which each 32-deep stage's hi·hi sum is exact in the tensor cores'
truncating accumulator; the stage sums are added in fp32.  The kernel runs only on the card
(``chip_smoke.py`` holds it per entry against ``matmul_ref``); here its
arithmetic, written out as ``ref.matmul_tf32x3_ref``, is held against the
reference's ``repro.kernels.ref.matmul_ref`` and its Pallas kernel
``repro.kernels.matmul.matmul(..., interpret=True)`` on the same seeded
numpy inputs, and the route, the loads and the workspace that
``kernels/matmul.py`` mirrors from the C code are pinned.

Errors are per entry, in units of the entry's own scale
sqrt((a∘a) @ (b∘b)).  Limit: 2e-4, the port's fp32 tolerance.

The ``hopper`` plans charge each step's peak with the largest buffer a
call of the step allocates beyond the reference's model: the TTT's
split-K workspace (``kernels/ttt.py`` ``workspace_bytes``, from
``split_plan``), the wide GEMM's image of u, and cuSOLVER's ``eigh`` and
QR workspace; after the first step they also count the caller's input,
which the port holds, and the factors already solved.  ``matfree`` plans
keep the reference's figures.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R_ref
from repro.kernels.matmul import matmul as pallas_matmul
from repro_torch.core import MemoryCapError, TuckerConfig, plan
from repro_torch.core.plan import (H100_SMS, _eigh_bytes,
                                   _hopper_workspace_bytes, _qr_bytes,
                                   _step_peak_bytes)
from repro_torch.kernels import _build, ref
from repro_torch.kernels.matmul import (CHUNK, ROUTES, image_rows, loads,
                                        route, side, workspace_bytes)
from repro_torch.kernels.ttt import split_plan
from repro_torch.kernels.ttt import workspace_bytes as ttt_workspace_bytes

LIMIT = 2e-4
#: the wide-route cases of chip_smoke.py's kernels_small phase: every R
#: with K = 7 and K = 1021, N cycling through an odd width (plain loads), a
#: 16-byte multiple for fp32 only and one for both dtypes (TMA)
WIDE_RS = (17, 24, 40, 64, 130, 300)
WIDE_KS = (7, 1021)
WIDE_NS = (1283, 2052, 2056)
WIDE_CASES = [(r, k, WIDE_NS[j % 3]) for j, (r, k) in enumerate(
    (r, k) for r in WIDE_RS for k in WIDE_KS)]

#: the wrapper module (the package attribute ``matmul`` is the function)
MM = importlib.import_module("repro_torch.kernels.matmul")
#: the plan module (likewise ``plan``)
P = importlib.import_module("repro_torch.core.plan")


def rnd(shape, seed) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def entry_err(got, want, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|got - want| / sqrt((a∘a) @ (b∘b)) per entry (float64)."""
    a2, b2 = a.astype(np.float64) ** 2, b.astype(np.float64) ** 2
    diff = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    return np.abs(diff) / np.sqrt(a2 @ b2)


def pallas_ref(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The reference's Pallas kernel in interpret mode, on inputs
    zero-padded to its 128-multiples (as ``repro/kernels/ops.py`` pads)."""
    (m, k), n = a.shape, b.shape[1]
    up = lambda v: -(-v // 128) * 128   # noqa: E731
    ap = np.zeros((up(m), up(k)), np.float32)
    bp = np.zeros((up(k), up(n)), np.float32)
    ap[:m, :k], bp[:k, :n] = a, b
    return np.asarray(pallas_matmul(jnp.asarray(ap), jnp.asarray(bp),
                                    interpret=True))[:m, :n]


class TestSplitTf32Arithmetic:
    @pytest.mark.parametrize("r,k,n", WIDE_CASES)
    def test_cases_against_the_reference(self, r, k, n):
        a, b = rnd((r, k), 21), rnd((k, n), 22)
        assert route(r, n) == "wide"
        got = ref.matmul_tf32x3_ref(torch.from_numpy(a), torch.from_numpy(b))
        want = np.asarray(R_ref.matmul_ref(jnp.asarray(a), jnp.asarray(b)))
        assert entry_err(got, want, a, b).max() <= LIMIT

    @pytest.mark.parametrize("r,k,n", [(17, 7, 130), (40, 200, 301),
                                       (130, 33, 200)])
    def test_against_the_pallas_kernel(self, r, k, n):
        a, b = rnd((r, k), 23), rnd((k, n), 24)
        got = ref.matmul_tf32x3_ref(torch.from_numpy(a), torch.from_numpy(b))
        assert entry_err(got, pallas_ref(a, b), a, b).max() <= LIMIT

    def test_full_reduction_depth(self):
        """adapt_wide's mode 0, K = 1021, at R = 64 on 4,096 columns: three
        products stay under the limit, one TF32 product exceeds it."""
        a, b = rnd((64, 1021), 25), rnd((1021, 4096), 26)
        want = np.asarray(R_ref.matmul_ref(jnp.asarray(a), jnp.asarray(b)))
        at, bt = torch.from_numpy(a), torch.from_numpy(b)
        three = ref.matmul_tf32x3_ref(at, bt)
        one = ref.matmul_tf32x3_ref(at, bt, products=1)
        assert entry_err(three, want, a, b).max() <= LIMIT
        assert entry_err(one, want, a, b).max() > LIMIT

    def test_bf16_operands_need_one_product(self):
        """bf16 values are exact in TF32: lo is zero and the split adds
        nothing, which is why the bf16 route takes one product."""
        a = torch.from_numpy(rnd((40, 300), 27)).bfloat16()
        b = torch.from_numpy(rnd((300, 500), 28)).bfloat16()
        assert torch.equal(ref.matmul_tf32x3_ref(a, b, products=1),
                           ref.matmul_tf32x3_ref(a, b, products=3))
        want = np.asarray(R_ref.matmul_ref(jnp.asarray(a.float().numpy()),
                                           jnp.asarray(b.float().numpy())))
        af, bf = a.float().numpy(), b.float().numpy()
        assert entry_err(ref.matmul_tf32x3_ref(a, b, products=1), want,
                         af, bf).max() <= LIMIT

    def test_truncating_accumulator_biases_the_energy(self):
        """The tensor cores' fp32 accumulator truncates.  Emulated per wgmma
        step at adapt_wide's mode 0 (K = 1021, R = 64), the sums' energy
        falls by about 2e-7 of itself -- what lifts the sketch's measured
        tail, and so its certificate, on the wide route -- while rounded
        sums leave it unbiased; per entry both stay within the limit."""
        a, b = rnd((64, 1021), 31), rnd((1021, 4096), 32)
        exact = a.astype(np.float64) @ b.astype(np.float64)
        energy = (exact ** 2).sum()
        at, bt = torch.from_numpy(a), torch.from_numpy(b)
        bias = {}
        for truncate in (False, True):
            got = ref.matmul_tf32x3_ref(at, bt, truncate=truncate).double()
            assert entry_err(got, exact, a, b).max() <= LIMIT
            bias[truncate] = float(((got.numpy() ** 2).sum() - energy)
                                   / energy)
        assert abs(bias[False]) < 1e-8
        assert -3e-7 < bias[True] < -1.2e-7

    def test_grid_sums_leave_the_energy_unbiased(self):
        """The kernels' sums: hi cut to each stage's grid, so that a stage's
        hi·hi sum is exact in the truncating accumulator, added in fp32; the
        cross terms in one accumulator over the whole depth.  At
        adapt_wide's mode 0 (K = 1021, R = 64) the energy's bias stays
        under 3e-8 of itself, against -1.2e-7 ... -3e-7 for the 32-deep
        stage sums; per entry it stays within the limit."""
        a, b = rnd((64, 1021), 31), rnd((1021, 4096), 32)
        exact = a.astype(np.float64) @ b.astype(np.float64)
        energy = (exact ** 2).sum()
        at, bt = torch.from_numpy(a), torch.from_numpy(b)
        bias = {}
        for scheme in ("grid", "stage"):
            got = ref.matmul_tf32x3_ref(at, bt, truncate=True,
                                        scheme=scheme).double()
            assert entry_err(got, exact, a, b).max() <= LIMIT
            bias[scheme] = float(((got.numpy() ** 2).sum() - energy)
                                 / energy)
        assert abs(bias["grid"]) < 3e-8
        assert -3e-7 < bias["stage"] < -1.2e-7

    @pytest.mark.parametrize("kind", ["whole_numbers", "positive",
                                      "both_positive"])
    def test_grid_sums_on_nonnegative_data(self, kind):
        """Nonnegative inputs as the paper's tensors hold them: a video's
        whole-number pixels (0..255), a radiance cube's positive values,
        and whole numbers against a positive u (a nonnegative tensor's
        leading direction, where every product has one sign and a stage's
        sum comes nearest its 2^24 units).  The energy stays within 3e-8,
        per entry within the limit, with the accumulator truncating."""
        g = np.random.default_rng(37)
        u = g.standard_normal((64, 1021))
        if kind == "both_positive":
            u = np.abs(u) + 1
            u /= np.linalg.norm(u, axis=1, keepdims=True)
        else:
            u = np.linalg.qr(u.T)[0].T
        b = (3 * np.abs(g.standard_normal((1021, 1024))) + 1
             if kind == "positive" else g.integers(0, 256, (1021, 1024)))
        a, b = u.astype(np.float32), b.astype(np.float32)
        exact = a.astype(np.float64) @ b.astype(np.float64)
        got = ref.matmul_tf32x3_ref(torch.from_numpy(a), torch.from_numpy(b),
                                    truncate=True, scheme="grid").double()
        assert entry_err(got, exact, a, b).max() <= LIMIT
        energy = (exact ** 2).sum()
        assert abs(((got.numpy() ** 2).sum() - energy) / energy) < 3e-8

    def test_bf16_stage_sums_only_lower_the_energy(self):
        """bf16 operands take one product a k-step, a stage summed in the
        truncating accumulator and added in fp32: per entry within the
        limit, and the energy can only fall (up to the rounding of the fp32
        adds, 2e-9), the certificate's safe side."""
        a = torch.from_numpy(rnd((64, 1021), 34)).bfloat16()
        b = torch.from_numpy(rnd((1021, 2048), 35)).bfloat16()
        af, bf = a.double().numpy(), b.double().numpy()
        exact = af @ bf
        got = ref.matmul_tf32x3_ref(a, b, products=1, truncate=True,
                                    scheme="grid")
        assert entry_err(got, exact, af, bf).max() <= LIMIT
        energy = (exact ** 2).sum()
        assert ((got.double().numpy() ** 2).sum() - energy) / energy < 2e-9

    def test_grid_split(self):
        """hi sits on its group's grid with at most U_BITS (u) or X_BITS
        (x) bits over it, lo is what is left to TF32, and a stage's hi·hi
        products are whole units whose sums fp32 holds exactly."""
        a, b = rnd((16, 100), 38), rnd((100, 24), 39)
        ah, al = ref.grid_split(torch.from_numpy(a), ref.U_BITS, 1)
        bh, bl = ref.grid_split(torch.from_numpy(b), ref.X_BITS, 0)
        assert torch.equal(ref.tf32_rna(ah), ah)
        assert torch.equal(ref.tf32_rna(al), al)
        for k0 in range(0, 100, 32):
            ks = slice(k0, k0 + 32)
            _, ea = np.frexp(np.abs(a[:, ks]).max(1, keepdims=True))
            _, eb = np.frexp(np.abs(b[ks]).max(0, keepdims=True))
            ua = ah[:, ks].double().numpy() / np.exp2(ea - ref.U_BITS)
            ub = bh[ks].double().numpy() / np.exp2(eb - ref.X_BITS)
            assert np.array_equal(ua, np.round(ua))
            assert np.abs(ua).max() <= 2 ** ref.U_BITS
            assert np.abs(ub).max() <= 2 ** ref.X_BITS
            sums = ua @ ub
            assert np.array_equal(sums.astype(np.float32), sums)
        err = np.abs((ah + al).double().numpy() - a)
        _, e = np.frexp(np.abs(a).max())
        assert err.max() <= 2.0 ** (e - 22)

    @pytest.mark.parametrize("products", [1, 3])
    def test_grid_sums_change_nothing_that_is_exact(self, products):
        """Small integers: the grid split keeps them whole (lo is zero), and
        every product and sum is exact in fp32, so the truncating
        emulation gives the rounded sums bit for bit."""
        g = np.random.default_rng(33)
        a = torch.from_numpy(g.integers(-8, 9, (24, 70)).astype(np.float32))
        b = torch.from_numpy(g.integers(-8, 9, (70, 50)).astype(np.float32))
        got = ref.matmul_tf32x3_ref(a, b, products, truncate=True,
                                    scheme="grid")
        assert torch.equal(got, ref.matmul_tf32x3_ref(a, b, products,
                                                      scheme="grid"))
        assert torch.equal(got, a @ b)

    def test_the_ttt_routes_bias_does_not_reach_the_certificate(self):
        """csrc/ttt.cu's tensor-core route sums 32-deep stages on the
        truncating accumulator too, so its Gram reads about 1e-7 low.  The
        sketch takes only the Gram's eigenvectors from it (the rotation V
        of b); the captured energy it certifies is the energy of Vᵀ b,
        exact for whatever V.  A perturbed V changes that energy to second
        order: far below the kernels' rounding of the energies."""
        g = np.random.default_rng(36)
        ell, r = 64, 40
        s = np.concatenate([np.linspace(10, 3, r), np.full(ell - r, 0.1)])
        basis = np.linalg.qr(g.standard_normal((ell, ell)))[0]
        b = ((basis * s) @ g.standard_normal((ell, 4000))).astype(np.float32)
        b64 = b.astype(np.float64)
        exact = b64 @ b64.T
        bt = torch.from_numpy(b)
        gram = ref.matmul_tf32x3_ref(bt, bt.T.contiguous(), truncate=True,
                                     scheme="stage").double().numpy()
        lean = np.mean((np.diag(gram) - np.diag(exact)) / np.diag(exact))
        assert -3e-7 < lean < -5e-8

        def captured(m):
            v = np.linalg.eigh(m)[1][:, -r:]
            return ((v.T @ b64) ** 2).sum()
        total = (b64 ** 2).sum()
        assert abs(captured(gram) - captured(exact)) / total < 1e-10

    @pytest.mark.parametrize("products", [1, 3])
    def test_truncation_changes_nothing_that_is_exact(self, products):
        """Small integers: every product and sum is exact in fp32, so the
        truncating emulation gives the rounded sums bit for bit."""
        g = np.random.default_rng(33)
        a = torch.from_numpy(g.integers(-8, 9, (24, 70)).astype(np.float32))
        b = torch.from_numpy(g.integers(-8, 9, (70, 50)).astype(np.float32))
        got = ref.matmul_tf32x3_ref(a, b, products, truncate=True)
        assert torch.equal(got, ref.matmul_tf32x3_ref(a, b, products))
        assert torch.equal(got, a @ b)

    def test_stages_sum_from_zero(self):
        """The stage length only regroups exact products: every stage
        length gives the same sums within fp32 rounding."""
        a, b = rnd((24, 1021), 29), rnd((1021, 300), 30)
        at, bt = torch.from_numpy(a), torch.from_numpy(b)
        want = np.asarray(R_ref.matmul_ref(jnp.asarray(a), jnp.asarray(b)))
        for stage in (8, 32, 1021):
            got = ref.matmul_tf32x3_ref(at, bt, stage=stage)
            assert entry_err(got, want, a, b).max() <= LIMIT


#: the last-mode cases: x (2053, 1021) @ uᵀ (1021, R) -- a ragged M of 16
#: tiles and a ragged last stage -- at every R the wide route's widths take
LAST_RS = (17, 20, 40, 64, 130, 300)


class TestLastModeSums:
    """The last mode, x (M, K) @ uᵀ (K, R), runs as Cᵀ = u @ xᵀ on the same
    sums: u's hi cut to U_BITS over its row's bound in a stage, x's to
    X_BITS over its row's (``matmul_tf32x3_ref(..., side="last")``)."""

    @pytest.mark.parametrize("r", LAST_RS)
    def test_grid_emulation_against_float64(self, r):
        """Per entry within the limit, and the energy within 3e-8 of
        itself, with the accumulator truncating; the reference's
        ``matmul_ref`` on the same inputs within the limit too."""
        x, ut = rnd((2053, 1021), 40 + r), rnd((1021, r), 41 + r)
        assert route(2053, r) == "wide" and side(2053, r) == "last"
        got = ref.matmul_tf32x3_ref(torch.from_numpy(x), torch.from_numpy(ut),
                                    truncate=True, scheme="grid",
                                    side="last").double().numpy()
        exact = x.astype(np.float64) @ ut.astype(np.float64)
        assert entry_err(got, exact, x, ut).max() <= LIMIT
        energy = (exact ** 2).sum()
        assert abs(((got ** 2).sum() - energy) / energy) < 3e-8
        want = np.asarray(R_ref.matmul_ref(jnp.asarray(x), jnp.asarray(ut)))
        assert entry_err(got, want, x, ut).max() <= LIMIT

    def test_is_the_first_modes_sums_transposed(self):
        """side="last" of (x, uᵀ) is side="first" of (u, xᵀ), transposed,
        bit for bit: the kernel runs the same sums either way."""
        x, ut = rnd((300, 100), 42), rnd((100, 40), 43)
        xt, utt = torch.from_numpy(x), torch.from_numpy(ut)
        last = ref.matmul_tf32x3_ref(xt, utt, truncate=True, scheme="grid",
                                     side="last")
        first = ref.matmul_tf32x3_ref(utt.T.contiguous(), xt.T.contiguous(),
                                      truncate=True, scheme="grid")
        assert torch.equal(last, first.T)

    def test_side_is_checked(self):
        a = torch.zeros((4, 4))
        with pytest.raises(ValueError, match="side"):
            ref.matmul_tf32x3_ref(a, a, side="middle")


class TestRouteMirror:
    @pytest.mark.parametrize("m,n,want", [
        (10, 353760, "slab"),       # the first mode at R <= 16
        (16, 353760, "slab"),
        (17, 353760, "wide"),       # the first wide R
        (64, 353760, "wide"),       # adapt_wide's sketch projection
        (40, 353760, "wide"),       # its refinement
        (256, 353760, "wide"),      # one pass
        (257, 353760, "wide"),      # two chunks
        (300, 2056, "wide"),
        (76800, 10, "slab"),        # the last mode: x (J, I) @ u^T
        (76800, 17, "wide"),        # the last mode above R = 16: one pass
        (353760, 300, "wide"),
        (64, 64, "wide"),           # N <= M: the last mode's wide route
        (64, 65, "wide"),
    ])
    def test_routes(self, m, n, want):
        assert route(m, n) == want

    @pytest.mark.parametrize("m,n,want", [
        (64, 353760, "first"), (76800, 64, "last"), (10000, 20, "last"),
        (64, 64, "last"), (64, 65, "first"), (16, 10, "last")])
    def test_sides(self, m, n, want):
        """N > M: u (R, K) @ x (K, N); N <= M: x (M, K) @ uᵀ (K, R), which
        the kernel reads K-major."""
        assert side(m, n) == want

    @pytest.mark.parametrize("j,i,r", [(76800, 7000, 10), (76800, 7000, 16),
                                       (76800, 7000, 17), (10000, 10000, 20),
                                       (76800, 7000, 64), (4000, 500, 300)])
    def test_the_last_mode_of_ops_takes_the_wide_route_above_r16(self, j, i,
                                                                 r):
        """ops.ttm on the last mode calls matmul(x (J, I), uᵀ (I, R)): the
        wide route from R = 17 on (Boats' row 2c at R = 64, Cavity's R =
        20), the slab route at and below 16."""
        assert route(j, r) == ("wide" if r > 16 else "slab")
        assert side(j, r) == "last"

    @pytest.mark.parametrize("n,dtype,aligned,want", [
        (353760, "float32", True, "tma"), (2052, "float32", True, "tma"),
        (1283, "float32", True, "plain"), (2052, "bfloat16", True, "plain"),
        (2056, "bfloat16", True, "tma"), (2056, "float32", False, "plain")])
    def test_loads(self, n, dtype, aligned, want):
        assert loads(n, dtype, aligned) == want

    def test_route_codes_follow_the_c_library(self):
        """atucker_matmul takes the image workspace after C and picks the
        route itself (route_of, which route() mirrors); atucker_matmul_info
        takes x's pointer for the alignment test and reports the route as
        its index in ROUTES."""
        assert ROUTES == ("slab", "wide")
        sig = _build.SIGNATURES["matmul"]
        assert sig["atucker_matmul"] == (_build._P,) * 4 + (_build._I,) * 4 \
            + (_build._P,)
        assert sig["atucker_matmul_info"] == (_build._P,) * 2 \
            + (_build._I,) * 4 + (_build._P,)

    @pytest.mark.parametrize("m,n", [(20, 30), (10, 30), (30, 20)])
    def test_cpu_runs_the_plain_version_on_every_route(self, m, n):
        """On the CPU the wrapper runs matmul_ref whatever route the shape
        would take on the card, and counts no launch."""
        g = torch.Generator().manual_seed(m * n)
        a, b = torch.randn((m, 5), generator=g), torch.randn((5, n), generator=g)
        before = dict(MM.ROUTE_LAUNCHES)
        assert torch.equal(MM.matmul(a, b), ref.matmul_ref(a, b))
        assert MM.ROUTE_LAUNCHES == before


class TestWorkspace:
    def test_image_of_the_sketch_projection(self):
        """R = 64, K = 1021: 32 stages of hi and lo tiles of 64 rows x 128
        bytes, 0.52 MB."""
        assert workspace_bytes(64, 353760, 1021) == 32 * 2 * 64 * 128 \
            == 524288
        assert workspace_bytes(40, 353760, 1021) == 524288   # 40 -> 64 rows
        assert workspace_bytes(64, 353760, 1021, "bfloat16") == 262144
        assert workspace_bytes(10, 353760, 1021) == 0        # slab
        # N <= M: the last mode's wide route holds the image of uᵀ's 60
        # columns (-> 64 rows)
        assert workspace_bytes(64, 60, 1021) == 524288

    @pytest.mark.parametrize("rows,want", [(17, 32), (32, 32), (33, 64),
                                           (64, 64), (65, 128), (96, 128),
                                           (127, 128), (128, 128)])
    def test_image_rows(self, rows, want):
        assert image_rows(rows) == want

    def test_chunks_reuse_the_first_chunks_image(self):
        assert CHUNK == 128
        assert workspace_bytes(300, 2056, 1021) == \
            workspace_bytes(128, 2056, 1021) == 32 * 2 * 128 * 128

    @pytest.mark.parametrize("m,n,k,dtype,want", [
        (76800, 64, 7000, "float32", 219 * 2 * 64 * 128),   # row 2c
        (10000, 20, 10000, "float32", 313 * 2 * 32 * 128),  # Cavity's ALS
        (10000, 20, 10000, "bfloat16", 313 * 32 * 128),
        (76800, 10, 7000, "float32", 0),                    # slab
        (4000, 300, 500, "float32", 16 * 2 * 128 * 128),    # chunks of 128
    ])
    def test_image_of_the_last_mode(self, m, n, k, dtype, want):
        """x (M, K) @ uᵀ (K, R): the image of u's R = N rows, the first
        chunk's, over ceil(K / 32) stages."""
        assert workspace_bytes(m, n, k, dtype) == want


class TestTttWorkspace:
    @pytest.mark.parametrize("a,i,r,b,sym,dtype", [
        (1, 320, 320, 240 * 7000, True, "float32"),     # Boats mode 0 Gram
        (320, 240, 240, 7000, True, "float32"),         # Boats mode 1 Gram
        (1, 1021, 1021, 1340 * 264, True, "float32"),   # HSI mode 0 Gram
        (1021, 1340, 1340, 264, True, "float32"),       # HSI mode 1 Gram
        (76800, 7000, 10, 1, False, "float32"),         # Boats' ALS TTT
        (1021, 1340, 64, 264, False, "float32"),        # the range sample
        (1, 16, 16, 4000, True, "float32"),             # a skinny Gram
        (5, 3, 3, 1, True, "float32"),                  # one split
        (7, 30, 30, 50, True, "bfloat16"),              # mirrored, one split
    ])
    def test_follows_split_plan_and_the_allocation_condition(
            self, a, i, r, b, sym, dtype):
        """splits x I x R fp32 when the reduction is split or a Gram above
        R = 16 is mirrored, else nothing: ttt3 allocates exactly this."""
        for aligned in (True, False):
            splits, _ = split_plan(i, r, a * b, b, sym, 132, dtype, aligned)
            want = splits * i * r * 4 if splits > 1 or (sym and r > 16) else 0
            assert ttt_workspace_bytes(a, i, r, b, sym, 132, dtype,
                                       aligned) == want

    @pytest.mark.parametrize("a,i,b,want", [
        (1, 320, 240 * 7000, 9011200), (320, 240, 7000, 10137600),
        (1, 1021, 1340 * 33 * 8, 16679056), (1021, 1340, 33 * 8, 14364800)])
    def test_eig_grams_of_the_full_size_tensors(self, a, i, b, want):
        assert ttt_workspace_bytes(a, i, i, b, True, 132) == want

    def test_the_ttt_sizes_for_the_cards_sm_count(self):
        # fewer SMs, fewer splits: the figure follows the card the plan is for
        assert ttt_workspace_bytes(1, 320, 320, 240 * 7000, True, 66) < \
            ttt_workspace_bytes(1, 320, 320, 240 * 7000, True, 132)


BOATS = ((320, 240, 7000), (10, 10, 10))
SMALL = ((40, 30, 50), (20, 6, 18))


def steps(shape, ranks, impl, **kw):
    return plan(shape, "float32", TuckerConfig(ranks=ranks, impl=impl, **kw),
                device="cpu").schedule


class TestHopperStepPeaks:
    @pytest.mark.parametrize("methods", ["eig", "als", "rand", "svd"])
    @pytest.mark.parametrize("shape,ranks", [BOATS, SMALL])
    def test_hopper_peak_is_matfree_plus_the_workspace(self, shape, ranks,
                                                       methods):
        """Each hopper step adds its calls' largest workspace and, after the
        first step, the input and the factors it holds (4-byte elements)."""
        cur, extras, held = list(shape), [], 0
        for h, m in zip(steps(shape, ranks, "hopper", methods=methods),
                        steps(shape, ranks, "matfree", methods=methods)):
            mode = h.mode
            a, b = math.prod(cur[:mode]), math.prod(cur[mode + 1:])
            extra = _hopper_workspace_bytes(h.method, a, h.i_n, h.r_n, b, 4,
                                            H100_SMS, first_mode=mode == 0)
            assert m.peak_bytes == _step_peak_bytes(m.method, m.i_n, m.r_n,
                                                    m.j_n, 4)
            assert h.peak_bytes == m.peak_bytes + extra + held
            extras.append(extra)
            cur[mode] = h.r_n
            held = (held or 4 * math.prod(shape)) + 4 * h.i_n * h.r_n
        # SVD runs no kernel; every other solver splits some reduction
        assert (max(extras) == 0) == (methods == "svd")

    def test_eig_on_boats_mode_0_holds_the_gram_workspace(self):
        (h,), (m,) = (steps(*BOATS, impl, methods="eig")[:1]
                      for impl in ("hopper", "matfree"))
        assert h.mode == 0 and h.peak_bytes - m.peak_bytes == 9011200

    def test_first_mode_gemm_image_is_charged(self, monkeypatch):
        """ALS at R = 40 on a first mode with B = 64: its TTT needs no
        split and its 40² Gram 6,400 B, and the wide GEMM's image of L (40
        -> 64 rows, 32 stages) is 524,288 B, charged on the first mode only
        (elsewhere the TTM is the interior kernel, which allocates
        nothing).  The fp32 QR of L, cuSOLVER's 3 MiB workspace with L's
        copies, outweighs both; without it the image is the figure."""
        qr = (3 * 2 ** 18 + 3 * 1021 * 40 + 40 * 40 + 1024) * 4
        assert _qr_bytes(1021, 40, 4) == qr == 3646304
        for first in (True, False):
            assert _hopper_workspace_bytes("als", 1, 1021, 40, 64, 4, 132,
                                           first_mode=first) == qr
        monkeypatch.setattr(P, "_qr_bytes", lambda *a: 0)
        assert _hopper_workspace_bytes("als", 1, 1021, 40, 64, 4, 132,
                                       first_mode=True) == 524288
        assert _hopper_workspace_bytes("als", 1, 1021, 40, 64, 4, 132) \
            == 40 * 40 * 4
        (h,), (m,) = (steps((1021, 8, 8), (40, 4, 4), impl,
                            methods="als")[:1]
                      for impl in ("hopper", "matfree"))
        assert h.mode == 0 and h.peak_bytes - m.peak_bytes == 524288

    def test_a_cap_between_the_two_is_refused_on_hopper_only(self):
        m = steps(*BOATS, "matfree", methods="eig")
        h = steps(*BOATS, "hopper", methods="eig")
        cap = max(s.peak_bytes for s in m)
        assert max(s.peak_bytes for s in h) > cap
        steps(*BOATS, "matfree", methods="eig", memory_cap_bytes=cap)
        with pytest.raises(MemoryCapError):
            steps(*BOATS, "hopper", methods="eig", memory_cap_bytes=cap)

    def test_the_search_prices_candidates_as_the_plan_does(self):
        """mode_order='opt' under a cap: the least cap the hopper search
        admits is above matfree's, and at it every step of the hopper plan
        fits (the search never picks a schedule the capped check refuses)."""
        def least(impl):
            lo, hi = 1, 1 << 40
            while hi - lo > 1:
                mid = (lo + hi) // 2
                try:
                    steps(*BOATS, impl, methods="eig", mode_order="opt",
                          memory_cap_bytes=mid)
                    hi = mid
                except MemoryCapError:
                    lo = mid
            return hi
        lm, lh = least("matfree"), least("hopper")
        assert lh > lm
        h = steps(*BOATS, "hopper", methods="eig", mode_order="opt",
                  memory_cap_bytes=lh)
        assert max(s.peak_bytes for s in h) == lh

    @pytest.mark.parametrize("n,allocated", [
        (8, 289792), (33, 22528), (240, 501248), (320, 869376),
        (1021, 21505024), (1340, 36731392), (7000, 984558080)])
    def test_eigh_bound_covers_the_cards_allocation(self, n, allocated):
        """What ``torch.linalg.eigh`` of an n × n fp32 matrix allocated on an
        H100 (chip_smoke.py's opt_cap_eig row, torch 2.11, CUDA 12.8), at
        every Gram size the Boats and HSI plans run, lies under the bound
        the hopper EIG step charges, and within 2 MB + 5% of it above n =
        1000 (so the bound does not over-refuse caps)."""
        bound = _eigh_bytes(n, 4)
        assert allocated <= bound
        if n > 1000:
            assert bound <= 1.05 * allocated + 2 ** 21

    def test_boats_eig_binds_at_the_7000_squared_eigh(self):
        """Boats, methods="eig", mode_order="opt": whatever the order, mode
        2's step holds the input beside the 7000² Gram and eigh's
        workspace, so the least hopper cap is that step's figure: input,
        the (10, 10, 7000) core and its update, the Gram, eigh's bound and
        the two other factors."""
        x_bytes = 320 * 240 * 7000 * 4
        want = (x_bytes + (7000 * 100 + 10 * 100) * 4 + 7000 ** 2 * 4
                + _eigh_bytes(7000, 4) + (320 + 240) * 10 * 4)
        assert want == 3379274976
        h = steps(*BOATS, "hopper", methods="eig", mode_order="opt",
                  memory_cap_bytes=want)
        assert [s.mode for s in h][-1] == 2 and h[-1].peak_bytes == want
        with pytest.raises(MemoryCapError, match="mode 2"):
            steps(*BOATS, "hopper", methods="eig", mode_order="opt",
                  memory_cap_bytes=want - 1)

    def test_thosvd_steps_hold_the_factors_but_read_the_input(self):
        """t-HOSVD solves every mode on the input itself, which the step's
        own figure counts: a hopper step adds its workspace and the factors
        solved before it, not a second copy of the input."""
        shape, ranks = SMALL
        done = 0
        for h, m in zip(steps(shape, ranks, "hopper", variant="thosvd",
                              methods="eig"),
                        steps(shape, ranks, "matfree", variant="thosvd",
                              methods="eig")):
            a, b = math.prod(shape[:h.mode]), math.prod(shape[h.mode + 1:])
            extra = _hopper_workspace_bytes("eig", a, h.i_n, h.r_n, b, 4,
                                            H100_SMS, first_mode=h.mode == 0)
            assert h.peak_bytes == m.peak_bytes + extra + done
            done += 4 * h.i_n * h.r_n

    def test_matfree_plan_json_is_unchanged_by_the_sm_count(self):
        import repro.core as R
        shape, ranks = BOATS
        for methods in ("eig", "als"):
            p = plan(shape, "float32", TuckerConfig(
                ranks=ranks, methods=methods, impl="matfree"), device="cpu")
            r = R.plan(shape, jnp.float32, R.TuckerConfig(
                ranks=ranks, methods=methods))
            assert [s.peak_bytes for s in p.schedule] == \
                [s.peak_bytes for s in r.schedule]


class TestLastModePlans:
    def test_last_mode_gemm_image_is_charged(self, monkeypatch):
        """ALS at R = 40 on a last mode of I = 100,000 with A = 64: the wide
        GEMM's image of L (40 -> 64 rows, 3,125 stages) is 51.2 MB, charged
        on the last mode (neither flag) and on the first (the same u on the
        other side), outweighing the TTT's workspace once QR's is left
        out; at R = 16 the slab route holds none."""
        monkeypatch.setattr(P, "_qr_bytes", lambda *a: 0)
        image = workspace_bytes(64, 40, 100_000)
        assert image == 3125 * 2 * 64 * 128 == 51_200_000
        assert _hopper_workspace_bytes("als", 64, 100_000, 40, 1, 4,
                                       132) == image
        assert _hopper_workspace_bytes("als", 1, 100_000, 40, 64, 4, 132,
                                       first_mode=True) == image
        assert _hopper_workspace_bytes("als", 64, 100_000, 16, 1, 4,
                                       132) < image

    @pytest.mark.parametrize("methods", ["eig", "als"])
    def test_capped_plan_with_a_wide_last_mode(self, methods):
        """Cavity's shape cut to (24, 24, 600) at ranks (20, 20, 20): the
        last mode runs its GEMM (and on ALS its TTT) at R = 20 on the wide
        routes.  Its hopper step adds the last mode's workspace at its
        view; the largest step peak is a cap the plan admits, one byte
        less it refuses."""
        shape, ranks = (24, 24, 600), (20, 20, 20)
        hs = steps(shape, ranks, "hopper", methods=methods)
        ms = steps(shape, ranks, "matfree", methods=methods)
        cur, held = list(shape), 0
        for h, m in zip(hs, ms):
            a, b = math.prod(cur[:h.mode]), math.prod(cur[h.mode + 1:])
            extra = _hopper_workspace_bytes(
                h.method, a, h.i_n, h.r_n, b, 4, H100_SMS,
                first_mode=h.mode == 0, interior=0 < h.mode < 2)
            assert h.peak_bytes == m.peak_bytes + extra + held
            if h.mode == 2:
                assert route(a, h.r_n) == "wide" and extra > 0
            cur[h.mode] = h.r_n
            held = (held or 4 * math.prod(shape)) + 4 * h.i_n * h.r_n
        cap = max(s.peak_bytes for s in hs)
        capped = steps(shape, ranks, "hopper", methods=methods,
                       memory_cap_bytes=cap)
        assert max(s.peak_bytes for s in capped) <= cap
        with pytest.raises(MemoryCapError):
            steps(shape, ranks, "hopper", methods=methods,
                  memory_cap_bytes=cap - 1)


def test_wide_route_matches_the_plain_version_on_the_card():
    """The wide route on the card against the plain version per entry, on
    both loads and both dtypes (the full check is chip_smoke.py's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for r, k, n in WIDE_CASES:
            a = torch.randn((r, k), generator=g, device="cuda").to(dtype)
            b = torch.randn((k, n), generator=g, device="cuda").to(dtype)
            got = MM.matmul(a, b)
            want = a.double() @ b.double()
            scale = (a.double() ** 2 @ b.double() ** 2).sqrt()
            assert float(((got.double() - want).abs() / scale).max()) <= LIMIT
