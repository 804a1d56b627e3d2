"""Port parity for the selective-scan kernel's plain version and its wrapper.

On the CPU ``repro_torch.kernels.s6_scan`` runs its plain version, the step
recurrence.  It is held against the reference's chunked jnp scan
``repro.models.ssm._s6_scan`` at 3e-4 (the tolerance of
tests/test_ssm_moe.py) and against its Pallas kernel ``s6_scan_fwd`` in
interpret mode at 5e-4 (tests/test_kernels.py), on those files' shapes and
inputs, with and without an initial state.  One pinned case records the
deliberate difference: at falcon-mamba's chunk of 256 and a step size of
0.022 the reference's chunked scan overflows fp32, and the port does not.
The chunked route's algebra (scan each chunk from zero, chain the chunks'
states, rescan from each entry state) is held against the step recurrence
through its PyTorch mirror ``s6_scan_chunked_ref``, at 1e-5 of max|y| and
max|h_final| in fp32, up to the full model's step sizes.
The CUDA kernel runs only on the card: its test skips here, and
chip_smoke.py holds it against the plain version on the H100.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.s6_scan import s6_scan_fwd
from repro.models.ssm import _s6_scan
from repro_torch import kernels as K
from repro_torch.kernels import ref, s6_scan
from repro_torch.kernels.s6_scan import (CHUNK_MAX, CHUNK_MIN,
                                        CHUNKED_MIN_WORK, ROUTES, chunk_len,
                                        route)
from torch_parity import to_np


def inputs(b, t, di, n, seed=0, dt_scale=0.1):
    """x, dt, B, C, a as float32 numpy: the reference tests' distributions."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, t, di)).astype(np.float32)
    dt = (np.abs(r.standard_normal((b, t, di))) * dt_scale).astype(np.float32)
    bm = r.standard_normal((b, t, n)).astype(np.float32)
    cm = r.standard_normal((b, t, n)).astype(np.float32)
    a = -np.abs(r.standard_normal((di, n))).astype(np.float32)
    return x, dt, bm, cm, a


def numpy_recurrence(x, dt, bm, cm, a, h0=None):
    """float64 step recurrence (tests/test_ssm_moe.py's oracle, with h0)."""
    b, t, di = x.shape
    h = np.zeros((b, di, a.shape[1])) if h0 is None else h0.astype(np.float64)
    ys = []
    for i in range(t):
        da = np.exp(dt[:, i][:, :, None] * a[None])
        h = da * h + (dt[:, i] * x[:, i])[:, :, None] * bm[:, i][:, None, :]
        ys.append(np.einsum("bn,bdn->bd", cm[:, i], h))
    return np.stack(ys, 1), h


def torch_args(*arrays):
    return [torch.from_numpy(a) for a in arrays]


class TestAgainstChunkedScan:
    @pytest.mark.parametrize("chunk", [4, 8, 37])
    def test_matches_reference_scan(self, chunk):
        ops = inputs(2, 37, 5, 4)
        y, hf = s6_scan(*torch_args(*ops))
        y_ref, h_ref = _s6_scan(*map(jnp.asarray, ops), chunk=chunk)
        np.testing.assert_allclose(to_np(y), to_np(y_ref), atol=3e-4)
        np.testing.assert_allclose(to_np(hf), to_np(h_ref), atol=3e-4)

    @pytest.mark.parametrize("chunk", [4, 16])
    def test_initial_state(self, chunk):
        ops = inputs(2, 29, 6, 8, seed=1)
        h0 = np.random.default_rng(2).standard_normal((2, 6, 8)).astype(
            np.float32)
        y, hf = s6_scan(*torch_args(*ops, h0))
        y_ref, h_ref = _s6_scan(*map(jnp.asarray, ops), chunk=chunk,
                                h0=jnp.asarray(h0))
        np.testing.assert_allclose(to_np(y), to_np(y_ref), atol=3e-4)
        np.testing.assert_allclose(to_np(hf), to_np(h_ref), atol=3e-4)

    def test_state_carry_across_calls(self):
        """Two calls carrying h_final into h0 == one long call == the
        reference's one long scan (tests/test_ssm_moe.py's carry case)."""
        x, dt, bm, cm, a = torch_args(*inputs(1, 24, 3, 2, seed=3))
        y_full, h_full = s6_scan(x, dt, bm, cm, a)
        y1, h1 = s6_scan(x[:, :10], dt[:, :10], bm[:, :10], cm[:, :10], a)
        y2, h2 = s6_scan(x[:, 10:], dt[:, 10:], bm[:, 10:], cm[:, 10:], a, h1)
        np.testing.assert_allclose(to_np(torch.cat([y1, y2], 1)),
                                   to_np(y_full), atol=2e-4)
        np.testing.assert_allclose(to_np(h2), to_np(h_full), atol=2e-4)
        y_ref, h_ref = _s6_scan(*(jnp.asarray(to_np(v).astype(np.float32))
                                  for v in (x, dt, bm, cm, a)), chunk=8)
        np.testing.assert_allclose(to_np(y_full), to_np(y_ref), atol=2e-4)
        np.testing.assert_allclose(to_np(h_full), to_np(h_ref), atol=2e-4)

    def test_single_step_is_the_decode_recurrence(self):
        """T = 1 from a state: the reference's decode branch
        (ssm.py:132-139) written out."""
        x, dt, bm, cm, a = inputs(3, 1, 7, 16, seed=4)
        h0 = np.random.default_rng(5).standard_normal((3, 7, 16)).astype(
            np.float32)
        y, hf = s6_scan(*torch_args(x, dt, bm, cm, a, h0))
        da = np.exp(dt[:, 0][..., None] * a[None])
        h = da * h0 + (dt[:, 0] * x[:, 0])[..., None] * bm[:, 0][:, None, :]
        np.testing.assert_allclose(to_np(hf), h, atol=1e-5)
        np.testing.assert_allclose(to_np(y)[:, 0],
                                   np.einsum("bn,bdn->bd", cm[:, 0], h),
                                   atol=1e-5)


class TestAgainstPallasKernel:
    @pytest.mark.parametrize("shape,bd,bt", [
        ((2, 128, 64, 8), 32, 16),
        ((1, 64, 32, 4), 32, 64),
        ((3, 96, 16, 16), 16, 32),
    ])
    def test_vs_interpret_mode(self, shape, bd, bt):
        ops = inputs(*shape)
        y, _ = s6_scan(*torch_args(*ops))
        y_ref = s6_scan_fwd(*map(jnp.asarray, ops), bd=bd, bt=bt,
                            interpret=True)
        np.testing.assert_allclose(to_np(y), to_np(y_ref), atol=5e-4)


def test_reference_chunked_scan_overflows_where_the_port_does_not():
    """The deliberate difference (ROADMAP.md Queue 3): with chunk = 256,
    N = 16, a = -(1..16) and dt = 0.022 the reference's exp(-cumsum) leaves
    fp32 and returns non-finite values; the port's recurrence matches the
    float64 numpy recurrence.  At dt = 0.018 both are finite."""
    b, t, di, n = 1, 512, 4, 16
    r = np.random.default_rng(6)
    x = r.standard_normal((b, t, di)).astype(np.float32)
    bm = r.standard_normal((b, t, n)).astype(np.float32)
    cm = r.standard_normal((b, t, n)).astype(np.float32)
    a = -np.tile(np.arange(1, n + 1, dtype=np.float32), (di, 1))
    for dt_val, overflows in ((0.022, True), (0.018, False)):
        dt = np.full((b, t, di), dt_val, np.float32)
        y_ref, _ = _s6_scan(*map(jnp.asarray, (x, dt, bm, cm, a)), chunk=256)
        assert (not np.isfinite(np.asarray(y_ref)).all()) == overflows
        y, hf = s6_scan(*torch_args(x, dt, bm, cm, a))
        y_np, h_np = numpy_recurrence(x, dt, bm, cm, a)
        np.testing.assert_allclose(to_np(y), y_np, atol=3e-4)
        np.testing.assert_allclose(to_np(hf), h_np, atol=3e-4)


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


class TestChunkedAlgebra:
    """``s6_scan_chunked_ref`` (phases A-C of the kernel's chunked route)
    against ``s6_scan_ref`` (the step recurrence) in fp32: 1e-5 of max|y|
    and of max|h_final|.  The two differ only in that a chunk's decay of
    the entry state is exp(a·Σdt) instead of a product of exp(dt·a)."""
    TOL = 1e-5

    def check(self, ops, h0, chunk):
        y, hf = ref.s6_scan_ref(*ops, h0)
        yc, hc = ref.s6_scan_chunked_ref(*ops, h0, chunk=chunk)
        assert yc.shape == y.shape and hc.shape == hf.shape
        assert rel_err(yc, y) <= self.TOL
        assert rel_err(hc, hf) <= self.TOL
        return yc, hc

    @pytest.mark.parametrize("shape,chunk", [
        ((2, 37, 5, 4), 8), ((2, 29, 6, 8), 4), ((1, 24, 3, 2), 5),
        ((3, 1, 7, 16), 4), ((2, 128, 64, 8), 32), ((1, 64, 32, 4), 16),
        ((3, 96, 16, 16), 40)])
    def test_small_shapes(self, shape, chunk):
        ops = torch_args(*inputs(*shape, seed=11))
        self.check(ops, None, chunk)
        h0 = torch.randn((shape[0], shape[2], shape[3]),
                         generator=torch.Generator().manual_seed(12))
        self.check(ops, h0, chunk)

    @pytest.mark.parametrize("chunk", [CHUNK_MIN, CHUNK_MAX])
    @pytest.mark.parametrize("edge", ["1", "L-1", "L", "L+1", "3L+5"])
    def test_chunk_edges(self, chunk, edge):
        """T around the kernel's shortest and longest chunk, from zeros and
        from a nonzero state."""
        t = {"1": 1, "L-1": chunk - 1, "L": chunk, "L+1": chunk + 1,
             "3L+5": 3 * chunk + 5}[edge]
        ops = torch_args(*inputs(2, t, 6, 16, seed=t))
        self.check(ops, None, chunk)
        h0 = torch.randn((2, 6, 16), generator=torch.Generator().manual_seed(t))
        self.check(ops, h0, chunk)

    @pytest.mark.parametrize("chunk", [CHUNK_MIN, chunk_len(1, 2048, 8192, 132)])
    def test_full_model_step_sizes(self, chunk):
        """dt at falcon-mamba-7b's layer-0 statistics (mean 0.0216, max
        0.35: softplus(-4 + 0.6 z) with one step at the observed maximum),
        a = -(1..16), T = 2048, Di = 8: the mirror stays finite and within
        1e-5, where the reference's chunked scan at its chunk of 256 returns
        non-finite values."""
        b, t, di, n = 1, 2048, 8, 16
        r = np.random.default_rng(13)
        x = r.standard_normal((b, t, di)).astype(np.float32)
        dt = np.log1p(np.exp(-4.0 + 0.6 * r.standard_normal((b, t, di))))
        dt = (dt * 0.0216 / dt.mean()).astype(np.float32)
        dt[0, t // 2, 3] = 0.35
        assert abs(dt.mean() - 0.0216) < 1e-3 and dt.max() == np.float32(0.35)
        bm = r.standard_normal((b, t, n)).astype(np.float32)
        cm = r.standard_normal((b, t, n)).astype(np.float32)
        a = -np.tile(np.arange(1, n + 1, dtype=np.float32), (di, 1))
        h0 = r.standard_normal((b, di, n)).astype(np.float32)
        yc, hc = self.check(torch_args(x, dt, bm, cm, a), torch.from_numpy(h0),
                            chunk)
        assert torch.isfinite(yc).all() and torch.isfinite(hc).all()
        y_ref, _ = _s6_scan(*map(jnp.asarray, (x, dt, bm, cm, a)), chunk=256)
        assert not np.isfinite(np.asarray(y_ref)).all()


class TestWrapper:
    def test_plain_version_is_the_wrapper_on_cpu(self):
        args = torch_args(*inputs(2, 9, 5, 3, seed=7))
        for got, want in zip(s6_scan(*args), ref.s6_scan_ref(*args)):
            assert got.dtype == torch.float32 and got.is_contiguous()
            assert torch.equal(got, want)

    def test_strided_bc_and_bf16(self):
        """B and C as column slices of one projection, as the model passes
        them; bf16 x/B/C are converted to fp32 before the arithmetic."""
        x, dt, bm, cm, a = inputs(2, 11, 6, 4, seed=8)
        proj = np.concatenate([np.zeros((2, 11, 3), np.float32), bm, cm], -1)
        pt = torch.from_numpy(proj)
        bv, cv = pt[..., 3:7], pt[..., 7:]
        assert not bv.is_contiguous()
        got = s6_scan(torch.from_numpy(x), torch.from_numpy(dt), bv, cv,
                      torch.from_numpy(a))
        want = numpy_recurrence(x, dt, bm, cm, a)
        for g, w in zip(got, want):
            np.testing.assert_allclose(to_np(g), w, atol=1e-5)
        b16 = [torch.from_numpy(v).bfloat16() for v in (x, bm, cm)]
        got16 = s6_scan(b16[0], torch.from_numpy(dt), b16[1], b16[2],
                        torch.from_numpy(a))
        want16 = numpy_recurrence(*(to_np(v) for v in (
            b16[0], torch.from_numpy(dt), b16[1], b16[2])), a)
        for g, w in zip(got16, want16):
            np.testing.assert_allclose(to_np(g), w, atol=1e-5)

    def test_rejects_bad_operands(self):
        x, dt, bm, cm, a = torch_args(*inputs(2, 5, 3, 4))
        with pytest.raises(TypeError, match="float32"):
            s6_scan(x, dt.double(), bm, cm, a)
        with pytest.raises(TypeError, match="must agree"):
            s6_scan(x, dt, bm.bfloat16(), cm, a)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            s6_scan(x.double(), dt, bm.double(), cm.double(), a)
        with pytest.raises(ValueError, match="shape"):
            s6_scan(x, dt[:, :4], bm, cm, a)
        with pytest.raises(ValueError, match="shape"):
            s6_scan(x, dt, bm, cm, a, torch.zeros(2, 3, 5))
        with pytest.raises(ValueError, match="shape"):
            s6_scan(x, dt, bm, cm, a.T.contiguous())
        with pytest.raises(TypeError, match="torch.Tensor"):
            s6_scan(x.numpy(), dt, bm, cm, a)

    def test_route_is_a_function_of_the_shape(self):
        """Decode (T = 1 at 4 slots) and a 37-token prompt take the single
        pass, a long prefill the chunked route; a forced route is checked,
        and on the CPU every route is the plain version."""
        assert route(4, 1, 8192) == route(1, 37, 8192) == "single"
        assert route(1, 517, 8192) == route(1, 8191, 8192) == "chunked"
        t_min = -(-CHUNKED_MIN_WORK // 8192)
        assert route(1, t_min - 1, 8192) == "single"
        assert route(1, t_min, 8192) == "chunked"
        args = torch_args(*inputs(2, 9, 5, 3, seed=7))
        want = ref.s6_scan_ref(*args)
        for r in ROUTES:
            for got, w in zip(s6_scan(*args, force_route=r), want):
                assert torch.equal(got, w)
        with pytest.raises(ValueError, match="force_route"):
            s6_scan(*args, force_route="fast")

    def test_chunk_len_fills_the_card_once(self):
        """The chunk is the shortest power of two in [64, 512] whose chunks'
        blocks (128 channels each) fit 8 per SM at once."""
        sms = 132
        assert chunk_len(1, 517, 8192, sms) == CHUNK_MIN
        assert chunk_len(1, 2048, 8192, sms) == 128
        assert chunk_len(1, 4096, 8192, sms) == 256
        assert chunk_len(1, 8191, 8192, sms) == CHUNK_MAX
        assert chunk_len(16, 16500, 8192, sms) == CHUNK_MAX
        for b, t, di in ((1, 300, 8192), (2, 2000, 8192), (4, 9000, 5000)):
            lc = chunk_len(b, t, di, sms)
            blocks = -(-t // lc) * b * -(-di // 128)
            assert lc == CHUNK_MAX or blocks <= 8 * sms
            assert lc == CHUNK_MIN or -(-t // (lc // 2)) * b * \
                -(-di // 128) > 8 * sms

    def test_cpu_runs_count_no_launches(self):
        K.reset_launch_counts()
        s6_scan(*torch_args(*inputs(1, 4, 3, 2)))
        assert K.launch_counts()["s6_scan"] == 0


def test_s6_kernel_matches_plain_version_on_the_card():
    """The CUDA kernel's two routes against its plain version on the card,
    fp32 and bf16, ragged shapes, a nonzero state and strided B/C (the full check,
    at the main path's sizes, is chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for b, t, di, n in ((2, 37, 5, 4), (2, 77, 200, 16), (3, 1, 100, 5)):
            proj = torch.randn((b, t, 3 + 2 * n), generator=g, device="cuda")
            x = torch.randn((b, t, di), generator=g, device="cuda").to(dtype)
            dt = torch.rand((b, t, di), generator=g, device="cuda") * 0.1
            a = -torch.rand((di, n), generator=g, device="cuda")
            h0 = torch.randn((b, di, n), generator=g, device="cuda")
            bm, cm = proj[..., 3:3 + n].to(dtype), proj[..., 3 + n:].to(dtype)
            want = ref.s6_scan_ref(x, dt, bm, cm, a, h0)
            for r in ROUTES:
                got = s6_scan(x, dt, bm, cm, a, h0, force_route=r)
                for gv, wv in zip(got, want):
                    assert float((gv - wv).abs().max()) <= \
                        1e-4 * float(wv.abs().max())
