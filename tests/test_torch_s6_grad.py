"""Port parity for the selective scan's gradient, and the autograd guard of
the kernels that have none.

On the CPU ``repro_torch.kernels.s6_scan`` under autograd is the
``S6Scan`` Function: its forward is the step recurrence and its backward
``ref.s6_scan_bwd_ref``, the reverse recurrence that the card's
``csrc/s6_scan_bwd.cu`` computes.  It is held against ``torch.autograd``
through ``ref.s6_scan_ref`` and against ``jax.grad`` of the reference's
chunked scan ``repro.models.ssm._s6_scan`` at chunk 16 (short enough that
its exp(-cumsum) does not overflow), on numpy inputs from a seed: ragged T,
a nonzero h0 and dh_final, bf16 x, and B and C as column views of one
projection.  Tolerance: 1e-5 of each gradient's max|.| in fp32 (the three
differ only in the order of fp32 sums); a bf16 x's gradient is compared in
bf16 against the same autograd graph, where both round one fp32 sum.

The kernels without a backward (``ttt``, ``matmul``, ``ttm_interior``)
refuse, on the card, an operand that requires grad while grad is enabled;
the device check is monkeypatched here so that the guard runs without a
card.  The CUDA backward itself runs only on the card: its test skips here
and chip_smoke.py holds it against the plain version on the H100.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import _s6_scan
from repro_torch import kernels as K
from repro_torch.kernels import _build, ref, s6_scan
from torch_parity import to_np

REL = 1e-5
NAMES = ("x", "dt", "proj", "a", "h0")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These tests run many tiny ops, for which starting a thread pool
    costs more than the op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(b, t, di, n, seed=0, dt_scale=0.1, extra=3):
    """x, dt, proj (B, T, extra + 2N: B and C are its last 2N columns), a,
    h0, dy, dh_final as float32 numpy."""
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(x=f(b, t, di),
                dt=(np.abs(f(b, t, di)) * dt_scale).astype(np.float32),
                proj=f(b, t, extra + 2 * n), a=-np.abs(f(di, n)),
                h0=f(b, di, n), dy=f(b, t, di), dhf=f(b, di, n))


def split(proj, n, extra=3):
    return proj[..., extra:extra + n], proj[..., extra + n:]


def rel(got, want) -> float:
    g, w = to_np(got), to_np(want)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def port_grads(d, n, *, h0, dhf, fn=s6_scan, x_dtype=torch.float32):
    """Gradients of Σ y·dy (+ Σ h_final·dhf) through ``fn`` w.r.t. x, dt,
    proj, a (and h0)."""
    ts = {k: torch.from_numpy(d[k]).requires_grad_(True) for k in NAMES}
    x = ts["x"].to(x_dtype) if x_dtype != torch.float32 else ts["x"]
    bm, cm = split(ts["proj"].to(x_dtype), n)
    y, hf = fn(x, ts["dt"], bm, cm, ts["a"], ts["h0"] if h0 else None)
    loss = (y * torch.from_numpy(d["dy"])).sum()
    if dhf:
        loss = loss + (hf * torch.from_numpy(d["dhf"])).sum()
    loss.backward()
    return {k: ts[k].grad for k in NAMES if h0 or k != "h0"}


CASES = [(2, 37, 5, 4), (1, 1, 6, 3), (2, 48, 16, 16), (3, 33, 9, 5)]


class TestPlainBackward:
    @pytest.mark.parametrize("shape", CASES)
    @pytest.mark.parametrize("h0,dhf", [(False, False), (True, True),
                                        (True, False)])
    def test_matches_autograd_of_the_recurrence(self, shape, h0, dhf):
        d = inputs(*shape, seed=sum(shape))
        want = port_grads(d, shape[3], h0=h0, dhf=dhf, fn=ref.s6_scan_ref)
        got = port_grads(d, shape[3], h0=h0, dhf=dhf)
        for k in want:
            assert rel(got[k], want[k]) <= REL, k

    def test_direct_call_returns_every_gradient(self):
        d = inputs(2, 20, 7, 4, seed=3)
        t = {k: torch.from_numpy(v) for k, v in d.items()}
        bm, cm = split(t["proj"], 4)
        dx, ddt, db, dc, da, dh0 = K.s6_scan_bwd(
            t["x"], t["dt"], bm, cm, t["a"], t["h0"], t["dy"], t["dhf"])
        want = port_grads(d, 4, h0=True, dhf=True, fn=ref.s6_scan_ref)
        assert rel(dx, want["x"]) <= REL and rel(ddt, want["dt"]) <= REL
        assert rel(torch.cat([torch.zeros(2, 20, 3), db, dc], -1),
                   want["proj"]) <= REL
        assert rel(da, want["a"]) <= REL and rel(dh0, want["h0"]) <= REL
        assert dx.dtype == db.dtype == torch.float32

    def test_bf16_x_and_projection(self):
        d = inputs(2, 29, 8, 4, seed=5)
        want = port_grads(d, 4, h0=True, dhf=True, fn=ref.s6_scan_ref,
                          x_dtype=torch.bfloat16)
        got = port_grads(d, 4, h0=True, dhf=True, x_dtype=torch.bfloat16)
        for k in want:
            assert rel(got[k], want[k]) <= REL, k

    def test_no_grad_keeps_the_plain_forward(self):
        d = inputs(1, 9, 4, 4, seed=2)
        t = {k: torch.from_numpy(v).requires_grad_(True) for k, v in d.items()}
        bm, cm = split(t["proj"], 4)
        with torch.no_grad():
            y, _ = s6_scan(t["x"], t["dt"], bm, cm, t["a"])
        assert y.grad_fn is None
        y, _ = s6_scan(t["x"], t["dt"], bm, cm, t["a"])
        assert type(y.grad_fn).__name__ == "S6ScanBackward"

    def test_cpu_backward_counts_no_launches(self):
        K.reset_launch_counts()
        d = inputs(1, 5, 3, 2, seed=1)
        port_grads(d, 2, h0=True, dhf=True)
        assert K.launch_counts()["s6_scan_bwd"] == 0
        assert K.launch_counts()["s6_scan"] == 0


class TestAgainstJaxGrad:
    """jax.grad of the reference's chunked scan at chunk 16."""

    @staticmethod
    def jax_grads(d, n, *, h0, dhf):
        def loss(x, dt, proj, a, h):
            bm, cm = proj[..., 3:3 + n], proj[..., 3 + n:]
            y, hf = _s6_scan(x, dt, bm, cm, a, 16, h0=h if h0 else None)
            out = jnp.sum(y * d["dy"])
            return out + jnp.sum(hf * d["dhf"]) if dhf else out
        g = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
            *(jnp.asarray(d[k]) for k in NAMES))
        return dict(zip(NAMES, g))

    @pytest.mark.parametrize("shape", [(2, 37, 5, 4), (2, 64, 16, 16),
                                       (1, 17, 9, 5), (3, 1, 6, 3)])
    @pytest.mark.parametrize("h0,dhf", [(False, False), (True, True)])
    def test_matches_jax_grad(self, shape, h0, dhf):
        d = inputs(*shape, seed=7 + shape[1])
        want = self.jax_grads(d, shape[3], h0=h0, dhf=dhf)
        got = port_grads(d, shape[3], h0=h0, dhf=dhf)
        if shape[1] == 1 and not h0:
            # one step from a zero state: da = Σ g dt exp(dt a) h_{-1} is 0;
            # the reference's exp(-cumsum)·exp(cumsum) leaves a residue
            assert float(got.pop("a").abs().max()) == 0.0
            assert np.abs(np.asarray(want["a"])).max() <= \
                REL * np.abs(np.asarray(want["dt"])).max()
        for k in got:
            assert rel(got[k], want[k]) <= REL, k

    def test_strided_projection_gets_its_columns(self):
        """B and C as column views: the gradient lands in their columns of
        the projection and the others (dt_rank's) stay zero here."""
        d = inputs(2, 21, 6, 4, seed=11)
        got = port_grads(d, 4, h0=True, dhf=True)
        want = self.jax_grads(d, 4, h0=True, dhf=True)
        assert float(got["proj"][..., :3].abs().max()) == 0.0
        assert rel(got["proj"], want["proj"]) <= REL


def chunked_grads(d, n, *, h0, dhf, chunk, states=None):
    """(dx, ddt, dB, dC, da, dh0) of ``ref.s6_scan_bwd_chunked_ref``."""
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    bm, cm = split(t["proj"], n)
    return ref.s6_scan_bwd_chunked_ref(
        t["x"], t["dt"], bm, cm, t["a"], t["h0"] if h0 else None, t["dy"],
        t["dhf"] if dhf else None, chunk=chunk, states=states)


#: (B, T, Di, N, backward chunk): T ragged against the chunk and the
#: checkpoints' 8 steps, N one group (4, 16) and four (64), Di ragged
#: against the kernel's 128-channel blocks
CHUNKED_CASES = [(2, 37, 5, 4, 16), (1, 77, 130, 16, 24), (2, 29, 9, 64, 8),
                 (3, 1, 6, 4, 8), (2, 50, 20, 16, 40)]


class TestChunkedBackward:
    """``ref.s6_scan_bwd_chunked_ref``, the algebra of the card's backward
    (local carries, the chain, the recompute from 8-step checkpoints, the
    fixed-order sums of dB, dC by 128-channel blocks and of da by chunk),
    against the plain reverse recurrence and against jax.grad of the
    reference's scan, at 1e-5 of each gradient's max|.| in fp32 (the
    orders of the sums differ)."""

    @pytest.mark.parametrize("shape", CHUNKED_CASES)
    @pytest.mark.parametrize("h0,dhf", [(False, False), (True, True),
                                        (True, False), (False, True)])
    def test_matches_the_reverse_recurrence(self, shape, h0, dhf):
        b, t, di, n, chunk = shape
        d = inputs(b, t, di, n, seed=sum(shape))
        ts = {k: torch.from_numpy(v) for k, v in d.items()}
        bm, cm = split(ts["proj"], n)
        want = ref.s6_scan_bwd_ref(ts["x"], ts["dt"], bm, cm, ts["a"],
                                   ts["h0"] if h0 else None, ts["dy"],
                                   ts["dhf"] if dhf else None)
        got = chunked_grads(d, n, h0=h0, dhf=dhf, chunk=chunk)
        for name, g, w in zip(("dx", "ddt", "dB", "dC", "da", "dh0"), got,
                              want):
            if name == "da" and t == 1 and not h0:
                assert float(g.abs().max()) == float(w.abs().max()) == 0.0
                continue
            assert rel(g, w) <= REL, name

    @pytest.mark.parametrize("shape", CHUNKED_CASES[:3])
    @pytest.mark.parametrize("h0,dhf", [(False, False), (True, True)])
    def test_matches_jax_grad(self, shape, h0, dhf):
        b, t, di, n, chunk = shape
        d = inputs(b, t, di, n, seed=7 + t)
        want = TestAgainstJaxGrad.jax_grads(d, n, h0=h0, dhf=dhf)
        dx, ddt, db, dc, da, dh0 = chunked_grads(d, n, h0=h0, dhf=dhf,
                                                 chunk=chunk)
        proj = torch.cat([torch.zeros(b, t, 3), db, dc], -1)
        for name, g in (("x", dx), ("dt", ddt), ("proj", proj), ("a", da)):
            assert rel(g, want[name]) <= REL, name
        if h0:
            assert rel(dh0, want["h0"]) <= REL

    @pytest.mark.parametrize("t,chunk", [(37, 16), (77, 64), (8, 8),
                                         (130, 128)])
    def test_forward_checkpoints(self, t, chunk):
        """``s6_scan_chunked_ref``'s phase C keeps the state entering every
        8th step, as the kernel's does: it matches the step recurrence's
        states, y and h_final are unchanged, and the backward run from
        them matches the one from the recurrence's own."""
        d = inputs(2, t, 12, 5, seed=t)
        ts = {k: torch.from_numpy(v) for k, v in d.items()}
        bm, cm = split(ts["proj"], 5)
        ops = (ts["x"], ts["dt"], bm, cm, ts["a"], ts["h0"])
        y, hf = ref.s6_scan_chunked_ref(*ops, chunk=chunk)
        y2, hf2, ck = ref.s6_scan_chunked_ref(*ops, chunk=chunk,
                                              checkpoints=8)
        assert torch.equal(y, y2) and torch.equal(hf, hf2)
        assert tuple(ck.shape) == (-(-t // 8), 2, 5, 12)
        h, want = ts["h0"], []
        for i in range(t):
            if i % 8 == 0:
                want.append(h.transpose(1, 2))
            h = (torch.exp(ts["dt"][:, i, :, None] * ts["a"]) * h
                 + (ts["dt"][:, i] * ts["x"][:, i])[..., None]
                 * bm[:, i, None, :])
        assert rel(ck, torch.stack(want)) <= REL
        got = chunked_grads(d, 5, h0=True, dhf=True, chunk=16, states=ck)
        base = chunked_grads(d, 5, h0=True, dhf=True, chunk=16)
        for g, w in zip(got, base):
            assert rel(g, w) <= REL


class TestBackwardPlan:
    """The card backward's chunking and buffers, pure functions of the
    shape (``kernels/s6_scan_bwd.py``), at the training shape and around
    its edges."""

    def test_training_shape(self):
        bwd = importlib.import_module("repro_torch.kernels.s6_scan_bwd")
        lb = bwd.chunk_len(2, 2048, 8192, 16, 132)
        assert lb == 344 and lb % bwd.SUB_CHUNK == 0
        blocks = 64 * 2 * -(-2048 // lb)
        assert blocks <= 2 * 132 * bwd._CHUNK_BLOCKS     # at most two waves
        sizes = bwd._bwd_sizes(2, 2048, 8192, 16, lb)
        assert sizes["checkpoints"] == 256 * 2 * 16 * 8192
        assert sizes["partials_bc"] == 64 * 2 * 2048 * 16
        assert sizes["partials_x"] == 0

    @pytest.mark.parametrize("n,groups", [(1, 1), (4, 1), (16, 1), (17, 2),
                                          (20, 2), (64, 4)])
    def test_state_groups(self, n, groups):
        bwd = importlib.import_module("repro_torch.kernels.s6_scan_bwd")
        assert bwd.groups(n) == groups
        partials = bwd._bwd_sizes(2, 37, 5, n, 8)["partials_x"]
        assert partials == (0 if groups == 1 else groups * 2 * 37 * 5)

    @pytest.mark.parametrize("t", [1, 7, 8, 9, 37, 8191])
    def test_chunks_cover_t(self, t):
        bwd = importlib.import_module("repro_torch.kernels.s6_scan_bwd")
        lb = bwd.chunk_len(1, t, 8192, 16, 132)
        k = -(-t // lb)
        assert lb % bwd.SUB_CHUNK == 0 and (k - 1) * lb < t <= k * lb
        fwd = importlib.import_module("repro_torch.kernels.s6_scan")
        assert bwd.SUB_CHUNK == fwd.CHECKPOINT_STRIDE == 8


class TestGuard:
    """ttt, matmul and ttm_interior have no backward: on the card they
    refuse an operand that requires grad while grad is enabled."""

    CALLS = {
        "ttt": lambda a, b: K.ttt3(a, b),
        "matmul": lambda a, b: K.matmul(a[0], b[0].T),
        "ttm_interior": lambda a, b: K.ttm_interior(a[0, :, :4], b),
    }

    @pytest.mark.parametrize("name", sorted(CALLS))
    def test_refuses_grad_on_the_card(self, monkeypatch, name):
        monkeypatch.setattr(_build, "check_operands", lambda *a, **k: "cuda")
        a = torch.randn(3, 4, 5, requires_grad=True)
        b = torch.randn(3, 4, 5)
        with pytest.raises(RuntimeError, match=f"{name}: the Hopper kernel has "
                                               "no backward"):
            self.CALLS[name](a, b)

    @pytest.mark.parametrize("name", sorted(CALLS))
    def test_cpu_tensors_differentiate_the_plain_version(self, name):
        a = torch.randn(3, 4, 5, requires_grad=True)
        out = self.CALLS[name](a, torch.randn(3, 4, 5))
        out.sum().backward()
        assert a.grad is not None

    def test_guard_passes_without_grad(self):
        a = torch.randn(2, 2, requires_grad=True)
        _build.refuse_grad("matmul", a.detach(), a.detach())
        with torch.no_grad():
            _build.refuse_grad("matmul", a)
        with pytest.raises(RuntimeError, match="matmul"):
            _build.refuse_grad("matmul", a.detach(), a)


def test_s6_backward_kernel_matches_plain_version_on_the_card():
    """The CUDA backward from both forward routes against the plain reverse
    recurrence on the card (the full check is chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    s6 = importlib.import_module("repro_torch.kernels.s6_scan")
    g = torch.Generator(device="cuda").manual_seed(0)
    for b, t, di, n in ((2, 37, 5, 4), (2, 131, 200, 16)):
        x = torch.randn((b, t, di), generator=g, device="cuda")
        dt = torch.rand((b, t, di), generator=g, device="cuda") * 0.1
        proj = torch.randn((b, t, 3 + 2 * n), generator=g, device="cuda")
        bm, cm = proj[..., 3:3 + n], proj[..., 3 + n:]
        a = -torch.rand((di, n), generator=g, device="cuda")
        h0 = torch.randn((b, di, n), generator=g, device="cuda")
        dy = torch.randn((b, t, di), generator=g, device="cuda")
        want = ref.s6_scan_bwd_ref(x, dt, bm, cm, a, h0, dy)
        for r in s6.ROUTES:
            _, _, states, stride = s6.forward_with_states(
                x, dt, bm, cm, a, h0, force_route=r)
            got = K.s6_scan_bwd(x, dt, bm, cm, a, h0, dy, states=states,
                                stride=stride)
            for gv, wv in zip(got, want):
                assert float((gv - wv).abs().max()) <= \
                    1e-4 * float(wv.abs().max())
