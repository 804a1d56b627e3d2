"""Backward of the Mamba-1 selective scan (S6) for Hopper: the gradient of
:class:`repro_torch.kernels.s6_scan.S6Scan`.

From dy (B, T, Di) and dh_final (B, Di, N) it computes dx, ddt, dB, dC, da
and dh0 of the recurrence the forward computes, walking t from T down to 1
with g_t = C_t ⊗ dy_t + exp(dt_{t+1}·a) ⊙ g_{t+1}.  The CUDA source is
``csrc/s6_scan_bwd.cu``: it recomputes the states of each chunk from the
entry states the forward kept (every ``stride`` steps) into shared memory
in sub-chunks of :data:`SUB_CHUNK` steps, walks them back, and reduces dB,
dC (over Di) and da (over B and T) from per-block partials in a fixed
order, with no atomics, so two runs on the same inputs agree bitwise.

A CPU tensor runs the plain version
(:func:`repro_torch.kernels.ref.s6_scan_bwd_ref`); a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import s6_scan_bwd_ref
from .s6_scan import _check

#: launches of the backward kernel (one per :func:`s6_scan_bwd` call on the
#: card, whatever the number of CUDA kernels it runs)
LAUNCHES = 0
#: steps per sub-chunk (csrc/s6_scan_bwd.cu SC); the states' stride must be
#: a multiple of it
SUB_CHUNK = 16


def _bwd_sizes(bsz: int, t: int, di: int, n: int, stride: int) -> dict:
    """Element counts of the backward's buffers (each must fit an int)."""
    k = -(-t // stride)
    return {"x": bsz * t * di, "checkpoints": k * (stride // SUB_CHUNK) * bsz * n * di,
            "carries": k * bsz * n * di, "partials_bc": -(-di // 32) * bsz * t * n,
            "partials_a": k * bsz * di * n}


def s6_scan_bwd(x: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor,
                cmat: torch.Tensor, a: torch.Tensor, h0: torch.Tensor | None,
                dy: torch.Tensor, dh_final: torch.Tensor | None = None, *,
                states: torch.Tensor | None = None, stride: int | None = None
                ) -> tuple[torch.Tensor, ...]:
    """Gradients (dx, ddt, dB, dC, da, dh0) of the scan from dy (B, T, Di)
    and dh_final (B, Di, N) or None: dx in x's dtype, dB and dC in bmat's,
    the rest fp32.  On the card it needs the forward's chunk entry states
    (``states``, ``stride``: :func:`.s6_scan.forward_with_states`) and launches
    ``csrc/s6_scan_bwd.cu``; on CPU tensors it runs the plain
    :func:`~repro_torch.kernels.ref.s6_scan_bwd_ref` from h0."""
    kind = _check(x, dt, bmat, cmat, a, h0)
    if kind == "cpu":
        return s6_scan_bwd_ref(x, dt, bmat, cmat, a, h0, dy, dh_final)
    bsz, t, di = x.shape
    n = a.shape[1]
    if states is None or stride is None or stride <= 0 or stride % SUB_CHUNK:
        raise ValueError(f"s6_scan_bwd: the forward's states and a stride "
                         f"that is a multiple of {SUB_CHUNK} are needed on the "
                         f"card, got stride {stride}")
    k = -(-t // stride)
    if (tuple(states.shape) != (k, bsz, di, n) or states.dtype != torch.float32
            or not states.is_contiguous() or states.device != x.device):
        raise ValueError(f"s6_scan_bwd: states must be contiguous fp32 "
                         f"{(k, bsz, di, n)} on {x.device}")
    for name, v, shape in (("dy", dy, (bsz, t, di)),
                           ("dh_final", dh_final, (bsz, di, n))):
        if v is not None and (tuple(v.shape) != shape or v.device != x.device):
            raise ValueError(f"s6_scan_bwd: {name} must be {shape} on "
                             f"{x.device}, got {tuple(v.shape)} on {v.device}")
    sizes = _bwd_sizes(bsz, t, di, n, stride)
    reach = {"bmat": (bsz - 1) * bmat.stride(0) + (t - 1) * bmat.stride(1) + n,
             "cmat": (bsz - 1) * cmat.stride(0) + (t - 1) * cmat.stride(1) + n}
    big = {k_: v for k_, v in {**sizes, **reach}.items() if v > _build._INT_MAX}
    if big:
        raise ValueError(f"s6_scan_bwd: the kernel indexes in 32 bits; these "
                         f"buffers reach 2**31 elements: {big}")
    dev = x.device
    dy = dy.float().contiguous()
    dhf = None if dh_final is None else dh_final.float().contiguous()
    with torch.cuda.device(dev):
        f32 = dict(dtype=torch.float32, device=dev)
        dx = torch.empty((bsz, t, di), dtype=x.dtype, device=dev)
        ddt = torch.empty((bsz, t, di), **f32)
        db = torch.empty((bsz, t, n), dtype=bmat.dtype, device=dev)
        dc = torch.empty((bsz, t, n), dtype=cmat.dtype, device=dev)
        da = torch.empty((di, n), **f32)
        dh0 = torch.empty((bsz, di, n), **f32)
        hck = torch.empty(sizes["checkpoints"], **f32)
        gl = torch.empty(sizes["carries"], **f32)
        ssum = torch.empty(k * bsz * di, **f32)
        pb = torch.empty(sizes["partials_bc"], **f32)
        pc = torch.empty(sizes["partials_bc"], **f32)
        pa = torch.empty(sizes["partials_a"], **f32)
        lib = _build.load("s6_scan_bwd")
        err = lib.atucker_s6_scan_bwd(
            x.data_ptr(), dt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
            a.data_ptr(), states.data_ptr(), dy.data_ptr(),
            None if dhf is None else dhf.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), db.data_ptr(), dc.data_ptr(), da.data_ptr(),
            dh0.data_ptr(), hck.data_ptr(), gl.data_ptr(), ssum.data_ptr(),
            pb.data_ptr(), pc.data_ptr(), pa.data_ptr(), bsz, t, di, n,
            stride, bmat.stride(0), bmat.stride(1), cmat.stride(0),
            cmat.stride(1), _build.dtype_code(x), _build.stream_ptr(dev))
        _build.check(lib, err, "s6_scan_bwd")
    global LAUNCHES
    LAUNCHES += 1
    return dx, ddt, db, dc, da, dh0


def launch_info(bsz: int, t: int, di: int, n: int, dtype: torch.dtype,
                    stride: int) -> list[dict]:
    """The same figures for the backward's four CUDA kernels (local pass,
    chain, chunk pass, and the reductions' kernel as it runs for dB), for
    states kept every ``stride`` steps (card only)."""
    args = (bsz, t, di, n, stride, _build.DTYPE_CODES[str(dtype)[6:]])
    rows, extra = _build.report("s6_scan_bwd", "atucker_s6_scan_bwd_info",
                                *args)
    regs, threads, per_sm, blocks = extra
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    rows.append(dict(registers=regs, threads=threads, blocks_per_sm=per_sm,
                     grid_blocks=blocks,
                     waves=blocks / (sms * per_sm) if per_sm else None))
    return rows
