"""Backward of the Mamba-1 selective scan (S6) for Hopper: the gradient of
:class:`repro_torch.kernels.s6_scan.S6Scan`.

From dy (B, T, Di) and dh_final (B, Di, N) it computes dx, ddt, dB, dC, da
and dh0 of the recurrence the forward computes, walking t from T down to 1
with g_t = C_t ⊗ dy_t + exp(dt_{t+1}·a) ⊙ g_{t+1}.  The CUDA source is
``csrc/s6_scan_bwd.cu``: it splits T into :func:`chunk_len` chunks, walks
each chunk back from a zero carry (the local pass), chains the chunks'
carries, then recomputes each chunk's states from the forward's
checkpoints (the state entering every :data:`SUB_CHUNK`-th step) into
shared memory, walks them back, and reduces dB, dC (over Di) and da (over B
and T) from per-block partials in one launch, in a fixed order, with no
atomics, so two runs on the same inputs agree bitwise.  N > 16 runs in
groups of 16 states, whose dx and ddt partials that launch adds as well.
:func:`kernels.ref.s6_scan_bwd_chunked_ref` writes the same algebra out in
PyTorch.

A CPU tensor runs the plain version
(:func:`repro_torch.kernels.ref.s6_scan_bwd_ref`); a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import s6_scan_bwd_ref
from .s6_scan import CHECKPOINT_STRIDE, _check

#: launches of the backward kernel (one per :func:`s6_scan_bwd` call on the
#: card, whatever the number of CUDA kernels it runs)
LAUNCHES = 0
#: steps per sub-chunk (csrc/s6_scan_bwd.cu SC): the forward's checkpoint
#: stride
SUB_CHUNK = CHECKPOINT_STRIDE
#: channels per block, states per group and resident blocks per SM of the
#: chunk pass (csrc/s6_scan_bwd.cu CB, NG and CHUNK_BLOCKS)
_CB, _NG, _CHUNK_BLOCKS = 128, 16, 3
#: the kernels of one call, in launch order
KERNEL_NAMES = ("local", "chain", "chunk", "reduce")


def groups(n: int) -> int:
    """State groups of the chunk pass: one for N <= 16, else ceil(N / 16)."""
    return 1 if n <= _NG else -(-n // _NG)


def chunk_len(bsz: int, t: int, di: int, n: int, n_sms: int) -> int:
    """Steps per chunk of the backward, a multiple of :data:`SUB_CHUNK`: as
    long as two waves of the chunk pass's resident blocks allow, so that its
    blocks fill the card with as little of a last wave as the shape gives
    (at (2, 2048, 8192, 16) on 132 SMs: 6 chunks of 344 steps, 768 blocks
    against 396 resident)."""
    per_chunk = -(-di // _CB) * bsz * groups(n)
    k = max(1, min(-(-t // SUB_CHUNK),
                   2 * n_sms * _CHUNK_BLOCKS // per_chunk))
    steps = -(-t // k)
    return -(-steps // SUB_CHUNK) * SUB_CHUNK


def _bwd_sizes(bsz: int, t: int, di: int, n: int, lb: int) -> dict:
    """Element counts of the backward's buffers at chunks of ``lb`` steps
    (each must fit an int, the kernel's indices being 32-bit)."""
    k = -(-t // lb)
    g = groups(n)
    return {"x": bsz * t * di, "checkpoints": -(-t // SUB_CHUNK) * bsz * n * di,
            "carries": k * bsz * n * di, "partials_bc": -(-di // _CB) * bsz * t * n,
            "partials_a": k * bsz * di * n,
            "partials_x": g * bsz * t * di if g > 1 else 0}


def s6_scan_bwd(x: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor,
                cmat: torch.Tensor, a: torch.Tensor, h0: torch.Tensor | None,
                dy: torch.Tensor, dh_final: torch.Tensor | None = None, *,
                states: torch.Tensor | None = None, stride: int | None = None
                ) -> tuple[torch.Tensor, ...]:
    """Gradients (dx, ddt, dB, dC, da, dh0) of the scan from dy (B, T, Di)
    and dh_final (B, Di, N) or None: dx in x's dtype, dB and dC in bmat's,
    the rest fp32.  On the card it needs the forward's checkpoints
    (``states``, ``stride``: :func:`.s6_scan.forward_with_states`) and
    launches ``csrc/s6_scan_bwd.cu``; on CPU tensors (and on ``meta``, the
    dry run's abstract trace) it runs the plain
    :func:`~repro_torch.kernels.ref.s6_scan_bwd_ref` from h0."""
    kind = _check(x, dt, bmat, cmat, a, h0)
    if kind in ("cpu", "meta"):
        return s6_scan_bwd_ref(x, dt, bmat, cmat, a, h0, dy, dh_final)
    bsz, t, di = x.shape
    n = a.shape[1]
    if states is None or stride != SUB_CHUNK:
        raise ValueError(f"s6_scan_bwd: the forward's checkpoints every "
                         f"{SUB_CHUNK} steps are needed on the card, got "
                         f"stride {stride}")
    want = (-(-t // SUB_CHUNK), bsz, n, di)
    if (tuple(states.shape) != want or states.dtype != torch.float32
            or not states.is_contiguous() or states.device != x.device):
        raise ValueError(f"s6_scan_bwd: states must be contiguous fp32 "
                         f"{want} on {x.device}")
    for name, v, shape in (("dy", dy, (bsz, t, di)),
                           ("dh_final", dh_final, (bsz, di, n))):
        if v is not None and (tuple(v.shape) != shape or v.device != x.device):
            raise ValueError(f"s6_scan_bwd: {name} must be {shape} on "
                             f"{x.device}, got {tuple(v.shape)} on {v.device}")
    dev = x.device
    lb = chunk_len(bsz, t, di, n, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    sizes = _bwd_sizes(bsz, t, di, n, lb)
    reach = {"bmat": (bsz - 1) * bmat.stride(0) + (t - 1) * bmat.stride(1) + n,
             "cmat": (bsz - 1) * cmat.stride(0) + (t - 1) * cmat.stride(1) + n}
    big = {k_: v for k_, v in {**sizes, **reach}.items() if v > _build._INT_MAX}
    if big:
        raise ValueError(f"s6_scan_bwd: the kernel indexes in 32 bits; these "
                         f"buffers reach 2**31 elements: {big}")
    k = -(-t // lb)
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
        gl = torch.empty(sizes["carries"], **f32)
        ssum = torch.empty(k * bsz * di, **f32)
        pb = torch.empty(sizes["partials_bc"], **f32)
        pc = torch.empty(sizes["partials_bc"], **f32)
        pa = torch.empty(sizes["partials_a"], **f32)
        px = pdt = None
        if sizes["partials_x"]:
            px = torch.empty(sizes["partials_x"], **f32)
            pdt = torch.empty(sizes["partials_x"], **f32)
        lib = _build.load("s6_scan_bwd")
        err = lib.atucker_s6_scan_bwd(
            x.data_ptr(), dt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
            a.data_ptr(), states.data_ptr(), dy.data_ptr(),
            None if dhf is None else dhf.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), db.data_ptr(), dc.data_ptr(), da.data_ptr(),
            dh0.data_ptr(), gl.data_ptr(), ssum.data_ptr(), pb.data_ptr(),
            pc.data_ptr(), pa.data_ptr(), None if px is None else px.data_ptr(),
            None if pdt is None else pdt.data_ptr(), bsz, t, di, n, lb,
            bmat.stride(0), bmat.stride(1), cmat.stride(0), cmat.stride(1),
            _build.dtype_code(x), _build.stream_ptr(dev))
        _build.check(lib, err, "s6_scan_bwd")
    global LAUNCHES
    LAUNCHES += 1
    return dx, ddt, db, dc, da, dh0


def launch_info(bsz: int, t: int, di: int, n: int, dtype: torch.dtype
                ) -> list[dict]:
    """For each of the backward's four CUDA kernels (:data:`KERNEL_NAMES`)
    at this shape: registers per thread, local memory per thread (spills
    and stack), shared memory per block, threads, resident blocks and warps
    per SM, grid blocks and waves (card only)."""
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    lb = chunk_len(bsz, t, di, n, sms)
    lib = _build.load("s6_scan_bwd")
    out = (ctypes.c_int * 24)()
    _build.check(lib, lib.atucker_s6_scan_bwd_info(
        bsz, t, di, n, lb, _build.DTYPE_CODES[str(dtype)[6:]],
        ctypes.addressof(out)), "atucker_s6_scan_bwd_info")
    rows = []
    for name, i in zip(KERNEL_NAMES, range(0, 24, 6)):
        regs, threads, per_sm, blocks, local, smem = out[i:i + 6]
        rows.append(dict(kernel=name, registers=regs, local_bytes=local,
                         smem_bytes=smem, threads=threads,
                         blocks_per_sm=per_sm,
                         warps_per_sm=per_sm * threads // 32,
                         grid_blocks=blocks, chunk_len=lb,
                         waves=blocks / (sms * per_sm) if per_sm else None))
    return rows
