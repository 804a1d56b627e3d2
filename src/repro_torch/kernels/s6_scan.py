"""Mamba-1 selective scan (S6) forward for Hopper, with state carry.

Computes, from the state ``h0`` (zeros when None),

    h_t = exp(dt_t * a) ⊙ h_{t-1} + (dt_t * x_t) ⊗ B_t,    y_t = h_t · C_t

and returns ``(y, h_final)``.  It replaces
``repro/kernels/s6_scan.py::s6_scan_fwd`` and adds the initial and final
state that serving needs: prefill starts from the cached state and hands its
final state to decode, and each decode step is this kernel at T = 1.  The
CUDA source is ``csrc/s6_scan.cu``.  What bounds it on the H100: the
T·Di·N exponentials on the SFU and the bytes of x, dt and y, about equal at
the longest prefill.  It has two routes, chosen by :func:`route` from
B·T·Di alone, so the prefill and the decode of one run always take the
same route for the same shape:

- ``"single"``: one launch that walks T inside each block, each channel's
  N states in the registers of 4 lanes.  Decode (T = 1) and short prompts
  take it: a launch costs the host-bound decode step ~27 µs.
- ``"chunked"``: three launches, parallel over chunks of
  :func:`chunk_len` steps (scan each chunk from zero; chain the chunks'
  states; rescan each chunk from its entry state), with scratch of
  (K, B, Di, N + 1) fp32 for K chunks.  Long prefills take it.

See the source for both designs.

Layouts are the reference's: x, dt (B, T, Di); bmat, cmat (B, T, N); a
(Di, N); h0 (B, Di, N).  x, bmat and cmat share one dtype (fp32 or bf16);
dt, a and h0 are fp32; y and h_final are fp32.  bmat and cmat need only a
contiguous last axis (the model passes column slices of its projection);
everything else must be contiguous on the card.

A CPU tensor runs the plain version
(:func:`repro_torch.kernels.ref.s6_scan_ref`); a CUDA tensor launches the
kernel or raises.

Under autograd (grad enabled and an input that requires grad) the scan is
:class:`S6Scan`: its forward is the kernel above, keeping the state entering
every :data:`CHECKPOINT_STRIDE`-th step (both routes write these
checkpoints as they walk), and its backward is the hand-written
``csrc/s6_scan_bwd.cu`` (:mod:`.s6_scan_bwd`), which recomputes the states
in between.  On CPU tensors the backward is the
plain :func:`repro_torch.kernels.ref.s6_scan_bwd_ref`.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .ref import s6_scan_chunked_ref, s6_scan_ref

#: launches of the CUDA kernel (one per wrapper call on the card, whatever
#: the number of CUDA kernels the route runs)
LAUNCHES = 0
#: steps between the states both routes keep for the backward: its
#: sub-chunk (csrc/s6_scan.cu and csrc/s6_scan_bwd.cu SC)
CHECKPOINT_STRIDE = 8
#: the kernel keeps at most 16 states per lane, 4 lanes per channel
MAX_STATE = 64
#: the chunked route runs from this B·T·Di on.  At (1, T, 8192, 16) on the
#: H100 its kernels overtake the single pass at T ≈ 256 and the whole call,
#: with its two extra launches, at T ≈ 384 (chip_smoke.py's route sweep)
CHUNKED_MIN_WORK = 384 * 8192
ROUTES = ("single", "chunked")
#: shortest and longest chunk of the chunked route (steps)
CHUNK_MIN, CHUNK_MAX = 64, 512
#: channels per block and resident blocks per SM of its scan phases
#: (csrc/s6_scan.cu CT and MIN_BLOCKS)
_CT, _BLOCKS_PER_SM = 128, 8


def route(bsz: int, t: int, di: int) -> str:
    """The route of a scan of x (bsz, t, di): a pure function of the shape."""
    return "chunked" if bsz * t * di >= CHUNKED_MIN_WORK else "single"


def chunk_len(bsz: int, t: int, di: int, n_sms: int) -> int:
    """Steps per chunk of the chunked route: the shortest power of two in
    [CHUNK_MIN, CHUNK_MAX] whose chunks need no more blocks than the card
    holds at once, so each scan phase runs about one wave of long chunks
    (at (1, T, 8192, 16): 64 steps up to T = 1056, 512 at T = 8191)."""
    blocks_per_chunk = bsz * -(-di // _CT)
    want = -(-t * blocks_per_chunk // (_BLOCKS_PER_SM * n_sms))
    lc = CHUNK_MIN
    while lc < want and lc < CHUNK_MAX:
        lc *= 2
    return lc


def _check(x, dt, bmat, cmat, a, h0) -> str:
    """Validate the operands before any pointer reaches C; returns the
    device type ("cpu" or "cuda")."""
    named = {"x": x, "dt": dt, "bmat": bmat, "cmat": cmat, "a": a}
    if h0 is not None:
        named["h0"] = h0
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"s6_scan: {name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
    if x.ndim != 3:
        raise ValueError(f"s6_scan: x must be (B, T, Di), got {tuple(x.shape)}")
    bsz, t, di = x.shape
    n = bmat.shape[-1] if bmat.ndim == 3 else -1
    want = {"x": (bsz, t, di), "dt": (bsz, t, di), "bmat": (bsz, t, n),
            "cmat": (bsz, t, n), "a": (di, n), "h0": (bsz, di, n)}
    for name, tensor in named.items():
        if tuple(tensor.shape) != want[name]:
            raise ValueError(f"s6_scan: {name} has shape {tuple(tensor.shape)}"
                             f", expected {want[name]} (B, T, Di, N = "
                             f"{bsz}, {t}, {di}, {n})")
    if x.numel() == 0 or n <= 0 or any(s > _build._INT_MAX for s in x.shape):
        raise ValueError(f"s6_scan: empty operand or an extent beyond 2**31 - 1"
                         f" (x {tuple(x.shape)}, N = {n})")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"s6_scan: x has dtype {x.dtype}; the kernel takes "
                        "float32 or bfloat16")
    for name in ("bmat", "cmat"):
        if named[name].dtype != x.dtype:
            raise TypeError(f"s6_scan: {name} has dtype {named[name].dtype}, "
                            f"x has {x.dtype}; they must agree")
    for name in ("dt", "a", "h0"):
        if name in named and named[name].dtype != torch.float32:
            raise TypeError(f"s6_scan: {name} must be float32, got "
                            f"{named[name].dtype}")
    for name, tensor in named.items():
        if tensor.device != x.device:
            raise ValueError(f"s6_scan: {name} is on {tensor.device}, x on "
                             f"{x.device}")
    kind = x.device.type
    if kind == "cuda":
        if n > MAX_STATE:
            raise ValueError(f"s6_scan: state size N = {n} exceeds the "
                             f"kernel's {MAX_STATE}")
        if bsz > 65535:
            raise ValueError(f"s6_scan: batch {bsz} exceeds the grid's 65535")
        for name, tensor in named.items():
            if name in ("bmat", "cmat"):
                if tensor.stride(2) != 1:
                    raise ValueError(f"s6_scan: {name} must have a contiguous "
                                     "last axis on the card")
            elif not tensor.is_contiguous():
                raise ValueError(f"s6_scan: {name} must be contiguous on the "
                                 "card (the kernel reads it in place)")
    elif kind not in ("cpu", "meta"):
        raise ValueError(f"s6_scan: unsupported device {x.device}")
    return kind


def _plain(x, dt, bmat, cmat, a, h0):
    """The plain version on a CPU tensor; on ``meta`` (the dry run's
    abstract trace, asked for by name) the chunked plain form, whose
    trace is O(√T) steps where the step recurrence's is O(T)."""
    if x.device.type == "cpu":
        return s6_scan_ref(x, dt, bmat, cmat, a, h0)
    chunk = 1 << max(0, math.ceil(math.log2(max(1, x.shape[1])) / 2))
    return s6_scan_chunked_ref(x, dt, bmat, cmat, a, h0, chunk=chunk)


def _forward(x, dt, bmat, cmat, a, h0, force_route, keep_states: bool):
    """The CUDA forward: (y, h_final, states, stride), with ``states``
    (ceil(T / stride), B, N, Di) fp32, the state entering every ``stride``
    = :data:`CHECKPOINT_STRIDE` steps, when ``keep_states`` (else None)."""
    bsz, t, di = x.shape
    n = a.shape[1]
    dev = x.device
    chunked = (force_route or route(bsz, t, di)) == "chunked"
    states, stride = None, None
    with torch.cuda.device(dev):
        if keep_states:
            stride = CHECKPOINT_STRIDE
            states = torch.empty((-(-t // stride), bsz, n, di),
                                 dtype=torch.float32, device=dev)
        ck = None if states is None else states.data_ptr()
        y = torch.empty((bsz, t, di), dtype=torch.float32, device=dev)
        hf = torch.empty((bsz, di, n), dtype=torch.float32, device=dev)
        lib = _build.load("s6_scan")
        ptrs = (x.data_ptr(), dt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
                a.data_ptr(), None if h0 is None else h0.data_ptr(),
                y.data_ptr(), hf.data_ptr())
        tail = (bmat.stride(0), bmat.stride(1), cmat.stride(0),
                cmat.stride(1), _build.dtype_code(x), _build.stream_ptr(dev))
        if chunked:
            lc = chunk_len(bsz, t, di, torch.cuda.get_device_properties(
                dev).multi_processor_count)
            k = -(-t // lc)
            # phase B leaves each chunk's entry state here
            h_loc = torch.empty((k, bsz, di, n), dtype=torch.float32,
                                device=dev)
            ssum = torch.empty((k, bsz, di), dtype=torch.float32, device=dev)
            err = lib.atucker_s6_scan_chunked(
                *ptrs, h_loc.data_ptr(), ssum.data_ptr(), ck, bsz, t, di, n, lc,
                *tail)
        else:
            err = lib.atucker_s6_scan(*ptrs, ck, bsz, t, di, n, *tail)
        _build.check(lib, err, "s6_scan")
    global LAUNCHES
    LAUNCHES += 1
    return y, hf, states, stride


def forward_with_states(x: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor,
                        cmat: torch.Tensor, a: torch.Tensor,
                        h0: torch.Tensor | None = None, *,
                        force_route: str | None = None):
    """The scan on the card keeping what its backward needs: (y, h_final,
    states, stride), ``states`` (ceil(T / stride), B, N, Di) fp32 being the
    state entering every ``stride`` = :data:`CHECKPOINT_STRIDE` steps (card
    only)."""
    if _check(x, dt, bmat, cmat, a, h0) != "cuda":
        raise ValueError("forward_with_states: the operands must be on the "
                         "card (the plain version keeps every state)")
    _check_route(force_route)
    return _forward(x, dt, bmat, cmat, a, h0, force_route, True)


def _check_route(force_route):
    if force_route is not None and force_route not in ROUTES:
        raise ValueError(f"s6_scan: force_route must be one of {ROUTES}, got "
                         f"{force_route!r}")


class S6Scan(torch.autograd.Function):
    """The selective scan under autograd.  Forward: the kernel (or, on CPU
    tensors, its plain version), keeping the checkpoints on the card;
    backward: :func:`.s6_scan_bwd.s6_scan_bwd`.  Under per-layer remat
    (``models/lm.py``) the layer's first forward writes the checkpoints
    too, and the remat's hooks drop them: at the training shape about
    0.08 ms and a 268 MB transient a layer, 0.2% of the step."""

    @staticmethod
    def forward(ctx, x, dt, bmat, cmat, a, h0, force_route):
        if x.device.type in ("cpu", "meta"):
            y, hf = _plain(x, dt, bmat, cmat, a, h0)
            states = stride = None
        else:
            y, hf, states, stride = _forward(x, dt, bmat, cmat, a, h0,
                                             force_route, True)
        ctx.save_for_backward(x, dt, bmat, cmat, a, h0, states)
        ctx.stride = stride
        return y, hf

    @staticmethod
    def backward(ctx, dy, dh_final):
        from .s6_scan_bwd import s6_scan_bwd
        x, dt, bmat, cmat, a, h0, states = ctx.saved_tensors
        dx, ddt, db, dc, da, dh0 = s6_scan_bwd(
            x, dt, bmat, cmat, a, h0, dy, dh_final, states=states,
            stride=ctx.stride)
        return dx, ddt, db, dc, da, (dh0 if h0 is not None else None), None


def s6_scan(x: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor,
            cmat: torch.Tensor, a: torch.Tensor,
            h0: torch.Tensor | None = None, *, force_route: str | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(y (B, T, Di), h_final (B, Di, N)), both fp32: the selective scan of
    x under step sizes dt from state h0 (zeros when None).  On the card
    ``force_route`` ("single" or "chunked") overrides :func:`route`, for
    measurements and tests of both routes at one shape.  With grad enabled
    and an input that requires grad it runs as :class:`S6Scan`, whose
    gradient comes from the backward kernel."""
    kind = _check(x, dt, bmat, cmat, a, h0)
    _check_route(force_route)
    if torch.is_grad_enabled() and any(
            v is not None and v.requires_grad
            for v in (x, dt, bmat, cmat, a, h0)):
        return S6Scan.apply(x, dt, bmat, cmat, a, h0, force_route)
    if kind in ("cpu", "meta"):
        return _plain(x, dt, bmat, cmat, a, h0)
    y, hf, _, _ = _forward(x, dt, bmat, cmat, a, h0, force_route, False)
    return y, hf


def launch_info(bsz: int, t: int, di: int, n: int, dtype: torch.dtype,
                force_route: str | None = None) -> list[dict]:
    """Registers per thread, threads, resident blocks per SM and grid blocks
    of each CUDA kernel that a call of this shape runs (card only)."""
    chunked = (force_route or route(bsz, t, di)) == "chunked"
    lc = chunk_len(bsz, t, di, torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count)
    return _build.launch_info("s6_scan", "atucker_s6_scan_info", bsz, t, di,
                              n, lc, int(chunked),
                              _build.DTYPE_CODES[str(dtype)[6:]])
