"""Mamba-1 selective scan (S6) forward for Hopper, with state carry.

Computes, from the state ``h0`` (zeros when None),

    h_t = exp(dt_t * a) ⊙ h_{t-1} + (dt_t * x_t) ⊗ B_t,    y_t = h_t · C_t

and returns ``(y, h_final)``.  It replaces
``repro/kernels/s6_scan.py::s6_scan_fwd`` and adds the initial and final
state that serving needs: prefill starts from the cached state and hands its
final state to decode, and each decode step is this kernel at T = 1.  The
CUDA source is ``csrc/s6_scan.cu``.  What bounds it on the H100: the
T·Di·N exponentials on the SFU and the bytes of x, dt and y, about equal at
the longest prefill.  The design keeps each channel's N states in the
registers of 4 lanes, walks T inside the block, and stages chunks of x, dt,
B and C in shared memory (see the source).

Layouts are the reference's: x, dt (B, T, Di); bmat, cmat (B, T, N); a
(Di, N); h0 (B, Di, N).  x, bmat and cmat share one dtype (fp32 or bf16);
dt, a and h0 are fp32; y and h_final are fp32.  bmat and cmat need only a
contiguous last axis (the model passes column slices of its projection);
everything else must be contiguous on the card.

A CPU tensor runs the plain version
(:func:`repro_torch.kernels.ref.s6_scan_ref`); a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import s6_scan_ref

#: launches of the CUDA kernel (one per wrapper call on the card)
LAUNCHES = 0
#: the kernel keeps at most 16 states per lane, 4 lanes per channel
MAX_STATE = 64


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
    elif kind != "cpu":
        raise ValueError(f"s6_scan: unsupported device {x.device}")
    return kind


def s6_scan(x: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor,
            cmat: torch.Tensor, a: torch.Tensor,
            h0: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(y (B, T, Di), h_final (B, Di, N)), both fp32: the selective scan of
    x under step sizes dt from state h0 (zeros when None)."""
    kind = _check(x, dt, bmat, cmat, a, h0)
    if kind == "cpu":
        return s6_scan_ref(x, dt, bmat, cmat, a, h0)
    bsz, t, di = x.shape
    n = a.shape[1]
    dev = x.device
    with torch.cuda.device(dev):
        y = torch.empty((bsz, t, di), dtype=torch.float32, device=dev)
        hf = torch.empty((bsz, di, n), dtype=torch.float32, device=dev)
        lib = _build.load("s6_scan")
        err = lib.atucker_s6_scan(
            x.data_ptr(), dt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
            a.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), hf.data_ptr(), bsz, t, di, n,
            bmat.stride(0), bmat.stride(1), cmat.stride(0), cmat.stride(1),
            _build.dtype_code(x), _build.stream_ptr(dev))
        _build.check(lib, err, "s6_scan")
    global LAUNCHES
    LAUNCHES += 1
    return y, hf
