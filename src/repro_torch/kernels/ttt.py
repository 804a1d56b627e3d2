"""Matricization-free TTT / Gram kernel (a-Tucker Sec. V) for Hopper.

Computes  z[i, r] = Σ_{a,b}  x[a, i, b] · y[a, r, b]  on (A, ·, B) views —
the mode-(I,J) tensor-times-tensor product contracting every mode except the
target one.  Gram (S = Y_(n) Y_(n)^T) is the special case y ≡ x.

Replaces ``repro/kernels/ttt.py::ttt_pallas3``; the CUDA source is
``csrc/ttt.cu`` (its tile kernel is ``csrc/contract.cuh``, shared with the
boundary GEMM).  What bounds it on the H100: the bytes of x when R is
skinny (the ALS TTT, R = 10 against I = 7000 and a 76,800-deep reduction),
fp32 FFMA for the Gram of a wide mode (I = R = 1340).  The design splits
the long A·B reduction across blocks so that every SM has work, finishes the
partial sums in a second small kernel (deterministic — no atomics), reads x
in place (no padding, any A ≥ 1 and B ≥ 1, ragged edges masked), gives the
last mode (B = 1) a column-per-thread path whose loads coalesce along i,
and computes only the upper tiles of a wide Gram.

A CPU tensor runs the plain version (:func:`repro_torch.kernels.ref.ttt_ref`);
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .ref import ttt_ref

#: launches of the CUDA kernel (one per wrapper call on the card)
LAUNCHES = 0


def _path(i: int, r: int, b: int, sym: bool) -> tuple[int, int, int]:
    """(output tiles, TK, blocks wanted per SM) of the path csrc/ttt.cu
    takes for an (I x R) output of a view with inner extent B."""
    if b == 1 and r <= 16:               # column per thread, 128 columns
        return math.ceil(i / 128), 64, 8
    if r <= 16:                          # 128 x 16 tiles
        return math.ceil(i / 128) * math.ceil(r / 16), 32, 4
    n = math.ceil(i / 128)               # 128 x 128 tiles, upper half if sym
    return (n * (n + 1) // 2 if sym else n * math.ceil(r / 128)), 16, 4


def split_plan(i: int, r: int, k: int, b: int, sym: bool,
               n_sms: int) -> tuple[int, int]:
    """(splits, k_per_split) of the reduction over k = A·B: enough blocks
    to fill every SM, each split at least eight TK-deep tiles long."""
    tiles, tk, per_sm = _path(i, r, b, sym)
    n_k = math.ceil(k / tk)
    want = max(1, math.ceil(per_sm * n_sms / tiles))
    splits = max(1, min(want, n_k // 8, 65535))
    per = math.ceil(n_k / splits)
    return math.ceil(n_k / per), per * tk


def ttt3(x3: torch.Tensor, y3: torch.Tensor) -> torch.Tensor:
    """z (I, R) = einsum('aib,arb->ir', x3, y3), fp32.  Pass ``y3 is x3``
    for the Gram."""
    kind = _build.check_operands("ttt", {"x3": 3, "y3": 3}, x3, y3)
    a, i, b = x3.shape
    a2, r, b2 = y3.shape
    if (a, b) != (a2, b2):
        raise ValueError(f"ttt: views {tuple(x3.shape)} and {tuple(y3.shape)} "
                         "differ outside the contracted axis")
    if kind == "cpu":
        return ttt_ref(x3, y3)
    dev = x3.device
    sym = x3.data_ptr() == y3.data_ptr() and i == r   # a Gram
    with torch.cuda.device(dev):
        n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
        splits, k_per_split = split_plan(i, r, a * b, b, sym, n_sms)
        z = torch.empty((i, r), dtype=torch.float32, device=dev)
        mirror = sym and r > 16     # csrc/ttt.cu finishes mirrored Grams
        ws = torch.empty((splits, i, r), dtype=torch.float32, device=dev) \
            if splits > 1 or mirror else z
        lib = _build.load("ttt")
        err = lib.atucker_ttt(x3.data_ptr(), y3.data_ptr(), ws.data_ptr(),
                              z.data_ptr(), a, i, r, b, _build.dtype_code(x3),
                              splits, k_per_split, int(sym),
                              _build.stream_ptr(dev))
        _build.check(lib, err, "ttt")
    global LAUNCHES
    LAUNCHES += 1
    return z


def launch_info(x3: torch.Tensor, y3: torch.Tensor) -> list[dict]:
    """Registers per thread, threads, resident blocks per SM and grid blocks
    of each CUDA kernel that ``ttt3(x3, y3)`` runs: the contraction, then the
    finish kernel where it runs (card only)."""
    a, i, b = x3.shape
    r = y3.shape[1]
    sym = x3.data_ptr() == y3.data_ptr() and i == r
    n_sms = torch.cuda.get_device_properties(x3.device).multi_processor_count
    splits, k_per_split = split_plan(i, r, a * b, b, sym, n_sms)
    return _build.launch_info("ttt", "atucker_ttt_info", a, i, r, b,
                              _build.dtype_code(x3), splits, k_per_split,
                              int(sym))
