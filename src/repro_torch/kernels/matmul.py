"""Boundary-mode TTM GEMM for Hopper: C (M, N) = A (M, K) @ B (K, N), fp32 out.

Used for the first-mode / last-mode TTM of the matricization-free st-HOSVD
(paper Fig. 4: the boundary modes collapse to a single GEMM).

Replaces ``repro/kernels/matmul.py::matmul``; the CUDA source is
``csrc/matmul.cu`` (its tile kernel is ``csrc/contract.cuh``, shared with
the TTT).  What bounds it on the H100: the bytes of the tensor operand —
the output is skinny (R ≤ a few dozen) while x is large (537.6 M elements
for a (320, 240, 7000) tensor).  The design streams x through memory once:
each block holds all R outputs of its row strip (last mode) or column strip
(first mode) instead of padding R to a 128-wide tile as the TPU kernel's
wrapper does, and issues the next tile's loads before it consumes the
current one.  Ragged edges are masked; nothing is padded.

A CPU tensor runs the plain version (:func:`repro_torch.kernels.ref.matmul_ref`);
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import matmul_ref

#: launches of the CUDA kernel (one per wrapper call on the card)
LAUNCHES = 0


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N) with fp32 accumulation; both contiguous on the card."""
    kind = _build.check_operands("matmul", {"a": 2, "b": 2}, a, b)
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"matmul: inner dims differ: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if kind == "cpu":
        return matmul_ref(a, b)
    dev = a.device
    with torch.cuda.device(dev):
        c = torch.empty((m, n), dtype=torch.float32, device=dev)
        lib = _build.load("matmul")
        err = lib.atucker_matmul(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                 m, n, k, _build.dtype_code(a),
                                 _build.stream_ptr(dev))
        _build.check(lib, err, "matmul")
    global LAUNCHES
    LAUNCHES += 1
    return c


def launch_info(a: torch.Tensor, b: torch.Tensor) -> list[dict]:
    """Registers per thread, threads, resident blocks per SM and grid blocks
    of the CUDA kernel that ``matmul(a, b)`` runs (card only)."""
    (m, k), n = a.shape, b.shape[1]
    return _build.launch_info("matmul", "atucker_matmul_info", m, n, k,
                              _build.dtype_code(a))
