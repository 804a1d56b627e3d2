"""Matricization-free interior-mode TTM for Hopper (a-Tucker Sec. V).

Computes  out[a, r, b] = Σ_i  u[r, i] · x[a, i, b]  on the (A, I_n, B) view
of the tensor — the paper's batched-GEMM organization of mode-n TTM, read
straight from the tensor's native row-major layout (B contiguous), never
unfolded.

Replaces ``repro/kernels/ttm.py::ttm_interior``; the CUDA source is
``csrc/ttm.cu``.  What bounds it on the H100: the bytes of x (R ≤ a few
dozen).  The design is a persistent grid, one block per SM, over equal
tiles of (a, b) columns of the flattened A·B axis (whole values of a when
B ≤ 1024); in each block one producer warp streams x through a
double-buffered shared-memory ring by ``cp.async.bulk`` copies on
``mbarrier``s, and 8 consumer warps keep exactly R outputs per column in
registers, with u in shared memory once per block.  Rows of x that are not
16-byte multiples (B = 1, odd B) take a plain-load path of the same kernel.
One CUDA launch per call; nothing is padded.

A CPU tensor runs the plain version
(:func:`repro_torch.kernels.ref.ttm_interior_ref`); a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import ttm_interior_ref

#: launches of the CUDA kernel (one per wrapper call on the card)
LAUNCHES = 0


def ttm_interior(u: torch.Tensor, x3: torch.Tensor) -> torch.Tensor:
    """out (A, R, B) = einsum('rn,anb->arb', u, x3), fp32."""
    kind = _build.check_operands("ttm_interior", {"u": 2, "x3": 3}, u, x3)
    a, i, b = x3.shape
    r, i2 = u.shape
    if i != i2:
        raise ValueError(f"ttm_interior: u {tuple(u.shape)} does not match "
                         f"the contracted axis of x3 {tuple(x3.shape)}")
    if kind == "cpu":
        return ttm_interior_ref(u, x3)
    dev = x3.device
    with torch.cuda.device(dev):
        out = torch.empty((a, r, b), dtype=torch.float32, device=dev)
        lib = _build.load("ttm")
        err = lib.atucker_ttm_interior(u.data_ptr(), x3.data_ptr(),
                                       out.data_ptr(), a, i, b, r,
                                       _build.dtype_code(x3),
                                       _build.stream_ptr(dev))
        _build.check(lib, err, "ttm_interior")
    global LAUNCHES
    LAUNCHES += 1
    return out


def launch_info(u: torch.Tensor, x3: torch.Tensor) -> list[dict]:
    """Registers per thread, threads, resident blocks per SM and grid blocks
    of the CUDA kernel that ``ttm_interior(u, x3)`` runs (card only)."""
    a, i, b = x3.shape
    return _build.launch_info("ttm", "atucker_ttm_interior_info",
                              x3.data_ptr(), a, i, b, u.shape[0],
                              _build.dtype_code(x3))
