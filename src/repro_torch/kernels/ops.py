"""Public wrappers for the a-Tucker Hopper kernels: mode-n TTM / TTT / Gram.

These are the primitives behind the ``hopper`` ops backend
(:mod:`repro_torch.core.backend`): ``TuckerConfig(impl="hopper")`` — or
``impl="auto"`` on CUDA — routes every TTM/TTT/Gram of a plan's sweep
through this module.

Dispatch mirrors the paper's Fig. 4 structure:
  mode == 0    → single GEMM   u @ X_(0-view)          (matmul kernel)
  mode == N-1  → single GEMM   X_(view) @ uᵀ           (matmul kernel)
  interior     → batched GEMM over merged outer dims   (ttm_interior kernel)

Unlike the TPU wrappers there is no padding anywhere: the kernels take the
free (A, I_n, B) view of x as it is and mask ragged edges themselves.  x
must be contiguous (its views are then free); the small u is made
contiguous here.  Every result is fp32.
"""

from __future__ import annotations

import math

import torch

from .matmul import matmul
from .ttm import ttm_interior
from .ttt import ttt3


def _as3(x: torch.Tensor, mode: int) -> torch.Tensor:
    _contiguous(x)
    a = math.prod(x.shape[:mode]) if mode else 1
    b = math.prod(x.shape[mode + 1:]) if mode < x.ndim - 1 else 1
    return x.view(a, x.shape[mode], b)


def _contiguous(x: torch.Tensor) -> None:
    if not x.is_contiguous():
        raise ValueError("the Hopper ops read x in place and need it "
                         f"contiguous (got strides {x.stride()} for shape "
                         f"{tuple(x.shape)})")


def ttm(x: torch.Tensor, u: torch.Tensor, mode: int) -> torch.Tensor:
    """Mode-n TTM through the Hopper kernels.  u: (R, I_mode).  Returns fp32."""
    r, i = u.shape
    if x.shape[mode] != i:
        raise ValueError(f"ttm: U {tuple(u.shape)} incompatible with mode "
                         f"{mode} of {tuple(x.shape)}")
    _contiguous(x)
    out_shape = tuple(x.shape[:mode]) + (r,) + tuple(x.shape[mode + 1:])
    if mode == 0:
        y = matmul(u.contiguous(), x.view(i, -1))
    elif mode == x.ndim - 1:
        y = matmul(x.view(-1, i), u.t().contiguous())
    else:
        y = ttm_interior(u.contiguous(), _as3(x, mode))
    return y.view(out_shape)


def ttt(x: torch.Tensor, y: torch.Tensor, mode: int,
        out: torch.Tensor | None = None) -> torch.Tensor:
    """z (I_mode, R_mode) = contraction of x, y over all modes but ``mode``
    (into ``out`` when given, as :func:`ttt3` takes it)."""
    return ttt3(_as3(x, mode), _as3(y, mode), out)


def gram(x: torch.Tensor, mode: int,
         out: torch.Tensor | None = None) -> torch.Tensor:
    """S (I_mode, I_mode) = Y_(n) Y_(n)ᵀ without unfolding."""
    x3 = _as3(x, mode)
    return ttt3(x3, x3, out)
