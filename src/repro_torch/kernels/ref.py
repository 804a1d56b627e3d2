"""Plain PyTorch versions of the Hopper kernels (standalone; no kernel imports).

Each one is the function its kernel computes, written naively on purpose:
inputs are cast to fp32 and contracted by one matmul/einsum with TF32 off,
so the result is a full-fp32 accumulation of the same products the kernel
sums, laid out (contiguous) as the kernel writes it.  The wrappers in this
package run them for tensors that lie on the CPU; ``chip_smoke.py`` holds
each kernel against them on the card.
"""

from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float())


def ttm_interior_ref(u: torch.Tensor, x3: torch.Tensor) -> torch.Tensor:
    """out (A, R, B) = einsum('rn,anb->arb')."""
    return torch.einsum("rn,anb->arb", u.float(), x3.float()).contiguous()


def ttt_ref(x3: torch.Tensor, y3: torch.Tensor) -> torch.Tensor:
    """z (I, R) = einsum('aib,arb->ir')."""
    return torch.einsum("aib,arb->ir", x3.float(), y3.float()).contiguous()


def gram_ref(x3: torch.Tensor) -> torch.Tensor:
    return ttt_ref(x3, x3)


def ttm_full_ref(x: torch.Tensor, u: torch.Tensor, mode: int) -> torch.Tensor:
    """Full mode-n TTM via explicit matricization."""
    xm = torch.movedim(x.float(), mode, 0).reshape(x.shape[mode], -1)
    y2 = torch.matmul(u.float(), xm)
    out_shape = (u.shape[0],) + tuple(x.shape[:mode]) + tuple(x.shape[mode + 1:])
    return torch.movedim(y2.reshape(out_shape), 0, mode)


def gram_full_ref(x: torch.Tensor, mode: int) -> torch.Tensor:
    xm = torch.movedim(x.float(), mode, 0).reshape(x.shape[mode], -1)
    return torch.matmul(xm, xm.T)
