"""Matricization-free dense tensor operations (a-Tucker, Sec. V).

The paper's insight: TTM / TTT / Gram on mode ``n`` never need an explicit
unfold.  Split the loop nest into (outer, along, inner) the target mode and
merge outer/inner — the computation becomes a single GEMM when ``n`` is the
first or last mode and a batched GEMM for interior modes (paper Fig. 4).

In C-order (row-major) PyTorch the *last* axis is contiguous, so the roles of
"first" and "last" are mirrored w.r.t. the paper's column-major layout; the
structure is identical.  A ``reshape`` that only merges adjacent axes of a
contiguous tensor is a free view, so the 3-way view ``(A, I_n, B)`` below
costs nothing; the contraction then runs directly on native storage.  These
are the ``matfree`` backend: ``torch.matmul``/``torch.einsum`` in full fp32
(TF32 stays off, the counterpart of the reference's ``Precision.HIGHEST``).

``*_explicit`` variants materialize the mode-n unfolding first (movedim →
copy → GEMM → fold) and exist as the paper's explicit-matricization baseline
(Fig. 8 benchmark).

The dtype helpers at the bottom keep plan JSON numpy-style (``"float32"``,
``"bfloat16"``) while tensors carry ``torch.dtype``.
"""

from __future__ import annotations

import math

import torch


# ---------------------------------------------------------------------------
# Shape helpers
# ---------------------------------------------------------------------------

def split_dims(shape: tuple[int, ...], mode: int) -> tuple[int, int, int]:
    """Return (A, I_n, B): dims merged before / along / after ``mode``."""
    a = math.prod(shape[:mode]) if mode > 0 else 1
    b = math.prod(shape[mode + 1:]) if mode < len(shape) - 1 else 1
    return a, shape[mode], b


def _as3(x: torch.Tensor, mode: int) -> torch.Tensor:
    """Free (adjacent-merge) reshape to the (A, I_n, B) view."""
    a, i, b = split_dims(tuple(x.shape), mode)
    return x.reshape(a, i, b)


def _accum(x: torch.Tensor) -> torch.dtype:
    """Gram/TTT result dtype: the input's, promoted to at least fp32."""
    return torch.promote_types(x.dtype, torch.float32)


# ---------------------------------------------------------------------------
# Matricization-free ops
# ---------------------------------------------------------------------------

def ttm(x: torch.Tensor, u: torch.Tensor, mode: int) -> torch.Tensor:
    """Mode-``mode`` tensor-times-matrix:  Y = X ×_mode U,  U: (R, I_mode).

    Matricization-free: contracts directly on the (A, I_n, B) view.
    mode == 0      → one GEMM   (R,I) @ (I, B)        -> (R, B)
    mode == N-1    → one GEMM   (A, I) @ (I, R)       -> (A, R)
    interior       → batched GEMM over A: (R,I)@(I,B) -> (A, R, B)
    """
    if u.ndim != 2 or u.shape[1] != x.shape[mode]:
        raise ValueError(f"ttm: U {tuple(u.shape)} incompatible with mode "
                         f"{mode} of {tuple(x.shape)}")
    r = u.shape[0]
    out_shape = tuple(x.shape[:mode]) + (r,) + tuple(x.shape[mode + 1:])
    n = x.ndim
    if mode == 0:
        y = torch.matmul(u, x.reshape(x.shape[0], -1))
    elif mode == n - 1:
        y = torch.matmul(x.reshape(-1, x.shape[-1]), u.T)
    else:
        # batched GEMM over A with u broadcast; no unfold copy
        y = torch.matmul(u, _as3(x, mode))
    return y.reshape(out_shape)


def ttm_chain(x: torch.Tensor, us) -> torch.Tensor:
    """Apply TTMs on several distinct modes (order-independent result)."""
    items = us.items() if isinstance(us, dict) else enumerate(us)
    y = x
    for mode, u in items:
        if u is not None:
            y = ttm(y, u, mode)
    return y


def _contract(x3: torch.Tensor, y3: torch.Tensor,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """z (I, R) = Σ_{a,b} x3[a,i,b] y3[a,r,b], accumulated in ≥ fp32.
    ``out`` (of that dtype) receives z straight from one matmul, as the
    sharded solvers' partial sums land in the buffer their all-reduce
    sends; the operands are laid out (I, A·B) as einsum lays them out."""
    dt = _accum(x3)
    if out is None:
        return torch.einsum("aib,arb->ir", x3.to(dt), y3.to(dt))
    xm = x3.to(dt).transpose(0, 1).reshape(x3.shape[1], -1)
    ym = xm if y3 is x3 else \
        y3.to(dt).transpose(0, 1).reshape(y3.shape[1], -1)
    return torch.mm(xm, ym.T, out=out)


def gram(x: torch.Tensor, mode: int,
         out: torch.Tensor | None = None) -> torch.Tensor:
    """S = Y_(n) Y_(n)^T  (I_n × I_n) without forming Y_(n).

    Special case of TTT with both inputs equal (paper Sec. V).  Contracts the
    merged outer and inner axes directly: einsum 'anb,amb->nm' (into
    ``out`` when given).
    """
    x3 = _as3(x, mode)
    return _contract(x3, x3, out)


def ttt(x: torch.Tensor, y: torch.Tensor, mode: int,
        out: torch.Tensor | None = None) -> torch.Tensor:
    """Mode-(I,J) product contracting every mode except ``mode``.

    x: (I_1..I_n..I_N), y: (I_1..R_n..I_N) with all non-``mode`` dims equal.
    Returns Z (I_n × R_n):  z[i,r] = Σ_other x[..i..] y[..r..].
    """
    if x.ndim != y.ndim:
        raise ValueError("ttt: rank mismatch")
    for m in range(x.ndim):
        if m != mode and x.shape[m] != y.shape[m]:
            raise ValueError(f"ttt: common mode {m} differs: "
                             f"{tuple(x.shape)} vs {tuple(y.shape)}")
    return _contract(_as3(x, mode), _as3(y, mode), out)


# ---------------------------------------------------------------------------
# Explicit-matricization baseline (paper Fig. 3 workflow; used by Fig. 8)
# ---------------------------------------------------------------------------

def unfold(x: torch.Tensor, mode: int) -> torch.Tensor:
    """Mode-n matricization Y_(n) (I_n × J_n).  Materializes a copy."""
    return torch.movedim(x, mode, 0).reshape(x.shape[mode], -1)


def fold(mat: torch.Tensor, mode: int, shape: tuple[int, ...]) -> torch.Tensor:
    """Inverse of :func:`unfold` for a tensor of target ``shape``."""
    shape = tuple(shape)
    full = (shape[mode],) + shape[:mode] + shape[mode + 1:]
    return torch.movedim(mat.reshape(full), 0, mode)


def ttm_explicit(x: torch.Tensor, u: torch.Tensor, mode: int) -> torch.Tensor:
    """TTM via explicit matricization: unfold → GEMM → fold."""
    y2 = torch.matmul(u, unfold(x, mode))
    out_shape = tuple(x.shape[:mode]) + (u.shape[0],) + tuple(x.shape[mode + 1:])
    return fold(y2, mode, out_shape)


def gram_explicit(x: torch.Tensor, mode: int) -> torch.Tensor:
    y2 = unfold(x, mode)
    return torch.matmul(y2, y2.T)


def ttt_explicit(x: torch.Tensor, y: torch.Tensor, mode: int) -> torch.Tensor:
    return torch.matmul(unfold(x, mode), unfold(y, mode).T)


# ---------------------------------------------------------------------------
# Norms / reconstruction
# ---------------------------------------------------------------------------

def fro_norm(x: torch.Tensor) -> torch.Tensor:
    xf = x.reshape(-1)
    return torch.sqrt(torch.dot(xf, xf))


def reconstruct(core: torch.Tensor, factors: list[torch.Tensor]) -> torch.Tensor:
    """X̂ = G ×_1 U^(1) ··· ×_N U^(N).  factors[n]: (I_n, R_n)."""
    y = core
    for mode, u in enumerate(factors):
        y = ttm(y, u, mode)  # u is (I_n, R_n): contracts R_n, expands to I_n
    return y


def rel_error(x: torch.Tensor, core: torch.Tensor,
              factors: list[torch.Tensor]) -> torch.Tensor:
    """‖X − X̂‖_F / ‖X‖_F (paper Table III metric)."""
    return fro_norm(x - reconstruct(core, factors)) / fro_norm(x)


# ---------------------------------------------------------------------------
# dtype names (plan JSON stays numpy-style)
# ---------------------------------------------------------------------------

_TORCH_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
                 "float32": torch.float32, "float64": torch.float64}


def dtype_name(dtype) -> str:
    """Numpy-style name (``"float32"``) of a ``torch.dtype``, numpy dtype or
    name — the form plan JSON and backend capabilities use."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    elif isinstance(dtype, str):
        name = dtype
    else:
        import numpy as np
        name = np.dtype(dtype).name
    if name not in _TORCH_DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}; expected one of "
                         f"{tuple(_TORCH_DTYPES)}")
    return name


def torch_dtype(dtype) -> torch.dtype:
    """The ``torch.dtype`` for a name, numpy dtype or ``torch.dtype``."""
    return _TORCH_DTYPES[dtype_name(dtype)]


def itemsize(dtype) -> int:
    return torch_dtype(dtype).itemsize
