"""Matricization-free TTT / Gram kernel (a-Tucker Sec. V) for Hopper.

Computes  z[i, r] = Σ_{a,b}  x[a, i, b] · y[a, r, b]  on (A, ·, B) views —
the mode-(I,J) tensor-times-tensor product contracting every mode except the
target one.  Gram (S = Y_(n) Y_(n)^T) is the special case y ≡ x.

Replaces ``repro/kernels/ttt.py::ttt_pallas3``; the CUDA source is
``csrc/ttt.cu``.  What bounds it on the H100: the bytes of x when R is
skinny (the ALS TTT, R = 10 against I = 7000 and a 76,800-deep reduction:
the ``cols`` and ``tile16`` routes, FFMA, the latter on ``csrc/contract.cuh``
shared with the boundary GEMM), arithmetic for the Gram of a wide mode
(I = R = 1340).  Every R > 16 runs on the tensor cores (``wgmma_tma``, or
``wgmma_plain`` for shapes TMA cannot take): fp32 operands split into two
TF32 halves and three products (fp32-class accuracy), bf16 one product,
on output tiles of 128 rows of x by :func:`tile_r` columns of y (fitted
to R: 32, 64 or 128).  A TTT with B = 1 (the last mode's ALS TTT) takes
``wgmma_cols``: zᵀ = yᵀ·x on the wide GEMM of ``csrc/wgmma.cuh``, x's
MN-major tiles by TMA, y split once into a K-major image.  The long A·B
reduction is split across blocks so that every SM has work; a second small
kernel finishes the partial sums (deterministic — no atomics) and mirrors
the upper tiles of a Gram.  x is read in place (no padding, any A ≥ 1 and
B ≥ 1, ragged edges masked or zero-filled).  :func:`route` mirrors the C
code's choice, :func:`split_plan` its tiling and :func:`workspace_bytes`
the workspace it needs beside z.

A CPU tensor runs the plain version (:func:`repro_torch.kernels.ref.ttt_ref`);
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from . import _build
# the wide GEMM's output chunk and stage depth, which wgmma_cols runs on
from .matmul import CHUNK, WIDE_TK as COLS_TK, image_rows
from .ref import ttt_ref

#: launches of the CUDA kernel (one per wrapper call on the card)
LAUNCHES = 0
#: the same launches by route and symmetry, keyed "<route>/gram" (y is x)
#: or "<route>/ttt", e.g. "wgmma_tma/ttt" for a wide TTT with y ≠ x
ROUTE_LAUNCHES: dict[str, int] = {}


#: the routes of csrc/ttt.cu, by the code its report function gives
ROUTES = ("cols", "tile16", "wgmma_tma", "wgmma_plain", "wgmma_cols")
#: elements of k per stage of the wide routes: 128 bytes of a row
WIDE_TK = {"float32": 32, "bfloat16": 64}


def route(r: int, b: int, dtype: str = "float32", aligned: bool = True,
          sym: bool = False) -> str:
    """The route csrc/ttt.cu takes for an (I x R) output of views with inner
    extent B (``sym``: a Gram, y is x): ``cols`` (B == 1, R <= 16),
    ``tile16`` (other R <= 16), and for R > 16 the tensor-core routes --
    ``wgmma_cols`` for a TTT with B == 1, else ``wgmma_tma`` when a row of
    B elements is a 16-byte multiple of at least 128 bytes and both
    operands are 16-byte aligned, else ``wgmma_plain``."""
    if r <= 16:
        return "cols" if b == 1 else "tile16"
    if b == 1 and not sym:
        return "wgmma_cols"
    row = b * (4 if dtype == "float32" else 2)
    return "wgmma_tma" if row % 16 == 0 and row >= 128 and aligned \
        else "wgmma_plain"


def tile_r(r: int, sym: bool) -> int:
    """Columns of y in an output tile of the wgmma_tma/wgmma_plain routes
    (csrc/ttt.cu tile_r): 128 for a Gram's square tiles, else R fitted to
    the wgmma widths 32, 64 or 128."""
    return 128 if sym or r > 64 else 64 if r > 32 else 32


def _cols_tile(r: int) -> int:
    """Columns of x a tile of the wgmma_cols route covers: 128, or 64 when
    the two consumer warpgroups split a chunk of more than 64 outputs."""
    return 128 if min(r, CHUNK) <= 64 else 64


def _path(i: int, r: int, a: int, b: int, sym: bool, rt: str,
          dtype: str) -> tuple[int, int, int, int]:
    """(output tiles, TK, blocks wanted per SM, stages of TK over the whole
    reduction) of route ``rt``.  The TMA route walks (a, 128-byte b-run)
    boxes, so its reduction is A·ceil(B/TK)·TK with the runs' tails padded;
    the others walk the flat k = a·B + b.  wgmma_cols counts the tiles of
    one chunk of 128 outputs (a pass of its persistent grid)."""
    if rt == "cols":                     # column per thread, 128 columns
        return math.ceil(i / 128), 64, 8, math.ceil(a * b / 64)
    if rt == "tile16":                   # 128 x 16 FFMA tiles
        return math.ceil(i / 128) * math.ceil(r / 16), 32, 4, \
            math.ceil(a * b / 32)
    if rt == "wgmma_cols":
        return math.ceil(i / _cols_tile(r)), COLS_TK, 1, \
            math.ceil(a * b / COLS_TK)
    n = math.ceil(i / 128)               # 128 x TR tiles, upper half if sym
    tiles = n * (n + 1) // 2 if sym else n * math.ceil(r / tile_r(r, sym))
    tk = WIDE_TK[dtype]
    n_k = a * math.ceil(b / tk) if rt == "wgmma_tma" else math.ceil(a * b / tk)
    return tiles, tk, 1, n_k


def split_plan(i: int, r: int, k: int, b: int, sym: bool, n_sms: int,
               dtype: str = "float32", aligned: bool = True
               ) -> tuple[int, int]:
    """(splits, k_per_split) of the reduction over k = A·B, each split at
    least eight TK-deep stages long, the splits covering the route's
    stages.  Grid routes: enough blocks to fill every SM (one wave of the
    wide routes).  wgmma_cols runs one persistent block an SM over the
    splits' tiles: the fewest splits (at most 64) whose busiest block runs
    within 5% of the fewest stages any split count gives (each split adds
    I × R partial sums to write and add)."""
    rt = route(r, b, dtype, aligned, sym)
    tiles, tk, per_sm, n_k = _path(i, r, k // b, b, sym, rt, dtype)
    if rt == "wgmma_cols":
        cost = {s: math.ceil(s * tiles / n_sms) * math.ceil(n_k / s)
                for s in range(1, max(1, min(n_k // 8, 64)) + 1)}
        least = min(cost.values())
        splits = min(s for s, c in cost.items() if c <= 1.05 * least)
    else:
        want = max(1, math.ceil(per_sm * n_sms / tiles))
        splits = max(1, min(want, n_k // 8, 65535))
    per = math.ceil(n_k / splits)
    return math.ceil(n_k / per), per * tk


def workspace_bytes(a: int, i: int, r: int, b: int, sym: bool, n_sms: int,
                    dtype: str = "float32", aligned: bool = True) -> int:
    """Bytes that :func:`ttt3` allocates beyond z for a call on an (A, I, B)
    x and an (A, R, B) y (``sym``: y is x): the split-K workspace of
    splits × I × R fp32 partial sums when the reduction is split
    (:func:`split_plan`) or the Gram is mirrored (R > 16), else 0; on
    wgmma_cols also y's pre-split image.  ``ttt3`` allocates exactly this,
    so the plan's memory model (``core/plan.py``) and the allocation cannot
    drift apart."""
    splits, per = split_plan(i, r, a * b, b, sym, n_sms, dtype, aligned)
    return _workspace(splits, i, r, sym, route(r, b, dtype, aligned, sym),
                      per, dtype)


def _workspace(splits: int, i: int, r: int, sym: bool, rt: str,
               k_per_split: int, dtype: str) -> int:
    """The workspace bytes of a call split ``splits`` ways: csrc/ttt.cu
    writes partial sums there and finishes them into z when the reduction
    is split or the Gram is mirrored (R > 16).  wgmma_cols keeps y's image
    after them (256-byte aligned; csrc/ttt.cu image_offset): every split's
    stages of (hi, lo) fp32 tiles (one tile for bf16) of the first chunk's
    image rows × 128 bytes."""
    mirror = sym and r > 16
    part = splits * i * r * 4 if splits > 1 or mirror else 0
    if rt != "wgmma_cols":
        return part
    planes = 2 if dtype == "float32" else 1
    image = splits * (k_per_split // COLS_TK) * planes * \
        image_rows(min(r, CHUNK)) * 128
    return -(-part // 256) * 256 + image


def _dtype_aligned(x3: torch.Tensor, y3: torch.Tensor) -> tuple[str, bool]:
    """The operands' dtype name, and whether both are 16-byte aligned."""
    return (str(x3.dtype).replace("torch.", ""),
            x3.data_ptr() % 16 == 0 and y3.data_ptr() % 16 == 0)


def _plan(x3: torch.Tensor, y3: torch.Tensor):
    """(A, I, R, B, sym, splits, k_per_split) of a call."""
    a, i, b = x3.shape
    r = y3.shape[1]
    sym = _sym(x3, y3)
    n_sms = torch.cuda.get_device_properties(x3.device).multi_processor_count
    splits, k_per_split = split_plan(i, r, a * b, b, sym, n_sms,
                                     *_dtype_aligned(x3, y3))
    return a, i, r, b, sym, splits, k_per_split


def _sym(x3: torch.Tensor, y3: torch.Tensor) -> bool:
    """Whether ``ttt3(x3, y3)`` is a Gram: y is x."""
    return x3.data_ptr() == y3.data_ptr() and x3.shape[1] == y3.shape[1]


def call_route(x3: torch.Tensor, y3: torch.Tensor) -> str:
    """The route ``ttt3(x3, y3)`` takes on the card."""
    return route(y3.shape[1], x3.shape[2], *_dtype_aligned(x3, y3),
                 _sym(x3, y3))


def ttt3(x3: torch.Tensor, y3: torch.Tensor,
         out: torch.Tensor | None = None) -> torch.Tensor:
    """z (I, R) = einsum('aib,arb->ir', x3, y3), fp32.  Pass ``y3 is x3``
    for the Gram.  ``out``, a contiguous fp32 (I, R) tensor on x3's device,
    receives z (the sharded solvers' partial sums land in the buffer their
    all-reduce sends)."""
    kind = _build.check_operands("ttt", {"x3": 3, "y3": 3}, x3, y3)
    a, i, b = x3.shape
    a2, r, b2 = y3.shape
    if (a, b) != (a2, b2):
        raise ValueError(f"ttt: views {tuple(x3.shape)} and {tuple(y3.shape)} "
                         "differ outside the contracted axis")
    if out is not None and (out.shape != (x3.shape[1], y3.shape[1])
                            or out.dtype != torch.float32
                            or out.device != x3.device
                            or not out.is_contiguous()):
        raise ValueError(f"ttt: out must be a contiguous float32 "
                         f"{(x3.shape[1], y3.shape[1])} tensor on "
                         f"{x3.device}")
    if kind == "cpu":
        z = ttt_ref(x3, y3)
        return z if out is None else out.copy_(z)
    _build.refuse_grad("ttt", x3, y3)
    dev = x3.device
    with torch.cuda.device(dev):
        a, i, r, b, sym, splits, k_per_split = _plan(x3, y3)
        z = torch.empty((i, r), dtype=torch.float32, device=dev) \
            if out is None else out
        dt, aligned = _dtype_aligned(x3, y3)
        n_ws = _workspace(splits, i, r, sym, route(r, b, dt, aligned, sym),
                          k_per_split, dt) // 4
        ws = torch.empty(n_ws, dtype=torch.float32, device=dev) if n_ws else z
        lib = _build.load("ttt")
        err = lib.atucker_ttt(x3.data_ptr(), y3.data_ptr(), ws.data_ptr(),
                              z.data_ptr(), a, i, r, b, _build.dtype_code(x3),
                              splits, k_per_split, int(sym),
                              _build.stream_ptr(dev))
        _build.check(lib, err, "ttt")
    global LAUNCHES
    LAUNCHES += 1
    key = f"{call_route(x3, y3)}/{'gram' if sym else 'ttt'}"
    ROUTE_LAUNCHES[key] = ROUTE_LAUNCHES.get(key, 0) + 1
    return z


def launch_info(x3: torch.Tensor, y3: torch.Tensor) -> list[dict]:
    """Registers per thread, threads, resident blocks per SM, grid blocks
    and waves of each CUDA kernel that ``ttt3(x3, y3)`` runs: the
    contraction (on wgmma_cols the wide GEMM, then the kernel that splits
    y), then the finish kernel where it runs (card only).  The first row
    also carries the route, its dynamic shared memory and the tiling; the
    route is the C library's own report, checked against :func:`route`."""
    a, i, r, b, sym, splits, k_per_split = _plan(x3, y3)
    rows, extra = _build.report("ttt", "atucker_ttt_info", x3.data_ptr(),
                                y3.data_ptr(), a, i, r, b,
                                _build.dtype_code(x3), splits, k_per_split,
                                int(sym))
    rt = ROUTES[extra[1]]
    if rt != call_route(x3, y3):
        raise RuntimeError(f"ttt: csrc/ttt.cu takes route {rt}, kernels/ttt.py "
                           f"mirrors {call_route(x3, y3)}")
    rows[0].update(route=rt, smem_bytes=extra[0], splits=splits,
                   k_per_split=k_per_split)
    if rt in ("wgmma_tma", "wgmma_plain"):
        rows[0]["tile"] = [128, tile_r(r, sym)]
    elif rt == "wgmma_cols":
        rows[0].update(tile=[_cols_tile(r), min(r, CHUNK)],
                       loads="tma" if extra[2] & 1 else "plain")
    return rows
