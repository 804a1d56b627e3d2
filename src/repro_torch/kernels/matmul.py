"""Boundary-mode TTM GEMM for Hopper: C (M, N) = A (M, K) @ B (K, N), fp32 out.

Used for the first-mode / last-mode TTM of the matricization-free st-HOSVD
(paper Fig. 4: the boundary modes collapse to a single GEMM): u (R, I) @
x (I, J) on the first mode, x (J, I) @ uᵀ (I, R) on the last.

Replaces ``repro/kernels/matmul.py::matmul``; the CUDA source is
``csrc/matmul.cu``.  Two routes, a pure function of (M, N) that
:func:`route` mirrors, with R = min(M, N) the outputs of a column of x:

* ``slab`` -- R ≤ 16.  Bound by the bytes of x.  The FFMA tile kernel of
  ``csrc/contract.cuh`` (shared with the TTT): each block holds all R
  outputs of its 16 × 128 (first mode) or 128 × 16 (last mode) strip of x,
  so x is read once.
* ``wide`` -- R > 16, on either side (:func:`side`: ``first`` when N > M,
  u (R, K) @ x (K, N); ``last`` when N ≤ M, x (M, K) @ uᵀ (K, R)).  One
  pass over x (R ≤ 128; chunks of 128 outputs above) on the tensor cores at
  fp32 accuracy: the wide route of ``csrc/wgmma.cuh`` with a batch of one,
  Cᵀ = xᵀ·uᵀ on ``wgmma`` with x's split-TF32 halves from registers (three
  products; bf16 one), x arriving by TMA (:func:`loads`) -- on the last
  mode K-major, in boxes of 32 k by 128 rows -- hi cut to a grid on which
  each 32-deep stage's hi·hi sums exactly in the tensor cores' truncating
  accumulator, added in fp32 (:func:`repro_torch.kernels.ref.
  matmul_tf32x3_ref` with ``scheme="grid"``).  u is split once a call into
  a pre-split image in a workspace of :func:`workspace_bytes`, which the
  ``hopper`` plans charge to the step's peak (``core/plan.py``).

Ragged edges are masked or zero-filled; nothing is padded in memory.  A CPU
tensor runs the plain version (:func:`repro_torch.kernels.ref.matmul_ref`);
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .ref import matmul_ref

#: launches of the CUDA kernel (one per wrapper call on the card)
LAUNCHES = 0
#: the same launches by route and side: "slab" and "wide" on the first mode
#: (N > M), "slab/last" and "wide/last" on the last (N <= M)
ROUTE_LAUNCHES: dict[str, int] = {}

#: the routes of csrc/matmul.cu, by the code its report function gives
ROUTES = ("slab", "wide")
#: outputs per pass of the wide route, and k rows per stage
CHUNK, WIDE_TK = 128, 32


def route(m: int, n: int) -> str:
    """The route csrc/matmul.cu takes for C (M, N): ``wide`` at R = min(M,
    N) > 16, on the first mode (N > M) and on the last (N <= M), ``slab``
    otherwise.  K, the dtype and the alignment do not change it; alignment
    picks the wide route's loads (:func:`loads`)."""
    return "wide" if min(m, n) > 16 else "slab"


def side(m: int, n: int) -> str:
    """Which operand of C (M, N) = a @ b is the tensor: ``first`` (N > M:
    u (R, K) @ x (K, N)) or ``last`` (N <= M: x (M, K) @ uᵀ (K, R))."""
    return "first" if n > m else "last"


def loads(row: int, dtype: str = "float32", aligned: bool = True) -> str:
    """How the wide route brings x in: ``tma`` when a row of x -- N
    elements of x (K, N) on the first mode, K of x (M, K) on the last -- is
    a 16-byte multiple and x is 16-byte aligned, else ``plain`` (the
    producer warps' own loads into the same layout)."""
    es = 4 if dtype == "float32" else 2
    return "tma" if aligned and row * es % 16 == 0 else "plain"


def image_rows(rows: int) -> int:
    """Rows of u's pre-split image for a chunk of ``rows`` outputs: the
    wgmma width of a consumer warpgroup (32 or 64), or 2 × 64 when the two
    warpgroups split R (rows > 64)."""
    return 32 if rows <= 32 else 64 if rows <= 64 else 2 * 64


def workspace_bytes(m: int, n: int, k: int, dtype: str = "float32") -> int:
    """Bytes that :func:`matmul` allocates beyond C for (M, K) @ (K, N): on
    the wide route u's pre-split image -- ceil(K / 32) stages of (hi, lo)
    fp32 tiles (one tile for bf16) of :func:`image_rows` rows × 128 bytes,
    sized for the first (largest) chunk of 128 of the R = min(M, N)
    outputs -- else 0."""
    if route(m, n) != "wide":
        return 0
    planes = 2 if dtype == "float32" else 1
    return math.ceil(k / WIDE_TK) * planes * \
        image_rows(min(m, n, CHUNK)) * 128


def dtype_name(t: torch.Tensor) -> str:
    """``"float32"`` / ``"bfloat16"`` of a tensor, as the mirrors take it."""
    return str(t.dtype).replace("torch.", "")


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
    _build.refuse_grad("matmul", a, b)
    rt = route(m, n)
    dev = a.device
    with torch.cuda.device(dev):
        c = torch.empty((m, n), dtype=torch.float32, device=dev)
        n_ws = workspace_bytes(m, n, k, dtype_name(a))
        ws = torch.empty(n_ws, dtype=torch.uint8, device=dev) if n_ws else None
        lib = _build.load("matmul")
        err = lib.atucker_matmul(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                 0 if ws is None else ws.data_ptr(),
                                 m, n, k, _build.dtype_code(a),
                                 _build.stream_ptr(dev))
        _build.check(lib, err, "matmul")
    global LAUNCHES
    LAUNCHES += 1
    key = rt if side(m, n) == "first" else f"{rt}/last"
    ROUTE_LAUNCHES[key] = ROUTE_LAUNCHES.get(key, 0) + 1
    return c


def launch_info(a: torch.Tensor, b: torch.Tensor) -> list[dict]:
    """Registers per thread, threads, resident blocks per SM, grid blocks
    and waves of each CUDA kernel that ``matmul(a, b)`` runs (card only):
    the GEMM, then on the wide route the kernel that splits u.  The first
    row also carries the route -- the C library's own report, checked
    against :func:`route` -- and on the wide route its side and x's loads
    (checked against :func:`side` and :func:`loads`), the dynamic shared
    memory and the ring's stages."""
    (m, k), n = a.shape, b.shape[1]
    rt = route(m, n)
    rows, extra = _build.report(
        "matmul", "atucker_matmul_info", a.data_ptr(), b.data_ptr(), m, n, k,
        _build.dtype_code(a))
    got = ROUTES[extra[1]]
    if got != rt:
        raise RuntimeError(f"matmul: csrc/matmul.cu takes route {got}, "
                           f"kernels/matmul.py mirrors {rt}")
    rows[0]["route"] = got
    if got == "wide":
        sd = side(m, n)
        x, row = (b, n) if sd == "first" else (a, k)
        want = loads(row, dtype_name(x), x.data_ptr() % 16 == 0)
        got_side = "last" if extra[2] & 2 else "first"
        got_loads = "tma" if extra[2] & 1 else "plain"
        if (got_side, got_loads) != (sd, want):
            raise RuntimeError(f"matmul: csrc/matmul.cu runs the {got_side} "
                               f"mode with {got_loads} loads, "
                               f"kernels/matmul.py mirrors {sd}, {want}")
        rows[0].update(side=got_side, loads=got_loads, smem_bytes=extra[0],
                       ring_stages=extra[3])
    return rows
