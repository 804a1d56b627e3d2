"""Matricization-free interior-mode TTM for Hopper (a-Tucker Sec. V).

Computes  out[a, r, b] = Σ_i  u[r, i] · x[a, i, b]  on the (A, I_n, B) view
of the tensor — the paper's batched-GEMM organization of mode-n TTM, read
straight from the tensor's native row-major layout (B contiguous), never
unfolded.

Replaces ``repro/kernels/ttm.py::ttm_interior``; the CUDA source is
``csrc/ttm.cu``.  What bounds it on the H100: the bytes of x (R ≤ a few
dozen).  Three routes, a pure function of (R, B, dtype, alignment) that
:func:`route` mirrors:

* ``slab`` -- R ≤ 16, rows of x (B elements) a 16-byte multiple of at least
  128 bytes, x aligned.  A persistent grid, one block per SM, over equal
  tiles of (a, b) columns of the flattened A·B axis (whole values of a when
  B ≤ 1024); in each block one producer warp streams x through a
  double-buffered shared-memory ring by ``cp.async.bulk`` copies on
  ``mbarrier``s, and 8 consumer warps keep exactly R outputs per column in
  registers (FFMA), with u in shared memory once per block.
* ``plain`` -- R ≤ 16 on any other x (B = 1, odd B): the same kernel, each
  consumer thread loading its columns itself.
* ``wide`` -- R > 16.  A batch of A first-mode GEMMs out[a] = u @ x[a]
  sharing u, in one pass over x (R ≤ 128; chunks of 128 outputs above) on
  the tensor cores at fp32 accuracy: the wide route of ``csrc/wgmma.cuh``
  that ``csrc/matmul.cu`` runs for the first mode, with x by TMA
  (:func:`loads`) or by the producer's plain loads, u split once a call into
  a pre-split image in a workspace of :func:`workspace_bytes`, which the
  ``hopper`` plans charge to the step's peak (``core/plan.py``), and each
  stage's hi·hi summed exactly and added in fp32
  (:func:`repro_torch.kernels.ref.ttm_tf32x3_ref` writes it out).

Nothing is padded in memory.  A CPU tensor runs the plain version
(:func:`repro_torch.kernels.ref.ttm_interior_ref`); a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build
from .matmul import dtype_name, workspace_bytes as gemm_workspace_bytes
from .ref import ttm_interior_ref

#: launches of the CUDA kernel (one per wrapper call on the card)
LAUNCHES = 0
#: the same launches by route ("slab", "plain", "wide")
ROUTE_LAUNCHES: dict[str, int] = {}

#: the routes of csrc/ttm.cu, by the code its report function gives
ROUTES = ("slab", "plain", "wide")
#: the widest R of the FFMA routes; rows of x the ring copies at least
FFMA_MAX_R, MIN_BULK_ROW_BYTES = 16, 128


def _bulk(b: int, dtype: str, aligned: bool) -> bool:
    row = b * (4 if dtype == "float32" else 2)
    return aligned and row % 16 == 0 and row >= MIN_BULK_ROW_BYTES


def route(r: int, b: int, dtype: str = "float32", aligned: bool = True) -> str:
    """The route csrc/ttm.cu takes for u (R, I) and x (A, I, B): ``wide`` at
    R > 16; else ``slab`` when a row of x is a 16-byte multiple of at least
    128 bytes and x is 16-byte aligned, ``plain`` otherwise.  A and I do
    not change it."""
    if r > FFMA_MAX_R:
        return "wide"
    return "slab" if _bulk(b, dtype, aligned) else "plain"


def loads(b: int, dtype: str = "float32", aligned: bool = True) -> str:
    """How the wide route brings x in: ``tma`` on the ring's rule (a row of
    B elements a 16-byte multiple of at least 128 bytes, x aligned), else
    ``plain`` (the producer warps' own loads, the columns of successive
    values of a packed end to end)."""
    return "tma" if _bulk(b, dtype, aligned) else "plain"


def workspace_bytes(r: int, i: int, dtype: str = "float32") -> int:
    """Bytes that :func:`ttm_interior` allocates beyond its output for u (R,
    I): on the wide route u's pre-split image -- the same image as the
    boundary GEMM's wide route (:func:`repro_torch.kernels.matmul.
    workspace_bytes` of u (R, I) against any wider x) -- else 0."""
    if route(r, 1, dtype) != "wide":
        return 0
    return gemm_workspace_bytes(r, r + 1, i, dtype)


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
    dt = dtype_name(x3)
    rt = route(r, b, dt, x3.data_ptr() % 16 == 0)
    dev = x3.device
    with torch.cuda.device(dev):
        out = torch.empty((a, r, b), dtype=torch.float32, device=dev)
        n_ws = workspace_bytes(r, i, dt)
        ws = torch.empty(n_ws, dtype=torch.uint8, device=dev) if n_ws else None
        lib = _build.load("ttm")
        err = lib.atucker_ttm_interior(u.data_ptr(), x3.data_ptr(),
                                       out.data_ptr(),
                                       0 if ws is None else ws.data_ptr(),
                                       a, i, b, r, _build.dtype_code(x3),
                                       _build.stream_ptr(dev))
        _build.check(lib, err, "ttm_interior")
    global LAUNCHES
    LAUNCHES += 1
    ROUTE_LAUNCHES[rt] = ROUTE_LAUNCHES.get(rt, 0) + 1
    return out


def launch_info(u: torch.Tensor, x3: torch.Tensor) -> list[dict]:
    """Registers per thread, threads, resident blocks per SM and grid blocks
    of each CUDA kernel that ``ttm_interior(u, x3)`` runs (card only): the
    TTM, then on the wide route the kernel that splits u.  The first row
    also carries the route -- the C library's own report, checked against
    :func:`route` -- and on the wide route x's loads (checked against
    :func:`loads`), the dynamic shared memory and the ring's stages."""
    a, i, b = x3.shape
    r = u.shape[0]
    dt = dtype_name(x3)
    aligned = x3.data_ptr() % 16 == 0
    rows, extra = _build.report("ttm", "atucker_ttm_interior_info",
                                x3.data_ptr(), a, i, b, r,
                                _build.dtype_code(x3))
    got, want = ROUTES[extra[1]], route(r, b, dt, aligned)
    if got != want:
        raise RuntimeError(f"ttm_interior: csrc/ttm.cu takes route {got}, "
                           f"kernels/ttm.py mirrors {want}")
    rows[0]["route"] = got
    if got == "wide":
        got_loads = "tma" if extra[2] else "plain"
        if got_loads != loads(b, dt, aligned):
            raise RuntimeError(f"ttm_interior: csrc/ttm.cu loads x by "
                               f"{got_loads}, kernels/ttm.py mirrors "
                               f"{loads(b, dt, aligned)}")
        rows[0].update(loads=got_loads, smem_bytes=extra[0],
                       ring_stages=extra[3])
    return rows
