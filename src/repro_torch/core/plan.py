"""Static solver schedules for the plan/execute Tucker front door.

The paper's flexible algorithms pick a solver per mode at runtime; here the
same selection happens ONCE, ahead of time, against the (statically known)
shapes each mode solve will see.  The result is a tuple of :class:`ModeStep`
records — mode, solver, the (I_n, R_n, J_n) triple the selector saw, plus
modeled FLOPs (cost_model Eq. 4/5) and peak working-set bytes — which is the
single dispatch point for all three variants (st-HOSVD shrinks the tensor
between steps, t-HOSVD solves every mode on the original tensor, HOOI
refines from an st-HOSVD init).

``run_schedule`` is the per-step runner with real wall-clock per step (the
recorded runner: each synchronized step is spanned as ``solve`` on the obs
bus and fed to the drift monitor, with the ``solve``/``solve_out`` chaos
seams); the ``sweep_*`` functions run the same schedules without timing,
and are what a plan's cached sweep runs (captured into CUDA graphs on the
card, :mod:`repro_torch.core.graphs`).

With ``n_shards > 1`` (the ``sharded`` backend) each step also freezes
the mode the tensor is sharded on while it runs, so the reshard points are
known ahead of execution, and ``mode_parallel`` opens mode-parallel groups;
:mod:`repro_torch.core.distributed` runs those schedules.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, replace
from typing import Callable, Sequence

import torch

from .. import chaos as _chaos
from ..obs import drift as _drift
from ..obs import trace as _obs
from .backend import backend_ops, get_backend
from .cost_model import als_flops, eig_flops, rand_flops, svd_flops
from .errors import NumericalError
from .solvers import ALS, DEFAULT_ALS_ITERS, DEFAULT_OVERSAMPLE, SOLVERS

VARIANTS = ("sthosvd", "thosvd", "hooi")


@dataclass(frozen=True)
class ModeStep:
    """One frozen mode solve: which solver runs on which (sub)problem,
    through which ops backend.

    The JSON schema is the reference's unchanged.  For sharded schedules
    (``backend="sharded"``) ``shard_mode`` is the tensor mode the input is
    sharded on while this step runs (``None`` = replicated: the shrunk
    tensor no longer divides over the mesh) and ``n_shards`` the device
    count the step's slab is split across (1 when replicated);
    ``peak_bytes`` is then a per-device figure.  ``group`` marks
    mode-parallel execution: consecutive steps sharing a non-None id
    compute their factors from the same un-shrunk tensor (their ``j_n`` is
    the group-entry shape's) and truncate together in one chain of TTMs;
    every member records the group's modeled peak.  ``rank_grid``/``tau``
    are set on the steps of rank-adaptive plans.
    """
    mode: int
    method: str          # "eig" | "als" | "svd" | "rand"
    i_n: int             # mode dimension at solve time
    r_n: int             # truncation rank
    j_n: int             # product of the remaining dims at solve time
    flops: float         # modeled solver cost (cost_model Eq. 4/5)
    peak_bytes: int      # modeled peak working set
    backend: str = "matfree"   # resolved ops backend (never "auto")
    shard_mode: int | None = None  # mode sharded over the mesh (None = replicated)
    n_shards: int = 1    # devices this step's tensor is split across
    predicted_s: float = 0.0   # predicted wall-clock (0.0 = no calibrated
                               # cost model was available at plan time)
    group: int | None = None   # mode-parallel group id (None = sequential)
    rank_grid: tuple[int, ...] | None = None  # adaptive candidate ranks
    tau: float = 0.0     # squared error budget / ||X||² (adaptive steps only)

    def to_dict(self) -> dict:
        d = {"mode": self.mode, "method": self.method, "i_n": self.i_n,
             "r_n": self.r_n, "j_n": self.j_n, "flops": self.flops,
             "peak_bytes": self.peak_bytes, "backend": self.backend,
             "shard_mode": self.shard_mode, "n_shards": self.n_shards,
             "predicted_s": self.predicted_s, "group": self.group}
        # the rank policy serializes only when present, so fixed-rank plan
        # JSON stays byte-identical to the reference's
        if self.rank_grid is not None:
            d["rank_grid"] = list(self.rank_grid)
            d["tau"] = self.tau
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ModeStep":
        shard_mode = d.get("shard_mode")
        group = d.get("group")
        rank_grid = d.get("rank_grid")
        return cls(mode=int(d["mode"]), method=str(d["method"]),
                   i_n=int(d["i_n"]), r_n=int(d["r_n"]), j_n=int(d["j_n"]),
                   flops=float(d["flops"]), peak_bytes=int(d["peak_bytes"]),
                   backend=str(d.get("backend", "matfree")),
                   shard_mode=None if shard_mode is None else int(shard_mode),
                   n_shards=int(d.get("n_shards", 1)),
                   predicted_s=float(d.get("predicted_s", 0.0)),
                   group=None if group is None else int(group),
                   rank_grid=None if rank_grid is None
                   else tuple(int(r) for r in rank_grid),
                   tau=float(d.get("tau", 0.0)))


class TimedSelector:
    """Wraps a selector callable, accumulating wall-clock spent selecting."""

    def __init__(self, selector: Callable[..., str]):
        self._selector = selector
        self.seconds = 0.0
        self.calls = 0

    def __call__(self, *, i_n: int, r_n: int, j_n: int) -> str:
        t0 = time.perf_counter()
        method = self._selector(i_n=i_n, r_n=r_n, j_n=j_n)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return method

    @property
    def cost_model(self):
        """The wrapped selector's (possibly calibrated) cost model, if any."""
        return getattr(self._selector, "cost_model", None)


# ---------------------------------------------------------------------------
# Schedule resolution (selection moved out of the hot loop)
# ---------------------------------------------------------------------------

def resolve_mode_order(shape: Sequence[int], ranks: Sequence[int],
                       mode_order) -> list[int]:
    n = len(shape)
    if mode_order is None:
        return list(range(n))
    if mode_order == "opt":
        raise ValueError("mode_order='opt' is resolved by resolve_schedule "
                         "(the DP search needs solver costs and the memory "
                         "cap), not by resolve_mode_order")
    if mode_order == "shrink":
        return sorted(range(n), key=lambda m: ranks[m] / shape[m])
    order = [int(m) for m in mode_order]
    if sorted(order) != list(range(n)):
        raise ValueError(f"mode_order {order} must be a permutation of 0..{n - 1}")
    return order


def validate_ranks(shape: Sequence[int], ranks: Sequence[int]) -> tuple[int, ...]:
    ranks = tuple(int(r) for r in ranks)
    if len(ranks) != len(shape):
        raise ValueError(f"ranks {ranks} do not match tensor order {len(shape)}")
    for m, (i, r) in enumerate(zip(shape, ranks)):
        if not (1 <= r <= i):
            raise ValueError(f"rank {r} invalid for mode {m} (dim {i})")
    return ranks


def _resolve_methods(methods, n_modes: int):
    """Normalize ``methods`` to either None (= use selector) or a per-mode list."""
    if methods == "auto":
        return None
    if isinstance(methods, str):
        methods = [methods] * n_modes
    else:
        methods = list(methods)
        if len(methods) != n_modes:
            raise ValueError(f"need {n_modes} per-mode methods, got {len(methods)}")
    for m in methods:
        _check_solver(m)
    return methods


def _check_solver(m: str) -> None:
    if m not in SOLVERS:
        raise ValueError(f"unknown solver {m!r}")


def _step_cost(method: str, i_n: int, r_n: int, j_n: int,
               als_iters: int) -> float:
    if method == "eig":
        return eig_flops(i_n, r_n, j_n)
    if method == "als":
        return als_flops(i_n, r_n, j_n, als_iters)
    if method == "rand":
        return rand_flops(i_n, r_n, j_n)
    return svd_flops(i_n, r_n, j_n)


def _solver_scratch_bytes(method: str, i_n: int, r_n: int, j_n: int,
                          itemsize: int, n_shards: int = 1) -> int:
    """Modeled solver scratch only (no I/O tensors): EIG's I_n×I_n Gram,
    ALS's L/R iterates (+ fp32 input cast for sub-fp32 dtypes), RAND's
    sketch, SVD's explicit unfolding plus its left singular block.  Scratch
    lives in the *accumulation* dtype; with ``n_shards > 1`` the sharded
    parts (ALS's R-tensor and cast) divide by the shard count while
    replicated scratch does not (the reference's per-device model, which
    the schedule search prices shard counts with)."""
    accum = max(itemsize, 4)   # bf16/fp16 accumulate in fp32; fp64 stays 8
    if method == "eig":
        return i_n * i_n * accum
    if method == "als":
        scratch = (2 * i_n * r_n + 2 * r_n * r_n) * accum \
            + 2 * r_n * j_n * accum // n_shards
        if accum != itemsize:
            scratch += i_n * j_n * accum // n_shards   # yc: fp32 input cast
        return scratch
    if method == "rand":
        # Gaussian test tensor Ω (ℓ·J) + range sample / Q (I·ℓ) + the ℓ-wide
        # projected tensor b (ℓ·J) + the ℓ×ℓ sketched Gram; plus the fp32
        # input cast for sub-fp32 dtypes (like ALS)
        ell = min(i_n, r_n + DEFAULT_OVERSAMPLE)
        scratch = (2 * ell * j_n + i_n * ell + ell * ell) * accum
        if accum != itemsize:
            scratch += i_n * j_n * accum
        return scratch
    # svd materializes the unfolding and U
    return (i_n * j_n + i_n * min(i_n, j_n)) * accum


def _step_peak_bytes(method: str, i_n: int, r_n: int, j_n: int,
                     itemsize: int, n_shards: int = 1) -> int:
    """Modeled peak working set: input + output tensors plus solver scratch
    (see :func:`_solver_scratch_bytes`).  I/O tensors live in the compute
    dtype (``itemsize``); with ``n_shards > 1`` the figure is per device
    (the I/O slabs divide by the shard count)."""
    io = (i_n * j_n + r_n * j_n) * itemsize // n_shards
    return int(io + _solver_scratch_bytes(method, i_n, r_n, j_n, itemsize,
                                          n_shards))


#: SMs of the H100 SXM: the count a ``hopper`` plan built without a card
#: (``device="cpu"``) sizes the TTT's split-K workspace for
H100_SMS = 132


def _eigh_bytes(n: int, itemsize: int) -> int:
    """Bytes ``torch.linalg.eigh`` of an n × n matrix allocates beyond its
    input on the card: the eigenvectors (n²) and cuSOLVER's ``syevd``
    workspace, 5.02–5.16 n² elements from n = 1021 on and under 1.2 MB
    (fp32) / 2 MB (fp64) in all below n = 512, as measured on an H100 with
    torch 2.11 and CUDA 12.8; bounded by 5.25 n² + 2¹⁸ elements
    (``chip_smoke.py`` holds the bound at every size the plans run)."""
    return (21 * n * n // 4 + (1 << 18)) * itemsize


def _qr_bytes(i: int, ell: int, itemsize: int) -> int:
    """Bytes a reduced ``torch.linalg.qr`` of an (i, ℓ) matrix, with the
    cast copy that feeds it, allocates on the card: a fixed 3 MiB (fp32) /
    6 MiB (fp64) cuSOLVER workspace a call (as measured on an H100 with
    torch 2.11 and CUDA 12.8), plus the copy, Q, R and tau."""
    return ((3 << 18) + 3 * i * ell + ell * ell + 1024) * itemsize


def _hopper_workspace_bytes(method: str, a: int, i_n: int, r_n: int, b: int,
                            itemsize: int, n_sms: int,
                            first_mode: bool = False,
                            interior: bool = False) -> int:
    """The most bytes that one call of a ``hopper`` step allocates beyond
    the reference's model of the step, over the calls the step's solver
    makes at its (A, I_n, B) view.  TTT/Gram calls hold the split-K
    workspace (:func:`repro_torch.kernels.ttt.workspace_bytes`): EIG the
    I_n² Gram (in the accumulation dtype); ALS the (I_n, R_n) TTT and the
    R-tensor's (R_n, R_n) Gram; RAND the (I_n, ℓ) range samples and the (ℓ,
    ℓ) Gram (fp32, as those solvers iterate); a TTT of B = 1 (the last
    mode) holds y's image beside them.  On the first mode (``first_mode``)
    and on the last (neither flag) the TTMs are GEMMs -- u (R, I_n) @ x (I_n,
    B), x (A, I_n) @ uᵀ -- whose wide route holds u's pre-split image
    (:func:`repro_torch.kernels.matmul.workspace_bytes`): EIG u (R_n, I_n);
    ALS L (R_n, I_n) and R̂ (R_n, R_n); RAND Q (ℓ, I_n) and V (R_n, ℓ).  On
    an ``interior`` mode the same u's go to the interior TTM, whose wide
    route (R > 16) holds the same image
    (:func:`repro_torch.kernels.ttm.workspace_bytes`).
    The dense factorizations hold cuSOLVER's workspace: EIG's ``eigh`` of
    the Gram (:func:`_eigh_bytes`, whose eigenvectors then stay beside the
    core update's GEMM image); ALS's fp32 QR of L (I_n, R_n) and RAND's
    float64 QR of (I_n, ℓ) (:func:`_qr_bytes`) and ``eigh`` of the ℓ²
    Gram.  SVD runs no kernel.  The TTT's route, and so its split, depends
    on B and on the operands' alignment: the larger of the aligned and
    unaligned figures is charged.  One call's buffers are freed before the
    next call allocates its own, so the step holds the largest one.  The
    reference's model has no such term, so only ``hopper`` steps carry
    it."""
    from ..kernels.matmul import workspace_bytes as gemm_workspace_bytes
    from ..kernels.ttm import workspace_bytes as ttm_workspace_bytes
    from ..kernels.ttt import workspace_bytes
    ell = min(i_n, r_n + DEFAULT_OVERSAMPLE)
    accum = max(itemsize, 4)
    if method == "eig":
        dtype = "bfloat16" if itemsize == 2 else "float32"
        ttts, gemms = [(i_n, i_n, True)], [(r_n, i_n)]
    elif method == "als":
        dtype = "float32"
        ttts, gemms = [(i_n, r_n, False), (r_n, r_n, True)], \
            [(r_n, i_n), (r_n, r_n)]
    elif method == "rand":
        dtype = "float32"
        ttts, gemms = [(i_n, ell, False), (ell, ell, True)], \
            [(ell, i_n), (r_n, ell)]
    else:
        return 0
    need = [workspace_bytes(a, i, r, b, sym, n_sms, dtype, aligned)
            for i, r, sym in ttts for aligned in (True, False)]
    if first_mode:
        image = max(gemm_workspace_bytes(m, b, k, dtype) for m, k in gemms)
    elif interior:
        image = max(ttm_workspace_bytes(m, k, dtype) for m, k in gemms)
    else:
        image = max(gemm_workspace_bytes(a, m, k, dtype) for m, k in gemms)
    if method == "eig":
        need += [_eigh_bytes(i_n, accum), i_n * i_n * accum + image]
    elif method == "als":
        need += [_qr_bytes(i_n, r_n, 4), image]
    else:
        need += [_qr_bytes(i_n, ell, 8), _eigh_bytes(ell, 8) + ell * ell * 8,
                 image]
    return max(need)


def _held_bytes(shape: Sequence[int], factors, itemsize: int,
                input_held: bool = True, input_shards: int = 1) -> int:
    """What a ``hopper`` step holds beside its own working set: the factors
    already solved (``factors``: (mode, rank) pairs; replicated on every
    rank of a mesh) and, once the sweep has left it (``input_held``, and at
    least one factor solved), the caller's input, which the port never
    donates — on a mesh the rank's slab of it, ``1 / input_shards`` of the
    tensor.  The reference's model counts neither (it donates the input),
    so only ``hopper`` steps (and ``sharded`` steps computing on
    ``hopper``) carry it."""
    factors = list(factors)
    held = sum(shape[m] * r for m, r in factors)
    if input_held and factors:
        held += math.prod(shape) // input_shards
    return held * itemsize


def _slab(shape: Sequence[int], shard_mode: int | None,
          n_shards: int) -> tuple[int, ...]:
    """One rank's view of a tensor of ``shape`` sharded on ``shard_mode``
    over ``n_shards`` ranks (the shape itself when replicated)."""
    view = list(shape)
    if shard_mode is not None and n_shards > 1:
        view[shard_mode] //= n_shards
    return tuple(view)


def _backend_peak_bytes(method: str, shape: Sequence[int], mode: int,
                        r_n: int, itemsize: int, backend: str,
                        n_sms: int | None, n_shards: int = 1,
                        held_bytes: int = 0,
                        shard_mode: int | None = None) -> int:
    """:func:`_step_peak_bytes` of solving ``mode`` of a tensor of the
    current ``shape`` at rank ``r_n`` (per device over ``n_shards`` when
    sharded on ``shard_mode``), plus, when the step computes on ``hopper``
    (``backend`` is the backend that computes, a sharded step's local
    one), the largest workspace of the step's calls at its rank's (A, I_n,
    B) view (:func:`_hopper_workspace_bytes`; ``n_sms`` None means
    :data:`H100_SMS`) and ``held_bytes`` (:func:`_held_bytes`).  Other
    backends keep the reference's figure."""
    i_n = shape[mode]
    j_n = math.prod(shape) // i_n
    peak = _step_peak_bytes(method, i_n, r_n, j_n, itemsize, n_shards)
    if backend == "hopper":
        view = _slab(shape, shard_mode, n_shards)
        peak += held_bytes + _hopper_workspace_bytes(
            method, math.prod(view[:mode]), i_n, r_n,
            math.prod(view[mode + 1:]), itemsize,
            H100_SMS if n_sms is None else n_sms, first_mode=mode == 0,
            interior=0 < mode < len(shape) - 1)
        if n_shards > 1 and shard_mode is not None:
            peak += _all_reduce_bytes([(method, i_n, r_n)], itemsize)
    return peak


def _all_reduce_bytes(entries, itemsize: int) -> int:
    """What the all-reduces of sharded steps hold beside their payload: the
    element after it that carries the rank's failure code, 4 bytes (8 in
    float64).  The solvers' ops write their partial sums (an EIG step's
    I_n² Gram, an ALS iteration's (I_n, R_n) TTT and R_n² Gram, a group's
    EIG Grams in one flat buffer) into the buffer the all-reduce sums in
    place (:func:`repro_torch.core.distributed.partial_sums`), so nothing
    is copied.  ``entries`` are ``(method, i_n, r_n)``, one for a step and
    one a member for a group.  ``hopper`` steps charge it; ``matfree``
    steps keep the reference's figures, which have no such element."""
    if not any(m in ("eig", "als") for m, _, _ in entries):
        return 0
    return max(itemsize, 4)


def _group_peak_bytes(entries, in_elems: int, out_elems: int,
                      itemsize: int, n_shards: int = 1) -> int:
    """Modeled per-device peak of one mode-parallel group: the shared
    un-shrunk input slab (charged once), the fused multi-TTM's truncated
    output slab, plus every member's solver scratch at once.  ``entries``
    is a sequence of ``(method, i_n, r_n, j_n)`` at the group's entry
    shape; a singleton reduces to :func:`_step_peak_bytes`."""
    io = (in_elems + out_elems) * itemsize // n_shards
    scratch = sum(_solver_scratch_bytes(meth, i_n, r_n, j_n, itemsize,
                                        n_shards)
                  for meth, i_n, r_n, j_n in entries)
    return int(io + scratch)


def _backend_group_peak_bytes(entries, cur: Sequence[int], group,
                              out_elems: int, itemsize: int, backend: str,
                              n_sms: int | None, n_shards: int = 1,
                              shard_mode: int | None = None,
                              held_bytes: int = 0) -> int:
    """:func:`_group_peak_bytes` of the group of modes ``group`` at the
    current dims ``cur`` (``entries`` as there, per member), plus, when it
    computes on ``hopper``, ``held_bytes`` and the largest workspace of any
    member's calls at the rank's view of the group-entry tensor (the
    members' calls run one after another)."""
    peak = _group_peak_bytes(entries, math.prod(cur), out_elems, itemsize,
                             n_shards)
    if backend == "hopper":
        view = _slab(cur, shard_mode, n_shards)
        peak += held_bytes + max(
            _hopper_workspace_bytes(
                meth, math.prod(view[:m]), i_n, r_n,
                math.prod(view[m + 1:]), itemsize,
                H100_SMS if n_sms is None else n_sms, first_mode=m == 0,
                interior=0 < m < len(cur) - 1)
            for m, (meth, i_n, r_n, _) in zip(group, entries))
        if n_shards > 1 and shard_mode is not None:
            peak += _all_reduce_bytes([e[:3] for e in entries], itemsize)
    return peak


def _reshard_bytes(shape: Sequence[int], old: int | None, new: int | None,
                   n_shards: int, itemsize: int) -> int:
    """What a rank holds at once while :func:`repro_torch.core.distributed._reshard`
    moves a tensor of ``shape`` from shard mode ``old`` to ``new``: the
    old slab, the send copy and the received chunks, each chunk with one
    element for the failure code (an all-to-all, 3 slabs and 2 elements a
    rank); the full tensor and the narrowed slab (from replicated); or the
    slab, its send copy with the code's element, the gathered slabs with
    theirs, and their concatenation (to replicated)."""
    if old == new or n_shards <= 1:
        return 0
    full = math.prod(shape)
    slab = full // n_shards
    if old is None:
        return (full + slab) * itemsize
    if new is None:
        return (2 * slab + 2 * full + n_shards + 1) * itemsize
    return (3 * slab + 2 * n_shards) * itemsize


def _entry_peak_bytes(peak: int, held_bytes: int, cur: Sequence[int],
                      prev: int | None, new: int | None, n_shards: int,
                      itemsize: int) -> int:
    """A ``hopper``-computed step's ``peak`` with the reshard into its shard
    mode ``new`` from the previous step's ``prev``, which runs before its
    solver: the larger of the two, the reshard holding ``held_bytes``
    beside its buffers (:func:`_reshard_bytes`).  The plan and the schedule
    search price every step after the first with it."""
    return max(peak, held_bytes + _reshard_bytes(cur, prev, new, n_shards,
                                                 itemsize))


def iter_groups(steps):
    """Partition a schedule into execution groups: consecutive steps sharing
    a non-None ``group`` id run as ONE mode-parallel group (all factors from
    the shared un-shrunk input, one chain of truncating TTMs); ``None``
    steps are sequential singletons.  Yields lists of :class:`ModeStep`."""
    batch: list = []
    for s in steps:
        if batch and s.group is not None and s.group == batch[0].group:
            batch.append(s)
            continue
        if batch:
            yield batch
        batch = [s]
    if batch:
        yield batch


def _make_step(mode: int, method, selector, shape: Sequence[int], r_n: int,
               als_iters: int, itemsize: int, backend: str,
               cost_model=None, n_sms: int | None = None,
               held_bytes: int = 0, n_shards: int = 1,
               shard_mode: int | None = None, mem_backend: str | None = None,
               group: int | None = None,
               peak_override: int | None = None) -> ModeStep:
    """The step solving ``mode`` of a tensor of the current ``shape`` (the
    step's (A, I_n, B) view sizes the ``hopper`` workspace; ``held_bytes``
    is what a ``hopper`` step holds beside it, :func:`_held_bytes`).  On a
    mesh (``n_shards > 1``) the tensor is sharded on ``shard_mode`` while
    the step runs — SVD and RAND steps always run replicated — and
    ``mem_backend`` is the backend that computes each rank's slab, which
    prices the step's memory (``backend`` when None).  Group members carry
    the group's peak (``peak_override``)."""
    i_n = shape[mode]
    j_n = math.prod(shape) // i_n
    m = selector(i_n=i_n, r_n=r_n, j_n=j_n) if method is None else method
    _check_solver(m)
    if not get_backend(backend).supports_solver(m):
        raise ValueError(
            f"backend {backend!r} does not support solver {m!r} "
            f"(capability metadata lists {get_backend(backend).solvers}); "
            "pin a supported method or pick another impl")
    if m in ("svd", "rand"):
        # SVD matricizes; RAND's sketch has no collective form: both run
        # replicated in sharded schedules
        shard_mode = None
    eff_shards = n_shards if shard_mode is not None else 1
    scale = get_backend(backend).cost_scale
    # a calibrated cost model predicts wall-clock per step; its scales
    # already absorb the backend it was fitted on, so the registry
    # cost_scale hint is NOT applied on top
    predicted_s = cost_model.predict_seconds(m, i_n, r_n, j_n, als_iters) \
        if cost_model is not None and cost_model.calibrated else 0.0
    peak = _backend_peak_bytes(
        m, shape, mode, r_n, itemsize, mem_backend or backend, n_sms,
        eff_shards, held_bytes, shard_mode) \
        if peak_override is None else peak_override
    return ModeStep(mode=mode, method=m, i_n=i_n, r_n=r_n, j_n=j_n,
                    flops=scale * _step_cost(m, i_n, r_n, j_n, als_iters),
                    peak_bytes=peak, backend=backend, shard_mode=shard_mode,
                    n_shards=eff_shards, predicted_s=predicted_s,
                    group=group)


def _make_group_steps(g, gid: int, cur, ranks, methods_g, selector,
                      als_iters: int, itemsize: int, backend: str,
                      n_shards: int, cost_model, mem_backend: str,
                      n_sms: int | None, held_bytes: int) -> list[ModeStep]:
    """The ModeSteps of one mode-parallel group: every member is sized at
    the GROUP-ENTRY shape (``j_n`` keeps the other members un-shrunk — the
    FLOPs premium of parallel execution), one shard mode serves the whole
    group (chosen OUTSIDE it, so every member's Gram keeps the shard axis
    inside its contraction dims; ``None`` = replicated when the group covers
    every shardable mode), and the GROUP's modeled peak — shared input slab
    + all members' concurrent scratch — is stamped on each member."""
    j_base = math.prod(cur)
    if n_shards > 1:
        from .distributed import pick_shard_mode_group
        shard = pick_shard_mode_group(tuple(cur), g, n_shards)
    else:
        shard = None
    eff = n_shards if shard is not None else 1
    resolved = []
    for m, meth in zip(g, methods_g):
        i_n, r_n = cur[m], ranks[m]
        j_n = j_base // i_n
        meth = selector(i_n=i_n, r_n=r_n, j_n=j_n) if meth is None else meth
        if meth in ("svd", "rand"):
            raise ValueError(
                f"mode {m} resolved to {meth!r}, which runs replicated and "
                "cannot join a mode-parallel group; pin eig/als for grouped "
                f"modes (mode_parallel='auto' never groups {meth})")
        resolved.append((meth, i_n, r_n, j_n))
    out_elems = j_base
    for m in g:
        out_elems = out_elems // cur[m] * ranks[m]
    gpeak = _backend_group_peak_bytes(resolved, cur, g, out_elems, itemsize,
                                      mem_backend, n_sms, eff, shard,
                                      held_bytes)
    return [
        _make_step(m, meth, None, cur, r_n, als_iters, itemsize, backend,
                   cost_model=cost_model, n_sms=n_sms, n_shards=n_shards,
                   shard_mode=shard, group=gid, peak_override=gpeak)
        for m, (meth, i_n, r_n, j_n) in zip(g, resolved)]


def resolve_schedule(
    shape: Sequence[int],
    ranks: Sequence[int],
    *,
    variant: str = "sthosvd",
    methods="auto",
    mode_order=None,
    selector: Callable[..., str] | None = None,
    als_iters: int = DEFAULT_ALS_ITERS,
    hooi_iters: int = 3,
    include_init: bool = True,
    itemsize: int = 4,
    backend: str = "matfree",
    platform: str = "cuda",
    n_shards: int = 1,
    cost_model=None,
    memory_cap_bytes: int | None = None,
    mode_parallel: str | int = "off",
    n_sms: int | None = None,
    local_backend: str | None = None,
) -> tuple[ModeStep, ...]:
    """Resolve the full per-mode solver schedule ahead of execution.

    Every (I_n, R_n, J_n) triple a runtime selector would have seen is
    derived from ``shape``/``ranks`` alone, so selection runs zero times at
    execute time.  For HOOI, ``include_init=False`` drops the st-HOSVD init
    sweep (caller supplies its own initial factors).

    ``itemsize`` is the byte width of the *compute* dtype and ``backend``
    the resolved ops-backend name stamped on every step; ``platform``
    (``"cuda"`` or ``"cpu"``) picks the default selector when ``methods``
    is ``"auto"`` and no ``selector`` is given.

    ``n_shards > 1`` resolves the DISTRIBUTION schedule too (the
    ``sharded`` backend, st-HOSVD only): each step freezes the shard mode
    the tensor lives on while that mode is solved — the largest remaining
    mode (other than the one being solved) that divides by the shard count,
    :func:`repro_torch.core.distributed.pick_shard_mode` — so reshard
    points are known ahead of execution and ``peak_bytes`` become
    per-device figures.  ``local_backend`` names the backend that computes
    each rank's slab (``None`` = ``matfree``); where it is ``hopper`` the
    steps are priced as ``hopper`` steps at the rank's view (workspace, the
    factors and the rank's slab of the input held beside it, and the
    reshard's transient buffers), elsewhere as the reference's.

    ``cost_model`` annotates each step with its predicted wall-clock
    (``ModeStep.predicted_s``) when CALIBRATED; the textbook model carries
    no seconds unit, so uncalibrated schedules record 0.0.  When a selector
    is auto-resolved here, its embedded cost model is used.

    ``mode_order="opt"`` (st-HOSVD and the HOOI init sweep) runs the exact
    subset DP of :mod:`repro_torch.core.schedule_opt`, jointly choosing
    mode order AND per-step solver (respecting pinned ``methods``) to
    minimize the cost model's predicted total under ``memory_cap_bytes``.

    ``memory_cap_bytes`` is a hard per-device ceiling on every step's
    modeled ``peak_bytes``: fixed-order schedules that exceed it (and
    ``"opt"`` searches that cannot fit under it) raise
    :class:`~repro_torch.core.schedule_opt.MemoryCapError` at plan time,
    naming the binding step.

    ``n_sms`` is the SM count of the card the plan is built for; a
    ``hopper`` step's ``peak_bytes`` adds the largest workspace of its
    calls, whose split-K part that count sizes (:func:`_backend_peak_bytes`;
    None means :data:`H100_SMS`, the H100 SXM's 132), and what it holds
    beside its working set: the factors already solved and, after the first
    step, the caller's input (:func:`_held_bytes`; the port never donates
    it).  Other backends keep the reference's figures.

    ``mode_parallel`` (sharded st-HOSVD only) opens mode-PARALLEL groups:
    members compute their Grams/iterates from the same un-shrunk tensor and
    truncate together — fewer collective barriers (priced as the max over
    members) at more FLOPs (members see un-shrunk ``j_n``).  ``"off"``
    keeps the sequential shrink; an int G groups the leading G modes of the
    resolved order; ``"auto"`` lets the DP price sequential-vs-parallel —
    jointly with order/solver when ``mode_order="opt"``, as a grouping
    search along the fixed order otherwise.  ``"auto"`` degrades to
    sequential when ``n_shards <= 1``; an explicit int G > 1 there is an
    error.
    """
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
    get_backend(backend)   # concrete, registered backend only (never "auto")
    if n_shards > 1 and variant != "sthosvd":
        raise ValueError(f"sharded schedules support variant 'sthosvd' only, "
                         f"got {variant!r} (t-HOSVD/HOOI re-solve from the "
                         "full tensor; reshard scheduling assumes the "
                         "sequential shrink)")
    mp: str | int = mode_parallel
    if isinstance(mp, bool) or \
            not (mp in ("off", "auto") or isinstance(mp, int)):
        raise ValueError(f"mode_parallel {mode_parallel!r} must be 'off', "
                         "'auto', or an int max group size")
    if isinstance(mp, int):
        if mp < 1:
            raise ValueError(f"mode_parallel={mp} must be >= 1")
        if mp == 1:
            mp = "off"   # a group of one IS the sequential step
    if mp != "off":
        if variant != "sthosvd":
            raise ValueError("mode_parallel applies to the sequential "
                             "st-HOSVD sweep only; leave it 'off' for "
                             f"variant {variant!r}")
        if n_shards <= 1:
            if mp == "auto":
                mp = "off"   # single device: sequential shrinking always
                             # wins the latency race
            else:
                raise ValueError(
                    f"mode_parallel={mp} needs a sharded schedule "
                    "(n_shards > 1): single-device execution has no "
                    "concurrent mesh resources to assign mode Grams to")
    shape = tuple(int(s) for s in shape)
    ranks = validate_ranks(shape, ranks)
    n = len(shape)
    fixed = _resolve_methods(methods, n)
    if fixed is None and selector is None:
        from .selector import default_selector
        selector = default_selector(platform, backend=backend)
    if cost_model is None:
        # a trained selector carries the calibration fitted from the same
        # records; TimedSelector exposes the wrapped selector's cost_model
        cost_model = getattr(selector, "cost_model", None)
    # the backend that computes (and so allocates): a sharded step's local
    mem = (local_backend or "matfree") if backend == "sharded" else backend

    def method_for(mode):
        return None if fixed is None else fixed[mode]

    def _capped(steps_t: tuple[ModeStep, ...]) -> tuple[ModeStep, ...]:
        # hard plan-time cap: "opt" schedules were searched under it, but the
        # check runs uniformly so fixed orders (and HOOI refinements, which
        # the DP does not reorder) fail loudly too
        if memory_cap_bytes is not None:
            from .schedule_opt import validate_schedule_cap
            validate_schedule_cap(steps_t, memory_cap_bytes)
        return steps_t

    steps: list[ModeStep] = []
    if variant == "thosvd":
        if mode_order is not None:
            raise ValueError("mode_order is meaningless for thosvd (factors "
                             "are computed independently from the original "
                             "tensor); leave it None")
        for mode in range(n):   # every step reads the input itself
            held = _held_bytes(shape, zip(range(mode), ranks), itemsize,
                               input_held=False)
            steps.append(_make_step(mode, method_for(mode), selector,
                                    shape, ranks[mode], als_iters,
                                    itemsize, backend, cost_model=cost_model,
                                    n_sms=n_sms, held_bytes=held))
        return _capped(tuple(steps))

    # st-HOSVD sweep (also HOOI's init): the tensor shrinks between steps
    # (or between GROUPS when mode_parallel opens one)
    if variant == "sthosvd" or include_init:
        search_kw = dict(methods=fixed, als_iters=als_iters,
                         itemsize=itemsize, n_shards=n_shards,
                         cost_model=cost_model,
                         memory_cap_bytes=memory_cap_bytes, backend=mem,
                         n_sms=n_sms)
        flat_methods: list | None = None
        if mp == "auto":
            # the planner prices sequential-vs-parallel per input: joint
            # subset DP when the order is searched too, grouping search
            # along the fixed order otherwise
            from .schedule_opt import optimize_grouping, optimize_schedule
            if mode_order == "opt":
                search = optimize_schedule(shape, ranks, max_group=n,
                                           **search_kw)
            else:
                search = optimize_grouping(
                    shape, ranks,
                    tuple(resolve_mode_order(shape, ranks, mode_order)),
                    **search_kw)
            groups = list(search.groups)
            flat_methods = list(search.methods)
        else:
            if mode_order == "opt":
                from .schedule_opt import optimize_schedule
                search = optimize_schedule(shape, ranks, **search_kw)
                order, flat_methods = list(search.order), list(search.methods)
            else:
                order = resolve_mode_order(shape, ranks, mode_order)
            if mp == "off":
                groups = [(m,) for m in order]
            else:   # int G >= 2: the leading group, the rest sequential
                g_lead = min(int(mp), n)
                groups = [tuple(order[:g_lead])] + \
                    [(m,) for m in order[g_lead:]]
        if n_shards > 1:
            from .distributed import pick_shard_mode
        cur = list(shape)
        done: list[int] = []
        pos = gid = 0
        for g in groups:
            # the caller's input is held beside every step after the first,
            # on a mesh as the rank's slab of the first step's shard mode
            held = _held_bytes(shape, ((m, ranks[m]) for m in done),
                               itemsize, input_shards=steps[0].n_shards
                               if steps else 1)
            meths = [flat_methods[pos + i] if flat_methods is not None
                     else method_for(m) for i, m in enumerate(g)]
            prev = steps[-1].shard_mode if steps else None
            if len(g) == 1:
                mode = g[0]
                shard = pick_shard_mode(tuple(cur), mode, n_shards) \
                    if n_shards > 1 else None
                step = _make_step(mode, meths[0], selector, cur, ranks[mode],
                                  als_iters, itemsize, backend,
                                  cost_model=cost_model, n_sms=n_sms,
                                  held_bytes=held, n_shards=n_shards,
                                  shard_mode=shard, mem_backend=mem)
                new = [step]
            else:
                new = _make_group_steps(
                    g, gid, cur, ranks, meths, selector, als_iters, itemsize,
                    backend, n_shards, cost_model, mem, n_sms, held)
                gid += 1
            if mem == "hopper" and steps:
                # the reshard into this step's shard mode runs before its
                # solver: the step's peak is the larger of the two
                peak = _entry_peak_bytes(new[0].peak_bytes, held, cur, prev,
                                         new[0].shard_mode, n_shards,
                                         itemsize)
                new = [s if s.peak_bytes == peak else
                       replace(s, peak_bytes=peak) for s in new]
            steps.extend(new)
            for m in g:
                cur[m] = ranks[m]
                done.append(m)
            pos += len(g)
    if variant == "sthosvd":
        return _capped(tuple(steps))

    # HOOI refinement sweeps: mode n sees x projected on all OTHER factors,
    # i.e. shape (R_0 .. I_n .. R_{N-1}) — static, so resolvable up front;
    # the input and every factor are held beside it
    held = _held_bytes(shape, zip(range(n), ranks), itemsize)
    for _ in range(hooi_iters):
        for mode in range(n):
            projected = ranks[:mode] + (shape[mode],) + ranks[mode + 1:]
            steps.append(_make_step(mode, method_for(mode), selector,
                                    projected, ranks[mode], als_iters,
                                    itemsize, backend, cost_model=cost_model,
                                    n_sms=n_sms, held_bytes=held))
    return _capped(tuple(steps))


# ---------------------------------------------------------------------------
# Single solver dispatch + runners
# ---------------------------------------------------------------------------

def solve_step(y: torch.Tensor, step: ModeStep, *,
               als_iters: int = DEFAULT_ALS_ITERS, impl: str | None = None):
    """THE solver dispatch point: every variant's mode solve funnels here.

    ``impl`` overrides the step's recorded ops backend; by default each step
    runs on the backend frozen into it at schedule-resolution time.  A
    ``"rand"`` step sketches at the default oversample and power
    iterations, as the reference's compiled sweeps do.
    """
    impl = step.backend if impl is None else impl
    if step.method == ALS:
        return SOLVERS[ALS](y, step.mode, step.r_n, num_iters=als_iters, impl=impl)
    _check_solver(step.method)
    return SOLVERS[step.method](y, step.mode, step.r_n, impl=impl)


def _sync(x: torch.Tensor) -> None:
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def observe_solve(step: ModeStep, dt: float, wall0: float, platform: str,
                  backend: str) -> None:
    """One timed mode solve: a retroactive ``solve`` span on the obs bus
    (started at unix time ``wall0``, lasting ``dt`` seconds) and a
    predicted-vs-actual pair for the drift monitor."""
    _obs.event("span", t=wall0, name="solve", dur_s=dt, mode=step.mode,
               solver=step.method, backend=backend, platform=platform,
               rank=step.r_n, i_n=step.i_n, j_n=step.j_n,
               predicted_s=step.predicted_s)
    _drift.MONITOR.observe(platform=platform, backend=backend,
                           solver=step.method, predicted_s=step.predicted_s,
                           actual_s=dt, source="execute")


def run_schedule(x: torch.Tensor, steps: Sequence[ModeStep], *,
                 sequential: bool, als_iters: int = DEFAULT_ALS_ITERS,
                 impl: str | None = None, block_until_ready: bool = False):
    """Per-step runner with wall-clock per step.

    ``sequential=True`` threads the shrinking tensor through the steps
    (st-HOSVD); ``sequential=False`` solves every step against ``x`` itself
    (t-HOSVD factors, HOOI inner solves on pre-projected tensors).
    ``block_until_ready=True`` synchronizes the device after every step, so
    the seconds are real device time, and checks each factor is finite.

    Returns ``(y_or_none, factors, seconds)`` where ``factors[mode]`` is the
    LAST factor computed for that mode and ``seconds[k]`` is step k's wall
    time.
    """
    y = x
    factors: dict[int, torch.Tensor] = {}
    seconds: list[float] = []
    platform = x.device.type
    for step in steps:
        wall0 = time.time()
        t0 = time.perf_counter()
        _chaos.fire("solve", mode=step.mode, method=step.method)
        res = solve_step(y if sequential else x, step, als_iters=als_iters,
                         impl=impl)
        if _chaos.active() and _chaos.poison("solve_out", mode=step.mode):
            res = res._replace(u=res.u * float("nan"))
        if block_until_ready:
            _sync(res.y_new)
            dt = time.perf_counter() - t0
            # a breakdown that slipped past the in-solver guards (e.g. a
            # non-finite Gram) shows up here as NaN factors — surface it
            # as a classified error naming the step, not as silent poison
            if not bool(torch.isfinite(res.u).all()):
                raise NumericalError(
                    f"{step.method} solve on mode {step.mode} produced a "
                    "non-finite factor (numerical breakdown)")
            # the per-step path is the only place a mode solve has real
            # wall-clock: span it retroactively (no enter/exit to leak on
            # solver errors) and feed predicted-vs-actual drift
            observe_solve(step, dt, wall0, platform, impl or step.backend)
        else:
            dt = time.perf_counter() - t0
        seconds.append(dt)
        factors[step.mode] = res.u
        if sequential:
            y = res.y_new
    return (y if sequential else None), factors, seconds


# ---------------------------------------------------------------------------
# Whole-sweep functions (what TuckerPlan.execute runs)
# ---------------------------------------------------------------------------

def project(x: torch.Tensor, factors, impl: str, skip: int | None = None):
    """x ×_m U_mᵀ over every mode m (but ``skip``), through ``impl``'s TTM —
    the core of t-HOSVD/HOOI, and HOOI's projected inner problems."""
    ttm = backend_ops(impl)[0]
    y = x
    for mode, u in enumerate(factors):
        if mode != skip:
            y = ttm(y, u.T, mode)
    return y


def sweep_sthosvd(x, steps: Sequence[ModeStep], *, als_iters: int,
                  impl: str | None = None):
    y = x
    factors: dict[int, torch.Tensor] = {}
    for step in steps:
        res = solve_step(y, step, als_iters=als_iters, impl=impl)
        factors[step.mode] = res.u
        y = res.y_new
    return y, [factors[m] for m in range(x.ndim)]


def sweep_thosvd(x, steps: Sequence[ModeStep], *, als_iters: int,
                 impl: str | None = None):
    factors = [solve_step(x, step, als_iters=als_iters, impl=impl).u
               for step in steps]
    return project(x, factors, impl or steps[0].backend), factors


def sweep_hooi(x, steps: Sequence[ModeStep], *, als_iters: int, n_init: int,
               impl: str | None = None):
    """HOOI with its st-HOSVD init inlined: ``steps[:n_init]`` is the init
    sweep (sequential shrink), the rest are refinement solves on x projected
    over every factor but the step's mode."""
    _, factors = sweep_sthosvd(x, steps[:n_init], als_iters=als_iters,
                               impl=impl)
    for step in steps[n_init:]:
        y = project(x, factors, impl or step.backend, skip=step.mode)
        factors[step.mode] = solve_step(y, step, als_iters=als_iters,
                                        impl=impl).u
    return project(x, factors, impl or steps[0].backend), factors
