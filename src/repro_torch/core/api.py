"""Plan/execute front door for a-Tucker: ``TuckerConfig`` → ``TuckerPlan``.

All input-adaptive decisions move to a one-time ``plan`` step:

    cfg  = TuckerConfig(ranks=(10, 10, 5), methods="auto")
    p    = plan(x.shape, "float32", cfg)      # selector runs here, never again
    res  = p.execute(x)                       # runs the frozen schedule
    ress = p.execute_batch(xs)                # the same sweep, item by item

``plan`` resolves the per-mode solver schedule, mode order and ops backend
against the static shapes and freezes them; ``execute`` only runs them.
The sweep is cached process-wide by ``(shape, dtype, schedule+backend,
variant, als_iters, compute_dtype, batched, device, captured)``
(``CACHE_STATS``, :func:`clear_sweep_cache`).  On the card a fixed-rank
plan without ``memory_cap_bytes`` runs its sweep as CUDA graphs captured at
its first execute (:mod:`repro_torch.core.graphs`), the counterpart of the
reference's jitted sweep; capped plans (whose cap holds step by step),
rank-adaptive plans, ``record=True`` and every execute inside an active
:func:`repro_torch.tune.recording` context (which harvests the timed
steps) run eagerly.  Plans are
JSON-serializable (``save``/``load``) in the reference's schema, so a
schedule planned by the JAX package runs here unchanged.

Rank-ADAPTIVE plans trade fixed ranks for an error target:

    cfg = TuckerConfig(error_target=0.05)        # ||X - X̂|| ≤ 0.05·||X||
    p   = plan(x.shape, "float32", cfg)          # freezes a rank POLICY
    res = p.execute(x)                           # sketches ranks, refines
    res.tucker.ranks, res.error_bound            # what the policy chose

The plan carries per-step candidate grids and equi-partitioned HOSVD
budgets instead of ranks; execution reads each mode's rank off a
randomized sketch (matricization-free, the same TTM/TTT/Gram kernels) and
either ships the sketch factors (``methods="rand"``) or refines at the
chosen ranks through the ordinary fixed-rank path.

``mode_order="opt"`` searches order and solver with the exact subset DP of
:mod:`repro_torch.core.schedule_opt`, under ``memory_cap_bytes`` when set.
A failed fixed-rank execute degrades along a bounded fallback ladder
(als→eig on a numerical breakdown, a replan under a tighter cap on an
out-of-memory); a kernel that fails on the card raises — nothing drops to
``matfree`` or the CPU.

Devices: entry points run on the card.  ``plan(..., device=None)`` and
``TuckerPlan.load(path, device=None)`` mean ``cuda:0`` and raise when CUDA
is not available — they never drop to the CPU; pass ``device="cpu"`` to
run there.  ``execute`` copies a numpy array or a tensor on another device
onto the plan's device.

Every layer reports to :mod:`repro_torch.obs` (``plan``/``execute`` spans,
cache misses, the first run's ``compile`` span and one ``capture`` span per
captured graph, each fallback hop as a ``fallback`` event and in the
``atucker_fallback_hops_total`` counter) and carries the chaos seams of
:mod:`repro_torch.chaos` (``sweep``, ``sweep_out``, ``sketch``).

Sharded plans (``TuckerConfig(mesh=...)`` with a ``torch.distributed``
``DeviceMesh``) run SPMD: every rank of the mesh calls ``plan`` and
``execute`` with the same arguments, passing either the global tensor or a
``DTensor`` holding only its slab; :mod:`repro_torch.core.distributed` runs
the schedule with explicit collectives, and every rank gets the replicated
factors and the all-gathered core.  With a mesh, ``device=None`` is the
rank's current CUDA device.
"""

from __future__ import annotations

import json
import math
import sys
import time
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Any, Callable, Sequence

import torch

from .. import chaos as _chaos
from ..obs import drift as _drift
from ..obs import metrics as _metrics
from ..obs import trace as _obs
from . import graphs as G
from . import tensor_ops as T
from .backend import (backend_ops, get_backend, local_backend,
                      resolve_backend)
from .errors import (CancelledError, DeadlineError, InputError,
                     NumericalError, ResourceError, check_finite,
                     check_result_finite, classify_exception)
from .plan import (ModeStep, TimedSelector, VARIANTS, observe_solve,
                   project, resolve_schedule, run_schedule, solve_step,
                   sweep_hooi, sweep_sthosvd, sweep_thosvd)
from .solvers import DEFAULT_ALS_ITERS, DEFAULT_OVERSAMPLE, DEFAULT_POWER_ITERS
from .sthosvd import ModeTrace, SthosvdResult, TuckerTensor

PLAN_FORMAT_VERSION = 1


def _active_sink():
    """The active :func:`repro_torch.tune.recording` sink, or None.  Probed
    through ``sys.modules``: plans that never import the tune subsystem pay
    nothing."""
    tune = sys.modules.get("repro_torch.tune")
    return tune.active_sink() if tune is not None else None


def mesh_spec(mesh) -> dict | None:
    """JSON-serializable description of a ``DeviceMesh``: axis names +
    per-axis sizes, the reference's schema.  Device identities are not
    serialized: a plan made on one host rebuilds its mesh from the local
    process group on another."""
    if mesh is None:
        return None
    return {"axis_names": list(mesh.mesh_dim_names),
            "shape": [int(s) for s in mesh.shape]}


def mesh_from_spec(spec: dict | None):
    """Rebuild a ``DeviceMesh`` from :func:`mesh_spec` output over the
    initialized default process group (every rank calls it, as it calls
    ``init_device_mesh``): on CUDA when the host has it, else on the CPU.
    Returns None when the spec is None, no process group is initialized, or
    the world is not the spec's size — the plan then loads for inspection
    but ``execute`` raises until a real mesh is available."""
    if spec is None:
        return None
    import torch.distributed as dist
    shape = tuple(int(s) for s in spec["shape"])
    if not (dist.is_available() and dist.is_initialized()) or \
            math.prod(shape) != dist.get_world_size():
        return None
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cuda" if torch.cuda.is_available() else "cpu",
                            shape, mesh_dim_names=tuple(spec["axis_names"]))


@dataclass(frozen=True)
class TuckerConfig:
    """Frozen description of a Tucker decomposition job (the *what*).

    The fields, their defaults, their validation and ``to_dict``/
    ``from_dict`` are the reference's, so configs and plans serialize
    identically.

    ``impl`` names an ops backend from :mod:`repro_torch.core.backend`
    (``matfree`` | ``explicit`` | ``hopper`` | custom) or ``"auto"``, which
    ``plan()`` resolves for the device and compute dtype (``hopper`` on
    CUDA for fp32/bf16).  ``compute_dtype`` casts inputs before the sweep.

    ``mode_order`` is ``None`` (the paper's 1..N), a permutation,
    ``"shrink"`` or ``"opt"`` — the exact subset-DP schedule search
    (:mod:`repro_torch.core.schedule_opt`) that jointly picks order AND
    per-step solver against the cost model's predicted total, under
    ``memory_cap_bytes`` when set.  ``memory_cap_bytes`` is a hard ceiling
    on every step's modeled working set: plans that cannot fit raise
    :class:`~repro_torch.core.schedule_opt.MemoryCapError` at plan time,
    naming the binding step.

    ``donate_input`` is accepted, stored and serialized; the port's sweep
    never aliases or frees its input.  ``donate_input=False`` keeps the
    reference's plan-level cap check: the held input must fit beside every
    later step (see :func:`plan`).

    ``mesh`` attaches a ``torch.distributed`` ``DeviceMesh`` (with
    ``mesh_dim_names``) for multi-device execution: ``impl="sharded"``
    requires one, and ``impl="auto"`` resolves to the sharded backend
    whenever one is present; a single-device ``impl`` with a mesh is
    rejected.  ``shard_axis`` names the mesh axis the tensor is sharded over
    (default: the mesh's first axis).  The mesh serializes as its SPEC
    (:func:`mesh_spec`).  ``memory_cap_bytes`` is then a per-device cap.

    ``mode_parallel`` opts sharded st-HOSVD sweeps into MODE-PARALLEL
    groups (one collective barrier for a group's Grams, more FLOPs):
    ``"off"`` (default), an int ``G ≥ 2`` (the first G modes of the resolved
    order), or ``"auto"`` (the schedule DP prices it; sequential on a single
    device).

    ``error_target`` switches the plan RANK-ADAPTIVE (st-HOSVD only): pass a
    target relative reconstruction error ε ∈ (0, 1) and ``ranks`` becomes
    optional — the plan carries a rank POLICY, and execution reads each
    mode's rank off a randomized sketch
    (:func:`repro_torch.core.solvers.rand_sketch`): the smallest candidate
    whose measured discarded energy fits the mode's share
    ``τ_n² = ε²·||X||²/N`` of the HOSVD bound ``||X − X̂||² ≤ Σ_n τ_n²``.
    ``ranks``, when also given, caps the per-mode rank; ``rank_grid``
    restricts the candidates — a flat int tuple is one shared ascending
    grid, a tuple of tuples is per-mode (default: every rank up to the
    cap).  ``methods`` names the solver that REFINES at the chosen ranks
    (``"auto"``/``"eig"``/``"als"`` …); ``methods="rand"`` ships the
    sketch's own factors.  ``oversample``/``power_iters`` tune the sketch
    (ℓ = r + oversample columns, subspace-iteration count).
    ``SthosvdResult.error_bound`` then reports the certified bound
    ``sqrt(Σ_n tail_n)/||X||`` measured from the executed sketch.
    """
    ranks: tuple[int, ...] | None = None
    variant: str = "sthosvd"
    methods: str | tuple[str, ...] = "auto"
    mode_order: tuple[int, ...] | str | None = None
    impl: str = "matfree"
    als_iters: int = DEFAULT_ALS_ITERS
    hooi_iters: int = 3
    compute_dtype: str | None = None
    mesh: Any = None
    shard_axis: str | None = None
    memory_cap_bytes: int | None = None
    donate_input: bool | None = None
    mode_parallel: str | int = "off"
    error_target: float | None = None
    rank_grid: tuple | None = None
    oversample: int = DEFAULT_OVERSAMPLE
    power_iters: int = DEFAULT_POWER_ITERS

    def __post_init__(self):
        if self.mesh is not None and \
                not getattr(self.mesh, "mesh_dim_names", None):
            raise ValueError("mesh must be a torch.distributed DeviceMesh "
                             "with mesh_dim_names (init_device_mesh(..., "
                             "mesh_dim_names=('data',)))")
        if self.ranks is not None:
            object.__setattr__(self, "ranks",
                               tuple(int(r) for r in self.ranks))
        elif self.error_target is None:
            raise ValueError("TuckerConfig needs ranks=... (fixed-rank) or "
                             "error_target=... (rank-adaptive)")
        if self.error_target is not None:
            object.__setattr__(self, "error_target", float(self.error_target))
            if not 0.0 < self.error_target < 1.0:
                raise ValueError(f"error_target={self.error_target} must be "
                                 "a relative error in (0, 1)")
            if self.variant != "sthosvd":
                raise ValueError("error_target (rank-adaptive planning) "
                                 "needs the sequential-shrink error "
                                 "accounting of variant='sthosvd', got "
                                 f"{self.variant!r}")
            if self.mode_parallel != "off":
                raise ValueError("rank-adaptive plans are sequential (the "
                                 "per-mode budget check threads the shrink); "
                                 "mode_parallel must stay 'off'")
            if self.mesh is not None or self.impl == "sharded":
                raise ValueError("rank-adaptive plans run replicated (the "
                                 "sketch has no collective path); drop the "
                                 "mesh / sharded impl, or resolve ranks "
                                 "first and plan the fixed-rank sharded "
                                 "sweep at the result")
        if self.rank_grid is not None:
            if self.error_target is None:
                raise ValueError("rank_grid is part of the rank-adaptive "
                                 "policy; set error_target=... too (for "
                                 "fixed ranks pass ranks=...)")
            rg = tuple(self.rank_grid)
            if all(isinstance(g, int) for g in rg):
                object.__setattr__(self, "rank_grid",
                                   tuple(int(g) for g in rg))
            else:
                object.__setattr__(
                    self, "rank_grid",
                    tuple(tuple(int(r) for r in g) for g in rg))
            if not rg:
                raise ValueError("rank_grid must not be empty")
        if self.oversample < 0 or self.power_iters < 0:
            raise ValueError("oversample and power_iters must be >= 0")
        if not isinstance(self.methods, str):
            object.__setattr__(self, "methods", tuple(self.methods))
        if isinstance(self.mode_order, (list, tuple)):
            object.__setattr__(self, "mode_order",
                               tuple(int(m) for m in self.mode_order))
        if isinstance(self.mode_order, str) and \
                self.mode_order not in ("shrink", "opt"):
            raise ValueError(f"mode_order {self.mode_order!r} must be a "
                             "permutation, 'shrink', 'opt', or None")
        if self.memory_cap_bytes is not None:
            object.__setattr__(self, "memory_cap_bytes",
                               int(self.memory_cap_bytes))
            if self.memory_cap_bytes <= 0:
                raise ValueError("memory_cap_bytes must be a positive byte "
                                 "count (None = uncapped)")
        if self.variant not in VARIANTS:
            raise ValueError(f"unknown variant {self.variant!r}; "
                             f"expected one of {VARIANTS}")
        if self.impl != "auto":
            b = get_backend(self.impl)   # ValueError on unregistered names
            # a mesh on a single-device backend would be silently ignored
            if self.mesh is not None and not b.requires_mesh:
                raise ValueError(
                    f"config carries a mesh but impl={self.impl!r} executes "
                    "on a single device; pass impl='sharded' (or 'auto', "
                    "which resolves to it when a mesh is present) or drop "
                    "the mesh")
        if self.compute_dtype is not None:
            T.dtype_name(self.compute_dtype)
        if self.als_iters < 1 or self.hooi_iters < 0:
            raise ValueError("als_iters must be ≥1 and hooi_iters ≥0")
        mp = self.mode_parallel
        if isinstance(mp, bool) or \
                not (mp in ("off", "auto") or isinstance(mp, int)):
            raise ValueError(f"mode_parallel {mp!r} must be 'off', 'auto', "
                             "or an int max group size")
        if isinstance(mp, int) and mp < 1:
            raise ValueError(f"mode_parallel={mp} must be >= 1")
        if self.shard_axis is not None and self.mesh is not None and \
                self.shard_axis not in self.mesh.mesh_dim_names:
            raise ValueError(f"shard_axis {self.shard_axis!r} not in mesh "
                             f"axes {self.mesh.mesh_dim_names}")

    @property
    def resolved_shard_axis(self) -> str | None:
        """The mesh axis sharded executions split over (explicit
        ``shard_axis`` or the mesh's first axis); None without a mesh."""
        if self.mesh is None:
            return self.shard_axis
        return self.shard_axis or self.mesh.mesh_dim_names[0]

    @property
    def n_shards(self) -> int:
        """Device count along the shard axis (1 without a mesh)."""
        if self.mesh is None:
            return 1
        names = tuple(self.mesh.mesh_dim_names)
        return int(self.mesh.size(names.index(self.resolved_shard_axis)))

    def to_dict(self) -> dict:
        d = {"ranks": None if self.ranks is None else list(self.ranks),
             "variant": self.variant,
             "methods": (self.methods if isinstance(self.methods, str)
                         else list(self.methods)),
             "mode_order": (list(self.mode_order)
                            if isinstance(self.mode_order, tuple)
                            else self.mode_order),
             "impl": self.impl, "als_iters": self.als_iters,
             "hooi_iters": self.hooi_iters,
             "compute_dtype": self.compute_dtype,
             "mesh": mesh_spec(self.mesh),
             "shard_axis": self.shard_axis,
             "memory_cap_bytes": self.memory_cap_bytes,
             "donate_input": self.donate_input,
             "mode_parallel": self.mode_parallel}
        # rank-policy keys ride only on adaptive configs, so fixed-rank
        # config JSON stays byte-identical to the reference's
        if self.error_target is not None:
            d["error_target"] = self.error_target
            d["rank_grid"] = (None if self.rank_grid is None else
                              [list(g) if isinstance(g, tuple) else g
                               for g in self.rank_grid])
            d["oversample"] = self.oversample
            d["power_iters"] = self.power_iters
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TuckerConfig":
        rg = d.get("rank_grid")
        if rg is not None:
            rg = tuple(tuple(g) if isinstance(g, list) else int(g)
                       for g in rg)
        ranks = d["ranks"]
        return cls(ranks=None if ranks is None else tuple(ranks),
                   variant=d.get("variant", "sthosvd"),
                   methods=(d["methods"] if isinstance(d["methods"], str)
                            else tuple(d["methods"])),
                   mode_order=(tuple(d["mode_order"])
                               if isinstance(d.get("mode_order"), list)
                               else d.get("mode_order")),
                   impl=d.get("impl", "matfree"),
                   als_iters=d.get("als_iters", DEFAULT_ALS_ITERS),
                   hooi_iters=d.get("hooi_iters", 3),
                   compute_dtype=d.get("compute_dtype"),
                   mesh=mesh_from_spec(d.get("mesh")),
                   shard_axis=d.get("shard_axis"),
                   memory_cap_bytes=d.get("memory_cap_bytes"),
                   donate_input=d.get("donate_input"),
                   mode_parallel=d.get("mode_parallel", "off"),
                   error_target=d.get("error_target"),
                   rank_grid=rg,
                   oversample=d.get("oversample", DEFAULT_OVERSAMPLE),
                   power_iters=d.get("power_iters", DEFAULT_POWER_ITERS))


def resolve_device(device=None, *, mesh=None) -> torch.device:
    """The device a plan runs on: ``cuda:0`` when ``device`` is None, or,
    with a ``mesh``, the rank's current CUDA device.  Raises when CUDA is
    asked for (or implied) and not available — never falls back to the
    CPU."""
    if device is None and mesh is not None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested (the default) but CUDA is not "
                "available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def _as_tensor(x) -> torch.Tensor:
    """``x`` as a tensor: a tensor as it is, an array (bf16 from ml_dtypes
    included) shared with torch where it can be, else copied once."""
    if isinstance(x, torch.Tensor):
        return x
    import numpy as np
    a = np.asarray(x)
    # torch tensors must own writable memory: copy read-only (e.g. jax-owned)
    # or strided arrays once, on the host
    a = np.array(a, order="C",
                 copy=not a.flags.writeable or not a.flags.c_contiguous)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bf16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


# ---------------------------------------------------------------------------
# Process-wide sweep cache
# ---------------------------------------------------------------------------

_SWEEP_CACHE: dict[tuple, "_Sweep"] = {}

#: builds = cache entries made; hits = cache reuses; traces = first runs of
#: an eager entry plus captured CUDA graphs (one per segment of a captured
#: sweep) — the reference's XLA compilations
CACHE_STATS = {"builds": 0, "hits": 0, "traces": 0}


def clear_sweep_cache() -> None:
    """Drop every cached sweep (releasing captured graphs, their memory
    pools and static inputs) and zero :data:`CACHE_STATS`."""
    _SWEEP_CACHE.clear()
    CACHE_STATS.update(builds=0, hits=0, traces=0)


def _count_trace() -> None:
    CACHE_STATS["traces"] += 1


def _eager_sweep(steps: tuple, cfg: "TuckerConfig", n: int
                 ) -> Callable[[torch.Tensor], tuple]:
    """The sweep of a fixed-rank schedule as ``x -> (core, factors)``: the
    compute-dtype cast, then st-HOSVD, t-HOSVD or HOOI over ``steps``."""
    cdtype = T.torch_dtype(cfg.compute_dtype) if cfg.compute_dtype else None

    def sweep(x: torch.Tensor):
        if cdtype is not None:
            x = x.to(cdtype)
        if cfg.variant == "sthosvd":
            return sweep_sthosvd(x, steps, als_iters=cfg.als_iters)
        if cfg.variant == "thosvd":
            return sweep_thosvd(x, steps, als_iters=cfg.als_iters)
        return sweep_hooi(x, steps, als_iters=cfg.als_iters, n_init=n)

    return sweep


def _require_mesh(cfg: "TuckerConfig") -> None:
    """Raise when a sharded plan's config has no mesh to run on."""
    if cfg.mesh is None:
        raise RuntimeError(
            "plan requires a mesh to execute its sharded schedule (no "
            "process group of the plan's mesh size was initialized when it "
            "loaded, or the config lost its mesh); re-plan with "
            "TuckerConfig(mesh=...) after init_process_group")


def _sharded_sweep(p: "TuckerPlan") -> Callable[[torch.Tensor], tuple]:
    """The sweep of a sharded plan as ``x -> (core, factors)`` on this
    rank's slab ``x`` (sharded on the first step's shard mode): the
    compute-dtype cast, then :mod:`repro_torch.core.distributed`'s sweep on
    the plan's mesh, computing on :attr:`TuckerPlan.local_backend`."""
    cfg = p.config
    _require_mesh(cfg)
    from .distributed import sweep_mode_parallel
    steps = p.schedule
    cdtype = T.torch_dtype(cfg.compute_dtype) if cfg.compute_dtype else None
    mesh, axis, local = cfg.mesh, cfg.resolved_shard_axis, p.local_backend

    def sweep(x: torch.Tensor):
        if cdtype is not None:
            x = x.to(cdtype)
        # the plan's "sweep" seam fires inside the ranks' agreement, so a
        # fault planted there on one rank ends the sweep on all of them
        return sweep_mode_parallel(
            x, steps, mesh=mesh, axis=axis, local=local,
            placed=steps[0].shard_mode, als_iters=cfg.als_iters,
            on_start=lambda: _chaos.fire("sweep", backend="sharded"))

    return sweep


def _plan_sweep(p: "TuckerPlan") -> Callable[[torch.Tensor], tuple]:
    """The uncached eager sweep of a fixed-rank plan."""
    if p.backend == "sharded":
        return _sharded_sweep(p)
    return _eager_sweep(p.schedule, p.config, len(p.shape))


def _check_finite_everywhere(x: torch.Tensor, cfg: "TuckerConfig") -> None:
    """:func:`~repro_torch.core.errors.check_finite` of a sharded plan's
    input: every rank learns (one ``all_reduce`` of a count) whether any
    rank's slab holds NaN/Inf, so all of them raise together instead of
    one raising while the others wait in the sweep's first collective.  A
    rank whose own slab is bad names the mode as ``check_finite`` does."""
    from .distributed import ShardAxis, all_reduce
    bad = (~torch.isfinite(x)).sum().reshape(1).to(torch.float64)
    bad = all_reduce(bad, ShardAxis.of(cfg.mesh, cfg.resolved_shard_axis))
    if float(bad[0]) > 0:
        check_finite(x, name="input")
        raise InputError(f"input contains {int(bad[0])} non-finite value(s) "
                         "on other ranks of the mesh")


class _Sweep:
    """One cache entry: a plan's sweep, eager or captured
    (:class:`~repro_torch.core.graphs.CapturedSweep`), over one tensor or
    (``batched``) item by item over a leading axis — the hand kernels are
    called through ctypes and do not vectorize.  Its first call is spanned
    as ``compile`` (the reference's first, compiling run); an eager entry
    counts that call as its trace, a captured one each graph it
    captures."""

    def __init__(self, p: "TuckerPlan", batched: bool, captured: bool):
        run = _plan_sweep(p)
        self.graphs = G.CapturedSweep(run, device=p.device,
                                      on_capture=_count_trace) \
            if captured else None
        self.run = self.graphs or run
        self.batched = batched
        self._first = True
        self._attrs = dict(shape=list(p.shape), dtype=p.dtype,
                           backend=p.backend, variant=p.config.variant,
                           batched=batched, captured=captured)

    def __call__(self, x: torch.Tensor):
        if not self._first:
            return self._call(x)
        self._first = False
        if self.graphs is None:
            _count_trace()
        with _obs.span("compile", includes_first_run=True, **self._attrs):
            return self._call(x)

    def _call(self, x: torch.Tensor):
        if self.batched:
            return [self.run(x[b]) for b in range(x.shape[0])]
        return self.run(x)


# ---------------------------------------------------------------------------
# TuckerPlan
# ---------------------------------------------------------------------------

@dataclass
class TuckerPlan:
    """A frozen, executable solver schedule for one (shape, dtype, config)
    on one device.

    ``schedule`` lists every mode solve in execution order with the solver
    the selector (or explicit methods) chose and the modeled FLOPs / peak
    working-set bytes of that step.  ``device`` is not serialized: a loaded
    plan runs on the device its loader names; left out, it is ``cuda:0``
    (raising without CUDA), as in :func:`plan`.
    """
    shape: tuple[int, ...]
    dtype: str
    config: TuckerConfig
    schedule: tuple[ModeStep, ...]
    select_seconds: float = 0.0     # one-time planning cost (selector calls)
    device: torch.device = field(default_factory=resolve_device)

    # -- introspection -------------------------------------------------------
    @property
    def is_adaptive(self) -> bool:
        """True when this plan carries a rank POLICY (``error_target``)
        instead of fixed ranks: steps are sized at their rank caps (the
        conservative figure for memory modeling) and ``execute`` reads the
        actual per-mode ranks off a randomized sketch of each input."""
        return self.config.error_target is not None

    @property
    def backend(self) -> str:
        """The resolved ops backend this plan's steps run on (``config.impl``
        may be ``"auto"``; this is what it resolved to at plan time)."""
        names = {s.backend for s in self.schedule}
        return self.schedule[0].backend if len(names) == 1 else "mixed"

    @property
    def methods(self) -> tuple[str, ...]:
        """Resolved solver per mode (first visit order, sorted by mode)."""
        first: dict[int, str] = {}
        for s in self.schedule:
            first.setdefault(s.mode, s.method)
        return tuple(first[m] for m in sorted(first))

    @property
    def total_flops(self) -> float:
        return sum(s.flops for s in self.schedule)

    @property
    def total_predicted_s(self) -> float:
        """Sum of the per-step calibrated cost-model predictions (0.0 when
        no calibration was available at plan time)."""
        return sum(s.predicted_s for s in self.schedule)

    @property
    def local_backend(self) -> str | None:
        """The backend each rank of a sharded plan computes its slab with
        (:func:`repro_torch.core.backend.local_backend`: ``hopper`` on CUDA,
        ``matfree`` on the CPU); None for single-device plans."""
        if self.backend != "sharded":
            return None
        return local_backend(self.device.type,
                             self.config.compute_dtype or self.dtype,
                             self.shape)

    @property
    def input_bytes(self) -> int:
        """Per-device bytes of the caller's input buffer in the plan's
        storage dtype: divided by the first step's shard count for sharded
        plans (the rank's slab of a ``DTensor`` input)."""
        return math.prod(self.shape) * T.itemsize(self.dtype) \
            // self.schedule[0].n_shards

    @property
    def donates(self) -> bool:
        """Always False: ``donate_input`` is recorded but the port's sweep
        never releases or aliases its input."""
        return False

    @property
    def peak_bytes(self) -> int:
        """Modeled (per-device) peak across the sweep.  The sweep never
        donates, so an st-HOSVD sweep keeps the caller's (dead after step 0)
        input alive through every later step: those steps charge
        ``input_bytes`` on top of their own working set (the reference's
        undonated figure).  A leading mode-parallel group counts as step 0:
        every member reads the full input, which its group peak charges."""
        peaks = [s.peak_bytes for s in self.schedule]
        if self.config.variant != "sthosvd" or len(peaks) == 1:
            # t-HOSVD/HOOI read X in (almost) every step — it is already
            # counted in their per-step io
            return max(peaks)
        from .plan import iter_groups
        k0 = len(next(iter_groups(self.schedule)))
        if k0 >= len(peaks):
            return max(peaks)
        return max(max(peaks[:k0]),
                   max(p + self.input_bytes for p in peaks[k0:]))

    @property
    def capped_peak_bytes(self) -> int:
        """The modeled figure ``memory_cap_bytes`` holds: the largest step
        peak, or :attr:`peak_bytes` (the held input on top of every later
        step) when the config says ``donate_input=False`` — the reference's
        cap on donated and undonated plans.  The port never frees the input
        it is given, so on the card the caller's tensor stays beside each
        step either way."""
        if self.config.donate_input is False:
            return self.peak_bytes
        return max(s.peak_bytes for s in self.schedule)

    @property
    def captures(self) -> bool:
        """Whether :meth:`execute` runs this plan's sweep as captured CUDA
        graphs: a fixed-rank plan on CUDA without ``memory_cap_bytes``.  A
        capped plan runs eagerly, so that its cap holds step by step (the
        graphs' private pool and static input would sit beside every step).
        Decided from the plan alone, never from an error."""
        return (self.device.type == "cuda" and not self.is_adaptive
                and self.config.memory_cap_bytes is None
                and self.backend != "sharded")

    @property
    def graph_segments(self) -> int:
        """CUDA graphs a captured sweep of this plan is cut into: one, plus
        one after each call that synchronizes with the host (each EIG/RAND
        step's ``eigh``, each SVD step's ``svd``;
        :data:`repro_torch.core.graphs.HOST_OPS`)."""
        return 1 + sum(G.HOST_OPS[s.method] for s in self.schedule)

    def _cache_key(self, batched: bool, captured: bool) -> tuple:
        # keyed on the RESOLVED per-step backend, not config.impl: two plans
        # whose "auto" resolved identically share one sweep; a captured and
        # an eager sweep of one schedule are distinct entries; sharded plans
        # also key on the mesh, the axis and the frozen shard modes/groups
        return (self.shape, self.dtype,
                tuple((s.mode, s.method, s.r_n, s.backend, s.shard_mode,
                       s.group)
                      for s in self.schedule),
                self.config.variant, self.config.als_iters,
                self.config.compute_dtype, batched, str(self.device),
                captured, self.config.mesh, self.config.resolved_shard_axis)

    def _sweep(self, batched: bool = False, eager: bool = False) -> _Sweep:
        """The cached sweep (``eager=True`` forces the eager one)."""
        captured = self.captures and not eager
        key = self._cache_key(batched, captured)
        fn = _SWEEP_CACHE.get(key)
        if fn is None:
            fn = _SWEEP_CACHE[key] = _Sweep(self, batched, captured)
            CACHE_STATS["builds"] += 1
            _obs.event("cache", status="miss", shape=list(self.shape),
                       dtype=self.dtype, backend=self.backend,
                       variant=self.config.variant, batched=batched,
                       captured=captured)
        else:
            # hits are counted, not published (misses are the informative
            # events), as in the reference
            CACHE_STATS["hits"] += 1
        return fn

    def graph_stats(self) -> dict | None:
        """The captured sweep's segments, host ops, pool bytes and static
        input bytes (:meth:`~repro_torch.core.graphs.CapturedSweep.stats`),
        or None when this plan's sweep is not captured or not built yet."""
        fn = _SWEEP_CACHE.get(self._cache_key(False, True))
        if fn is None or fn.graphs is None or fn.graphs.program is None:
            return None
        return fn.graphs.stats()

    # -- execution -----------------------------------------------------------
    def _place(self, x) -> torch.Tensor:
        """``x`` on the plan's device, checked against its shape and dtype;
        for a sharded plan this rank's slab of it, sharded on the first
        step's shard mode (:func:`repro_torch.core.distributed.local_input`:
        a ``DTensor`` gives its local tensor, a global tensor is narrowed)."""
        x = _as_tensor(x)
        if tuple(x.shape) != self.shape:
            raise InputError(f"plan is for shape {self.shape}, got "
                             f"{tuple(x.shape)}")
        if T.dtype_name(x.dtype) != self.dtype:
            raise InputError(f"plan is for dtype {self.dtype}, got "
                             f"{T.dtype_name(x.dtype)}")
        if self.backend == "sharded":
            _require_mesh(self.config)
            from .distributed import local_input
            return local_input(x, self.config.mesh,
                               self.config.resolved_shard_axis,
                               self.schedule[0].shard_mode, self.device)
        return x.to(self.device).contiguous()

    def execute(self, x, *, record: bool = False, donate: bool | None = None,
                validate: str | None = None) -> SthosvdResult:
        """Run the frozen schedule on ``x`` (a tensor or numpy array of the
        plan's shape and dtype, copied onto the plan's device if needed).

        A fixed-rank plan runs its cached sweep (:meth:`_sweep`): on the
        card, without ``memory_cap_bytes``, as CUDA graphs captured at the
        first execute (:attr:`captures`), whose results come back as clones
        of the graphs' output buffers.  ``record=True`` (or an active
        :func:`repro_torch.tune.recording` context) runs the per-step
        runner that synchronizes the device after every step, so each
        ``ModeTrace.seconds`` is real wall-clock (each step a ``solve``
        span, fed to the drift monitor); the recording context's sink also
        receives the timed trace.  ``donate`` is accepted for the
        reference's signature and ignored (the port never donates).
        ``validate="finite"`` rejects NaN/Inf inputs with
        :class:`~repro_torch.core.errors.InputError` naming the offending
        mode and checks the outputs (raising
        :class:`~repro_torch.core.errors.NumericalError`, which the ladder
        then gets a chance to recover).

        A sharded plan is executed by every rank of its mesh with the same
        arguments; ``x`` is the global tensor or a ``DTensor`` on the mesh
        holding the rank's slab.  Its sweep stays eager (a cached closure
        per plan key); ``record=True`` raises, since the per-step recorded
        runner is single-device (:func:`~repro_torch.core.distributed.sthosvd_distributed`
        times sharded steps), and an active recording context is not fed.

        A rank-adaptive plan runs its sketch pass and then the sketch's own
        result or a fixed-rank refinement (:meth:`_execute_adaptive`), both
        eagerly.  A fixed-rank plan runs under the fallback ladder
        (:func:`_run_with_fallback`): als→eig on a numerical breakdown, a
        replan under a tighter cap with ``mode_order="opt"`` on an
        out-of-memory; each rung at most once, each hop an obs ``fallback``
        event and counted (:func:`fallback_hops`), and the classified error
        re-raised when no rung is left.  A kernel or a capture that fails on
        the card raises: no rung drops to ``matfree``, an eager sweep or the
        CPU.
        """
        del donate
        return self._traced_execute(x, record=record, validate=validate,
                                    eager=False)

    __call__ = execute

    def _traced_execute(self, x, *, record: bool, validate: str | None,
                        eager: bool) -> SthosvdResult:
        if not _obs.enabled():
            return self._execute(x, record=record, validate=validate,
                                 eager=eager)
        attrs = self.__dict__.get("_obs_attrs")
        if attrs is None:
            # static per-plan span attributes, built once: the properties
            # walk the schedule and would otherwise run on every execute
            attrs = self.__dict__["_obs_attrs"] = dict(
                shape=list(self.shape), dtype=self.dtype,
                backend=self.backend, variant=self.config.variant,
                adaptive=self.is_adaptive, device=str(self.device),
                predicted_s=self.total_predicted_s,
                peak_bytes=self.peak_bytes)
        with _obs.span("execute", record=record, **attrs):
            return self._execute(x, record=record, validate=validate,
                                 eager=eager)

    def _execute(self, x, *, record: bool, validate: str | None,
                 eager: bool) -> SthosvdResult:
        if validate not in (None, "none", "finite"):
            raise ValueError(
                f"validate must be None, 'none' or 'finite', got {validate!r}")
        sharded = self.backend == "sharded"
        if record and sharded:
            raise ValueError(
                "record=True needs the per-step recorded runner, which "
                "sharded plans do not have; time sharded steps with "
                "distributed.sthosvd_distributed")
        raw, x = x, self._place(x)
        if validate == "finite":
            if sharded:
                _check_finite_everywhere(x, self.config)
            else:
                check_finite(x, name="input")
        if self.is_adaptive:
            try:
                return self._execute_adaptive(x, record=record)
            except Exception as e:  # noqa: BLE001 - classification is the point
                terr = classify_exception(e)
                if terr is not None and terr is not e:
                    raise terr from e
                raise

        def run(p: "TuckerPlan") -> SthosvdResult:
            sink = None if sharded else _active_sink()
            if record or sink is not None:
                # the recorded runner, never the captured sweep: its steps
                # are what the sink learns from (a fallback hop's degraded
                # plan records the same way)
                res = p._run(x, True)
                if sink is not None:
                    p._feed(sink, res.trace)
            else:
                if not sharded:
                    _chaos.fire("sweep", backend=p.backend)
                # a hop's plan may shard its first step on another mode: x
                # is placed again through that plan
                xp = p._place(raw) if sharded and p is not self else x
                core, factors = p._sweep(eager=eager)(xp)
                if _chaos.active() and _chaos.poison("sweep_out",
                                                     backend=p.backend):
                    core = core * float("nan")
                res = p._result(core, factors, [0.0] * len(p.schedule))
            if validate == "finite":
                check_result_finite(res.tucker.core, res.tucker.factors,
                                    context=f"{p.config.variant} sweep")
            return res

        return _run_with_fallback(self, run)

    def _feed(self, sink, trace) -> None:
        """Hand a timed trace of this plan to a tune sink."""
        sink.add_traces(trace, platform=self.device.type,
                        dtype=self.config.compute_dtype or self.dtype,
                        order=len(self.shape), als_iters=self.config.als_iters)

    def _result(self, core, factors, seconds) -> SthosvdResult:
        trace = [ModeTrace(s.mode, s.method, s.i_n, s.r_n, s.j_n, dt,
                           backend=s.backend, predicted_s=s.predicted_s)
                 for s, dt in zip(self.schedule, seconds)]
        return SthosvdResult(tucker=TuckerTensor(core=core,
                                                 factors=list(factors)),
                             trace=trace, select_overhead_s=0.0)

    def _run(self, x: torch.Tensor, record: bool) -> SthosvdResult:
        """The uncached runners on a placed ``x``: the per-step recorded
        runner, or (``record=False``) the eager sweep — what a captured
        sweep replays, and what an eager cache entry runs."""
        if record:
            cfg = self.config
            if cfg.compute_dtype:
                x = x.to(T.torch_dtype(cfg.compute_dtype))
            core, factors, seconds = self._run_recorded(x)
            return self._result(core, factors, seconds)
        core, factors = _plan_sweep(self)(x)
        return self._result(core, factors, [0.0] * len(self.schedule))

    def _run_recorded(self, x: torch.Tensor):
        """The per-step runner: every mode solve synchronized and timed."""
        cfg = self.config
        steps = self.schedule
        n = len(self.shape)
        if cfg.variant == "sthosvd":
            core, fdict, seconds = run_schedule(
                x, steps, sequential=True, als_iters=cfg.als_iters,
                block_until_ready=True)
            return core, [fdict[m] for m in range(n)], seconds
        if cfg.variant == "thosvd":
            _, fdict, seconds = run_schedule(
                x, steps, sequential=False, als_iters=cfg.als_iters,
                block_until_ready=True)
            factors = [fdict[m] for m in range(n)]
            return project(x, factors, steps[0].backend), factors, seconds
        # hooi: timed init sweep, then timed projected refinements
        _, fdict, seconds = run_schedule(
            x, steps[:n], sequential=True, als_iters=cfg.als_iters,
            block_until_ready=True)
        factors = [fdict[m] for m in range(n)]
        seconds = list(seconds)
        for step in steps[n:]:
            y = project(x, factors, step.backend, skip=step.mode)
            wall0, t0 = time.time(), time.perf_counter()
            res = solve_step(y, step, als_iters=cfg.als_iters)
            if res.u.device.type == "cuda":
                torch.cuda.synchronize(res.u.device)
            seconds.append(time.perf_counter() - t0)
            observe_solve(step, seconds[-1], wall0, x.device.type,
                          step.backend)
            factors[step.mode] = res.u
        return project(x, factors, steps[0].backend), factors, seconds

    # -- rank-adaptive execution ---------------------------------------------
    def resolve_ranks(self, x) -> tuple[tuple[int, ...], float]:
        """Run ONLY the sketch pass on ``x``: the per-mode ranks the policy
        chooses for this input plus the certified relative-error bound —
        without building the decomposition.  Adaptive plans only."""
        if not self.is_adaptive:
            raise ValueError("resolve_ranks needs a rank-adaptive plan "
                             "(TuckerConfig(error_target=...)); this plan's "
                             f"ranks are fixed at {self.config.ranks}")
        ranks, tails, *_ = self._sketch_pass(self._place(x))
        return ranks, math.sqrt(sum(tails.values()))

    def _sketch_pass(self, x: torch.Tensor):
        """The rank-adaptive sweep core: sequential randomized sketches
        (:func:`repro_torch.core.solvers.rand_sketch`) in schedule order,
        reading each mode's rank off its sketched eigenvalue tail.

        Per step, the captured energy of a rank-r truncation of the current
        tensor equals the sum of the top-r eigenvalues of the sketched Gram
        — exact for the factor actually used — so the smallest grid
        candidate whose discarded energy fits the step's budget
        ``tau·||X||²`` is chosen.  ``||X||²`` is the energy measured at step
        0, which makes ``sqrt(Σ_n tail_n)`` of the recorded fractional tails
        a guaranteed relative-error bound via the sequential HOSVD
        inequality.

        The captured energy of each Ritz direction is summed from the
        rotated sketch core ``z = TTM(b, Vᵀ, mode)`` itself
        (:func:`~repro_torch.core.solvers.mode_energies`, float64 across
        runs), not read off the eigenvalues of the fp32 sketched Gram as in
        the reference: over a 3.5e5-deep reduction that Gram's trace is off
        by ~5e-6 of ||X||² on the card, a twentieth of the tail a 1%-noise
        input leaves.  The Gram still gives the rotation; the tail is the
        exact discarded energy of the factor that is used, and the shrunk
        core is the first r slices of z.

        The sketch width is input-adaptive: each mode starts at
        ``max(16, 2·oversample, smallest candidate + oversample)`` and
        doubles only while no candidate ≤ the current width meets the
        budget, up to ``rank cap + oversample`` (capped at I_n).  A narrower
        sketch can only under-capture — the measured tail of the factor it
        yields is still exact — so widening never weakens the guarantee.
        The host reads the eigenvalues and the energy once a width (one
        copy, one synchronization).

        Returns ``(ranks, tails, factors, core, seconds, js, missed)``:
        per-mode chosen ranks and fractional tails, the sketch's own
        orthonormal factors, the shrunk core, per-step wall-clock, the J_n
        each step saw, and the modes whose budget no grid candidate met even
        at the cap width — the miss that triggers the rand→eig hop in
        :meth:`_execute_adaptive`.
        """
        from .solvers import _accum, _sq_norm, mode_energies, rand_sketch
        cfg = self.config
        if cfg.compute_dtype:
            x = x.to(T.torch_dtype(cfg.compute_dtype))
        wdtype = x.dtype
        y = x
        total = None
        chosen: dict[int, int] = {}
        tails: dict[int, float] = {}
        factors: dict[int, torch.Tensor] = {}
        seconds: list[float] = []
        js: list[int] = []
        missed: list[int] = []
        platform = x.device.type
        for s in self.schedule:
            wall0, t0 = time.time(), time.perf_counter()
            _chaos.fire("sketch", mode=s.mode)
            js.append(y.numel() // y.shape[s.mode])
            width_cap = min(s.i_n, s.rank_grid[-1] + cfg.oversample)
            width = min(width_cap, max(16, 2 * cfg.oversample,
                                       s.rank_grid[0] + cfg.oversample))
            ttm = backend_ops(s.backend)[0]
            energy_t = _sq_norm(y.to(_accum(y.dtype)))   # once a mode
            while True:
                q, b, _, vecs, _ = rand_sketch(
                    y, s.mode, width, power_iters=cfg.power_iters,
                    impl=s.backend, energy=energy_t)
                v = vecs.flip(1).to(q.dtype)   # Ritz vectors, descending
                z = ttm(b, v.T, s.mode)        # the rotated sketch core
                host = torch.cat([mode_energies(z, s.mode),
                                  energy_t.reshape(1)]).cpu()
                energy = float(host[-1])
                if total is None:
                    total = energy or 1.0  # step 0: ||X||², the budget basis
                csum = host[:-1].cumsum(0)    # csum[r-1] = top-r captured
                budget = s.tau * total
                r = tail = None
                for cand in s.rank_grid:    # ascending: smallest fit wins
                    if cand > width:
                        break
                    t = max(energy - float(csum[cand - 1]), 0.0)
                    if t <= budget:
                        r, tail = cand, t
                        break
                if r is not None or width >= width_cap:
                    break
                width = min(2 * width, width_cap)
            if r is None:   # no candidate fits even at the cap width: take
                            # the largest grid rank the sketch can express
                r = max(g for g in s.rank_grid if g <= width)
                tail = max(energy - float(csum[r - 1]), 0.0)
                missed.append(s.mode)
            chosen[s.mode], tails[s.mode] = int(r), tail / total
            # top-r Ritz rotation of the range basis; the shrunk core is the
            # first r slices of the rotated sketch — no pass over the input
            factors[s.mode] = (q @ v[:, :r]).to(wdtype)
            y = z.narrow(s.mode, 0, r).contiguous().to(wdtype)
            if y.device.type == "cuda":
                torch.cuda.synchronize(y.device)
            dt = time.perf_counter() - t0
            seconds.append(dt)
            # retroactive span (no enter/exit to leak on solver errors):
            # same shape a live span emits, parented under the execute span
            _obs.event("span", t=wall0, name="sketch", dur_s=dt,
                       mode=s.mode, solver="rand", backend=s.backend,
                       platform=platform, i_n=s.i_n, rank=int(r),
                       tail_err=tail / total, width=int(width), j_n=js[-1],
                       predicted_s=s.predicted_s)
            _drift.MONITOR.observe(platform=platform, backend=s.backend,
                                   solver="rand", predicted_s=s.predicted_s,
                                   actual_s=dt, source="execute")
        ranks = tuple(chosen[m] for m in range(len(self.shape)))
        return ranks, tails, factors, y, seconds, js, missed

    def _execute_adaptive(self, x: torch.Tensor, *,
                          record: bool = False) -> SthosvdResult:
        """Two-phase rank-adaptive execution.

        Phase 1 resolves ranks per mode (:meth:`_sketch_pass`).  Phase 2:
        with ``methods="rand"`` the sketch's own factors and shrunk core ARE
        the result, certified by the measured bound; any other ``methods``
        re-plans at the chosen FIXED ranks and runs the ordinary eig/als
        sweep as refinement, with the sketch time reported as
        ``select_overhead_s`` and the measured per-mode tails riding the
        refined trace as ``tail_err``.  A sketch-only plan that missed a
        mode's budget at the cap width takes the rand→eig hop: it refines
        with exact eig solves at the chosen ranks instead of shipping the
        under-converged sketch, and reports the measured (missed) bound.
        Both phases run eagerly: the ranks, and so the refinement's
        schedule, are chosen per input."""
        cfg = self.config
        ranks, tails, factors, core, seconds, js, missed = \
            self._sketch_pass(x)
        bound = math.sqrt(sum(tails.values()))
        m = cfg.methods
        sketch_only = m == "rand" or \
            (not isinstance(m, str) and all(q == "rand" for q in m))
        hop_methods = None
        if sketch_only and missed:
            hop_methods = "eig"
            sketch_only = False
            _emit_hop(self, "rand_to_eig", modes=[int(mm) for mm in missed])
        if not sketch_only:
            rcfg = replace(cfg, ranks=ranks, error_target=None,
                           rank_grid=None,
                           mode_order=tuple(s.mode for s in self.schedule))
            if hop_methods is not None:
                rcfg = replace(rcfg, methods=hop_methods)
            res = plan(self.shape, self.dtype, rcfg,
                       device=self.device)._traced_execute(
                x, record=record, validate=None, eager=True)
            for t in res.trace:
                t.tail_err = tails[t.mode]
            return SthosvdResult(
                tucker=res.tucker, trace=res.trace,
                select_overhead_s=res.select_overhead_s + sum(seconds),
                error_bound=bound)
        n = len(self.shape)
        trace = [ModeTrace(s.mode, "rand", s.i_n, ranks[s.mode], j, dt,
                           backend=s.backend, predicted_s=s.predicted_s,
                           tail_err=tails[s.mode])
                 for s, j, dt in zip(self.schedule, js, seconds)]
        sink = _active_sink()
        if sink is not None:
            self._feed(sink, trace)
        return SthosvdResult(
            tucker=TuckerTensor(core=core,
                                factors=[factors[mm] for mm in range(n)]),
            trace=trace, select_overhead_s=0.0, error_bound=bound)

    def execute_batch(self, xs, *,
                      donate: bool | None = None) -> list[SthosvdResult]:
        """Decompose a fleet of same-shaped tensors (leading batch axis);
        returns one result per batch element.

        The fleet runs item by item through one cached sweep (the hand
        kernels are called through ctypes and do not vectorize), keyed
        apart from :meth:`execute`'s as the reference keys its vmapped
        program: on the card it is captured once and replayed per item.
        Rank-adaptive plans run :meth:`execute` per item, since the policy
        may choose different ranks per tensor.  ``donate`` is accepted for
        the reference's signature and ignored."""
        del donate
        return self._execute_lanes(xs, keep_errors=False)

    def _execute_lanes(self, xs, *, keep_errors: bool) -> list:
        """:meth:`execute_batch` item by item; with ``keep_errors`` an item
        that raises yields its exception in its place and the other items
        still run (the serve service's per-lane failure isolation: one
        poisoned lane of a fused wave fails alone)."""
        xs = _as_tensor(xs)
        if tuple(xs.shape[1:]) != self.shape:
            raise ValueError(f"plan is for batches of shape {self.shape}, "
                             f"got {tuple(xs.shape)}")
        if T.dtype_name(xs.dtype) != self.dtype:
            raise ValueError(f"plan is for dtype {self.dtype}, got "
                             f"{T.dtype_name(xs.dtype)}")
        xs = xs.to(self.device).contiguous()
        if self.is_adaptive or self.backend == "sharded":
            # adaptive: the policy may choose other ranks per tensor;
            # sharded: each item is placed onto the mesh by execute
            run = self.execute
        else:
            fn = self._sweep(batched=True)
            zeros = [0.0] * len(self.schedule)

            def run(x):
                ((core, factors),) = fn(x[None])
                return self._result(core, factors, zeros)
        out = []
        for b in range(xs.shape[0]):
            try:
                out.append(run(xs[b]))
            except Exception as e:  # noqa: BLE001 - kept per lane on request
                if not keep_errors:
                    raise
                out.append(e)
        return out

    # -- derivation ----------------------------------------------------------
    def for_shape(self, shape: Sequence[int], *,
                  selector: Callable[..., str] | None = None,
                  keep_methods: bool = False) -> "TuckerPlan":
        """This plan's config/dtype re-planned at a different ``shape``, on
        the same device — the plan-reuse hook for shape buckets.

        By default the selector and mode order re-resolve against the new
        per-mode problem sizes, so the derived plan is indistinguishable
        from ``plan(shape, self.dtype, self.config)`` (same schedule, same
        cached sweep).  ``keep_methods=True`` instead pins this plan's
        resolved per-mode solvers and frozen sweep order onto the new
        shape: zero selector calls, at the price of solver choices tuned
        for this plan's shape, not the new one's."""
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(self.shape):
            raise ValueError(
                f"plan is for an order-{len(self.shape)} tensor; cannot "
                f"derive an order-{len(shape)} plan (shape {shape})")
        if shape == self.shape:
            return self
        cfg = self.config
        if keep_methods:
            order = tuple(s.mode for s in self.schedule[:len(self.shape)])
            if self.is_adaptive:
                # the policy IS the method; pin only the sweep order
                # (config.methods stays the refinement solver choice)
                cfg = replace(cfg, mode_order=order)
            else:
                cfg = replace(cfg, methods=self.methods, mode_order=order)
        return plan(shape, self.dtype, cfg, selector=selector,
                    device=self.device)

    # -- reporting -----------------------------------------------------------
    def describe(self) -> str:
        """Human-readable plan report (the reference's text): the frozen
        schedule in execution order with modeled cost and peak per step,
        the rank policy of an adaptive plan, plus the totals, donation
        policy, and memory cap.  A plan that :attr:`captures` also names
        each step's CUDA graph segment (a step whose solver synchronizes
        with the host spans two)."""
        cfg = self.config
        cap = cfg.memory_cap_bytes
        head = (f"error_target={cfg.error_target:g} (rank-adaptive)"
                if self.is_adaptive else f"ranks {cfg.ranks}")
        lines = [
            f"TuckerPlan {self.shape} {self.dtype} -> {head} "
            f"[{cfg.variant}, backend={self.backend}]",
            f"  mode_order={cfg.mode_order!r}  "
            + (f"mode_parallel={cfg.mode_parallel!r}  "
               if cfg.mode_parallel != "off" else "")
            + f"memory_cap_bytes={cap if cap is not None else 'uncapped'}  "
            f"donate_input={'auto' if cfg.donate_input is None else cfg.donate_input}"
            " (resolves: undonated)",
        ]
        if self.is_adaptive:
            lines.append(
                f"  rank policy: tau²={self.schedule[0].tau:.3g}·||X||² "
                f"per mode  oversample={cfg.oversample}  "
                f"power_iters={cfg.power_iters}  "
                "(steps sized at grid caps; ranks resolve per input)")
        if self.captures:
            lines.append(
                f"  cuda graphs: {self.graph_segments} segment(s); each "
                "eigh/svd runs eagerly between two")
        per_dev = any(s.n_shards > 1 for s in self.schedule)
        if self.backend == "sharded":
            lines.append(
                f"  mesh={mesh_spec(cfg.mesh)}  "
                f"shard_axis={cfg.resolved_shard_axis!r}  "
                f"local_backend={self.local_backend}")
        seg = 0
        for k, s in enumerate(self.schedule):
            pred = f"  pred={s.predicted_s * 1e3:.3f}ms" if s.predicted_s \
                else ""
            pol = (f"  grid={s.rank_grid[0]}..{s.rank_grid[-1]}"
                   f"({len(s.rank_grid)})"
                   if s.rank_grid is not None else "")
            shard = f"  shard_mode={s.shard_mode}/{s.n_shards}" \
                if per_dev else ""
            grp = f"  ∥group={s.group}" if s.group is not None else ""
            graph = ""
            if self.captures:
                last = seg + G.HOST_OPS[s.method]
                graph = (f"  graph={seg}" if last == seg
                         else f"  graphs={seg}-{last}")
                seg = last
            lines.append(
                f"  step {k}: mode {s.mode} {s.method:>3s}  "
                f"I={s.i_n} R={s.r_n} J={s.j_n}  "
                f"flops={s.flops:.3g}  peak={s.peak_bytes:,}B"
                f"{shard}{grp}{pol}{pred}{graph}")
        total_pred = self.total_predicted_s
        lines.append(
            f"  total: flops={self.total_flops:.3g}  "
            f"peak={self.peak_bytes:,}B"
            + (" (per device)" if per_dev else "")
            + (f"  predicted={total_pred * 1e3:.3f}ms" if total_pred else "")
            + (f"  cap_headroom={cap - self.capped_peak_bytes:,}B"
               if cap is not None else ""))
        return "\n".join(lines)

    # -- persistence (the reference's schema) --------------------------------
    def to_dict(self) -> dict:
        return {"version": PLAN_FORMAT_VERSION, "shape": list(self.shape),
                "dtype": self.dtype, "config": self.config.to_dict(),
                "schedule": [s.to_dict() for s in self.schedule],
                "select_seconds": self.select_seconds}

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d: dict, *, device=None) -> "TuckerPlan":
        """Rebuild a plan from its dict; ``device`` as in :func:`plan`
        (None = ``cuda:0``, raising without CUDA)."""
        if d.get("version", 1) > PLAN_FORMAT_VERSION:
            raise ValueError(f"plan format {d['version']} newer than supported "
                             f"{PLAN_FORMAT_VERSION}")
        config = TuckerConfig.from_dict(d["config"])
        return cls(shape=tuple(d["shape"]), dtype=T.dtype_name(d["dtype"]),
                   config=config,
                   schedule=tuple(ModeStep.from_dict(s) for s in d["schedule"]),
                   select_seconds=d.get("select_seconds", 0.0),
                   device=resolve_device(device, mesh=config.mesh))

    @classmethod
    def from_json(cls, s: str, *, device=None) -> "TuckerPlan":
        return cls.from_dict(json.loads(s), device=device)

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_json())

    @classmethod
    def load(cls, path: str | Path, *, device=None) -> "TuckerPlan":
        return cls.from_json(Path(path).read_text(), device=device)


# ---------------------------------------------------------------------------
# plan / decompose
# ---------------------------------------------------------------------------

def _resolve_rank_policy(shape: tuple[int, ...],
                         config: TuckerConfig) -> tuple[tuple, tuple]:
    """Per-mode candidate grids + sizing caps for a rank-adaptive config.

    The cap (each step's ``r_n`` — what scratch/peak modeling and the
    schedule DP see) is the largest candidate: ``ranks`` when given, else
    the grid maximum, else the full mode dimension.  A flat int
    ``rank_grid`` is one shared grid applied to every mode; a tuple of
    tuples is per-mode.  Candidates are deduplicated, clamped to
    ``[1, cap]``, and sorted ascending — the execute-time budget check
    walks them smallest-first."""
    n = len(shape)
    rg = config.rank_grid
    if rg is not None and all(isinstance(g, int) for g in rg):
        rg = tuple(rg for _ in range(n))
    if rg is not None and len(rg) != n:
        raise ValueError(f"rank_grid has {len(rg)} mode entries for an "
                         f"order-{n} tensor of shape {shape}")
    if config.ranks is not None and len(config.ranks) != n:
        raise ValueError(f"ranks {config.ranks} do not match order-{n} "
                         f"shape {shape}")
    grids = []
    for m in range(n):
        hi = shape[m] if config.ranks is None \
            else max(1, min(int(config.ranks[m]), shape[m]))
        if rg is None:
            g = tuple(range(1, hi + 1))
        else:
            g = tuple(sorted({max(1, min(int(r), hi)) for r in rg[m]}))
        grids.append(g)
    return tuple(grids), tuple(g[-1] for g in grids)


def _plan_adaptive(shape: tuple[int, ...], dtype: str, config: TuckerConfig,
                   device: torch.device) -> "TuckerPlan":
    """Rank-adaptive planning: freeze a rank POLICY, not ranks.

    The schedule is sized at each mode's rank CAP (see
    :func:`_resolve_rank_policy`) — the conservative figure for scratch
    modeling and ``memory_cap_bytes`` — with every step pinned to the
    ``rand`` sketch solver.  ``mode_order="opt"`` runs the schedule DP with
    the rank grid as its third decision axis, so the sweep order is chosen
    for the policy, not just the caps.  Each step then carries its
    ``rank_grid`` and the equi-partitioned HOSVD budget share
    ``tau = error_target²/N``; the actual ranks resolve per input at
    execute time (:meth:`TuckerPlan._sketch_pass`)."""
    n = len(shape)
    compute_dtype = T.dtype_name(config.compute_dtype or dtype)
    backend = resolve_backend(config.impl, platform=device.type,
                              dtype=compute_dtype, shape=shape)
    if not backend.supports_solver("rand"):
        raise ValueError(f"backend {backend.name!r} cannot run the 'rand' "
                         "sketch solver rank-adaptive plans are built on "
                         f"(capabilities: {backend.solvers})")
    grids, caps = _resolve_rank_policy(shape, config)
    from .selector import default_selector
    cost_model = default_selector(device.type,
                                  backend=backend.name).cost_model
    t0 = time.perf_counter()
    mode_order = config.mode_order
    if mode_order == "opt":
        from .schedule_opt import optimize_schedule
        mode_order = optimize_schedule(
            shape, caps, methods=["rand"] * n, als_iters=config.als_iters,
            itemsize=T.itemsize(compute_dtype), cost_model=cost_model,
            memory_cap_bytes=config.memory_cap_bytes,
            rank_grid=grids, backend=backend.name,
            n_sms=_device_sms(device)).order
    schedule = resolve_schedule(
        shape, caps, variant="sthosvd", methods="rand",
        mode_order=mode_order, als_iters=config.als_iters,
        itemsize=T.itemsize(compute_dtype), backend=backend.name,
        platform=device.type, cost_model=cost_model,
        memory_cap_bytes=config.memory_cap_bytes,
        n_sms=_device_sms(device))
    tau = float(config.error_target) ** 2 / n
    schedule = tuple(replace(s, rank_grid=grids[s.mode], tau=tau)
                     for s in schedule)
    return TuckerPlan(shape=shape, dtype=dtype, config=config,
                      schedule=schedule,
                      select_seconds=time.perf_counter() - t0,
                      device=device)


def _device_sms(device: torch.device) -> int | None:
    """The SM count of a CUDA ``device``, which sizes a ``hopper`` step's
    split-K workspace in its ``peak_bytes``; None for the CPU, where the
    plan sizes it for the H100 SXM's 132 SMs
    (:data:`repro_torch.core.plan.H100_SMS`)."""
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).multi_processor_count


def plan(shape: Sequence[int], dtype, config: TuckerConfig, *,
         selector: Callable[..., str] | None = None,
         device=None) -> TuckerPlan:
    """Resolve ``config`` against a concrete (shape, dtype) → ``TuckerPlan``.

    All selector/cost-model queries happen here, against the statically
    known per-mode problem sizes, and ``config.impl`` (possibly ``"auto"``)
    is resolved through the backend registry against the device's platform
    (``"cuda"`` or ``"cpu"``) and the compute dtype; ``TuckerPlan.execute``
    never selects or resolves again.  ``dtype`` is a name (``"float32"``),
    a ``torch.dtype`` or a numpy dtype.  ``device`` None means ``cuda:0``
    and raises when CUDA is not available.

    A config with ``error_target=`` routes to rank-adaptive planning
    (:func:`_plan_adaptive`): the plan freezes a rank policy and sweep
    order; per-mode ranks resolve per input at execute time.

    With a mesh (``impl="sharded"``, or ``"auto"`` when one is attached)
    the shard-mode schedule is frozen here too — per-step shard modes,
    reshard points, mode-parallel groups and per-device ``peak_bytes`` —
    and ``device`` None is the rank's current CUDA device; the selector and
    the memory model are the rank's local backend's
    (:attr:`TuckerPlan.local_backend`).

    ``memory_cap_bytes`` holds every step's modeled peak (the schedule
    search and :func:`~repro_torch.core.schedule_opt.validate_schedule_cap`);
    with ``donate_input=False`` the plan must also fit with the held input
    beside every later step (:attr:`TuckerPlan.capped_peak_bytes`), as the
    reference's undonated plans must.

    The call is spanned as ``plan`` on the obs bus.
    """
    if not _obs.enabled():
        return _plan(shape, dtype, config, selector=selector, device=device)
    with _obs.span("plan", shape=[int(s) for s in shape],
                   dtype=T.dtype_name(dtype), impl=config.impl,
                   variant=config.variant,
                   mode_order=str(config.mode_order),
                   adaptive=config.error_target is not None) as sp:
        p = _plan(shape, dtype, config, selector=selector, device=device)
        sp.set(backend=p.backend, n_steps=len(p.schedule),
               methods=list(p.methods), select_s=p.select_seconds,
               predicted_s=p.total_predicted_s, peak_bytes=p.peak_bytes,
               device=str(p.device))
        return p


def _plan(shape: Sequence[int], dtype, config: TuckerConfig, *,
          selector: Callable[..., str] | None = None,
          device=None) -> TuckerPlan:
    shape = tuple(int(s) for s in shape)
    dtype = T.dtype_name(dtype)
    device = resolve_device(device, mesh=config.mesh)
    if config.error_target is not None:
        return _plan_adaptive(shape, dtype, config, device)
    platform = device.type
    compute_dtype = T.dtype_name(config.compute_dtype or dtype)
    backend = resolve_backend(config.impl, platform=platform,
                              dtype=compute_dtype, shape=shape,
                              mesh=config.mesh)
    sharded = backend.requires_mesh
    if sharded and config.variant != "sthosvd":
        raise ValueError(f"backend {backend.name!r} supports variant "
                         f"'sthosvd' only, got {config.variant!r}")
    # a sharded plan's ranks compute on their device's own backend, which
    # is what its selector and its memory model are for
    local = local_backend(platform, compute_dtype, shape) if sharded else None
    sel_backend = local if sharded else backend.name
    # selector resolution sees the RESOLVED backend: a per-backend trained
    # model outranks the platform-pooled one, and its embedded (possibly
    # calibrated) cost model prices the schedule either way
    from .selector import default_selector
    timed = None
    if config.methods == "auto":
        if selector is None:
            selector = default_selector(platform, backend=sel_backend)
        selector = timed = TimedSelector(selector)
    cost_model = getattr(selector, "cost_model", None) or \
        default_selector(platform, backend=sel_backend).cost_model
    mp = config.mode_parallel
    if not sharded and mp not in ("off", "auto", 1):
        raise ValueError(
            f"mode_parallel={mp} needs a sharded backend (attach a mesh); "
            f"impl resolved to {backend.name!r}")
    schedule = resolve_schedule(
        shape, config.ranks, variant=config.variant, methods=config.methods,
        mode_order=config.mode_order, selector=selector,
        als_iters=config.als_iters, hooi_iters=config.hooi_iters,
        itemsize=T.itemsize(compute_dtype), backend=backend.name,
        platform=platform, n_shards=config.n_shards if sharded else 1,
        cost_model=cost_model, memory_cap_bytes=config.memory_cap_bytes,
        mode_parallel=mp if sharded else "off",
        n_sms=_device_sms(device), local_backend=local)
    p = TuckerPlan(shape=shape, dtype=dtype, config=config,
                   schedule=schedule,
                   select_seconds=timed.seconds if timed else 0.0,
                   device=device)
    cap = config.memory_cap_bytes
    if cap is not None and p.capped_peak_bytes > cap:
        # every step fits, but the held input does not fit beside them
        from .schedule_opt import MemoryCapError
        raise MemoryCapError(
            f"schedule fits memory_cap_bytes={cap:,} per step, but the "
            f"undonated sweep's modeled peak is {p.peak_bytes:,} bytes — "
            f"the caller-held input copy ({p.input_bytes:,} bytes) rides on "
            "every step after the first; raise the cap")
    return p


# ---------------------------------------------------------------------------
# Execute-time fallback ladder
# ---------------------------------------------------------------------------

#: the metrics-registry counter of the ladder's hops, labeled by hop
#: (``als_to_eig``, ``replan_cap``, the adaptive ``rand_to_eig``) and backend
HOPS_METRIC = "atucker_fallback_hops_total"


def _hop_counter() -> _metrics.Counter:
    return _metrics.REGISTRY.counter(
        HOPS_METRIC, "execute-time fallback ladder hops, by rung")


def fallback_hops() -> dict[tuple[str, str], int]:
    """The ladder's hop counts in this process, keyed (hop, backend): a view
    of the registry's ``atucker_fallback_hops_total`` counter."""
    out = {}
    for labels, v in _hop_counter().series().items():
        d = dict(labels)
        out[(d["hop"], d["backend"])] = int(v)
    return out


def reset_fallback_hops() -> None:
    """Zero the registry's hop counter."""
    _hop_counter().clear()


def _emit_hop(p: TuckerPlan, name: str, err: BaseException | None = None,
              **fields) -> None:
    """One ladder hop: an obs ``fallback`` event and a count in the
    registry (``err`` names the failure that triggered it)."""
    if err is not None:
        fields["error"] = type(err).__name__
    _obs.event("fallback", hop=name, **fields, shape=list(p.shape),
               backend=p.backend)
    _hop_counter().inc(hop=name, backend=p.backend)


def _replan_safe(p: TuckerPlan, cfg: TuckerConfig) -> TuckerPlan | None:
    """Plan a ladder hop's degraded config, or None when the hop itself
    cannot be planned (e.g. the tighter cap admits no schedule) — the
    ladder then gives up rather than masking the original failure with a
    planning error."""
    try:
        return plan(p.shape, p.dtype, cfg, device=p.device)
    except ValueError:   # MemoryCapError included
        return None


def _agreed_on_mesh(p: TuckerPlan, err: BaseException) -> bool:
    """Whether every rank of a sharded plan's mesh raised ``err``'s class
    together: a :class:`~repro_torch.core.distributed.MeshError`, or any
    failure when the shard axis has one rank."""
    from .distributed import MeshError, ShardAxis
    if isinstance(err, MeshError):
        return True
    return ShardAxis.of(p.config.mesh, p.config.resolved_shard_axis).size == 1


def _next_hop(p: TuckerPlan, err: BaseException,
              applied: list[str]) -> tuple[str, TuckerPlan] | None:
    """The next ladder rung for a classified failure, or None when the
    ladder is exhausted.  Each rung applies at most once, in a fixed order,
    so the ladder is bounded and deterministic.

    The reference's ``pallas_to_matfree`` rung has no counterpart (a kernel
    that fails on the card raises), and its ``donate_off`` rung has nothing
    to turn off (the port never donates).

    A sharded plan takes a rung only on a failure every rank of its mesh
    agreed on (:class:`~repro_torch.core.distributed.MeshError`, raised
    alike on every rank, or any failure on a one-rank mesh): its rung is
    then chosen from the agreed class, and the degraded plan is planned
    the same way on every rank (planning is deterministic given the plan),
    so every rank pairs its new plan's collectives with its peers'.  A
    failure the mesh did not agree on re-raises."""
    cfg = p.config
    if p.backend == "sharded" and not _agreed_on_mesh(p, err):
        return None
    if isinstance(err, NumericalError):
        if "als_to_eig" not in applied and \
                any(s.method == "als" for s in p.schedule):
            methods = tuple("eig" if m == "als" else m for m in p.methods)
            p2 = _replan_safe(p, replace(cfg, methods=methods))
            if p2 is not None:
                return "als_to_eig", p2
        return None
    if isinstance(err, ResourceError) and "replan_cap" not in applied:
        # replan the whole sweep under a tighter cap
        current = cfg.memory_cap_bytes or p.capped_peak_bytes
        cap = max(1, int(0.75 * current))
        p2 = _replan_safe(p, replace(cfg, memory_cap_bytes=cap,
                                     mode_order="opt"))
        if p2 is not None:
            return "replan_cap", p2
    return None


def _run_with_fallback(p0: TuckerPlan,
                       run: Callable[[TuckerPlan], SthosvdResult]
                       ) -> SthosvdResult:
    """Drive ``run(plan)`` through the fallback ladder: classify each
    failure, degrade one rung at a time, re-raise the classified error once
    no rung remains.  Input-side failures (bad input, deadline,
    cancellation) never hop — retrying cannot fix the caller's data."""
    p = p0
    applied: list[str] = []
    while True:
        try:
            return run(p)
        except Exception as e:  # noqa: BLE001 - classification is the point
            if isinstance(e, (InputError, DeadlineError, CancelledError)):
                raise
            terr = classify_exception(e)
            hop = _next_hop(p, terr if terr is not None else e, applied)
            if hop is None:
                if terr is not None and terr is not e:
                    raise terr from e
                raise
            name, p2 = hop
            applied.append(name)
            _emit_hop(p, name, terr if terr is not None else e)
            p = p2


def decompose(x, config: TuckerConfig, *,
              selector: Callable[..., str] | None = None,
              device=None) -> SthosvdResult:
    """One-shot convenience: ``plan(x.shape, x.dtype, config).execute(x)``.
    ``device`` None means the device of a CUDA tensor ``x``, else
    ``cuda:0``."""
    x = _as_tensor(x)
    if device is None and x.device.type == "cuda":
        device = x.device
    return plan(x.shape, x.dtype, config, selector=selector,
                device=device).execute(x)
