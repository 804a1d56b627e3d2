"""Distributed st-HOSVD for tensors sharded across a ``torch.distributed``
device mesh (the TuckerMPI pattern) — the execution engine behind the
``sharded`` ops backend.

The port of ``repro/core/distributed.py``.  JAX's mesh is single-controller;
here every rank runs the same program (SPMD) on its own slab:

  * Gram (mode n ≠ shard mode m): each rank contracts its local slab — the
    shard axis lies inside the contraction — giving a *partial* I_n×I_n
    Gram; one ``all_reduce`` over the shard axis's process group completes
    it.  The ALS iterate's TTT and R-tensor Gram are partial sums the same
    way; the solvers take the local backend's ops triple with ``gram`` and
    ``ttt`` wrapped to all-reduce (:func:`sharded_ops`).
  * eigh/QR on the replicated small matrices run redundantly on every rank.
  * TTM (mode n ≠ m): local; the output stays sharded on m.
  * Before a step whose frozen shard mode differs, the tensor is resharded
    (:func:`_reshard`): one ``all_to_all_single`` between two shard modes,
    a ``narrow`` from replicated, an ``all_gather`` to replicated.

Each rank computes its slab with its device's own backend (``hopper`` on
CUDA, ``matfree`` on the CPU: :func:`repro_torch.core.backend.local_backend`).
The collectives are ones NCCL and gloo both have on CUDA tensors:
``all_reduce``, ``all_to_all_single`` and list-form ``all_gather``; chunks
are ordered by the rank in the shard axis's group.  A collective that
fails raises; nothing here drops to one device.

The distribution decisions (which mode each step shards, where reshards
land, mode-parallel groups) are frozen at plan time by
:func:`repro_torch.core.plan.resolve_schedule` via :func:`pick_shard_mode`;
this module only executes frozen schedules:

  * :func:`run_sharded_schedule` — per-step runner with real per-mode
    wall-clock, ``solve`` spans and drift observations (the legacy
    :func:`sthosvd_distributed` entry point).
  * :func:`sweep_sharded` / :func:`sweep_mode_parallel` — the same schedule
    without timing, which ``TuckerPlan``'s sweep cache keeps as an eager
    closure per plan key.  Every member of a mode-parallel group computes
    its factor from the SAME un-shrunk slab; the group's EIG Grams are
    all-reduced in ONE collective over a flat buffer (one barrier for the
    group), then a chain of local TTMs truncates every group mode.

The result's factors are replicated on every rank, and its core is
all-gathered to every rank as a plain tensor (the reference leaves the
core sharded on its last shard mode).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..obs import drift as _drift
from ..obs import trace as _obs
from . import graphs as G
from .backend import backend_ops
from .plan import ModeStep, iter_groups, solve_step
from .solvers import DEFAULT_ALS_ITERS, _accum, als_solve, eig_solve
from .sthosvd import ModeTrace, SthosvdResult, TuckerTensor


def pick_shard_mode(shape: tuple[int, ...], exclude: int,
                    n_shards: int) -> int | None:
    """Largest mode ≠ ``exclude`` divisible by the shard count; None → the
    (shrunk) tensor no longer shards evenly and is cheap enough to replicate
    — st-HOSVD's sequential shrinking makes the late modes tiny."""
    return pick_shard_mode_group(shape, (exclude,), n_shards)


def pick_shard_mode_group(shape: tuple[int, ...], exclude,
                          n_shards: int) -> int | None:
    """Largest mode outside ``exclude`` (an iterable of modes) divisible by
    the shard count.  A mode-parallel group's shard mode must lie OUTSIDE
    the group: the Gram of the sharded mode itself would need an all-gather,
    so a group covering every shardable mode runs replicated (``None``) —
    the memory model prices exactly that, which is how a per-device cap can
    refuse an all-modes group."""
    excluded = frozenset(exclude)
    for m in sorted(range(len(shape)), key=lambda m: -shape[m]):
        if m not in excluded and shape[m] % n_shards == 0:
            return m
    return None


# ---------------------------------------------------------------------------
# The shard axis and its collectives
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShardAxis:
    """The mesh axis a sharded run splits over: its process group, its size
    and this process's rank in it (chunks are ordered by that rank)."""
    group: object
    size: int
    rank: int

    @classmethod
    def of(cls, mesh, axis: str) -> "ShardAxis":
        group = mesh.get_group(axis)
        return cls(group=group, size=dist.get_world_size(group),
                   rank=dist.get_rank(group))


#: per-kind count of collective calls and bytes sent through them in this
#: process (``seconds`` only inside :func:`timed_collectives`)
_STATS: dict[str, dict[str, float]] = {}
_TIMED = [False]


def collective_stats() -> dict[str, dict[str, float]]:
    """``{kind: {"calls", "bytes", "seconds"}}`` of the collectives this
    process issued since :func:`reset_collective_stats`: ``bytes`` is what
    this rank put in (an ``all_reduce``'s buffer, an ``all_to_all``'s slab,
    an ``all_gather``'s slab)."""
    return {k: dict(v) for k, v in _STATS.items()}


def reset_collective_stats() -> None:
    _STATS.clear()


@contextmanager
def timed_collectives():
    """Time every collective issued inside the block: the device is
    synchronized before and after each one, so ``collective_stats()``'s
    ``seconds`` hold the collective alone (a measurement aid: it serializes
    the sweep)."""
    _TIMED[0] = True
    try:
        yield
    finally:
        _TIMED[0] = False


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _collective(kind: str, t: torch.Tensor, fn, *args, **kw) -> None:
    """Run one collective ``fn`` whose payload is ``t`` on this rank,
    counting it (and timing it inside :func:`timed_collectives`)."""
    st = _STATS.setdefault(kind, {"calls": 0, "bytes": 0, "seconds": 0.0})
    st["calls"] += 1
    st["bytes"] += t.numel() * t.element_size()
    if not _TIMED[0]:
        fn(*args, **kw)
        return
    _sync(t)
    t0 = time.perf_counter()
    fn(*args, **kw)
    _sync(t)
    st["seconds"] += time.perf_counter() - t0


def all_reduce(t: torch.Tensor, ax: ShardAxis) -> torch.Tensor:
    """Sum ``t`` over the shard axis in place (a contiguous copy first if
    it is not) and return it."""
    t = t.contiguous()
    if ax.size > 1:
        _collective("all_reduce", t, dist.all_reduce, t, group=ax.group)
    return t


def _reshard(y: torch.Tensor, old: int | None, new: int | None,
             ax: ShardAxis) -> torch.Tensor:
    """Move this rank's ``y`` (sharded on mode ``old``; None = replicated)
    to mode ``new``.  Between two shard modes it is one
    ``all_to_all_single``: every rank splits its slab along ``new`` (moved
    to the front and made contiguous) and joins the chunks it receives along
    ``old`` in group-rank order.  From replicated it is a local ``narrow``;
    to replicated a list-form ``all_gather``."""
    k, r = ax.size, ax.rank
    if old == new or k == 1:
        return y
    if old is None:
        c = y.shape[new] // k
        return y.narrow(new, r * c, c).contiguous()
    y = y.contiguous()
    if new is None:
        parts = [torch.empty_like(y) for _ in range(k)]
        _collective("all_gather", y, dist.all_gather, parts, y,
                    group=ax.group)
        return torch.cat(parts, dim=old)
    n = y.ndim
    yt = y.movedim(new, 0).contiguous()
    out = torch.empty_like(yt)
    _collective("all_to_all", yt, dist.all_to_all_single, out, yt,
                group=ax.group)
    del yt
    c = out.shape[0] // k
    # out is (k, c, *the other dims of y in order): chunk j came from rank
    # j and holds rank j's part of mode ``old``; one permutation puts every
    # dim back in place with the source rank just outside ``old``
    out = out.reshape(k, c, *out.shape[1:])

    def pos(d):   # where y's dim d (≠ new) sits in out
        return (d + 1 if d < new else d) + 1

    perm: list[int] = []
    shape: list[int] = []
    for d in range(n):
        if d == new:
            perm.append(1)
            shape.append(c)
        elif d == old:
            perm += [0, pos(d)]
            shape.append(k * y.shape[d])
        else:
            perm.append(pos(d))
            shape.append(y.shape[d])
    return out.permute(perm).contiguous().reshape(shape)


def sharded_ops(local: str, ax: ShardAxis):
    """The local backend's ``(ttm, gram, ttt)`` with ``gram`` and ``ttt``
    all-reducing their fp32 (or wider) partial sums over the shard axis —
    what the EIG and ALS solvers run on a slab sharded on a mode other than
    the one being solved (every Gram/TTT then contracts over the shard
    mode; every TTM stays local)."""
    ttm, gram, ttt = backend_ops(local)

    def pgram(x, mode):
        return all_reduce(gram(x, mode), ax)

    def pttt(x, y, mode):
        return all_reduce(ttt(x, y, mode), ax)

    return ttm, pgram, pttt


# ---------------------------------------------------------------------------
# Frozen-schedule execution
# ---------------------------------------------------------------------------

def _eig_u(s: torch.Tensor, r_n: int, dtype) -> torch.Tensor:
    """Top-r_n eigvecs of a (replicated) Gram, descending, in ``dtype``."""
    _, vecs = G.eigh(s.to(_accum(s.dtype)))
    return vecs[:, -r_n:].flip(1).to(dtype)


def solve_step_sharded(y: torch.Tensor, placed: int | None, step: ModeStep,
                       ax: ShardAxis, local: str, *,
                       als_iters: int = DEFAULT_ALS_ITERS):
    """One frozen mode solve on the mesh: reshard this rank's ``y`` (sharded
    on ``placed``) to the step's recorded shard mode, then run its solver's
    collective schedule on the ``local`` backend.  Returns ``(u, y_new)``
    with ``u`` replicated and ``y_new`` sharded on ``step.shard_mode``."""
    return _step_on_slab(_reshard(y, placed, step.shard_mode, ax), step, ax,
                         local, als_iters)


def _step_on_slab(y, step, ax, local, als_iters):
    """:func:`solve_step_sharded` on a ``y`` already sharded on the step's
    shard mode."""
    if step.shard_mode is None:
        # replicated: every rank runs the plain local solve
        res = solve_step(y, step, als_iters=als_iters, impl=local)
        return res.u, res.y_new
    ops = sharded_ops(local, ax)
    if step.method == "eig":
        res = eig_solve(y, step.mode, step.r_n, impl=ops)
    elif step.method == "als":
        res = als_solve(y, step.mode, step.r_n, num_iters=als_iters,
                        impl=ops)
    else:
        raise ValueError(f"unknown distributed method {step.method!r}")
    return res.u, res.y_new


def solve_group_sharded(y: torch.Tensor, placed: int | None, group,
                        ax: ShardAxis, local: str, *,
                        als_iters: int = DEFAULT_ALS_ITERS):
    """One frozen mode-parallel group on the mesh: every member's factor is
    computed from the SAME un-shrunk slab — all EIG members' partial Grams
    all-reduced in ONE collective over a flat buffer, ALS members on the
    all-reducing ops against the shared input — then a chain of local TTMs
    truncates every group mode.  Returns ``(factors, y_new)`` with
    ``factors`` keyed by mode and ``y_new`` sharded on the group's shard
    mode."""
    return _group_on_slab(_reshard(y, placed, group[0].shard_mode, ax),
                          group, ax, local, als_iters)


def _group_on_slab(y, group, ax, local, als_iters):
    """:func:`solve_group_sharded` on a ``y`` already sharded on the
    group's shard mode."""
    for step in group:
        if step.method not in ("eig", "als"):
            raise ValueError(
                f"method {step.method!r} cannot run in a mode-parallel "
                "group (plan-time resolution should have rejected it)")
    shard = group[0].shard_mode   # one shard mode serves the whole group
    ttm, gram, _ = backend_ops(local)
    factors: dict[int, torch.Tensor] = {}
    if shard is None:
        # replicated group (it covered every shardable mode): local Grams /
        # ALS on the full tensor
        for step in group:
            if step.method == "eig":
                factors[step.mode] = _eig_u(gram(y, step.mode), step.r_n,
                                            y.dtype)
            else:
                factors[step.mode] = als_solve(y, step.mode, step.r_n,
                                               num_iters=als_iters,
                                               impl=local).u
    else:
        eig_steps = [s for s in group if s.method == "eig"]
        if eig_steps:
            grams = [gram(y, s.mode) for s in eig_steps]
            flat = all_reduce(torch.cat([g.reshape(-1) for g in grams]), ax)
            for s, g in zip(eig_steps,
                            flat.split([g.numel() for g in grams])):
                factors[s.mode] = _eig_u(g.view(s.i_n, s.i_n), s.r_n,
                                         y.dtype)
            del grams, flat
        ops = sharded_ops(local, ax)
        for step in group:
            if step.method == "als":
                factors[step.mode] = als_solve(y, step.mode, step.r_n,
                                               num_iters=als_iters,
                                               impl=ops).u
    for step in group:
        y = ttm(y, factors[step.mode].T, step.mode)
    return factors, y


def _solve_batch(y, batch, ax, local, als_iters):
    """One entry of :func:`iter_groups` on a ``y`` already sharded on its
    shard mode: ``(factors, y_new)``."""
    if len(batch) == 1:
        u, y = _step_on_slab(y, batch[0], ax, local, als_iters)
        return {batch[0].mode: u}, y
    return _group_on_slab(y, batch, ax, local, als_iters)


def _sweep_batches(x, steps, ax: ShardAxis, local: str, placed: int | None,
                   als_iters: int, on_batch=None):
    """THE sharded sweep loop, shared by every runner: for each entry of
    :func:`iter_groups`, reshard this rank's tensor to the entry's shard
    mode, then solve it.  The tensor is rebound after the reshard, so the
    one before it is freed before the solve allocates (the step's modeled
    peak holds one slab beside the caller's ``x``).  ``on_batch(batch, y)``
    runs after each entry with its output (the per-step runner's timing
    hook; it must not keep ``y``).  Returns ``(core, factors)``: the core
    all-gathered to every rank, the factors keyed by mode."""
    y = x
    factors: dict[int, torch.Tensor] = {}
    for batch in iter_groups(steps):
        y = _reshard(y, placed, batch[0].shard_mode, ax)
        placed = batch[0].shard_mode
        fs, y = _solve_batch(y, batch, ax, local, als_iters)
        factors.update(fs)
        if on_batch is not None:
            on_batch(batch, y)
    return _reshard(y, placed, None, ax), factors


def run_sharded_schedule(x: torch.Tensor, steps, mesh, axis: str, *,
                         local: str, placed: int | None = None,
                         als_iters: int = DEFAULT_ALS_ITERS,
                         block_until_ready: bool = True):
    """Per-step runner with real wall-clock per mode on this rank's slab
    ``x`` (sharded on ``placed``).

    Mode-parallel groups run as one unit; their wall-clock is attributed
    evenly across the members so ``seconds`` stays index-aligned with
    ``steps``.  With ``block_until_ready`` the device is synchronized after
    every step and each is spanned as ``solve`` (``backend="sharded"``,
    ``n_shards``, ``group``) and fed to the drift monitor.  Returns
    ``(core, factors, seconds)`` like
    :func:`repro_torch.core.plan.run_schedule` (``factors`` keyed by mode),
    with the core all-gathered to every rank."""
    seconds: list[float] = []
    platform = x.device.type
    clock = [time.time(), time.perf_counter()]

    def on_batch(batch, y):
        if block_until_ready:
            _sync(y)
        wall0, t0 = clock
        dt = time.perf_counter() - t0
        seconds.extend([dt / len(batch)] * len(batch))
        if block_until_ready:
            for s in batch:
                _obs.event("span", t=wall0, name="solve",
                           dur_s=dt / len(batch), mode=s.mode,
                           solver=s.method, backend="sharded",
                           platform=platform, rank=s.r_n, i_n=s.i_n,
                           j_n=s.j_n, n_shards=s.n_shards,
                           group=s.group, predicted_s=s.predicted_s)
                _drift.MONITOR.observe(platform=platform, backend="sharded",
                                       solver=s.method,
                                       predicted_s=s.predicted_s,
                                       actual_s=dt / len(batch),
                                       source="execute")
        clock[:] = [time.time(), time.perf_counter()]

    core, factors = _sweep_batches(x, steps, ShardAxis.of(mesh, axis), local,
                                   placed, als_iters, on_batch)
    return core, factors, seconds


def sweep_sharded(x, steps, *, mesh, axis: str, local: str,
                  placed: int | None = None, als_iters: int):
    """The sequential sharded sweep: :func:`sweep_mode_parallel` on a
    schedule without mode-parallel groups."""
    if any(s.group is not None for s in steps):
        raise ValueError("sweep_sharded runs sequential schedules; a "
                         "schedule with groups runs sweep_mode_parallel")
    return sweep_mode_parallel(x, steps, mesh=mesh, axis=axis, local=local,
                               placed=placed, als_iters=als_iters)


def sweep_mode_parallel(x, steps, *, mesh, axis: str, local: str,
                        placed: int | None = None, als_iters: int):
    """The sharded sweep on this rank's slab ``x`` (sharded on ``placed``):
    ``(core, factors)``, the core all-gathered to every rank and the
    factors (replicated) in mode order.  Steps sharing a ``group`` id run
    as one mode-parallel group (:func:`solve_group_sharded`)."""
    core, factors = _sweep_batches(x, steps, ShardAxis.of(mesh, axis), local,
                                   placed, als_iters)
    return core, [factors[m] for m in range(x.ndim)]


# ---------------------------------------------------------------------------
# Input placement (shared with TuckerPlan.execute)
# ---------------------------------------------------------------------------

def _placement_of(x, mesh, axis: str) -> int | None:
    """The tensor mode a ``DTensor`` on ``mesh`` is sharded on along
    ``axis`` (None = replicated there); every other mesh axis must
    replicate it."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    shard = None
    for name, p in zip(names, x.placements):
        if isinstance(p, Shard) and name == axis:
            shard = p.dim
        elif not isinstance(p, Replicate):
            raise ValueError(
                f"DTensor placement {p} on mesh axis {name!r}: a sharded "
                f"plan takes a tensor sharded on {axis!r} only (Shard or "
                "Replicate there, Replicate elsewhere)")
    return shard


def local_input(x, mesh, axis: str, shard: int | None,
                device: torch.device) -> torch.Tensor:
    """This rank's slab of ``x`` sharded on ``shard`` (None = the whole
    tensor): a ``DTensor`` on ``mesh`` gives its local tensor, moved through
    :func:`_reshard` when it is sharded on another mode; any other tensor
    (or array) is the global tensor, the same on every rank, and the rank
    narrows its slab out of it before moving it to ``device``, so a host
    tensor larger than one card still places."""
    from torch.distributed.tensor import DTensor
    from .api import _as_tensor
    ax = ShardAxis.of(mesh, axis)
    if isinstance(x, DTensor):
        placed = _placement_of(x, mesh, axis)
        if placed is not None and x.shape[placed] % ax.size:
            raise ValueError(
                f"DTensor sharded unevenly: mode {placed} of {tuple(x.shape)}"
                f" over {ax.size} ranks")
        y = x.to_local().to(device)
        return _reshard(y.contiguous(), placed, shard, ax)
    x = _as_tensor(x)
    return _reshard(x, None, shard, ax).to(device).contiguous()


# ---------------------------------------------------------------------------
# Legacy entry point — thin wrapper over the shared schedule machinery
# ---------------------------------------------------------------------------

def sthosvd_distributed(
    x,
    ranks,
    mesh,
    *,
    axis: str = "data",
    methods: str = "eig",
    als_iters: int = DEFAULT_ALS_ITERS,
    selector=None,
    mode_order=None,
    memory_cap_bytes: int | None = None,
    mode_parallel: str | int = "off",
    block_until_ready: bool = True,
    device=None,
) -> SthosvdResult:
    """Distributed flexible st-HOSVD.  ``methods``: 'eig' | 'als' | 'auto'.

    ``x`` is the global tensor (the same on every rank) or a ``DTensor`` on
    ``mesh``; ``mesh`` a ``DeviceMesh`` with a ``mesh_dim_names`` axis
    ``axis``.  ``mode_order="opt"`` runs the subset-DP schedule search
    against the PER-DEVICE peak model; ``memory_cap_bytes`` is the
    per-device cap.  ``mode_parallel`` ("off" | "auto" | int) opts steps
    into mode-parallel groups — see
    :func:`repro_torch.core.plan.resolve_schedule`.  ``device`` None means
    the device of a CUDA ``x``, else the rank's current CUDA device (raising
    without CUDA); pass ``device="cpu"`` to run on the CPU.

    Thin wrapper over the shared plan machinery: the per-mode solver AND
    shard-mode schedule is resolved ahead of time
    (``resolve_schedule(..., backend="sharded")``), then run per step with
    real wall-clock in the trace.  For repeated execution build a plan:
    ``plan(shape, dtype, TuckerConfig(..., impl="sharded", mesh=mesh))``.
    """
    from torch.distributed.tensor import DTensor
    from . import tensor_ops as T
    from .api import _as_tensor, _device_sms, resolve_device
    from .backend import local_backend
    from .plan import TimedSelector, resolve_schedule

    if not isinstance(x, DTensor):
        x = _as_tensor(x)
        if device is None and x.device.type == "cuda":
            device = x.device
    dev = resolve_device(device, mesh=mesh)
    local = local_backend(dev.type, x.dtype, tuple(x.shape))
    timed = None
    if methods == "auto":
        if selector is None:
            from .selector import default_selector
            selector = default_selector(dev.type, backend=local)
        selector = timed = TimedSelector(selector)
    n_shards = mesh.size(tuple(mesh.mesh_dim_names).index(axis))
    schedule = resolve_schedule(
        tuple(x.shape), ranks, variant="sthosvd", methods=methods,
        selector=selector, mode_order=mode_order, als_iters=als_iters,
        itemsize=T.itemsize(x.dtype), backend="sharded",
        platform=dev.type, n_shards=n_shards,
        memory_cap_bytes=memory_cap_bytes, mode_parallel=mode_parallel,
        n_sms=_device_sms(dev), local_backend=local)
    first = schedule[0].shard_mode
    y = local_input(x, mesh, axis, first, dev)
    core, factors, seconds = run_sharded_schedule(
        y, schedule, mesh, axis, local=local, placed=first,
        als_iters=als_iters, block_until_ready=block_until_ready)
    trace = [ModeTrace(s.mode, s.method, s.i_n, s.r_n, s.j_n, dt,
                       backend=s.backend, predicted_s=s.predicted_s)
             for s, dt in zip(schedule, seconds)]
    tucker = TuckerTensor(core=core,
                          factors=[factors[m] for m in range(len(x.shape))])
    return SthosvdResult(tucker=tucker, trace=trace,
                         select_overhead_s=timed.seconds if timed else 0.0)


__all__ = [
    "ShardAxis", "all_reduce", "collective_stats", "local_input",
    "pick_shard_mode", "pick_shard_mode_group",
    "reset_collective_stats", "run_sharded_schedule", "sharded_ops",
    "solve_group_sharded", "solve_step_sharded", "sthosvd_distributed",
    "sweep_mode_parallel", "sweep_sharded", "timed_collectives",
]
