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

A failure on one rank ends the sweep on every rank (the reference is
single-controller, so its fallback ladder degrades the whole mesh at
once; here every rank must leave its collectives together).  Every
collective of a sweep carries one extra element: this rank's failure code
(0 ok, 1 numerical, 2 resource, 3 other, as base-256 digits so that the
sum over ranks keeps the largest code).  The order of a sweep's
collectives and the size and dtype of each follow from the plan alone
(:func:`planned_collectives`): the schedule fixes every reshard and every
solver's all-reduces (one Gram for EIG, a TTT and a Gram per ALS
iteration, one flat buffer for a group's EIG Grams), the shapes shrink by
the schedule's ranks, and no collective depends on the data.  So every
rank runs the same sequence, and a rank that fails between two
collectives knows the next one: it issues it with zeros of the planned
size and its code (:class:`_Link`), every rank reads the code in that
same collective, and all of them leave the sweep there with the same
classified error (:class:`MeshError` of the agreed code).  No rank waits
on a peer that has left, and no collective runs after the one that
carried the code.  The plan-time check holds every collective of a
healthy sweep to its planned kind, size and dtype.
"""

from __future__ import annotations

import math
import threading
import time
import traceback
from contextlib import contextmanager
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .. import chaos as _chaos
from ..obs import drift as _drift
from ..obs import trace as _obs
from . import graphs as G
from .backend import backend_ops
from .errors import (NumericalError, ResourceError, TuckerError,
                     classify_exception)
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


# ---------------------------------------------------------------------------
# Agreement on a rank-local failure
# ---------------------------------------------------------------------------

#: failure codes the sweep's collectives carry; the largest over ranks wins
OK, NUMERICAL, RESOURCE, OTHER = 0, 1, 2, 3
#: ranks a shard axis may have for the codes' base-256 digits to stay exact
#: in an fp32 sum (255 · 256² < 2²⁴)
MAX_AGREEING_RANKS = 255


class MeshError(TuckerError):
    """A sharded sweep ended on every rank of its mesh because a rank
    failed.  ``code`` is the agreed failure code (the largest over the
    ranks); the failing rank chains its own error."""

    code = OTHER


class MeshNumericalError(MeshError, NumericalError):
    code = NUMERICAL


class MeshResourceError(MeshError, ResourceError):
    code = RESOURCE


def mesh_error(code: int, what: str) -> MeshError:
    """The classified error every rank raises for an agreed ``code``."""
    cls = {NUMERICAL: MeshNumericalError,
           RESOURCE: MeshResourceError}.get(code, MeshError)
    kind = {NUMERICAL: "numerical", RESOURCE: "resource"}.get(code, "other")
    return cls(f"sharded sweep ended on every rank: a rank failed ({kind}) "
               f"before {what}")


def failure_code(exc: BaseException) -> int:
    """The code of a rank's own failure: its class in the taxonomy."""
    t = classify_exception(exc)
    if isinstance(t, NumericalError):
        return NUMERICAL
    if isinstance(t, ResourceError):
        return RESOURCE
    return OTHER


def _digit(code: int) -> float:
    return 0.0 if code == OK else float(256 ** (code - 1))


def _agreed(total: float) -> int:
    """The largest code in a sum of :func:`_digit` contributions."""
    v = int(round(total))
    return OTHER if v >= 256 ** 2 else RESOURCE if v >= 256 else \
        NUMERICAL if v >= 1 else OK


def planned_collectives(shape, dtype, steps, n_shards: int,
                        placed: int | None, als_iters: int,
                        local: str) -> list[tuple[str, int, torch.dtype]]:
    """The collectives a sweep of ``steps`` issues on each rank, in order:
    ``(kind, payload elements, dtype)``, the payload without the flag
    element.  Reshards move this rank's slab of the current shape (an
    ``all_to_all`` between shard modes, an ``all_gather`` to replicated, a
    local narrow from it); each step sharded on a mode all-reduces its
    solver's partial sums in the accumulation dtype (EIG the I_n² Gram, ALS
    per iteration the (I_n, R_n) TTT and the R_n² Gram, a group its EIG
    Grams in one flat buffer); the core is all-gathered last.  y keeps its
    dtype through a lone ALS (or RAND, SVD) step and takes the local TTM's
    output dtype (fp32 on ``hopper``) through EIG steps and groups."""
    if n_shards == 1:
        return []
    acc = torch.promote_types(dtype, torch.float32)
    ydt, cur, out = dtype, list(shape), []

    def reshard(old, new):
        if old != new and old is not None:
            out.append(("all_to_all" if new is not None else "all_gather",
                        math.prod(cur) // n_shards, ydt))

    for batch in iter_groups(steps):
        shard = batch[0].shard_mode
        reshard(placed, shard)
        placed = shard
        if shard is not None:
            eig = [s.i_n ** 2 for s in batch if s.method == "eig"]
            if eig:
                out.append(("all_reduce", sum(eig), acc))
            for s in batch:
                if s.method == "als":
                    out += [("all_reduce", s.i_n * s.r_n, acc),
                            ("all_reduce", s.r_n ** 2, acc)] * als_iters
        if (len(batch) > 1 or batch[0].method == "eig") and local == "hopper":
            ydt = torch.float32
        for s in batch:
            cur[s.mode] = s.r_n
    reshard(placed, None)
    return out


class _Link:
    """One sweep's agreement: the collectives it has left (in plan order)
    and, as a context manager around the sweep, the handling of this
    rank's own failure: join the next planned collective with zeros and
    the failure's code, then leave with the agreed :class:`MeshError`."""

    _local = threading.local()

    def __init__(self, plan, ax: ShardAxis, device):
        self.plan, self.ax, self.device, self.pos = plan, ax, device, 0

    @classmethod
    def current(cls) -> "_Link | None":
        stack = getattr(cls._local, "stack", None)
        return stack[-1] if stack else None

    def expect(self, kind: str, numel: int, dtype) -> None:
        """Hold a collective about to run to the plan."""
        if self.pos >= len(self.plan) or self.plan[self.pos] != \
                (kind, numel, dtype):
            want = self.plan[self.pos] if self.pos < len(self.plan) else None
            raise RuntimeError(
                f"sharded sweep: collective {self.pos} is {(kind, numel, dtype)}"
                f", the plan has {want}")

    def __enter__(self):
        if self.ax.size > MAX_AGREEING_RANKS:
            raise ValueError(f"a shard axis of {self.ax.size} ranks exceeds "
                             f"the {MAX_AGREEING_RANKS} that agree on a fault")
        stack = self._local.__dict__.setdefault("stack", [])
        stack.append(self)
        return self

    def __exit__(self, typ, exc, tb):
        self._local.stack.pop()
        if exc is None or isinstance(exc, MeshError) or \
                not isinstance(exc, Exception) or self.pos >= len(self.plan):
            # clean, already agreed, or no collective left to carry it
            return False
        # the failed step's frames still hold what it allocated (after an
        # OOM, up to the cap): drop their locals and the allocator's cache,
        # so that the join's buffer fits where the healthy collective's did
        traceback.clear_frames(tb)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        kind, numel, dtype = self.plan[self.pos]
        raise mesh_error(self.join(kind, numel, dtype, failure_code(exc)),
                         f"{kind} {self.pos}") from exc

    def join(self, kind: str, numel: int, dtype, code: int) -> int:
        """Issue the planned collective with a zero payload and ``code``;
        returns the agreed code."""
        k, dev = self.ax.size, self.device
        if kind == "all_reduce":
            buf = torch.zeros(numel + 1, dtype=dtype, device=dev)
            buf[numel] = _digit(code)
            _collective(kind, buf, dist.all_reduce, buf, group=self.ax.group)
            return _agreed(float(buf[numel]))
        if kind == "all_to_all":
            buf = torch.zeros((k, numel // k + 1), dtype=dtype, device=dev)
            buf[:, -1] = _digit(code)
            got = torch.empty_like(buf)
            _collective(kind, buf, dist.all_to_all_single, got, buf,
                        group=self.ax.group)
            return _agreed(float(got[:, -1].double().sum()))
        buf = torch.zeros(numel + 1, dtype=dtype, device=dev)
        buf[numel] = _digit(code)
        parts = [torch.empty_like(buf) for _ in range(k)]
        _collective(kind, buf, dist.all_gather, parts, buf,
                    group=self.ax.group)
        return _agreed(sum(float(q[numel]) for q in parts))


class Decisions:
    """Rank 0's decisions for every rank of a mesh, and the ranks'
    agreements on their own failures, over a gloo process group of their
    own on CPU tensors (so a decision never queues behind a CUDA
    collective of a sweep).

    The group is created collectively by the constructor: every process
    of the default group must construct its ``Decisions`` at the same
    point of its program (``dist.new_group``'s rule).  Each of its
    collectives gives up after ``timeout_s`` with an error, so a rank that
    stops answering fails its peers instead of hanging them; :meth:`close`
    releases the group (locally).  ``leader`` is the mesh's first rank.
    :meth:`send` (the leader) and :meth:`recv` (every other rank) carry one
    message, a list of ints, in two broadcasts (its length, then its body);
    :meth:`agree` takes the largest of one code a rank, :meth:`agree_lanes`
    the largest and the smallest of a vector a rank, elementwise."""

    def __init__(self, mesh, timeout_s: float):
        import datetime
        ranks = sorted(int(r) for r in mesh.mesh.flatten().tolist())
        self.group = dist.new_group(
            ranks, backend="gloo",
            timeout=datetime.timedelta(seconds=timeout_s))
        self.root = ranks[0]
        self.leader = dist.get_rank() == self.root

    def close(self) -> None:
        if self.group is not None:
            dist.destroy_process_group(self.group)
            self.group = None

    def send(self, msg: list[int]) -> None:
        n = torch.tensor([len(msg)], dtype=torch.int64)
        dist.broadcast(n, src=self.root, group=self.group)
        if msg:
            dist.broadcast(torch.tensor(msg, dtype=torch.int64),
                           src=self.root, group=self.group)

    def recv(self) -> list[int]:
        n = torch.zeros(1, dtype=torch.int64)
        dist.broadcast(n, src=self.root, group=self.group)
        if not int(n):
            return []
        body = torch.zeros(int(n), dtype=torch.int64)
        dist.broadcast(body, src=self.root, group=self.group)
        return body.tolist()

    def agree(self, code: int) -> int:
        """The largest ``code`` over the ranks (:data:`OK` when all are)."""
        t = torch.tensor([code], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return int(t)

    def agree_lanes(self, codes: list[int]) -> tuple[list[int], list[int]]:
        """(largest, smallest) of each entry of ``codes`` over the ranks,
        in one collective."""
        t = torch.tensor(list(codes) + [-c for c in codes], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        n = len(codes)
        return t[:n].tolist(), [-c for c in t[n:].tolist()]


def _flagged(kind: str, payload: torch.Tensor, issue, read) -> None:
    """Run one collective of the sweep in progress: hold it to the plan,
    ``issue()`` it, then ``read()`` the sum of the ranks' codes and raise
    the agreed :class:`MeshError` when a rank failed."""
    link = _Link.current()
    if link is not None:
        link.expect(kind, payload.numel(), payload.dtype)
    issue()
    if link is not None:
        link.pos += 1
    code = _agreed(read())
    if code != OK:
        raise mesh_error(code, f"{kind} {link.pos - 1 if link else ''}")


def partial_sums(shape, dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(buf, t)``: a buffer for partial sums that :func:`all_reduce` sums
    in place -- ``t`` (``shape``) is its payload, which the solver's op
    writes, and the element after it carries the failure code."""
    n = math.prod(shape)
    buf = torch.empty(n + 1, dtype=dtype, device=device)
    buf[n] = 0.0
    return buf, buf[:n].view(shape)


def all_reduce(t: torch.Tensor, ax: ShardAxis,
               buf: torch.Tensor | None = None) -> torch.Tensor:
    """Sum ``t`` over the shard axis and return it, in one collective that
    carries the failure code's element after the payload: in place when
    ``t`` is the payload of ``buf`` (:func:`partial_sums`), else over a copy
    of ``t`` with the element appended (a small tensor)."""
    if ax.size == 1:
        return t
    n = t.numel()
    if buf is None:
        buf, payload = partial_sums(t.shape, t.dtype, t.device)
        payload.copy_(t)
        t = payload
    _flagged("all_reduce", t, lambda: _collective(
        "all_reduce", buf, dist.all_reduce, buf, group=ax.group),
        lambda: float(buf[n]))
    return t


def _reshard(y: torch.Tensor, old: int | None, new: int | None,
             ax: ShardAxis) -> torch.Tensor:
    """Move this rank's ``y`` (sharded on mode ``old``; None = replicated)
    to mode ``new``.  Between two shard modes it is one
    ``all_to_all_single``: every rank splits its slab along ``new`` (moved
    to the front) into a send buffer of one row a rank, each row ending in
    the failure code's element, and joins the chunks it receives along
    ``old`` in group-rank order.  From replicated it is a local ``narrow``;
    to replicated a list-form ``all_gather`` of the slab and its code,
    into buffers (and the concatenation's output) allocated before it."""
    k, r = ax.size, ax.rank
    if old == new or k == 1:
        return y
    if old is None:
        c = y.shape[new] // k
        return y.narrow(new, r * c, c).contiguous()
    y = y.contiguous()
    n = y.numel()
    if new is None:
        send = torch.empty(n + 1, dtype=y.dtype, device=y.device)
        send[:n].copy_(y.view(-1))
        send[n] = 0.0
        parts = [torch.empty_like(send) for _ in range(k)]
        shape = list(y.shape)
        shape[old] *= k
        out = torch.empty(shape, dtype=y.dtype, device=y.device)
        _flagged("all_gather", y, lambda: _collective(
            "all_gather", send, dist.all_gather, parts, send, group=ax.group),
            lambda: sum(float(q[n]) for q in parts))
        return torch.cat([q[:n].view(y.shape) for q in parts], dim=old,
                         out=out)
    c = y.shape[new] // k
    others = [y.shape[d] for d in range(y.ndim) if d != new]
    send = torch.empty((k, n // k + 1), dtype=y.dtype, device=y.device)
    send[:, :-1].view(k, c, *others).copy_(
        y.movedim(new, 0).unflatten(0, (k, c)))
    send[:, -1] = 0.0
    got = torch.empty_like(send)
    _flagged("all_to_all", y, lambda: _collective(
        "all_to_all", send, dist.all_to_all_single, got, send,
        group=ax.group), lambda: float(got[:, -1].double().sum()))
    del send
    # got is (k, c·others + 1): row j came from rank j and holds rank j's
    # part of mode ``old``; one permutation puts every dim back in place
    # with the source rank just outside ``old``
    out = got[:, :-1].view(k, c, *others)

    def pos(d):   # where y's dim d (≠ new) sits in out
        return (d + 1 if d < new else d) + 1

    perm: list[int] = []
    shape: list[int] = []
    for d in range(y.ndim):
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
        i = x.shape[mode]
        buf, z = partial_sums((i, i), _sum_dtype(x), x.device)
        return all_reduce(gram(x, mode, z), ax, buf)

    def pttt(x, y, mode):
        buf, z = partial_sums((x.shape[mode], y.shape[mode]), _sum_dtype(x),
                              x.device)
        return all_reduce(ttt(x, y, mode, z), ax, buf)

    return ttm, pgram, pttt


def _sum_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype of the partial sums the local ops return for ``x``."""
    return torch.promote_types(x.dtype, torch.float32)


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
    shard mode.  Fires the chaos seam ``"solve"`` first, as the
    single-device runner does for each step."""
    _chaos.fire("solve", mode=step.mode, method=step.method)
    if step.shard_mode is None:
        # replicated: every rank runs the plain local solve
        res = solve_step(y, step, als_iters=als_iters, impl=local)
        return res.u, res.y_new
    ops = sharded_ops(local, ax)
    if step.method == "eig":
        res = eig_solve(y, step.mode, step.r_n, impl=ops)
    elif step.method == "als":
        res = als_solve(y, step.mode, step.r_n, num_iters=als_iters,
                        impl=ops, cols=step.j_n)
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
    for step in group:
        _chaos.fire("solve", mode=step.mode, method=step.method)
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
            sizes = [s.i_n ** 2 for s in eig_steps]
            buf, flat = partial_sums((sum(sizes),), _sum_dtype(y), y.device)
            grams = [g.view(s.i_n, s.i_n)
                     for s, g in zip(eig_steps, flat.split(sizes))]
            for s, g in zip(eig_steps, grams):
                gram(y, s.mode, g)
            all_reduce(flat, ax, buf)
            for s, g in zip(eig_steps, grams):
                factors[s.mode] = _eig_u(g, s.r_n, y.dtype)
            del grams, flat, buf
        ops = sharded_ops(local, ax)
        for step in group:
            if step.method == "als":
                factors[step.mode] = als_solve(y, step.mode, step.r_n,
                                               num_iters=als_iters,
                                               impl=ops, cols=step.j_n).u
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
                   als_iters: int, on_batch=None, on_start=None):
    """THE sharded sweep loop, shared by every runner: for each entry of
    :func:`iter_groups`, reshard this rank's tensor to the entry's shard
    mode, then solve it.  The tensor is rebound after the reshard, so the
    one before it is freed before the solve allocates (the step's modeled
    peak holds one slab beside the caller's ``x``).  ``on_batch(batch, y)``
    runs after each entry with its output (the per-step runner's timing
    hook; it must not keep ``y``); ``on_start()`` runs first, inside the
    agreement (a plan's ``"sweep"`` chaos seam).  Returns ``(core, factors)``: the core
    all-gathered to every rank, the factors keyed by mode.  A failure on
    any rank ends the loop on every rank with the same :class:`MeshError`
    (:class:`_Link`)."""
    y = x
    factors: dict[int, torch.Tensor] = {}
    # the plan is of the global shape: x is this rank's slab of it
    shape = tuple(d * ax.size if m == placed else d
                  for m, d in enumerate(x.shape))
    plan = planned_collectives(shape, x.dtype, steps, ax.size, placed,
                               als_iters, local)
    with _Link(plan, ax, x.device):
        if on_start is not None:
            on_start()
        for batch in iter_groups(steps):
            y = _reshard(y, placed, batch[0].shard_mode, ax)
            placed = batch[0].shard_mode
            fs, y = _solve_batch(y, batch, ax, local, als_iters)
            factors.update(fs)
            if on_batch is not None:
                on_batch(batch, y)
        core = _reshard(y, placed, None, ax)
    return core, factors


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
                        placed: int | None = None, als_iters: int,
                        on_start=None):
    """The sharded sweep on this rank's slab ``x`` (sharded on ``placed``):
    ``(core, factors)``, the core all-gathered to every rank and the
    factors (replicated) in mode order.  Steps sharing a ``group`` id run
    as one mode-parallel group (:func:`solve_group_sharded`);
    ``on_start()`` runs first, inside the agreement on a rank's failure."""
    core, factors = _sweep_batches(x, steps, ShardAxis.of(mesh, axis), local,
                                   placed, als_iters, on_start=on_start)
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
    "MeshError", "MeshNumericalError", "MeshResourceError", "ShardAxis",
    "all_reduce", "collective_stats", "failure_code", "local_input",
    "mesh_error", "pick_shard_mode", "pick_shard_mode_group",
    "planned_collectives",
    "reset_collective_stats", "run_sharded_schedule", "sharded_ops",
    "solve_group_sharded", "solve_step_sharded", "sthosvd_distributed",
    "sweep_mode_parallel", "sweep_sharded", "timed_collectives",
]
