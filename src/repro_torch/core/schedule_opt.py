"""Plan-time schedule search: DP-optimal mode order + solver choice under a
memory cap (the paper's GPU OOM regime).

st-HOSVD cost is dominated by the order modes are processed in — shrinking a
high-compression mode first collapses J_n for every later step — and the key
structural fact is that the (I_n, R_n, J_n) triple a mode sees depends only
on the *set* of modes already processed (and the ranks they shrank to), not
on their sequence.  That makes the search space a lattice of 2^N subsets
instead of N! sequences, so an exact Held–Karp-style DP is cheap for any
realistic tensor order:

  state    = subset S of already-shrunk modes, encoded as the bit-mask
             ``mask`` (bit m set ⇔ mode m already shrunk); transitions only
             ever SET bits, so iterating masks in ascending integer order
             is a valid topological order of the lattice
  value(S) = min total predicted cost of reaching S, held in
             ``best[mask] = (cost, flops, prev_mask, group, assign, rks,
             cur)`` — cost is the latency objective, flops the
             lexicographic tie-break, ``prev_mask`` the back-pointer the
             winning schedule is reconstructed from, ``group``/``assign``/
             ``rks`` the modes/solvers/ranks of the transition that reached
             this state, and ``cur`` the current (partially shrunk) dims
  edge     = processing mode m ∉ S with solver q at rank r, priced by the
             (possibly calibrated) :class:`~repro_torch.core.cost_model.CostModel`
             — predicted seconds when calibrated, Eq. 4/5 FLOPs otherwise —
             and gated by ``memory_cap_bytes`` against the same per-device
             ``_step_peak_bytes`` model the plan layer stamps on every step
             (a transition whose modeled peak exceeds the cap is simply
             never relaxed, so infeasible schedules are pruned *during*
             the sweep rather than checked after)

The DP jointly picks the mode ORDER, the per-step SOLVER, and — when a
``rank_grid`` supplies per-mode candidates — the per-step RANK: a cap below
EIG's I_n² Gram scratch can force the slower-but-smaller ALS iterate (or
vice versa — ALS's fp32 input cast can be the binding buffer for sub-fp32
inputs), exactly the trade the paper's OOM regime demands.  For sharded
plans the per-state shard participation follows :func:`pick_shard_mode` on
the state's shrunken shape, so different orders genuinely see different
per-device peaks — the DP searches over shard participation implicitly
through the order.

The RANK axis (error-targeted planning, ROADMAP "randomized sketching"):
``rank_grid[m]`` lists ascending candidate ranks for mode m, and each
sequential transition tries every (solver, rank) pair, the chosen rank
propagating into every later step's J_n through ``cur``.  With the shipped
cost models — monotone in rank for every solver — the per-mode argmin is
always the smallest candidate admissible under the cap, so the axis's value
is exact J_n propagation and cap gating at the *chosen* ranks (a tight cap
can rule out a larger rank the executor might want; the DP detects that at
plan time instead of shipping cap-priced steps that cannot run).  The
chosen ranks come back in :attr:`ScheduleSearch.ranks`.  Rank-adaptive
plans (``TuckerConfig(error_target=...)``) use this to order their sketch
pass; the rank the *executor* finally settles on is read off the sketch's
singular-value tail at run time (:func:`repro_torch.core.solvers.rand_sketch`).

With ``max_group > 1`` the DP also searches MODE-PARALLEL GROUPS: a
transition may shrink a whole set of modes at once, modeling the sharded
runner's concurrent-Gram path (all members' Grams from the same un-shrunk
tensor, one fused multi-TTM truncation).  A group edge is priced as the
``max`` of its members' step costs — latency, not work — while a FLOPs sum
is kept as the lexicographic tie-break so sequential execution wins exact
ties (it never does more work).  A group's modeled peak charges the shared
full-size input once plus every member's solver scratch CONCURRENTLY
(:func:`repro_torch.core.plan._group_peak_bytes`), so a
``memory_cap_bytes`` that admits each mode alone can still force a group to
split.

Entry points:

  * :func:`optimize_schedule` — the DP; returns the optimal order + per-step
    methods (+ grouping when ``max_group > 1``) + predicted total.  Raises
    :class:`MemoryCapError` naming the binding step/group when no complete
    schedule fits the cap.
  * :func:`optimize_grouping` — grouping-only segmentation DP along a FIXED
    mode order (explicit ``mode_order`` with ``mode_parallel="auto"``).
  * :func:`validate_schedule_cap` — post-hoc cap check for schedules whose
    order was fixed by the caller (explicit ``mode_order``, t-HOSVD, HOOI
    refinement sweeps); same error contract.

Used by :func:`repro_torch.core.plan.resolve_schedule` when
``mode_order="opt"`` / ``memory_cap_bytes`` flow in from ``TuckerConfig``.
Pure Python.  Each search is spanned on the obs bus (:mod:`repro_torch.obs`)
as in the reference: ``plan.dp_search`` and ``plan.dp_grouping``.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from itertools import combinations, product
from typing import Sequence

from ..obs import trace as _obs
from .cost_model import DEFAULT_COST_MODEL, CostModel
from .errors import ResourceError
from .solvers import DEFAULT_ALS_ITERS

#: solvers the optimizer may choose between when methods are not pinned.
#: SVD is deliberately excluded — it is never the predicted-best solver and
#: always matricizes (plan it explicitly if you want the baseline).  RAND is
#: excluded from the *default* set too (its accuracy depends on the spectrum,
#: which the DP cannot see); pass ``search_methods=("eig", "als", "rand")``
#: to let sketch FLOPs compete, or pin it per mode via ``methods``.
SEARCH_METHODS = ("eig", "als")


class MemoryCapError(ResourceError, ValueError):
    """No schedule satisfies ``memory_cap_bytes``; the message names the
    binding step (mode, solver, problem size, modeled bytes).  Part of the
    classified-failure taxonomy (a :class:`~repro_torch.core.errors.ResourceError`)
    while still a ``ValueError`` for pre-taxonomy call sites."""


@dataclass(frozen=True)
class ScheduleSearch:
    """Result of the subset DP: the optimal order, the solver chosen for
    each position of that order, the predicted total cost (seconds for a
    calibrated cost model, FLOPs otherwise), and how many lattice states
    were expanded (diagnostics / tune harvesting).  ``groups`` partitions
    ``order`` into consecutive mode-parallel groups (all singletons for a
    purely sequential schedule; empty for legacy callers that never asked
    the DP to consider grouping).  ``ranks`` is the rank chosen for each
    position of ``order`` — equal to the caller's fixed ranks unless a
    ``rank_grid`` opened the rank axis, in which case it is the DP's
    per-mode pick from the grid."""
    order: tuple[int, ...]
    methods: tuple[str, ...]        # per position of ``order``
    total_cost: float
    calibrated: bool                # total_cost is seconds, not FLOPs
    n_states: int
    groups: tuple[tuple[int, ...], ...] = ()
    ranks: tuple[int, ...] = ()     # per position of ``order``

    def to_dict(self) -> dict:
        return {"order": list(self.order), "methods": list(self.methods),
                "total_cost": self.total_cost, "calibrated": self.calibrated,
                "n_states": self.n_states,
                "groups": [list(g) for g in self.groups],
                "ranks": list(self.ranks)}


def __getattr__(name: str):
    # pick_shard_mode(_group) live in core/distributed.py, which the search
    # imports lazily (it imports the plan layer); still importable from here
    if name in ("pick_shard_mode", "pick_shard_mode_group"):
        from . import distributed
        return getattr(distributed, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _candidates(methods, mode: int,
                search=SEARCH_METHODS) -> tuple[str, ...]:
    """Solver candidates for ``mode``: the pinned one, or the search set."""
    if methods is None:
        return search
    return (methods[mode],)


def _priced_candidates(shape, ranks, methods, itemsize, n_shards, cur, m,
                       search=SEARCH_METHODS, rank_grid=None,
                       backend="matfree", n_sms=None, done=(),
                       input_shards=1, prev_shard=None):
    """Every (method, peak_bytes, i_n, r_n, j_n, shard_mode) candidate for
    solving mode ``m`` at the DP state whose current (partially shrunk) dims
    are ``cur`` — the ONE place the shard-participation and per-device peak
    rules live, shared by the DP transition loop and the infeasibility
    message.  With a ``rank_grid`` the rank axis opens: one candidate per
    (solver, grid rank) pair instead of the single fixed ``ranks[m]``.
    ``backend`` and ``n_sms`` price a candidate as the plan prices its step
    (:func:`repro_torch.core.plan._backend_peak_bytes`: a ``hopper`` step
    adds the kernels' workspace at the rank's view of the state, and holds
    the factors of the modes ``done`` and, after the first step, the input —
    on a mesh ``1 / input_shards`` of it, the first step's shard count;
    after the first step it also prices the reshard from the previous step's
    ``prev_shard``, :func:`repro_torch.core.plan._entry_peak_bytes`). The DP
    carries ``input_shards`` and ``prev_shard`` along the best path
    into each state."""
    # the plan's own model (plan.py imports this module lazily: no cycle)
    from .plan import _backend_peak_bytes, _entry_peak_bytes, _held_bytes
    i_n = shape[m]
    j_n = math.prod(cur) // i_n
    held = _held_bytes(shape, ((d, cur[d]) for d in done), itemsize,
                       input_shards=input_shards)
    rank_cands = (ranks[m],) if rank_grid is None else tuple(rank_grid[m])
    if n_shards > 1:
        from .distributed import pick_shard_mode
        shard = pick_shard_mode(tuple(cur), m, n_shards)
    else:
        shard = None
    for meth in _candidates(methods, m, search):
        sm = shard if meth not in ("svd", "rand") else None
        eff = n_shards if sm is not None else 1
        for r_n in rank_cands:
            peak = _backend_peak_bytes(meth, cur, m, r_n, itemsize, backend,
                                       n_sms, eff, held, sm)
            if backend == "hopper" and done:
                peak = _entry_peak_bytes(peak, held, cur, prev_shard, sm,
                                         n_shards, itemsize)
            yield meth, peak, i_n, r_n, j_n, sm


def step_cost(cost_model: CostModel, method: str, i_n: int, r_n: int,
              j_n: int, als_iters: int) -> float:
    """The DP's edge weight: MARGINAL predicted seconds — the calibrated
    per-FLOP scales times Eq. 4/5, WITHOUT the fitted per-solve dispatch
    overheads.  Every complete schedule runs exactly N solves, so the
    overhead term is a constant offset that cannot change the argmin over
    orders — but it was fitted on eager per-solve dispatch, which the fused
    compiled sweep the optimizer is scheduling never pays, and keeping it
    would bias the solver choice toward the low-overhead solver (EIG) far
    beyond its in-sweep advantage.  With textbook scales (1.0) this
    degrades to a plain FLOP count, pricing the uncalibrated regime."""
    if method == "eig":
        return cost_model.eig_scale * cost_model.eig_flops(i_n, r_n, j_n)
    if method == "als":
        return cost_model.als_scale * \
            cost_model.als_flops(i_n, r_n, j_n, als_iters)
    if method == "rand":
        # sketch FLOPs (range sample + power iterations + Rayleigh–Ritz)
        # with the fitted rand scale — how rank-adaptive sketch passes and
        # explicit rand pins are priced into the order/solver/rank search
        return cost_model.rand_scale_eff * cost_model.rand_flops(i_n, r_n, j_n)
    # svd has no fitted scale; eig's per-FLOP seconds are the closest GEMM
    # proxy (same convention as CostModel.predict_seconds) — svd only enters
    # the search when explicitly pinned, so the bias cannot flip a solver
    # choice, only shade the order of a schedule that already chose svd
    return cost_model.eig_scale * cost_model.svd_flops(i_n, r_n, j_n)


def _price_group(shape, ranks, methods, als_iters, itemsize, n_shards, cur,
                 g, cost_model, backend="matfree", n_sms=None, done=(),
                 input_shards=1, prev_shard=None):
    """Every priced solver assignment for running the modes of ``g`` as ONE
    mode-parallel group at the state whose current dims are ``cur``: yields
    ``(assign, latency, flops, peak_bytes, shard_mode)``.  Each member is
    sized at the group-entry shape (J_n keeps the other members un-shrunk),
    latency is the max over members (they run concurrently), flops the sum
    (the work tie-break), and the peak is the group model — shared input
    slab plus every member's scratch at once.  SVD matricizes and RAND runs
    replicated — neither joins a group; a group containing a mode pinned to
    either yields nothing (infeasible).  Groups are also rank-FIXED: the
    rank axis applies to sequential transitions only (a group's fused
    multi-TTM is sized at plan time and cannot absorb a run-time rank
    decision).
    ``backend``, ``n_sms``, ``done``, ``input_shards`` and ``prev_shard``
    price the group as :func:`_priced_candidates` prices a step."""
    from .plan import (_backend_group_peak_bytes, _entry_peak_bytes,
                       _held_bytes)   # lazy
    in_elems = math.prod(cur)
    out_elems = in_elems
    for m in g:
        out_elems = out_elems // cur[m] * ranks[m]
    held = _held_bytes(shape, ((d, cur[d]) for d in done), itemsize,
                       input_shards=input_shards)
    if n_shards > 1:
        from .distributed import pick_shard_mode_group
        shard = pick_shard_mode_group(tuple(cur), g, n_shards)
    else:
        shard = None
    eff = n_shards if shard is not None else 1
    cand_sets = []
    for m in g:
        cands = tuple(c for c in _candidates(methods, m)
                      if c not in ("svd", "rand"))
        if not cands:
            return
        cand_sets.append(cands)
    for assign in product(*cand_sets):
        entries = []
        lat = fl = 0.0
        for m, meth in zip(g, assign):
            i_n, r_n = cur[m], ranks[m]
            j_n = in_elems // i_n
            c = step_cost(cost_model, meth, i_n, r_n, j_n, als_iters)
            lat = max(lat, c)
            fl += c
            entries.append((meth, i_n, r_n, j_n))
        peak = _backend_group_peak_bytes(entries, cur, g, out_elems,
                                         itemsize, backend, n_sms, eff,
                                         shard, held)
        if backend == "hopper" and done:
            peak = _entry_peak_bytes(peak, held, cur, prev_shard, shard,
                                     n_shards, itemsize)
        yield assign, lat, fl, peak, shard


def _relax(best, nxt: int, cost: float, flops: float, prev: int,
           group, assign, rks, cur, entry) -> None:
    """Lexicographic (latency, flops) relaxation: strictly-better latency
    wins; at equal latency the lower-work schedule wins, so a parallel
    group never displaces a sequential plan it merely ties.  ``rks`` records
    the rank chosen for each mode of ``group`` (the rank axis) and ``cur``
    the resulting current dims, which later transitions read their J_n
    from — the channel through which a rank choice propagates downstream.
    ``entry`` is ``(input_shards, shard_mode)`` after the transition: the
    first step's shard count and the last one's shard mode, which price
    the held input and the next reshard (:func:`_after`)."""
    cand = best.get(nxt)
    if cand is None or (cost, flops) < (cand[0], cand[1]):
        best[nxt] = (cost, flops, prev, tuple(group), tuple(assign),
                     tuple(rks), tuple(cur), entry)


def _after(state, shard, n_shards: int, first: bool) -> tuple:
    """The ``entry`` of a state reached from ``state`` by a transition that
    shards on ``shard``: the first transition fixes the input's shard
    count, every transition the shard mode the next one reshards from."""
    ins = (n_shards if shard is not None else 1) if first else state[7][0]
    return ins, shard


def optimize_schedule(
    shape: Sequence[int],
    ranks: Sequence[int],
    *,
    methods: Sequence[str] | None = None,
    als_iters: int = DEFAULT_ALS_ITERS,
    itemsize: int = 4,
    n_shards: int = 1,
    cost_model: CostModel | None = None,
    memory_cap_bytes: int | None = None,
    max_group: int = 1,
    search_methods: Sequence[str] = SEARCH_METHODS,
    rank_grid: Sequence[Sequence[int]] | None = None,
    backend: str = "matfree",
    n_sms: int | None = None,
) -> ScheduleSearch:
    """Exact subset DP over st-HOSVD schedules.

    ``methods`` pins the solver per MODE (the DP then only searches order);
    ``None`` lets each step choose from ``search_methods`` (default
    :data:`SEARCH_METHODS`; widen to ``("eig", "als", "rand")`` to let the
    sketch-FLOPs pricing compete).  With ``n_shards > 1`` every candidate
    step's peak is the per-device figure for the shard mode
    :func:`pick_shard_mode` assigns at that state.  ``max_group > 1``
    additionally searches mode-parallel groupings: a transition may shrink
    up to ``max_group`` modes at once, priced by the latency/FLOPs rules of
    :func:`_price_group`; ``max_group=1`` reduces exactly to the sequential
    DP.

    ``rank_grid`` opens the RANK axis: per-mode ascending candidate ranks
    (``rank_grid[m]``; ``ranks`` then only seeds the search's sizing
    fallback) — sequential transitions try every (solver, rank) pair and
    the chosen rank shrinks ``cur`` for all later steps, so order × solver
    × rank is searched jointly.  Incompatible with ``max_group > 1``
    (groups are rank-fixed; see :func:`_price_group`).

    ``backend`` and ``n_sms`` price every sequential candidate as the plan
    prices its step: a ``hopper`` candidate adds its calls' workspace at
    the state's view and what it holds beside it (:func:`_priced_candidates`),
    so the search never picks a schedule that the capped check then refuses;
    groups likewise (:func:`_price_group`).  On a mesh a candidate also
    holds the rank's slab of the input and pays the reshard from the
    previous step's shard mode, both read off the best path into its state
    (so under a tight cap the search may miss a schedule whose costlier
    prefix reshards more cheaply, but it never returns one the plan
    refuses).

    Raises :class:`MemoryCapError` when no complete order fits the cap; the
    message names the cheapest-memory step (or group) that still exceeds it
    at the deepest reachable state (the *binding* step).
    """
    wall0, t0 = time.time(), time.perf_counter()
    shape = tuple(int(s) for s in shape)
    ranks = tuple(int(r) for r in ranks)
    n = len(shape)
    cm = cost_model if cost_model is not None else DEFAULT_COST_MODEL
    full = (1 << n) - 1
    max_group = max(1, min(int(max_group), n))
    search = tuple(search_methods)
    if rank_grid is not None:
        rank_grid = tuple(tuple(int(r) for r in g) for g in rank_grid)
        if len(rank_grid) != n or any(not g for g in rank_grid):
            raise ValueError(f"rank_grid needs a non-empty candidate tuple "
                             f"per mode ({n} modes), got {rank_grid}")
        if max_group > 1:
            raise ValueError("the rank axis (rank_grid) applies to "
                             "sequential schedules only; groups are "
                             "rank-fixed — use max_group=1")

    # best[mask] = (cost, flops, prev_mask, group, assign, rks, cur,
    # entry); see
    # the module docstring for the full state encoding.  Transitions only
    # ever set bits, so ascending-mask iteration is a valid topological
    # order.  cost is the latency objective, flops the lexicographic
    # tie-break (see _relax); cur carries the chosen-rank dims forward.
    best: dict[int, tuple[float, float, int, tuple, tuple, tuple, tuple]] = {
        0: (0.0, 0.0, -1, (), (), (), shape, (1, None))}
    for mask in range(full):
        state = best.get(mask)
        if state is None:
            continue
        cur = list(state[6])
        rem = [m for m in range(n) if not mask >> m & 1]
        done = [m for m in range(n) if mask >> m & 1]
        ins, prev_shard = state[7]
        for m in rem:   # sequential edges, exactly the max_group=1 DP
            for meth, peak, i_n, r_n, j_n, sm in _priced_candidates(
                    shape, ranks, methods, itemsize, n_shards, cur, m,
                    search, rank_grid, backend, n_sms, done, ins,
                    prev_shard):
                if memory_cap_bytes is not None and peak > memory_cap_bytes:
                    continue
                c = step_cost(cm, meth, i_n, r_n, j_n, als_iters)
                nxt_cur = list(cur)
                nxt_cur[m] = r_n
                _relax(best, mask | (1 << m), state[0] + c, state[1] + c,
                       mask, (m,), (meth,), (r_n,), nxt_cur,
                       _after(state, sm, n_shards, not done))
        for size in range(2, min(max_group, len(rem)) + 1):
            for g in combinations(rem, size):
                nxt = mask
                for m in g:
                    nxt |= 1 << m
                for assign, lat, fl, peak, sm in _price_group(
                        shape, ranks, methods, als_iters, itemsize,
                        n_shards, cur, g, cm, backend, n_sms, done, ins,
                        prev_shard):
                    if memory_cap_bytes is not None \
                            and peak > memory_cap_bytes:
                        continue
                    nxt_cur = list(cur)
                    for m in g:
                        nxt_cur[m] = ranks[m]
                    _relax(best, nxt, state[0] + lat, state[1] + fl,
                           mask, g, assign, tuple(ranks[m] for m in g),
                           nxt_cur, _after(state, sm, n_shards, not done))

    if full not in best:
        raise MemoryCapError(_infeasible_message(
            shape, ranks, methods, als_iters, itemsize, n_shards,
            memory_cap_bytes, best, max_group=max_group, cost_model=cm,
            search=search, rank_grid=rank_grid, backend=backend,
            n_sms=n_sms))

    groups: list[tuple[int, ...]] = []
    meths: list[tuple[str, ...]] = []
    rkss: list[tuple[int, ...]] = []
    mask = full
    while mask:
        prev, g, assign, rks = best[mask][2:6]
        groups.append(g)
        meths.append(assign)
        rkss.append(rks)
        mask = prev
    groups.reverse()
    meths.reverse()
    rkss.reverse()
    result = ScheduleSearch(
        order=tuple(m for g in groups for m in g),
        methods=tuple(q for a in meths for q in a),
        total_cost=best[full][0], calibrated=cm.calibrated,
        n_states=len(best), groups=tuple(groups),
        ranks=tuple(r for rks in rkss for r in rks))
    _obs.event("span", t=wall0, name="plan.dp_search",
               dur_s=time.perf_counter() - t0, shape=list(shape),
               n_states=result.n_states, order=list(result.order),
               methods=list(result.methods), max_group=max_group,
               calibrated=result.calibrated, total_cost=result.total_cost)
    return result


def optimize_grouping(
    shape: Sequence[int],
    ranks: Sequence[int],
    order: Sequence[int],
    *,
    methods: Sequence[str] | None = None,
    als_iters: int = DEFAULT_ALS_ITERS,
    itemsize: int = 4,
    n_shards: int = 1,
    cost_model: CostModel | None = None,
    memory_cap_bytes: int | None = None,
    max_group: int | None = None,
    backend: str = "matfree",
    n_sms: int | None = None,
) -> ScheduleSearch:
    """Mode-parallel grouping search along a FIXED mode order (the
    ``mode_parallel="auto"`` path when the user pinned ``mode_order``):
    a segmentation DP over prefixes of ``order`` — ``dp[k]`` is the
    cheapest latency to have shrunk ``order[:k]``, and a transition runs
    the contiguous slice ``order[k:k+L]`` as one group (``L=1`` is a plain
    sequential step).  Solver choice per member follows the same rules as
    :func:`optimize_schedule`.  ``max_group=None`` allows groups up to the
    full tensor order.  Spanned as ``plan.dp_grouping`` on the obs bus."""
    wall0, t0 = time.time(), time.perf_counter()
    shape = tuple(int(s) for s in shape)
    ranks = tuple(int(r) for r in ranks)
    order = tuple(int(m) for m in order)
    n = len(order)
    cm = cost_model if cost_model is not None else DEFAULT_COST_MODEL
    max_group = n if max_group is None else max(1, min(int(max_group), n))

    dp: dict[int, tuple] = {0: (0.0, 0.0, -1, (), (), (), shape, (1, None))}
    for k in range(n):
        state = dp.get(k)
        if state is None:
            continue
        done = set(order[:k])
        cur = [ranks[i] if i in done else shape[i]
               for i in range(len(shape))]
        m = order[k]
        ins, prev_shard = state[7]
        for meth, peak, i_n, r_n, j_n, sm in _priced_candidates(
                shape, ranks, methods, itemsize, n_shards, cur, m,
                backend=backend, n_sms=n_sms, done=order[:k],
                input_shards=ins, prev_shard=prev_shard):
            if memory_cap_bytes is not None and peak > memory_cap_bytes:
                continue
            c = step_cost(cm, meth, i_n, r_n, j_n, als_iters)
            nxt_cur = list(cur)
            nxt_cur[m] = r_n
            _relax(dp, k + 1, state[0] + c, state[1] + c, k, (m,), (meth,),
                   (r_n,), nxt_cur, _after(state, sm, n_shards, k == 0))
        for size in range(2, min(max_group, n - k) + 1):
            g = order[k:k + size]
            for assign, lat, fl, peak, sm in _price_group(
                    shape, ranks, methods, als_iters, itemsize, n_shards,
                    cur, g, cm, backend, n_sms, order[:k], ins, prev_shard):
                if memory_cap_bytes is not None and peak > memory_cap_bytes:
                    continue
                nxt_cur = list(cur)
                for gm in g:
                    nxt_cur[gm] = ranks[gm]
                _relax(dp, k + size, state[0] + lat, state[1] + fl,
                       k, g, assign, tuple(ranks[gm] for gm in g), nxt_cur,
                       _after(state, sm, n_shards, k == 0))

    if n not in dp:
        deepest = max(dp)
        done = set(order[:deepest])
        cur = [ranks[i] if i in done else shape[i]
               for i in range(len(shape))]
        cands = [(order[deepest],)] + [
            order[deepest:deepest + size]
            for size in range(2, min(max_group, n - deepest) + 1)]
        binding = _min_peak_binding(shape, ranks, methods, als_iters,
                                    itemsize, n_shards, cur, cands, cm,
                                    backend=backend, n_sms=n_sms,
                                    done=order[:deepest],
                                    entry=dp[deepest][7])
        raise MemoryCapError(_format_binding(
            shape, ranks, memory_cap_bytes, sorted(done), binding, n_shards))

    groups: list[tuple[int, ...]] = []
    meths: list[tuple[str, ...]] = []
    rkss: list[tuple[int, ...]] = []
    k = n
    while k:
        prev, g, assign, rks = dp[k][2:6]
        groups.append(g)
        meths.append(assign)
        rkss.append(rks)
        k = prev
    groups.reverse()
    meths.reverse()
    rkss.reverse()
    result = ScheduleSearch(
        order=order, methods=tuple(q for a in meths for q in a),
        total_cost=dp[n][0], calibrated=cm.calibrated,
        n_states=len(dp), groups=tuple(groups),
        ranks=tuple(r for rks in rkss for r in rks))
    _obs.event("span", t=wall0, name="plan.dp_grouping",
               dur_s=time.perf_counter() - t0, shape=list(shape),
               order=list(order), groups=[list(g) for g in result.groups],
               calibrated=result.calibrated, total_cost=result.total_cost)
    return result


def _min_peak_binding(shape, ranks, methods, als_iters, itemsize, n_shards,
                      cur, candidate_groups, cost_model,
                      search=SEARCH_METHODS, rank_grid=None,
                      backend="matfree", n_sms=None, done=(),
                      entry=(1, None)):
    """The cheapest-memory candidate over ``candidate_groups`` (each a tuple
    of modes; singletons are plain sequential steps) at the state whose
    current dims are ``cur`` (and whose ``entry`` is ``(input_shards,
    prev_shard)``, :func:`_relax`) — the step/group any schedule must
    eventually pay.  Returns ``(peak, modes, assign, detail)`` where
    ``detail`` is the singleton's (i_n, r_n, j_n) or ``None`` for a
    multi-mode group."""
    binding = None
    for g in candidate_groups:
        if len(g) == 1:
            for meth, peak, i_n, r_n, j_n, _ in _priced_candidates(
                    shape, ranks, methods, itemsize, n_shards, cur, g[0],
                    search, rank_grid, backend, n_sms, done, *entry):
                if binding is None or peak < binding[0]:
                    binding = (peak, g, (meth,), (i_n, r_n, j_n))
        else:
            for assign, _lat, _fl, peak, _ in _price_group(
                    shape, ranks, methods, als_iters, itemsize, n_shards,
                    cur, g, cost_model, backend, n_sms, done, *entry):
                if binding is None or peak < binding[0]:
                    binding = (peak, g, assign, None)
    return binding


def _format_binding(shape, ranks, cap, done, binding, n_shards) -> str:
    peak, g, assign, detail = binding
    dev = " per device" if n_shards > 1 else ""
    after = f"after shrinking modes {list(done)}, " if done else ""
    if len(g) == 1:
        m, meth = g[0], assign[0]
        i_n, r_n, j_n = detail
        what = (f"the binding step — mode {m} "
                f"({meth}, I={i_n} R={r_n} J={j_n})")
        remedy = ("raise the cap above that, shrink the ranks, "
                  "or shard over more devices")
    else:
        what = (f"the binding group — modes {list(g)} "
                f"({'+'.join(assign)}, concurrent Grams from the un-shrunk "
                "input)")
        remedy = ("raise the cap above that, shrink the ranks, split the "
                  "group (mode_parallel='off'), or shard over more devices")
    return (f"memory_cap_bytes={cap:,} is infeasible for shape {shape} → "
            f"ranks {ranks}: {after}{what} — still needs "
            f"≥{peak:,} modeled bytes{dev}; {remedy}")


def _infeasible_message(shape, ranks, methods, als_iters, itemsize, n_shards,
                        cap, best, max_group=1, cost_model=None,
                        search=SEARCH_METHODS, rank_grid=None,
                        backend="matfree", n_sms=None) -> str:
    """Name the binding step (or group): at the deepest reachable state, the
    remaining candidate whose cheapest-memory pricing still exceeds the cap
    by the least — the transition any schedule must eventually pay."""
    n = len(shape)
    cm = cost_model if cost_model is not None else DEFAULT_COST_MODEL
    deepest = max(best, key=lambda mask: bin(mask).count("1"))
    cur = list(best[deepest][6])   # state dims, rank-axis aware
    done = [i for i in range(n) if deepest >> i & 1]
    rem = [m for m in range(n) if not deepest >> m & 1]
    cands = [(m,) for m in rem]
    for size in range(2, min(max_group, len(rem)) + 1):
        cands.extend(combinations(rem, size))
    binding = _min_peak_binding(shape, ranks, methods, als_iters, itemsize,
                                n_shards, cur, cands, cm, search, rank_grid,
                                backend, n_sms, done, best[deepest][7])
    return _format_binding(shape, ranks, cap, done, binding, n_shards)


def validate_schedule_cap(steps, memory_cap_bytes: int) -> None:
    """Post-hoc cap check for fixed-order schedules (explicit ``mode_order``,
    t-HOSVD, HOOI refinements): every step's modeled per-device peak must fit.
    Raises :class:`MemoryCapError` naming the first binding step."""
    for k, s in enumerate(steps):
        if s.peak_bytes > memory_cap_bytes:
            dev = " per device" if s.n_shards > 1 else ""
            grp = f" in mode-parallel group {s.group}" \
                if s.group is not None else ""
            raise MemoryCapError(
                f"schedule exceeds memory_cap_bytes={memory_cap_bytes:,}: "
                f"step {k} (mode {s.mode}, {s.method}, I={s.i_n} R={s.r_n} "
                f"J={s.j_n}){grp} models {s.peak_bytes:,} peak bytes{dev}; "
                "mode_order='opt' searches order AND solver under the cap")
