"""Measurement producers: offline sampling harness + online trace harvester.

Offline (:func:`collect`): random tensors, log-uniform dims/ranks (paper
Sec. IV-B; covers the asymmetric one-huge-mode shapes where the EIG/ALS
crossover lives), each mode timed with BOTH solvers through each requested
ops backend — the paired records are exactly what labeling needs.  On the
CPU the sampled dims, ranks and tensors for a seed are the reference's
(the same numpy stream); on the card each tensor is drawn on the device
from a ``torch.Generator`` seeded with the run's seed, so only the first
tensor's dims match the reference's.

Timing.  On the CPU a solve is timed as it is called, best of ``reps``
after a throwaway, as in the reference.  On the card an uncapped plan
replays its sweep as CUDA graphs (:mod:`repro_torch.core.graphs`), where
ALS's hundreds of kernel launches a solve cost the host nothing; a label
timed eagerly would teach the selector a host-bound crossover that the
production path never pays.  So on CUDA ``Measurement.seconds`` is the
solve captured the way :class:`~repro_torch.core.graphs.CapturedSweep`
captures a sweep (cut at its ``eigh``) and replayed, with a synchronize
after each replay, best of ``reps``.  ``collect(eager=...)`` keeps the
eager time of the same solve beside it, for reports.

Online (:func:`recording` / :func:`harvest_result`): every executed
``TuckerPlan`` already produces per-mode ``ModeTrace`` records; inside a
``recording()`` context (or with ``plan.execute(record=True)``) those
traces carry real wall-clock and are converted into :class:`Measurement`
rows — production traffic improves the selector for free.  Online records
are one-sided (only the solver the plan chose ran), so they sharpen the
store wherever offline coverage or OTHER plans supply the opposing method.
They come from the eager per-step runner, which synchronizes after every
step, so on the card they are eager times; :class:`RecordStore`'s dedup
keeps the fastest observation of a key, so a collected replay wins over a
harvested eager time at the same point.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Iterable, Sequence

import numpy as np
import torch

from ..core import graphs as G
from ..core import tensor_ops as T
from ..core.selector import extract_features
from ..core.solvers import DEFAULT_ALS_ITERS
from .records import (
    COLLECT,
    HARVEST,
    Measurement,
    RecordStore,
    device_fingerprint,
)

#: tiny preset for CI — a handful of tensors, one backend, dims small enough
#: that the whole collect→train loop finishes in well under a minute
SMOKE = dict(n_tensors=8, dim_range=(8, 40), backends=("matfree",),
             orders=(3,), reps=1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _best(fn, device: torch.device, reps: int) -> float:
    best = float("inf")
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def _time_solver(y: torch.Tensor, mode: int, rank: int, method: str, *,
                 impl: str, als_iters: int = DEFAULT_ALS_ITERS,
                 reps: int = 2, eager: bool = False
                 ) -> tuple[float, float | None]:
    """``(seconds, eager seconds)`` of one mode solve, each the best of
    ``reps`` after a throwaway (see the module docstring): on CUDA seconds
    is the captured solve's replay, on the CPU the eager call.  The eager
    figure is None unless ``eager``."""
    from ..core.solvers import SOLVERS
    kw = {"num_iters": als_iters} if method == "als" else {}

    def run():
        return SOLVERS[method](y, mode, rank, impl=impl, **kw)

    dev = y.device
    if dev.type != "cuda":
        run()
        t = _best(run, dev, reps)
        return t, (t if eager else None)

    def solve(_):
        # reads y itself (the graphs hold its address): the sweep's static
        # input is a placeholder
        r = run()
        return r.y_new, [r.u]

    graphs = G.CapturedSweep(solve, device=dev)
    graphs(torch.zeros(1, device=dev))   # warm-up, capture, one replay
    t = _best(graphs.replay, dev, reps)
    del graphs
    return t, (_best(run, dev, reps) if eager else None)


def measure(x: torch.Tensor, ranks: Sequence[int], *,
            modes: Sequence[int] | None = None,
            backends: Sequence[str] = ("matfree",),
            als_iters: int = DEFAULT_ALS_ITERS, reps: int = 2,
            eager: dict | None = None) -> list[Measurement]:
    """Time EIG and ALS on each of ``modes`` (default: all) of ``x`` at
    ``ranks[mode]`` through each backend → one eig and one als
    :class:`Measurement` a (backend, mode), in that order, on ``x``'s
    device.  ``eager``, when given, maps each record's ``key()`` to the
    eager seconds of the same solve."""
    dev = x.device
    common0 = dict(platform=dev.type, device=device_fingerprint(dev),
                   dtype=T.dtype_name(x.dtype), order=x.ndim,
                   als_iters=als_iters, source=COLLECT)
    out: list[Measurement] = []
    for impl in backends:
        for mode in (range(x.ndim) if modes is None else modes):
            i_n, r_n = x.shape[mode], int(ranks[mode])
            common = dict(common0, backend=impl, i_n=i_n, r_n=r_n,
                          j_n=x.numel() // i_n)
            for method in ("eig", "als"):
                t, te = _time_solver(x, mode, r_n, method, impl=impl,
                                     als_iters=als_iters, reps=reps,
                                     eager=eager is not None)
                m = Measurement(method=method, seconds=t, **common)
                if eager is not None:
                    eager[m.key()] = te
                out.append(m)
    return out


def collect(
    n_tensors: int = 120,
    dim_range: tuple[int, int] = (10, 192),
    seed: int = 0,
    *,
    orders: Sequence[int] = (3,),
    backends: Sequence[str] = ("matfree",),
    dtype="float32",
    als_iters: int = DEFAULT_ALS_ITERS,
    reps: int = 2,
    max_elements: int = 1 << 22,
    max_rank: int | None = None,
    device=None,
    eager: dict | None = None,
    verbose: bool = False,
) -> list[Measurement]:
    """Time EIG vs ALS per (tensor, mode, backend) → paired Measurements.

    One eig + one als record per point, as in the paper ("the statistics of
    each mode constitute a record"), stratified across ``backends`` and
    tensor ``orders``.  Ranks are log-uniform in [min(4, I_n/2), I_n/2],
    as the reference draws them, with both ends capped at ``max_rank`` when
    given.  ``max_elements`` caps the sampled tensor volume by halving the
    largest sampled dim until the tensor fits.

    ``device`` None means ``cuda:0`` and raises without CUDA (pass
    ``"cpu"`` for the CPU); ``eager`` is passed to :func:`measure`.
    """
    from ..core.api import resolve_device
    from ..core.backend import get_backend
    for b in backends:
        get_backend(b)   # fail fast on unknown names
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed) \
        if dev.type == "cuda" else None
    tdtype = T.torch_dtype(dtype)

    def log_uniform(lo, hi):
        return int(round(np.exp(rng.uniform(np.log(lo), np.log(hi)))))

    out: list[Measurement] = []
    for t in range(n_tensors):
        order = int(orders[t % len(orders)])
        dims = [log_uniform(dim_range[0], dim_range[1])
                for _ in range(order)]
        while math.prod(dims) > max_elements and max(dims) > 4:
            k = int(np.argmax(dims))
            dims[k] = max(4, dims[k] // 2)
        if math.prod(dims) > max_elements:
            # even all-4 dims overflow the cap (absurd order): skip rather
            # than allocate a tensor the cap exists to prevent
            if verbose:
                print(f"[tune.collect] skipping order-{order} sample "
                      f"(4^{order} > max_elements)")
            continue
        dims = tuple(dims)
        tops = [max(2, d // 2 if max_rank is None else min(max_rank, d // 2))
                for d in dims]
        ranks = tuple(log_uniform(min(max(1, min(4, d // 2)), top), top)
                      for d, top in zip(dims, tops))
        if gen is None:   # the reference's draw, from the same stream
            x = torch.from_numpy(rng.standard_normal(dims)).to(tdtype)
        else:
            x = torch.randn(dims, generator=gen, device=dev, dtype=tdtype)
        out.extend(measure(x, ranks, backends=backends, als_iters=als_iters,
                           reps=reps, eager=eager))
        del x
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if verbose and (t + 1) % 10 == 0:
            print(f"[tune.collect] {t + 1}/{n_tensors} tensors sampled "
                  f"({len(out)} records)")
    return out


def collect_into(store: RecordStore, **kw) -> int:
    """``collect()`` straight into a store; returns records appended."""
    return store.append(collect(**kw))


def collect_samples(
    n_tensors: int = 120,
    dim_range: tuple[int, int] = (10, 192),
    seed: int = 0,
    order: int = 3,
    dtype="float32",
    verbose: bool = False,
    device=None,
):
    """Legacy array API: (features, labels, times) on the matfree backend —
    the pre-flywheel signature (plus ``device``) kept for the selector's
    training shims."""
    ms = collect(n_tensors, dim_range, seed, orders=(order,), dtype=dtype,
                 device=device, verbose=verbose)
    feats, labels, times = [], [], []
    for te, ta in zip(ms[::2], ms[1::2]):   # collect() emits (eig, als) pairs
        feats.append(extract_features(te.i_n, te.r_n, te.j_n))
        labels.append(0 if te.seconds <= ta.seconds else 1)
        times.append((te.seconds, ta.seconds))
    return np.array(feats), np.array(labels), np.array(times)


# ---------------------------------------------------------------------------
# Online harvesting: executed-plan traces → training records
# ---------------------------------------------------------------------------

class RecordSink:
    """In-memory accumulator the plan layer feeds timed traces into while a
    :func:`recording` context is active."""

    def __init__(self):
        self.measurements: list[Measurement] = []

    def add_traces(self, traces, *, platform: str, dtype: str,
                   order: int, als_iters: int = DEFAULT_ALS_ITERS) -> int:
        ms = measurements_from_traces(traces, platform=platform, dtype=dtype,
                                      order=order, als_iters=als_iters)
        self.measurements.extend(ms)
        return len(ms)

    def flush(self, store: RecordStore) -> int:
        n = store.append(self.measurements)
        self.measurements.clear()
        return n


_SINKS: list[RecordSink] = []


def active_sink() -> RecordSink | None:
    """The innermost active recording sink (None outside any context).
    Checked by ``TuckerPlan.execute`` — via ``sys.modules`` so plans that
    never meet the tune subsystem pay nothing."""
    return _SINKS[-1] if _SINKS else None


@contextlib.contextmanager
def recording(store: RecordStore | str | None = None):
    """Process-wide harvest context: every ``TuckerPlan.execute`` inside it
    runs the timed (eager, per-step synchronized) runner instead of the
    captured sweep, and its per-mode wall-clock lands in the yielded
    :class:`RecordSink` — flushed to ``store`` on exit if given.

        with tune.recording(store):
            plan.execute(x)          # production call, now also a sample
    """
    if isinstance(store, (str, bytes)) or hasattr(store, "__fspath__"):
        store = RecordStore(store)
    sink = RecordSink()
    _SINKS.append(sink)
    try:
        yield sink
    finally:
        _SINKS.remove(sink)
        if store is not None:
            sink.flush(store)


def measurements_from_traces(traces, *, platform: str, dtype: str,
                             order: int,
                             als_iters: int = DEFAULT_ALS_ITERS,
                             ) -> list[Measurement]:
    """Convert timed ``ModeTrace`` records into harvest Measurements.

    Traces with no real timing (``seconds <= 0`` — e.g. from the cached
    sweep, where per-step time is unobservable) and solver families
    outside EIG/ALS/RAND are skipped: only rows a trainer can label
    against belong in the store.

    Each row carries the trace's plan-time ``predicted_s`` (when a
    calibrated cost model priced the schedule) and, for rank-adaptive
    ``rand`` traces, the measured fractional tail energy as ``rel_err``.
    The device fingerprint is ``platform``'s (:func:`device_fingerprint`).
    """
    device = device_fingerprint(platform)
    out = []
    for t in traces:
        if t.seconds <= 0.0 or t.method not in ("eig", "als", "rand"):
            continue
        out.append(Measurement(
            platform=platform, backend=t.backend, device=device,
            i_n=t.i_n, r_n=t.r_n, j_n=t.j_n, method=t.method,
            seconds=float(t.seconds), dtype=dtype, order=order,
            als_iters=als_iters, source=HARVEST,
            predicted_s=float(getattr(t, "predicted_s", 0.0)),
            rel_err=float(getattr(t, "tail_err", 0.0))))
    return out


def harvest_result(result, store: RecordStore | None = None, *,
                   platform: str | None = None, dtype: str = "float32",
                   als_iters: int = DEFAULT_ALS_ITERS) -> list[Measurement]:
    """Harvest one ``SthosvdResult`` (from ``plan.execute(record=True)`` or
    a legacy entry point) into Measurements; appended to ``store`` when
    given.  ``platform`` defaults to the device type of the result's
    core."""
    platform = platform or result.tucker.core.device.type
    order = len({t.mode for t in result.trace})
    ms = measurements_from_traces(result.trace, platform=platform,
                                  dtype=dtype, order=order,
                                  als_iters=als_iters)
    if store is not None:
        store.append(ms)
    return ms


def harvest_results(results: Iterable, store: RecordStore, **kw) -> int:
    """Batch :func:`harvest_result`; returns total records appended."""
    return sum(len(harvest_result(r, store, **kw)) for r in results)
