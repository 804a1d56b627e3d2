"""Streaming Tucker serving: async submit/poll over shape buckets.

The port of ``repro/serve/service.py``, with the reference's API and
semantics on an explicit ``device`` (None = ``cuda:0``, raising without
CUDA, as :func:`repro_torch.core.api.plan`):

  * ``submit(x, config) -> Ticket`` places the request's tensor on the
    service's device, routes it into a shape bucket
    (:mod:`repro_torch.serve.buckets` — odd shapes are zero-padded up to
    the nearest bucket; exact-mode results are bitwise-equal to unpadded
    execution) and enqueues it under a bounded-queue backpressure policy
    (``"reject"`` raises :class:`RejectedError`, ``"block"`` waits for
    space).
  * Waves of up to ``policy.wave_slots`` lanes are formed per bucket and
    executed through the bucket's warm
    :class:`~repro_torch.core.api.TuckerPlan` and its cached batched sweep
    (the process-wide ``_SWEEP_CACHE``; captured into CUDA graphs on the
    card).  The batched sweep runs item by item, one cache entry whatever
    the wave size, so waves carry no zero-filled lanes (the reference pads
    each wave to a power of two to bound its vmapped programs).
    Dispatch is pipelined: a wave is enqueued on the service device's
    current stream and a ``torch.cuda.Event`` recorded after it; its
    ``finish`` waits on that event, so while wave *i* runs on the device
    the service stacks wave *i+1*.  Every wave runs on that one stream: a
    captured sweep copies its input into one static buffer, so waves of a
    bucket must stay in stream order.  A wave whose solvers synchronize
    with the host (each EIG step's ``eigh``) blocks inside its dispatch.
  * ``poll(ticket)`` / ``wait(ticket)`` retrieve results; ``drain()`` runs
    or awaits everything queued.  ``start()`` spawns a background worker so
    ``submit`` returns immediately (async mode); without it the service is
    a synchronous pump (``drain`` executes inline).
  * ``stats()`` exposes per-bucket p50/p95/p99 latency, queue depth,
    pad-waste and lane-occupancy ratios, and backend/solver counters;
    ``trace_path=`` appends a JSONL event per submit/wave/completion, and
    every serve event also goes to the :mod:`repro_torch.obs` bus.
  * ``record=True`` (or an ambient :func:`repro_torch.tune.recording`
    context) runs waves through the eager timed path so served traffic
    feeds the autotune flywheel — optionally straight into a
    ``record_store``.

``impl`` and ``memory_cap_bytes`` pin every plan the service builds;
``TuckerBatchEngine`` is a thin synchronous wrapper over this service
(identity bucket policy, unbounded waves).

``mesh`` (a ``torch.distributed`` ``DeviceMesh``, plus an optional
``shard_axis``) attaches the mesh to every plan the service builds, as the
reference does: a mesh with no explicit ``impl`` pins ``impl="sharded"``,
requests that carry their own mesh keep it, and a pinned single-device
``impl`` drops it.  Every rank of the mesh runs its own service and submits
the same requests (global tensors) with the same ``rid``s; every rank must
then run the same waves in the same order, or the collectives of different
requests pair up and hang.  So on a mesh rank 0 decides and every rank
follows, over a gloo group of the service's own
(:class:`~repro_torch.core.distributed.Decisions`, created collectively by
the constructor):

  * rank 0 picks each wave (by its own timing, as a single service does),
    expires the wave's requests whose deadline passed on its clock, routes
    the wave through its breaker (the cooldown read on its clock) and
    broadcasts the bucket, the ordered ``rid``s, the expired ``rid``s and
    the route; every rank then dispatches exactly that wave.  A rank whose
    own submissions lag waits for those ``rid``s up to
    ``decision_timeout_s``; past it every rank fails the wave with an
    agreed :class:`~repro_torch.core.distributed.MeshError` (a late
    request fails with it on arrival).  Every collective of the decision
    group gives up after twice ``decision_timeout_s``: a rank that stops
    answering (its worker died, its process is gone) ends its peers'
    workers, whose jobs then fail, instead of hanging them.  So in
    ``drain()`` every rank must reach its drain within that time of rank
    0's, and an idle worker on rank 0 sends a heartbeat every second.
    The group is created only when the service's plans keep the mesh (a
    pinned single-device ``impl`` drops it) and released by ``close()``.
  * a rank's failure before a sweep's first collective (the wave's
    stacking, the ``wave``/``wave_job`` chaos seams) is agreed before the
    sweep: every rank leaves the wave with the same ``MeshError`` and
    recovers it alike.  A failure inside a sweep ends it on every rank with
    the same classified error (the sweep's own agreement), so every rank's
    plan takes the same fallback rung or keeps the same lane error.  Which
    lanes a wave recovers (quarantine, bisection) and each request's final
    outcome are agreed too, so the breaker, the retries and the results
    are the same on every rank.
  * one wave is in flight at a time (``max_inflight_waves`` is 1).
  * what cannot be agreed cheaply is refused or left to rank 0:
    ``backpressure="reject"`` with a bounded queue raises at construction
    (the default is ``"block"`` with a mesh); ``cancel`` takes effect on
    rank 0 only and reaches the other ranks with its next decision (on
    them it returns False); ``stop(force=True)`` and a worker that ends
    are carried to every rank by rank 0's stop decision (``ROADMAP.md``
    Queue 3).

Failure isolation:

  * ``submit(..., validate="finite")`` (the default) rejects NaN/Inf
    inputs at admission with :class:`~repro_torch.core.errors.InputError`
    naming the worst offending mode; ``deadline_s=`` bounds how long a
    request may wait — expired requests fail with
    :class:`~repro_torch.core.errors.DeadlineError` at admission or
    pre-wave, without ever occupying a lane.
  * A failed fused wave is **bisected**: the wave re-runs in halves (on the
    same cached batched sweep, so non-poisoned lanes stay bitwise-identical
    to a clean wave) until the poisoned request is quarantined alone; a
    lane that comes back non-finite, or whose own solve raises inside the
    item-by-item batch (``eigh`` refuses a NaN Gram where the reference's
    returns NaN), is quarantined the same way.  The last
    resort for a single request is an exact isolated run, whose failure
    comes back *classified* (:func:`~repro_torch.core.errors.coerce_exception`
    guarantees no unclassified exception ever escapes through ``poll``).
  * A per-bucket **circuit breaker** trips after ``breaker_threshold``
    consecutive wave failures: the bucket degrades to exact item-by-item
    execution, then half-opens after ``breaker_cooldown_s`` with a single
    fused probe wave.  ``stats()["resilience"]`` and :meth:`health`
    surface trips, states, and recovery counters.
  * ``submit(..., retries=n)`` grants a per-request retry budget: wave-
    level failures re-enqueue the job up to *n* times (input, deadline,
    and cancellation failures never retry).

The worker thread may capture a bucket's sweep into CUDA graphs while
another thread admits requests (whose finiteness check synchronizes with
the device): captures run in ``"thread_local"`` capture mode
(:mod:`repro_torch.core.graphs`), so work on other threads cannot
invalidate them.
"""

from __future__ import annotations

import math
import sys
import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass, field, replace

import torch

from .. import chaos as _chaos
from ..core import tensor_ops as T
from ..core.api import (CACHE_STATS, TuckerConfig, TuckerPlan, _as_tensor,
                        plan as make_plan, resolve_device)
from ..core.distributed import (OK, OTHER, Decisions, MeshError,
                                failure_code, mesh_error)
from ..core.errors import (CancelledError, DeadlineError, InputError,
                           NumericalError, ResourceError, check_finite,
                           coerce_exception)
from ..core.plan import validate_ranks
from ..core.sthosvd import SthosvdResult
from ..obs import drift as _drift
from ..obs import trace as _obs
from .buckets import BucketPolicy, pad_block, pad_waste, slice_valid, trim_result
from .metrics import BucketMetrics, LatencyWindow, TraceWriter

BACKPRESSURE_MODES = ("reject", "block")
VALIDATE_MODES = ("finite", "none")

#: errors that a retry budget never retries: the request itself is the
#: problem (bad input), or the caller already gave up (deadline, cancel)
_NO_RETRY = (InputError, DeadlineError, CancelledError)

#: the kinds of rank 0's decisions on a mesh (the first int of a message)
_WAVE, _CANCEL, _IDLE, _STOP, _END = 1, 2, 3, 4, 5
_ROUTES = ("fused", "isolated", "probe")
#: rank 0's worker tells an idle mesh it is alive this often (seconds)
_HEARTBEAT_S = 1.0
_FORCED = ("service stopped with force=True; request was abandoned before "
           "completing")


class RejectedError(RuntimeError):
    """submit() refused a request: the admission queue is full (policy
    ``"reject"``) or could not make progress (``"block"`` with no runnable
    wave)."""


class ServiceClosed(RuntimeError):
    """submit() after close(): the service no longer admits requests."""


@dataclass
class Ticket:
    """Handle returned by :meth:`TuckerService.submit`; pass to ``poll`` /
    ``wait``.  ``padded`` says the request did not fit its bucket exactly
    (``bucket`` is the slot shape it was padded into); ``deadline_s`` is
    the admission deadline the request carries (None = none)."""
    rid: int
    shape: tuple[int, ...]
    bucket: tuple[int, ...]
    padded: bool
    submitted_at: float
    deadline_s: float | None = None
    _job: "_Job" = field(repr=False, default=None)


class _Job:
    """Internal per-request state (Ticket keeps the only reference once the
    job leaves the queue, so completed work is garbage-collected with its
    ticket)."""
    __slots__ = ("rid", "x", "config", "shape", "key", "t_submit",
                 "deadline", "retries_left", "result", "error", "event")

    def __init__(self, rid, x, config, shape, key, *, deadline=None,
                 retries=0):
        self.rid = rid
        self.x = x
        self.config = config
        self.shape = shape
        self.key = key
        self.t_submit = time.perf_counter()
        self.deadline = deadline       # absolute perf_counter, or None
        self.retries_left = retries
        self.result: SthosvdResult | None = None
        self.error: Exception | None = None
        self.event = threading.Event()


class _Breaker:
    """Per-bucket circuit breaker over FUSED wave execution.

    ``closed`` — waves run fused (the fast path).  After ``threshold``
    consecutive wave failures the breaker opens: the bucket degrades to
    exact item-by-item execution (``"isolated"``), trading throughput for
    blast-radius-one.  After ``cooldown_s`` one wave is dispatched fused
    as a probe (``half_open``); success re-closes the breaker, failure
    re-opens it for another cooldown.

    ``trips`` counts only closed→open transitions, so concurrent failure
    reports cannot double-count a single trip.  Every transition happens
    under the service lock.
    """
    __slots__ = ("threshold", "cooldown_s", "state", "consecutive",
                 "opened_at", "probing", "trips", "reopens")

    def __init__(self, threshold: int, cooldown_s: float):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.state = "closed"
        self.consecutive = 0
        self.opened_at = 0.0
        self.probing = False
        self.trips = 0
        self.reopens = 0

    def route(self, now: float) -> str:
        """How the next wave should run: ``"fused"`` | ``"isolated"`` |
        ``"probe"`` (fused, but its outcome decides reopen-vs-close).
        Claims the probe slot, so only one probe is in flight at a time."""
        if self.state == "closed":
            return "fused"
        if not self.probing and now - self.opened_at >= self.cooldown_s:
            self.probing = True
            self.state = "half_open"
            return "probe"
        return "isolated"

    def on_result(self, ok: bool, now: float) -> bool:
        """Outcome of a non-probe fused wave; True when this report TRIPPED
        the breaker (closed→open) — the only transition that counts as a
        trip, so a burst of concurrent failures trips exactly once."""
        if ok:
            self.consecutive = 0
            return False
        self.consecutive += 1
        if self.state == "closed" and self.consecutive >= self.threshold:
            self.state = "open"
            self.opened_at = now
            self.trips += 1
            return True
        return False

    def on_probe(self, ok: bool, now: float) -> None:
        """Outcome of the half-open probe wave."""
        self.probing = False
        if ok:
            self.state = "closed"
            self.consecutive = 0
        else:
            self.state = "open"
            self.opened_at = now
            self.reopens += 1

    def follow(self, route: str) -> None:
        """Take the route rank 0 decided on a mesh: a probe claims the
        probe slot (the outcomes that follow are agreed, so every other
        transition happens alike on every rank)."""
        if route == "probe":
            self.probing = True
            self.state = "half_open"

    def snapshot(self) -> dict:
        return {"state": self.state, "trips": self.trips,
                "reopens": self.reopens,
                "consecutive_failures": self.consecutive}


class _BucketState:
    __slots__ = ("key", "queue", "metrics", "breaker")

    def __init__(self, key, breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 5.0):
        self.key = key
        self.queue: deque[_Job] = deque()
        self.metrics = BucketMetrics(bucket=key[0])
        self.breaker = _Breaker(breaker_threshold, breaker_cooldown_s)


def _finite(t: torch.Tensor) -> bool:
    return bool(torch.isfinite(t).all())


class TuckerService:
    """Continuous-batching decomposition service (see module docstring).

    ``impl`` / ``memory_cap_bytes`` pin every plan the service builds
    (request configs keep the tighter memory cap).  ``device`` is where
    every request runs: None means ``cuda:0`` and raises when CUDA is not
    available.  ``policy`` is the
    :class:`~repro_torch.serve.buckets.BucketPolicy`; ``max_queue`` bounds
    total queued requests (None = unbounded, backpressure off).

    ``max_inflight_waves`` bounds CROSS-WAVE PIPELINING: how many dispatched
    waves may be awaiting results while the pump stacks the next one.
    ``1`` is fully serial (dispatch → wait → next), ``2`` (default) the
    classic one-ahead pipeline.  Per-bucket ``pipeline_occupancy`` in
    :meth:`stats` reports how often the window was actually used.

    ``breaker_threshold`` / ``breaker_cooldown_s`` configure the per-bucket
    circuit breaker (consecutive wave failures before fused execution is
    suspended, and how long before a fused probe is attempted).

    Synchronous use (the engine wrapper, offline batches)::

        svc = TuckerService(device="cuda")
        t = svc.submit(x, cfg)
        svc.drain()
        res = svc.poll(t)

    Streaming use::

        with TuckerService(max_queue=256, backpressure="block") as svc:
            svc.start()
            tickets = [svc.submit(x, cfg) for x in stream]
            results = [svc.wait(t) for t in tickets]
    """

    def __init__(self, selector=None, *, policy: BucketPolicy | None = None,
                 impl: str | None = None, mesh=None,
                 shard_axis: str | None = None,
                 memory_cap_bytes: int | None = None,
                 max_queue: int | None = 1024,
                 backpressure: str | None = None,
                 max_inflight_waves: int = 2,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 5.0,
                 record: bool = False, record_store=None,
                 trace_path=None, device=None,
                 decision_timeout_s: float = 60.0):
        if backpressure is None:
            backpressure = "reject" if mesh is None else "block"
        if backpressure not in BACKPRESSURE_MODES:
            raise ValueError(f"backpressure {backpressure!r} not in "
                             f"{BACKPRESSURE_MODES}")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 or None (unbounded)")
        if max_inflight_waves < 1:
            raise ValueError("max_inflight_waves must be >= 1 (1 = serial "
                             "dispatch, 2 = classic one-ahead pipelining)")
        if breaker_threshold < 1:
            raise ValueError("breaker_threshold must be >= 1")
        if breaker_cooldown_s <= 0:
            raise ValueError("breaker_cooldown_s must be > 0")
        from ..core.backend import get_backend
        impl = "sharded" if impl is None and mesh is not None else impl
        # the plans keep the mesh unless a single-device impl is pinned
        on_mesh = mesh is not None and (
            impl == "auto" or get_backend(impl).requires_mesh)
        if on_mesh and decision_timeout_s < _HEARTBEAT_S:
            raise ValueError(f"decision_timeout_s must be >= {_HEARTBEAT_S}"
                             " s, the idle worker's heartbeat")
        if on_mesh and backpressure == "reject" and max_queue is not None:
            raise ValueError(
                "backpressure='reject' with a mesh: a full queue would drop "
                "a request on one rank only, by that rank's timing; use "
                "'block' or max_queue=None (ROADMAP.md Queue 3)")
        self.device = resolve_device(device, mesh=mesh)
        self._selector = selector
        self._policy = policy if policy is not None else BucketPolicy()
        self._impl = impl
        self._mesh = mesh
        self._shard_axis = shard_axis
        self._cap = memory_cap_bytes
        self._max_queue = max_queue
        self._backpressure = backpressure
        # a mesh keeps one wave in flight: its agreements run in order
        self._max_inflight = 1 if on_mesh else int(max_inflight_waves)
        self._decision_timeout = float(decision_timeout_s)
        self._breaker_threshold = int(breaker_threshold)
        self._breaker_cooldown = float(breaker_cooldown_s)
        self._record = record
        self._record_store = record_store
        self._trace = TraceWriter(trace_path) if trace_path else None

        self._plans: dict[tuple, TuckerPlan] = {}
        self._buckets: dict[tuple, _BucketState] = {}
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self._space = threading.Condition(self._lock)
        self._idle = threading.Condition(self._lock)
        self._pending = 0          # queued + in-flight, not yet completed
        self._inflight_jobs: set[_Job] = set()
        self._active_bucket: tuple | None = None
        self._next_rid = 0
        self._counters = {"submitted": 0, "requests": 0, "rejected": 0,
                          "failed": 0, "batches": 0, "plans_built": 0}
        self._res = {"deadline_expired": 0, "cancelled": 0, "retried": 0,
                     "bisections": 0, "quarantined": 0, "recovered": 0,
                     "isolated_waves": 0, "probe_waves": 0}
        self._latency = LatencyWindow()
        self._t0 = time.perf_counter()
        self._thread: threading.Thread | None = None
        self._running = False
        self._worker_failed = False
        self._closed = False
        # on a mesh: rank 0's decision channel, the cancels rank 0 has yet
        # to announce, the requests a decision failed before they arrived
        # here, and whether rank 0's stop abandons unfinished work
        self._chan = (Decisions(mesh, 2 * self._decision_timeout)
                      if on_mesh else None)
        self._cancel_out: list[int] = []
        self._orphans: dict[int, Exception] = {}
        self._stop_force = False

    # -- tracing -------------------------------------------------------------
    def _emit(self, kind: str, **fields) -> None:
        """One serve event, to BOTH sinks: the service's own JSONL
        TraceWriter (when ``trace_path`` was given) and the process-wide
        :mod:`repro_torch.obs` event bus (no-op unless tracing is enabled),
        so a bus capture ties serve lifecycle events to the
        plan/execute/compile spans underneath them."""
        if self._trace:
            self._trace.event(kind, **fields)
        _obs.event(kind, **fields)

    # -- config pinning ------------------------------------------------------
    def _pinned(self, config: TuckerConfig) -> TuckerConfig:
        from ..core.backend import get_backend
        impl = self._impl if self._impl is not None else config.impl
        mesh, axis = config.mesh, config.shard_axis
        if mesh is None and self._mesh is not None:
            mesh, axis = self._mesh, self._shard_axis or config.shard_axis
        if impl != "auto" and not get_backend(impl).requires_mesh:
            mesh = None   # pinned single-device backend: a mesh is moot
        cap = config.memory_cap_bytes
        if self._cap is not None:
            cap = self._cap if cap is None else min(cap, self._cap)
        if (impl, mesh, axis, cap) != (config.impl, config.mesh,
                                       config.shard_axis,
                                       config.memory_cap_bytes):
            config = replace(config, impl=impl, mesh=mesh, shard_axis=axis,
                             memory_cap_bytes=cap)
        return config

    # -- plan cache ----------------------------------------------------------
    def plan_for(self, shape, dtype, config: TuckerConfig) -> TuckerPlan:
        """The (cached) plan a request of this (shape, dtype, config) runs
        under the service's pins — built on first use, reused forever."""
        return self._plan_cached(tuple(int(s) for s in shape),
                                 T.dtype_name(dtype), self._pinned(config))

    def _plan_cached(self, shape: tuple, dtype: str, pinned: TuckerConfig,
                     *, base: TuckerPlan | None = None) -> TuckerPlan:
        key = (shape, dtype, pinned)
        p = self._plans.get(key)
        if p is None:
            if base is not None:
                # derive from the bucket's warm plan (same config/dtype and
                # device): the api-level reuse hook for padded member shapes
                p = base.for_shape(shape, selector=self._selector)
            else:
                p = make_plan(shape, dtype, pinned, selector=self._selector,
                              device=self.device)
            # plan building happens outside the lock (it can be slow); two
            # threads may race here, in which case the first insert wins
            with self._lock:
                if key in self._plans:
                    return self._plans[key]
                self._plans[key] = p
                self._counters["plans_built"] += 1
        return p

    # -- admission -----------------------------------------------------------
    def submit(self, x, config: TuckerConfig, *, rid: int | None = None,
               deadline_s: float | None = None, retries: int = 0,
               validate: str | None = "finite") -> Ticket:
        """Admit one decomposition request; returns a :class:`Ticket`.

        ``x`` (a tensor or numpy array) is placed, detached, on the
        service's device; the service keeps a reference to a tensor already
        there, so the caller must not write to it until the request
        completes.
        Validation (ranks vs the TRUE shape) happens here so a bad request
        fails its caller, not the wave that picks it up.
        ``validate="finite"`` (the default) additionally rejects NaN/Inf
        inputs at admission with :class:`~repro_torch.core.errors.InputError`
        naming the worst offending mode; pass ``validate="none"`` to skip
        the check on trusted traffic.  ``deadline_s`` bounds the request's
        total time in the service: a request still queued when its deadline
        passes fails with :class:`~repro_torch.core.errors.DeadlineError`
        instead of occupying a lane.  ``retries`` is a per-request budget of
        wave-level retry attempts (input/deadline/cancel failures never
        retry).

        When the queue is at ``max_queue``: ``backpressure="reject"``
        raises :class:`RejectedError` immediately; ``"block"`` waits for
        space — against the background worker when running, otherwise by
        pumping a wave inline (synchronous callers backpressure themselves
        by doing the work).
        """
        if self._closed:
            raise ServiceClosed("service is closed to new submissions")
        if validate is None:
            validate = "none"
        if validate not in VALIDATE_MODES:
            raise ValueError(f"validate {validate!r} not in {VALIDATE_MODES}")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("deadline_s must be > 0 (or None)")
        if retries < 0:
            raise ValueError("retries must be >= 0")
        t_adm = time.perf_counter()
        x = _as_tensor(x)
        shape = tuple(int(s) for s in x.shape)
        if config.ranks is not None:
            validate_ranks(shape, config.ranks)
        # rank-adaptive configs (error_target, ranks=None) have no ranks to
        # validate here: per-mode ranks resolve per input at execute time,
        # and the config's own __post_init__ already validated the target
        dtype = T.dtype_name(x.dtype)
        # detached: the worker thread's grad mode is its own, and a wave
        # serves values, never an autograd graph
        x = x.detach().to(self.device)
        if validate == "finite":
            check_finite(x, name="request input")
        pinned = self._pinned(config)
        bshape = self._policy.bucket_shape(shape)
        key = (bshape, dtype, pinned)
        deadline = t_adm + deadline_s if deadline_s is not None else None
        while True:
            with self._lock:
                if self._closed:
                    raise ServiceClosed("service is closed to new submissions")
                bs = self._buckets.get(key)
                if bs is None:
                    bs = self._buckets[key] = _BucketState(
                        key, self._breaker_threshold, self._breaker_cooldown)
                if self._max_queue is None or self._pending < self._max_queue:
                    if rid is None:
                        rid = self._next_rid
                    self._next_rid = max(self._next_rid, rid) + 1
                    job = _Job(rid, x, pinned, shape, key,
                               deadline=deadline, retries=retries)
                    bs.metrics.submitted += 1
                    self._counters["submitted"] += 1
                    if rid in self._orphans:
                        # rank 0's decision on this rid came before it
                        job.error = self._orphans.pop(rid)
                        bs.metrics.failed += 1
                        self._counters["failed"] += 1
                        job.event.set()
                        break
                    bs.queue.append(job)
                    self._pending += 1
                    self._work.notify_all()
                    break
                if self._backpressure == "reject":
                    bs.metrics.rejected += 1
                    self._counters["rejected"] += 1
                    self._emit("reject", rid=rid, shape=list(shape),
                               bucket=list(bshape))
                    raise RejectedError(
                        f"admission queue full ({self._max_queue} pending); "
                        "retry later or use backpressure='block'")
                if deadline is not None and self._chan is None and \
                        time.perf_counter() >= deadline:
                    # (on a mesh rank 0 expires it before its wave instead)
                    bs.metrics.rejected += 1
                    self._counters["rejected"] += 1
                    raise DeadlineError(
                        f"request missed its {deadline_s}s deadline while "
                        "blocked on admission (queue full)")
                if self._running:
                    self._space.wait(timeout=0.1)
                    continue
            # block policy, no worker: free space by running a wave here
            if not self._pump_once():
                raise RejectedError(
                    "queue full under backpressure='block' with no worker "
                    "running and no runnable wave")
        self._emit("submit", rid=job.rid, shape=list(shape),
                   bucket=list(bshape), padded=shape != bshape)
        return Ticket(rid=job.rid, shape=shape, bucket=bshape,
                      padded=shape != bshape, submitted_at=time.time(),
                      deadline_s=deadline_s, _job=job)

    # -- retrieval -----------------------------------------------------------
    def poll(self, ticket: Ticket) -> SthosvdResult | None:
        """Non-blocking: the request's result, or None while it is queued or
        in flight.  Re-raises the request's failure, if it failed."""
        job = ticket._job
        if job.error is not None:
            raise job.error
        return job.result

    def wait(self, ticket: Ticket, timeout: float | None = None) -> SthosvdResult:
        """Block until the request completes (driving the queue inline when
        no worker thread is running), then return its result."""
        job = ticket._job
        if not job.event.is_set() and not self._running:
            self.drain()
        if not job.event.wait(timeout):
            raise TimeoutError(f"request {ticket.rid} still pending after "
                               f"{timeout}s")
        return self.poll(ticket)

    def cancel(self, ticket: Ticket) -> bool:
        """Cancel a not-yet-dispatched request.  Returns True when the
        request was removed from its queue: its waiters unblock and
        ``poll``/``wait`` raise :class:`~repro_torch.core.errors.CancelledError`.
        Returns False when the request already dispatched or completed —
        in-flight work is never interrupted.  On a mesh only rank 0 cancels
        (its next decision cancels the request on every rank); on the other
        ranks this returns False."""
        job = ticket._job
        with self._lock:
            if self._chan is not None and not self._chan.leader:
                return False
            bs = self._buckets.get(job.key)
            if bs is None or job not in bs.queue:
                return False
            bs.queue.remove(job)
            self._cancel_locked(job)
            if self._chan is not None:
                self._cancel_out.append(job.rid)
        self._emit("cancel", rid=job.rid, bucket=list(job.key[0]))
        return True

    def _cancel_locked(self, job: _Job) -> None:
        """Fail a job taken off its queue with CancelledError (caller holds
        the lock)."""
        bs = self._buckets[job.key]
        self._inflight_jobs.discard(job)
        job.result = None
        job.error = CancelledError(
            f"request {job.rid} was cancelled before dispatch")
        self._pending -= 1
        self._counters["failed"] += 1
        bs.metrics.failed += 1
        bs.metrics.cancelled += 1
        self._res["cancelled"] += 1
        job.event.set()
        self._space.notify_all()
        self._idle.notify_all()

    @property
    def pending(self) -> int:
        """Requests admitted but not yet completed (queued + in flight)."""
        with self._lock:
            return self._pending

    # -- wave formation ------------------------------------------------------
    def _take_wave(self) -> tuple[_BucketState, list[_Job]] | None:
        """Pop the next wave: up to ``wave_slots`` requests from the bucket
        whose head request has waited longest (FIFO across buckets)."""
        with self._lock:
            ready = [bs for bs in self._buckets.values() if bs.queue]
            if not ready:
                return None
            bs = min(ready, key=lambda b: b.queue[0].t_submit)
            k = len(bs.queue) if self._policy.wave_slots is None \
                else min(len(bs.queue), self._policy.wave_slots)
            jobs = [bs.queue.popleft() for _ in range(k)]
            self._inflight_jobs.update(jobs)
            return bs, jobs

    def _job_block(self, j: _Job, bshape):
        """One lane's input block (padded up to the bucket when needed),
        with the per-job chaos seams: ``wave_job`` fires (raise/oom/slow)
        and a due ``wave_job_data`` nan-rule poisons this lane's data —
        the synthetic "one bad request inside a fused wave"."""
        _chaos.fire("wave_job", rid=j.rid)
        xb = j.x
        if j.shape != bshape:
            xb = pad_block(xb, bshape)
        if _chaos.active() and _chaos.poison("wave_job_data", rid=j.rid):
            xb = xb * float("nan")
        return xb

    def _stack_wave(self, jobs: list[_Job], bshape) -> torch.Tensor:
        """The lanes' blocks stacked, agreed on a mesh."""
        return self._agreed(lambda: torch.stack(
            [self._job_block(j, bshape) for j in jobs]), "the wave's sweep")

    def _agreed(self, fn, what: str):
        """``fn()``, with its outcome agreed on a mesh before any
        collective follows: every rank returns fn's value when every rank's
        ``fn`` succeeded, else every rank raises the same
        :class:`~repro_torch.core.distributed.MeshError` (of the largest
        failure code, chaining this rank's own failure).  Without a mesh,
        just ``fn()``."""
        if self._chan is None:
            return fn()
        out, exc = None, None
        try:
            out = fn()
        except Exception as e:  # noqa: BLE001 - agreed below
            exc = e
        code = self._chan.agree(OK if exc is None else failure_code(exc))
        if code != OK:
            raise mesh_error(code, what) from exc
        return out

    def _wave_event(self):
        """A CUDA event recorded on the service device's current stream
        after a wave's work (None on the CPU, where the work is done)."""
        if self.device.type != "cuda":
            return None
        evt = torch.cuda.Event()
        evt.record(torch.cuda.current_stream(self.device))
        return evt

    def _dispatch_wave(self, bs: _BucketState, jobs: list[_Job],
                       inflight: int = 0, decided=None):
        """Enqueue one wave on the device and hand back a ``finish()``
        closure that waits on the wave's event, completes the tickets, and
        updates metrics.  The pump keeps up to ``max_inflight_waves``
        dispatched-but-unfinished waves, so host-side stacking and padding
        overlap device execution; ``inflight`` is how many earlier waves
        were still in flight at this dispatch (recorded as pipeline
        occupancy).

        ``finish()`` is also where failure isolation lives: jobs whose
        results never materialized (wave exception, asynchronous device
        failure, or a non-finite fused lane) are recovered — fused groups
        by bisection, everything else by an exact isolated re-run — and
        whatever still fails comes back as a *classified* error.

        ``decided`` is rank 0's decision on a mesh, ``(expired rids,
        route)``: the wave takes it instead of reading this rank's clock
        and breaker."""
        bshape, dtype, cfg = bs.key
        t_start = time.perf_counter()
        done: list[tuple[_Job, SthosvdResult | None, TuckerPlan | None,
                         Exception | None]] = []
        # pre-wave deadline sweep: expired requests fail here, before the
        # wave is stacked, so they never occupy a lane
        live: list[_Job] = []
        for j in jobs:
            if (j.rid in decided[0] if decided is not None else
                    j.deadline is not None and t_start >= j.deadline):
                done.append((j, None, None, DeadlineError(
                    f"request {j.rid} missed its deadline before dispatch "
                    f"(queued {t_start - j.t_submit:.3f}s)")))
            else:
                live.append(j)
        lanes = len(live)
        fused_group: list[_Job] = []   # jobs sharing ONE stacked dispatch
        failed_lanes: list[_Job] = []  # fused lanes whose own solve raised
        wave_exc: Exception | None = None
        record = self._recording()
        with self._lock:
            self._active_bucket = bs.key
            if decided is not None:
                route = decided[1]
            else:
                route = bs.breaker.route(t_start) if (live and not record) \
                    else "fused"
            if route == "isolated":
                self._res["isolated_waves"] += 1
            elif route == "probe":
                self._res["probe_waves"] += 1
        try:
            if not live:
                pass
            elif record:
                for j in live:
                    done.append(self._run_recorded(j, bshape, dtype, cfg))
            elif route == "isolated":
                # breaker open: exact item-by-item execution at each
                # request's true shape — no fused wave left to poison
                for j in live:
                    done.append(self._run_isolated(j, bs))
            elif self._policy.pad_mode == "mask" and \
                    any(j.shape != bshape for j in live):
                # mask mode: mixed true shapes fuse into ONE batched wave at
                # the bucket shape; zero slack is arithmetically inert and
                # the factors' slack rows come back zero, so each lane
                # trims to its true shape afterwards
                p = self._plan_cached(bshape, dtype, cfg)
                self._agreed(lambda: _chaos.fire("wave", bucket=bshape,
                                                 n=len(live)),
                             "the wave's sweep")
                fused_group = list(live)
                stack = self._stack_wave(live, bshape)
                for j, r in zip(live, p._execute_lanes(stack,
                                                       keep_errors=True)):
                    if isinstance(r, Exception):
                        failed_lanes.append(j)
                        continue
                    r = trim_result(r, j.shape) if j.shape != bshape else r
                    done.append((j, r, p, None))
            else:
                exact = [j for j in live if j.shape == bshape]
                padded = [j for j in live if j.shape != bshape]
                if exact:
                    p = self._plan_cached(bshape, dtype, cfg)
                    self._agreed(lambda: _chaos.fire("wave", bucket=bshape,
                                                     n=len(exact)),
                                 "the wave's sweep")
                    if len(exact) == 1:
                        # singleton: share the unbatched cached sweep
                        self._agreed(lambda: _chaos.fire(
                            "wave_job", rid=exact[0].rid), "the wave's sweep")
                        res = p.execute(exact[0].x)
                        done.append((exact[0], res, p, None))
                    else:
                        fused_group = list(exact)
                        stack = self._stack_wave(exact, bshape)
                        for j, r in zip(exact, p._execute_lanes(
                                stack, keep_errors=True)):
                            if isinstance(r, Exception):
                                failed_lanes.append(j)
                            else:
                                done.append((j, r, p, None))
                if padded:
                    # the admission slot buffer: every padded member lands in
                    # a bucket-shaped slot; exact mode then slices the valid
                    # block back out (bitwise-lossless) and runs it through
                    # the plan its TRUE shape resolves to — the identical
                    # cached sweep a direct decompose() would run, which is
                    # what makes padded results bitwise-equal to unpadded
                    # execution
                    base = self._plans.get((bshape, dtype, cfg))
                    slots = torch.stack([pad_block(j.x, bshape)
                                         for j in padded])
                    for i, j in enumerate(padded):
                        self._agreed(lambda: _chaos.fire("wave_job",
                                                         rid=j.rid),
                                     f"request {j.rid}'s sweep")
                        tp = self._plan_cached(j.shape, dtype, cfg, base=base)
                        res = tp.execute(slice_valid(slots[i], j.shape))
                        done.append((j, res, tp, None))
        except Exception as e:  # noqa: BLE001 - recovered in finish(), not here
            wave_exc = e
        evt = self._wave_event()

        def finish():
            # 1) collect what needs recovery: jobs the wave never produced a
            #    result for, asynchronous device failures, and poisoned
            #    fused lanes
            fused_ids = {id(j) for j in fused_group}
            # a fused lane whose solve raised (e.g. eigh refusing a NaN
            # Gram) is quarantined like one that came back non-finite
            quarantine: list[_Job] = list(failed_lanes)
            other: list[_Job] = []
            if wave_exc is not None:
                executed = {id(j) for j, *_ in done}
                executed.update(id(j) for j in failed_lanes)
                other.extend(j for j in live if id(j) not in executed)
            synced = True
            if evt is not None:
                try:
                    evt.synchronize()
                except Exception:  # noqa: BLE001 - async failure -> recovery
                    synced = False
            final: list = []
            for j, res, p, err in done:
                if res is None:
                    final.append((j, res, p, err))
                    continue
                if not synced:
                    other.append(j)
                    continue
                if id(j) in fused_ids and not _finite(res.tucker.core):
                    # poisoned lane quarantine: re-derive THIS lane alone;
                    # every other lane keeps its fused result untouched
                    quarantine.append(j)
                    continue
                final.append((j, res, p, err))
            if self._chan is not None:
                # every rank recovers the lanes any rank must recover
                flags = {id(j): 1 for j in quarantine}
                flags.update((id(j), 2) for j in other)
                agreed, _ = self._chan.agree_lanes(
                    [flags.get(id(j), 0) for j in live])
                quarantine = [j for j, f in zip(live, agreed) if f == 1]
                other = [j for j, f in zip(live, agreed) if f == 2]
                final = [e for e in final if not any(
                    e[0] is j for j in quarantine + other)]
            recover = quarantine + other
            quarantined = len(quarantine)
            wave_ok = not recover
            if quarantined:
                with self._lock:
                    self._res["quarantined"] += quarantined
            # 2) recover: fused members by bisection on the same batched
            #    sweep (clean lanes stay bitwise-identical), the rest by one
            #    exact isolated re-run
            recovered_ids = {id(j) for j in recover}
            if recover:
                fused_rec = [j for j in recover if id(j) in fused_ids]
                other_rec = [j for j in recover if id(j) not in fused_ids]
                if fused_rec:
                    final.extend(self._bisect(bs, fused_rec))
                for j in other_rec:
                    final.append(self._run_isolated(j, bs))
            if self._chan is not None:
                final = self._agree_outcomes(jobs, final)
            # 3) breaker bookkeeping (fused waves only; recorded and
            #    already-isolated waves say nothing about the fused path)
            breaker_events = []
            if live and not record:
                with self._lock:
                    if route == "probe":
                        was = bs.breaker.state
                        bs.breaker.on_probe(wave_ok, time.perf_counter())
                        if wave_ok and was != "closed":
                            breaker_events.append(
                                ("breaker_close", {"bucket": list(bshape)}))
                    elif route == "fused":
                        if bs.breaker.on_result(wave_ok,
                                                time.perf_counter()):
                            breaker_events.append(
                                ("breaker_open",
                                 {"bucket": list(bshape),
                                  "after_failures": bs.breaker.consecutive}))
            # 4) retry budget: requeue retryable failures instead of
            #    completing them (bad-input / deadline / cancel never retry)
            requeue: list[_Job] = []
            completed: list = []
            for entry in final:
                j, res, p, err = entry
                if (err is not None and j.retries_left > 0
                        and not isinstance(err, _NO_RETRY)):
                    j.retries_left -= 1
                    requeue.append(j)
                else:
                    completed.append(entry)
            t_done = time.perf_counter()
            events = []
            with self._lock:
                self._inflight_jobs.difference_update(jobs)
                m = bs.metrics
                m.waves += 1
                m.pipelined_waves += inflight > 0
                m.inflight_sum += inflight
                m.lanes += lanes
                m.lanes_filled += len(live)
                m.quarantined += quarantined
                self._counters["batches"] += 1
                for j in requeue:
                    bs.queue.append(j)
                    m.retried += 1
                    self._res["retried"] += 1
                    events.append(("retry", {"rid": j.rid,
                                             "left": j.retries_left}))
                if requeue:
                    self._work.notify_all()
                for j, res, p, err in completed:
                    if j.event.is_set():
                        # already finalized elsewhere (cancelled while
                        # queued for retry, or abandoned by a force-stop)
                        continue
                    j.result, j.error = res, err
                    if err is not None:
                        m.failed += 1
                        self._counters["failed"] += 1
                        if isinstance(err, DeadlineError):
                            m.deadline_expired += 1
                            self._res["deadline_expired"] += 1
                        events.append(("error", {"rid": j.rid,
                                                 "error": repr(err)}))
                    else:
                        lat = t_done - j.t_submit
                        m.completed += 1
                        m.padded += j.shape != bshape
                        m.true_elems += math.prod(j.shape)
                        m.slot_elems += math.prod(bshape)
                        m.latency.add(lat)
                        m.queue_wait.add(t_start - j.t_submit)
                        m.backends[p.backend] = m.backends.get(p.backend, 0) + 1
                        for meth in p.methods:
                            m.solvers[meth] = m.solvers.get(meth, 0) + 1
                        if id(j) in recovered_ids:
                            m.recovered += 1
                            self._res["recovered"] += 1
                        self._counters["requests"] += 1
                        self._latency.add(lat)
                        events.append(("done", {
                            "rid": j.rid, "bucket": list(bshape),
                            "latency_s": round(lat, 6),
                            "backend": p.backend,
                            "pad_waste": round(pad_waste(j.shape, bshape), 6)}))
                    self._pending -= 1
                    j.event.set()
                if self._active_bucket == bs.key:
                    self._active_bucket = None
                self._space.notify_all()
                self._idle.notify_all()
            self._emit("wave", bucket=list(bshape),
                       lanes=lanes, filled=len(live),
                       pad_mode=self._policy.pad_mode, route=route,
                       wall_s=round(t_done - t_start, 6))
            for kind, fields in breaker_events:
                self._emit(kind, **fields)
            for kind, fields in events:
                self._emit(kind, **fields)
            if not record:
                # recorded waves fed drift per step (source="execute")
                # inside plan.execute already; here the only measurement
                # is the wave wall-clock, so amortize it across the wave's
                # completed jobs and attribute each job's share across its
                # plan's steps proportionally to their predictions — the
                # serve-traffic view of predicted-vs-actual calibration
                self._observe_wave_drift(completed, t_done - t_start)

        return finish

    def _recording(self) -> bool:
        tune = sys.modules.get("repro_torch.tune")
        return self._record or (tune is not None
                                and tune.active_sink() is not None)

    def _agree_outcomes(self, jobs: list[_Job], final: list) -> list:
        """On a mesh: each request's outcome agreed across the ranks, in
        the wave's order.  A request whose outcome class (a result, an
        error that never retries, or another error's failure code) differs
        between ranks fails on every rank with the agreed
        :class:`~repro_torch.core.distributed.MeshError`."""
        by_job = {id(e[0]): e for e in final}
        entries = [by_job[id(j)] for j in jobs]

        def status(err):
            if err is None:
                return 0
            return 1 if isinstance(err, _NO_RETRY) else 2 + failure_code(err)
        hi, lo = self._chan.agree_lanes([status(e[3]) for e in entries])
        out = []
        for (j, res, p, err), h, l in zip(entries, hi, lo):
            if h != l:
                agreed = mesh_error(OTHER if h < 3 else h - 2,
                                    f"request {j.rid} completed")
                agreed.__cause__ = err
                j, res, p, err = j, None, None, agreed
            out.append((j, res, p, err))
        return out

    # -- failure recovery ----------------------------------------------------
    def _fused_sync(self, bs: _BucketState, group: list[_Job]) -> list:
        """Re-run ``group`` as one fused wave on the bucket plan's batched
        sweep — the cache entry the original wave ran, so every lane's
        result is bitwise-identical to the one a clean wave would have
        produced.  Waits for the results and raises if any lane fails or
        comes back non-finite (the bisection then halves the group)."""
        bshape, dtype, cfg = bs.key
        p = self._plan_cached(bshape, dtype, cfg)
        stack = self._stack_wave(group, bshape)

        def run():
            out = []
            for j, r in zip(group, p.execute_batch(stack)):
                if not _finite(r.tucker.core):
                    raise NumericalError(
                        f"request {j.rid}: fused lane produced a non-finite "
                        "core (poisoned wave member)")
                rr = trim_result(r, j.shape) if j.shape != bshape else r
                out.append((j, rr, p, None))
            return out
        return self._agreed(run, "a bisected wave completed")

    def _bisect(self, bs: _BucketState, group: list[_Job]) -> list:
        """Wave bisection: retry the failed group fused; on failure halve
        it and recurse, so a single poisoned request is quarantined alone
        while its wave-mates complete.  The singleton base case falls back
        to an exact isolated run, whose failure comes back classified."""
        if not group:
            return []
        try:
            return self._fused_sync(bs, group)
        except Exception:  # noqa: BLE001 - halve and isolate
            if len(group) == 1:
                return [self._run_isolated(group[0], bs)]
            with self._lock:
                self._res["bisections"] += 1
            self._emit("bisect", bucket=list(bs.key[0]), n=len(group))
            mid = len(group) // 2
            return (self._bisect(bs, group[:mid])
                    + self._bisect(bs, group[mid:]))

    def _run_isolated(self, j: _Job, bs: _BucketState):
        """Exact single-request execution at the request's TRUE shape — the
        breaker-open path and the last resort for a quarantined request.
        Runs under ``validate="finite"`` so a poisoned result is caught
        (and the plan's own fallback ladder gets a chance to recover it);
        failures come back classified, never raw."""
        bshape, dtype, cfg = bs.key
        try:
            self._agreed(lambda: _chaos.fire("wave_job", rid=j.rid),
                         f"request {j.rid}'s isolated sweep")
            base = self._plans.get((bshape, dtype, cfg))
            tp = self._plan_cached(j.shape, dtype, cfg, base=base)
            res = tp.execute(j.x, validate="finite")
            return (j, res, tp, None)
        except Exception as e:  # noqa: BLE001 - per-job failure isolation
            return (j, None, None, coerce_exception(e))

    @staticmethod
    def _observe_wave_drift(done, wall_s: float) -> None:
        ok = [(j, p) for j, res, p, err in done
              if err is None and p is not None]
        if not ok or wall_s <= 0.0:
            return
        per_job = wall_s / len(ok)
        for _, p in ok:
            total_pred = p.total_predicted_s
            if total_pred <= 0.0:
                continue
            for s in p.schedule:
                _drift.MONITOR.observe(
                    platform=p.device.type, backend=s.backend,
                    solver=s.method, predicted_s=s.predicted_s,
                    actual_s=per_job * (s.predicted_s / total_pred),
                    source="serve")

    def _run_recorded(self, j: _Job, bshape, dtype, cfg):
        """Eager timed execution for one request: per-step wall-clock feeds
        the autotune flywheel (the ambient recording() sink sees the traces
        via plan.execute itself; ``record_store`` harvests them here)."""
        try:
            if self._policy.pad_mode == "mask" and j.shape != bshape:
                p = self._plan_cached(bshape, dtype, cfg)
                res = p.execute(pad_block(j.x, bshape), record=True)
                out = trim_result(res, j.shape)
            else:
                base = self._plans.get((bshape, dtype, cfg))
                p = self._plan_cached(j.shape, dtype, cfg, base=base)
                res = out = p.execute(j.x, record=True)
            if self._record_store is not None:
                from .. import tune
                tune.harvest_result(
                    res, self._record_store,
                    dtype=cfg.compute_dtype or dtype,
                    als_iters=cfg.als_iters)
            return (j, out, p, None)
        except Exception as e:  # noqa: BLE001 - per-job failure isolation
            return (j, None, None, coerce_exception(e))

    # -- pumping -------------------------------------------------------------
    def _pump_once(self) -> bool:
        """Run one wave to completion inline; False when nothing is queued."""
        if self._chan is not None:
            return self._mesh_round(once=True)
        wave = self._take_wave()
        if wave is None:
            return False
        self._dispatch_wave(*wave)()
        return True

    def drain(self) -> None:
        """Complete everything admitted so far.  With a worker running this
        waits; otherwise it pumps waves inline, keeping up to
        ``max_inflight_waves`` in flight while successors are stacked (the
        same pipelining the worker does)."""
        if self._running:
            with self._lock:
                while self._pending > 0 and self._running:
                    self._idle.wait(timeout=0.1)
            return
        if self._chan is not None:
            self._mesh_round()
            return
        inflight: deque = deque()
        while True:
            wave = self._take_wave()
            if wave is None:
                if inflight:
                    # retried jobs may have re-entered the queue from a
                    # finish(); complete in-flight waves, then re-check
                    inflight.popleft()()
                    continue
                break
            inflight.append(self._dispatch_wave(*wave,
                                                inflight=len(inflight)))
            while len(inflight) >= self._max_inflight:
                inflight.popleft()()
        while inflight:
            inflight.popleft()()

    # -- rank 0's decisions on a mesh -----------------------------------------
    def _announce_cancels(self) -> None:
        """Rank 0: send the cancels made since its last decision."""
        with self._lock:
            rids, self._cancel_out = self._cancel_out, []
        if rids:
            self._chan.send([_CANCEL, len(rids), *rids])

    def _lead_wave(self, bs: _BucketState, jobs: list[_Job]) -> None:
        """Rank 0: decide a taken wave (its expired requests and its route,
        on this rank's clock and breaker), send the decision, run it."""
        t = time.perf_counter()
        expired = [j.rid for j in jobs
                   if j.deadline is not None and t >= j.deadline]
        live = len(expired) < len(jobs)
        record = self._recording()
        with self._lock:
            route = bs.breaker.route(t) if live and not record else "fused"
        bshape = list(bs.key[0])
        self._chan.send([_WAVE, _ROUTES.index(route), len(bshape), *bshape,
                         len(jobs), *(j.rid for j in jobs), len(expired),
                         *expired])
        self._run_decided(bs, jobs, set(expired), route, [])

    def _follow(self, msg: list[int]) -> None:
        """Another rank: act on one of rank 0's decisions."""
        if msg[0] == _CANCEL:
            jobs, missing = self._hold(msg[2:2 + msg[1]])
            with self._lock:
                for j in jobs:
                    self._cancel_locked(j)
                for rid in missing:
                    self._orphans[rid] = CancelledError(
                        f"request {rid} was cancelled before dispatch")
            return
        route = _ROUTES[msg[1]]
        nb = msg[2]
        bshape = tuple(msg[3:3 + nb])
        rest = msg[3 + nb:]
        rids = rest[1:1 + rest[0]]
        rest = rest[1 + rest[0]:]
        expired = set(rest[1:1 + rest[0]])
        jobs, missing = self._hold(rids, bshape)
        bs = self._buckets[jobs[0].key] if jobs else None
        self._run_decided(bs, jobs, expired, route, missing)

    def _hold(self, rids: list[int], bshape=None):
        """Take the queued jobs of ``rids`` (in that order) off their
        queues, waiting up to ``decision_timeout_s`` for the ones this
        rank has not been submitted yet.  Returns (jobs, missing rids); a
        job of another bucket than ``bshape`` counts as missing."""
        stop = time.monotonic() + self._decision_timeout
        with self._lock:
            while True:
                found = {}
                for b in self._buckets.values():
                    for j in b.queue:
                        if j.rid in rids and j.rid not in found and (
                                bshape is None or tuple(j.key[0]) == bshape):
                            found[j.rid] = j
                if len(found) == len(set(rids)) or \
                        time.monotonic() >= stop:
                    break
                self._work.wait(timeout=0.01)
            jobs = [found[r] for r in dict.fromkeys(rids) if r in found]
            for j in jobs:
                self._buckets[j.key].queue.remove(j)
            if len({j.key for j in jobs}) > 1:
                missing = list(rids)   # not one bucket: the wave cannot run
            else:
                missing = [r for r in rids if r not in found]
            self._inflight_jobs.update(jobs)
            return jobs, missing

    def _run_decided(self, bs, jobs: list[_Job], expired: set, route: str,
                     missing: list[int]) -> None:
        """Every rank: agree that every rank holds the decided wave, then
        dispatch and finish it.  When a rank does not, every rank fails the
        jobs it holds with the same MeshError (a missing request fails with
        it on arrival), and a probe counts as failed."""
        code = self._chan.agree(OTHER if missing else OK)
        if code != OK:
            err = MeshError(
                f"a rank did not hold the wave's requests within "
                f"{self._decision_timeout}s of rank 0's decision")
            with self._lock:
                self._fail_locked(jobs, err)
                for rid in missing:
                    self._orphans[rid] = err
                if bs is not None and route == "probe":
                    bs.breaker.on_probe(False, time.perf_counter())
            return
        if not self._chan.leader:
            with self._lock:
                bs.breaker.follow(route)
        self._dispatch_wave(bs, jobs, decided=(expired, route))()

    def _lead_once(self) -> bool:
        """Rank 0: send the cancels made since its last decision, then
        decide and run one wave; False when none is queued."""
        self._announce_cancels()
        wave = self._take_wave()
        if wave is None:
            return False
        self._lead_wave(*wave)
        return True

    def _follow_until(self, end: int) -> tuple[list[int], bool]:
        """Another rank: act on rank 0's decisions (skipping its
        heartbeats) until its message of kind ``end``.  Returns that
        message and whether a wave ran."""
        ran = False
        while True:
            msg = self._chan.recv()
            if msg[0] == end:
                return msg, ran
            if msg[0] != _IDLE:
                self._follow(msg)
                ran = ran or msg[0] == _WAVE

    def _mesh_round(self, once: bool = False) -> bool:
        """The synchronous pump on a mesh: rank 0 decides waves (one when
        ``once``) until its queue is empty, then sends the round's end;
        the other ranks follow until it.  True when a wave ran."""
        if not self._chan.leader:
            return self._follow_until(_END)[1]
        ran = False
        while not (once and ran) and self._lead_once():
            ran = True
        self._chan.send([_END])
        return ran

    def _lead_pump(self) -> None:
        """Rank 0's worker: decide waves as they form; tell an idle mesh
        it is alive every ``_HEARTBEAT_S``; return when stopped."""
        last = time.monotonic()
        while True:
            if _chaos.active():
                _chaos.fire("worker")
            with self._lock:
                if not self._running:
                    return
            if self._lead_once():
                last = time.monotonic()
                continue
            if time.monotonic() - last >= _HEARTBEAT_S:
                self._chan.send([_IDLE])
                last = time.monotonic()
            with self._lock:
                if self._running and not any(
                        b.queue for b in self._buckets.values()):
                    self._work.wait(timeout=0.05)

    def _follow_pump(self) -> None:
        """Another rank's worker: follow rank 0's decisions until its
        stop, which says whether unfinished work is abandoned."""
        msg, _ = self._follow_until(_STOP)
        self._stop_force = bool(msg[1])

    # -- background worker (async mode) --------------------------------------
    def start(self) -> "TuckerService":
        """Spawn the background wave pump; ``submit`` becomes fire-and-
        forget and ``poll``/``wait`` observe completions as they land.  On
        a mesh every rank starts its worker: rank 0's decides the waves,
        the others' follow."""
        with self._lock:
            if self._running:
                return self
            self._running = True
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name="tucker-service")
        self._thread.start()
        return self

    def stop(self, drain: bool = True, *, force: bool = False,
             join_timeout: float = 30.0) -> None:
        """Stop the worker.  ``drain=True`` (default) completes the queue
        first; ``force=True`` abandons queued AND in-flight work instead —
        every unfinished job fails with a classified
        :class:`~repro_torch.core.errors.ResourceError` and its waiters
        unblock immediately.  If the worker thread does not join within
        ``join_timeout`` seconds (a wedged wave), a ``RuntimeWarning``
        names the bucket it was last dispatching instead of returning
        silently; the daemonic thread is then abandoned.

        On a mesh rank 0's stop ends every rank's worker: its worker sends
        the stop (with ``force``, every rank then abandons its unfinished
        jobs, once the wave in flight has finished on every rank).  The
        other ranks' ``stop`` waits for it."""
        if self._running and drain and not force:
            self.drain()
        follower = self._chan is not None and not self._chan.leader
        with self._lock:
            if not follower:
                self._running = False
            if force and self._chan is not None:
                self._stop_force = self._stop_force or not follower
            elif force:
                self._abandon_unfinished_locked(_FORCED)
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=join_timeout)
            if self._thread.is_alive():
                with self._lock:
                    stuck = self._active_bucket
                where = ("bucket " + "x".join(str(s) for s in stuck[0])
                         if stuck else "an unknown bucket")
                if follower:
                    where += " (or waiting for rank 0's stop)"
                warnings.warn(
                    f"service worker did not stop within {join_timeout}s; "
                    f"it was last dispatching {where} — abandoning the "
                    "daemonic worker thread (use stop(force=True) to fail "
                    "its jobs immediately)", RuntimeWarning, stacklevel=2)
            self._thread = None

    def _abandon_unfinished_locked(self, reason: str) -> None:
        """Fail every queued and in-flight job with a ResourceError (caller
        holds the lock).  The finish() of a still-running wave skips jobs
        whose event is already set, so nothing is completed twice."""
        stranded: list[_Job] = []
        for bs in self._buckets.values():
            while bs.queue:
                stranded.append(bs.queue.popleft())
        stranded.extend(self._inflight_jobs)
        self._fail_locked(stranded, ResourceError(reason))

    def _fail_locked(self, jobs: list[_Job], err: Exception) -> None:
        """Complete unfinished ``jobs`` (off their queues) with ``err``
        (caller holds the lock)."""
        for j in jobs:
            self._inflight_jobs.discard(j)
            if j.event.is_set():
                continue
            j.result, j.error = None, err
            self._pending -= 1
            self._counters["failed"] += 1
            self._buckets[j.key].metrics.failed += 1
            j.event.set()
        self._idle.notify_all()
        self._space.notify_all()

    def close(self) -> None:
        """Refuse new submissions, drain what's queued, stop the worker,
        release a mesh's decision group and close the trace file.  On a
        mesh every rank closes (its drain is a round of rank 0's); after
        a mesh worker died its peers may be gone, so nothing is drained."""
        with self._lock:
            self._closed = True
        if self._running:
            self.stop(drain=True)
        elif self._chan is None or not self._worker_failed:
            self.drain()
        if self._chan is not None:
            self._chan.close()
        if self._trace:
            self._trace.close()

    def __enter__(self) -> "TuckerService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _pump(self) -> None:
        inflight: deque = deque()
        died: Exception | None = None
        try:
            if self._chan is not None:
                (self._lead_pump if self._chan.leader else
                 self._follow_pump)()
                return
            while True:
                if _chaos.active():
                    _chaos.fire("worker")
                wave = self._take_wave()
                if wave is None:
                    if inflight:
                        inflight.popleft()()
                        continue   # completions may have unblocked submits
                    with self._lock:
                        if not self._running:
                            break
                        if not any(b.queue for b in self._buckets.values()):
                            self._work.wait(timeout=0.05)
                    continue
                inflight.append(self._dispatch_wave(*wave,
                                                    inflight=len(inflight)))
                while len(inflight) >= self._max_inflight:
                    inflight.popleft()()
        except Exception as e:  # noqa: BLE001 - a dying pump must fail its jobs
            died = e
        finally:
            while inflight:
                inflight.popleft()()
            # a dying pump must not strand waiters: fail whatever remains
            with self._lock:
                if self._chan is not None and died is None:
                    # a mesh worker's orderly end: rank 0 stopped
                    self._running = False
                    if self._stop_force:
                        self._abandon_unfinished_locked(_FORCED)
                elif self._running:   # left the loop on an unexpected error
                    self._running = False
                    self._worker_failed = True
                    reason = "service worker died; request was never executed"
                    if died is not None:
                        reason += f" (worker failure: {died!r})"
                    self._abandon_unfinished_locked(reason)
                self._idle.notify_all()
                self._space.notify_all()
            if self._chan is not None and self._chan.leader:
                # every rank's worker ends with rank 0's (after its own
                # waiters were released: a dead peer times this out)
                try:
                    self._chan.send([_STOP, int(self._stop_force
                                                or died is not None)])
                except Exception:  # noqa: BLE001 - the channel itself failed
                    pass

    # -- observability -------------------------------------------------------
    def _bucket_label(self, key, taken: set) -> str:
        bshape, dtype, cfg = key
        policy = (f"e{cfg.error_target:g}" if cfg.ranks is None
                  else "x".join(str(r) for r in cfg.ranks))
        label = "x".join(str(s) for s in bshape) + f"/{dtype}/r{policy}"
        if cfg.variant != "sthosvd":
            label += f"/{cfg.variant}"
        base, k = label, 2
        while label in taken:
            label, k = f"{base}#{k}", k + 1
        taken.add(label)
        return label

    def health(self) -> dict:
        """Liveness/readiness probe: ``"ok"`` | ``"degraded"`` (some
        bucket's breaker is not closed — fused serving suspended there) |
        ``"unhealthy"`` (the worker died unexpectedly).  Cheap: counters
        only, never touches the device."""
        with self._lock:
            taken: set = set()
            open_buckets = [self._bucket_label(bs.key, taken)
                            for bs in self._buckets.values()
                            if bs.breaker.state != "closed"]
            if self._worker_failed:
                status = "unhealthy"
            elif open_buckets:
                status = "degraded"
            else:
                status = "ok"
            return {
                "status": status,
                "worker": ("failed" if self._worker_failed else
                           "running" if self._running else "stopped"),
                "pending": self._pending,
                "breakers_open": open_buckets,
            }

    def stats(self) -> dict:
        """Operator snapshot: global counters + per-bucket observability
        (p50/p95/p99 latency ms, queue depth, pad-waste, occupancy,
        backend/solver counts).  ``resilience`` aggregates the failure-
        isolation machinery (deadlines, cancels, retries, bisections,
        quarantines, breaker trips) and each bucket snapshot carries its
        breaker state."""
        with self._lock:
            taken: set = set()
            buckets = {}
            backends: dict = {}
            solvers: dict = {}
            true_elems = slot_elems = 0
            trips = reopens = open_count = 0
            for key, bs in self._buckets.items():
                snap = bs.metrics.snapshot(queue_depth=len(bs.queue))
                snap["breaker"] = bs.breaker.snapshot()
                buckets[self._bucket_label(key, taken)] = snap
                trips += bs.breaker.trips
                reopens += bs.breaker.reopens
                open_count += bs.breaker.state != "closed"
                for k, v in bs.metrics.backends.items():
                    backends[k] = backends.get(k, 0) + v
                for k, v in bs.metrics.solvers.items():
                    solvers[k] = solvers.get(k, 0) + v
                true_elems += bs.metrics.true_elems
                slot_elems += bs.metrics.slot_elems
            elapsed = time.perf_counter() - self._t0
            return {
                **self._counters,
                "pending": self._pending,
                "max_inflight_waves": self._max_inflight,
                "n_buckets": len(self._buckets),
                "backends": backends,
                "solvers": solvers,
                "pad_waste": round(1.0 - true_elems / slot_elems, 6)
                             if slot_elems else 0.0,
                "throughput_rps": self._counters["requests"] / elapsed
                                  if elapsed > 0 else 0.0,
                "latency": self._latency.snapshot_ms(),
                "buckets": buckets,
                "resilience": {
                    **self._res,
                    "breaker_trips": trips,
                    "breaker_reopens": reopens,
                    "breakers_open": open_count,
                },
                # process-wide observability riding the operator snapshot:
                # sweep-cache behaviour and predicted-vs-actual drift
                "sweep_cache": dict(CACHE_STATS),
                "drift": _drift.MONITOR.summary(),
            }
