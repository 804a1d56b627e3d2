"""Per-bucket observability for the streaming Tucker service.

The port's own copy of ``repro/serve/metrics.py``: counters + latency
windows per bucket, a thread-safe JSONL trace writer, and snapshot helpers
that :meth:`repro_torch.serve.service.TuckerService.stats` assembles into
one operator-facing dict.  Everything here is plain Python (no torch) so
metric reads never touch the device.
"""

from __future__ import annotations

import json
import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path

#: latency percentiles every snapshot reports, as (label, q) pairs
PERCENTILES = (("p50_ms", 50.0), ("p95_ms", 95.0), ("p99_ms", 99.0))


class LatencyWindow:
    """Sliding window of the last ``maxlen`` latency samples (seconds).

    Percentiles are computed on demand over the window by linear
    interpolation — recent-traffic figures, not lifetime averages, which is
    what an SLO dashboard wants.  ``count``/``total_s`` keep lifetime sums
    for mean/throughput math.
    """

    def __init__(self, maxlen: int = 2048):
        self._window: deque[float] = deque(maxlen=maxlen)
        self.count = 0
        self.total_s = 0.0

    def add(self, seconds: float) -> None:
        self._window.append(float(seconds))
        self.count += 1
        self.total_s += float(seconds)

    @staticmethod
    def _interp(xs: list, q: float) -> float:
        """q-th percentile of an already-sorted sample list."""
        if not xs:
            return 0.0
        rank = (len(xs) - 1) * q / 100.0
        lo = math.floor(rank)
        hi = min(lo + 1, len(xs) - 1)
        return xs[lo] + (xs[hi] - xs[lo]) * (rank - lo)

    def percentile(self, q: float) -> float:
        """q-th percentile (0..100) of the window in SECONDS; 0.0 empty."""
        return self._interp(sorted(self._window), q)

    def snapshot_ms(self) -> dict:
        # one sort for all percentiles (snapshot_ms used to re-sort the
        # window per percentile — 3x per snapshot)
        xs = sorted(self._window)
        out = {label: self._interp(xs, q) * 1e3 for label, q in PERCENTILES}
        out["mean_ms"] = (self.total_s / self.count * 1e3) if self.count else 0.0
        # windowed mean, over the same samples the percentiles saw — the
        # lifetime mean_ms can sit far from p50 after a traffic shift
        out["window_mean_ms"] = (sum(xs) / len(xs) * 1e3) if xs else 0.0
        return out


@dataclass
class BucketMetrics:
    """Counters for one shape bucket.  Mutated under the service lock."""
    bucket: tuple[int, ...]
    submitted: int = 0
    completed: int = 0
    rejected: int = 0
    failed: int = 0
    padded: int = 0              # completed requests that carried slack
    waves: int = 0
    pipelined_waves: int = 0     # waves dispatched while another was in flight
    inflight_sum: int = 0        # Σ waves already in flight at each dispatch
    lanes: int = 0               # total lanes dispatched
    lanes_filled: int = 0        # lanes carrying a real request
    true_elems: int = 0          # sum of completed requests' true sizes
    slot_elems: int = 0          # sum of the slots they occupied
    cancelled: int = 0           # removed from the queue before dispatch
    deadline_expired: int = 0    # failed with DeadlineError (never ran)
    retried: int = 0             # wave failures re-enqueued under a budget
    quarantined: int = 0         # poisoned fused lanes re-derived alone
    recovered: int = 0           # completed only after bisection/isolation
    backends: dict = field(default_factory=dict)
    solvers: dict = field(default_factory=dict)
    latency: LatencyWindow = field(default_factory=LatencyWindow)
    queue_wait: LatencyWindow = field(default_factory=LatencyWindow)

    @property
    def pad_waste(self) -> float:
        """Fraction of slot elements that were slack across completed
        requests (0.0 = every request fit its bucket exactly)."""
        return 1.0 - self.true_elems / self.slot_elems if self.slot_elems \
            else 0.0

    @property
    def occupancy(self) -> float:
        """Filled fraction of dispatched lanes (the port adds no zero-filled
        lanes, so 1.0 once a wave ran)."""
        return self.lanes_filled / self.lanes if self.lanes else 0.0

    @property
    def pipeline_occupancy(self) -> float:
        """Fraction of this bucket's waves dispatched while at least one
        earlier wave was still in flight (0.0 = fully serial dispatch,
        → 1.0 = the device never waited for host-side wave stacking)."""
        return self.pipelined_waves / self.waves if self.waves else 0.0

    @property
    def avg_inflight(self) -> float:
        """Mean number of waves already in flight at each dispatch (bounded
        by the service's ``max_inflight_waves`` − 1)."""
        return self.inflight_sum / self.waves if self.waves else 0.0

    def snapshot(self, queue_depth: int = 0) -> dict:
        return {
            "bucket": list(self.bucket),
            "submitted": self.submitted, "completed": self.completed,
            "rejected": self.rejected, "failed": self.failed,
            "padded": self.padded, "waves": self.waves,
            "pipelined_waves": self.pipelined_waves,
            "pipeline_occupancy": round(self.pipeline_occupancy, 6),
            "avg_inflight": round(self.avg_inflight, 6),
            "queue_depth": queue_depth,
            "pad_waste": round(self.pad_waste, 6),
            "occupancy": round(self.occupancy, 6),
            "backends": dict(self.backends), "solvers": dict(self.solvers),
            "latency": self.latency.snapshot_ms(),
            "queue_wait": self.queue_wait.snapshot_ms(),
            "resilience": {
                "cancelled": self.cancelled,
                "deadline_expired": self.deadline_expired,
                "retried": self.retried,
                "quarantined": self.quarantined,
                "recovered": self.recovered,
            },
        }


class TraceWriter:
    """Append-only JSONL event log (one object per line), thread-safe.

    Events carry a wall-clock ``t`` and a ``kind`` (``submit`` | ``wave``
    | ``done`` | ``reject`` | ``error``); everything else is free-form.
    The file handle opens lazily and every event is flushed — a crashed
    service leaves a readable trace (the same interrupted-append tolerance
    the tune store practices).

    A writer also works as a :mod:`repro_torch.obs` event-bus sink
    (``obs.add_sink(writer.handle)``): bus events are plain dicts in the
    same schema, so span and cache events land in the same JSONL stream
    the serve events always used.

    ``event()`` after :meth:`close` raises ``ValueError`` — it used to
    silently reopen the file, so a "closed" trace kept growing.
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._lock = threading.Lock()
        self._fh = None
        self._closed = False

    def _write(self, obj: dict) -> None:
        line = json.dumps(obj, default=repr)
        with self._lock:
            if self._closed:
                raise ValueError(
                    f"TraceWriter for {self.path} is closed; events after "
                    "close() are a bug in the caller (the writer used to "
                    "silently reopen the file here)")
            if self._fh is None:
                self.path.parent.mkdir(parents=True, exist_ok=True)
                self._fh = self.path.open("a")
            self._fh.write(line + "\n")
            self._fh.flush()

    def event(self, kind: str, **fields) -> None:
        self._write({"t": time.time(), "kind": kind, **fields})

    def handle(self, evt: dict) -> None:
        """Event-bus sink adapter: append one already-shaped event dict
        (``{"t": ..., "kind": ..., ...}``) as a JSONL line."""
        self._write(evt)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._fh is not None:
                self._fh.close()
                self._fh = None
