"""Counter / gauge / histogram registry with Prometheus text exposition.

The port's copy of ``repro/obs/metrics.py``: the PROCESS-wide metric surface
every layer shares.  The fallback ladder counts its hops here
(``atucker_fallback_hops_total``, by hop and backend), and
:func:`absorb_service_stats` folds a serve service's ``stats()`` snapshot
in (the reference's schema), so one scrape of
:meth:`MetricsRegistry.render` sees the whole stack.

Everything is stdlib + threads; label sets are sorted key/value tuples so
series identity is order-independent, matching Prometheus semantics.
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_left

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "absorb_service_stats"]

#: default histogram bucket boundaries (seconds-flavored, widely useful)
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)


def _labelset(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(ls: tuple, extra: tuple = ()) -> str:
    items = [*ls, *extra]
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in items) + "}"


class _Metric:
    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        self._lock = threading.Lock()
        self._series: dict[tuple, float] = {}

    def _bump(self, labels: dict, value: float, *, add: bool) -> None:
        ls = _labelset(labels)
        with self._lock:
            self._series[ls] = (self._series.get(ls, 0.0) + value) if add \
                else value

    def value(self, **labels) -> float:
        with self._lock:
            return self._series.get(_labelset(labels), 0.0)

    def series(self) -> dict[tuple, float]:
        with self._lock:
            return dict(self._series)

    def clear(self) -> None:
        """Drop every series (a reset for tests and process-local views)."""
        with self._lock:
            self._series.clear()


class Counter(_Metric):
    """Monotone counter; ``inc`` with negative amounts is rejected."""
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc({amount}))")
        self._bump(labels, amount, add=True)

    def render(self) -> list[str]:
        return [f"{self.name}{_fmt_labels(ls)} {v:g}"
                for ls, v in sorted(self.series().items())]


class Gauge(_Metric):
    """Set-to-current-value metric."""
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._bump(labels, float(value), add=False)

    def inc(self, amount: float = 1.0, **labels) -> None:
        self._bump(labels, amount, add=True)

    def render(self) -> list[str]:
        return [f"{self.name}{_fmt_labels(ls)} {v:g}"
                for ls, v in sorted(self.series().items())]


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: each ``le``
    bucket counts observations ≤ its bound, ``+Inf`` counts all)."""
    kind = "histogram"

    def __init__(self, name: str, help_: str, buckets=DEFAULT_BUCKETS):
        self.name = name
        self.help = help_
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._lock = threading.Lock()
        # per labelset: [per-bucket counts..., +Inf count], sum
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}

    def observe(self, value: float, **labels) -> None:
        ls = _labelset(labels)
        idx = bisect_left(self.buckets, value)
        with self._lock:
            counts = self._counts.setdefault(ls,
                                             [0] * (len(self.buckets) + 1))
            counts[idx] += 1
            self._sums[ls] = self._sums.get(ls, 0.0) + value

    def count(self, **labels) -> int:
        with self._lock:
            return sum(self._counts.get(_labelset(labels), ()))

    def render(self) -> list[str]:
        out = []
        with self._lock:
            items = sorted((ls, list(c), self._sums.get(ls, 0.0))
                           for ls, c in self._counts.items())
        for ls, counts, total in items:
            cum = 0
            for bound, c in zip(self.buckets, counts):
                cum += c
                out.append(f"{self.name}_bucket"
                           f"{_fmt_labels(ls, (('le', f'{bound:g}'),))} "
                           f"{cum}")
            cum += counts[-1]
            out.append(f"{self.name}_bucket"
                       f"{_fmt_labels(ls, (('le', '+Inf'),))} {cum}")
            out.append(f"{self.name}_sum{_fmt_labels(ls)} {total:g}")
            out.append(f"{self.name}_count{_fmt_labels(ls)} {cum}")
        return out


class MetricsRegistry:
    """Named metric registry: ``counter``/``gauge``/``histogram`` return
    the existing metric on repeat calls (idempotent, so module-level
    wiring never double-registers) and :meth:`render` emits the whole
    registry as Prometheus text exposition format."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get(self, cls, name: str, help_: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help_, **kw)
            elif not isinstance(m, cls):
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{type(m).__name__}")
            return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(Counter, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(Gauge, name, help_)

    def histogram(self, name: str, help_: str = "",
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help_, buckets=buckets)

    def render(self) -> str:
        lines = []
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, m in metrics:
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            lines.extend(m.render())
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


#: the process-wide registry (use your own MetricsRegistry to isolate)
REGISTRY = MetricsRegistry()


def absorb_service_stats(stats: dict,
                         registry: MetricsRegistry = REGISTRY,
                         service: str = "tucker") -> None:
    """Fold one :meth:`TuckerService.stats` snapshot into the registry:
    global counters become labeled counters-as-gauges (a snapshot is a
    level, not an increment), per-bucket latency percentiles / pad-waste /
    occupancy become gauges labeled by bucket."""
    g = registry.gauge
    for key in ("submitted", "requests", "rejected", "failed", "batches",
                "plans_built", "pending"):
        if key in stats:
            g(f"atucker_serve_{key}",
              f"service {key} (lifetime snapshot)").set(
                  stats[key], service=service)
    g("atucker_serve_throughput_rps", "completed requests per second").set(
        stats.get("throughput_rps", 0.0), service=service)
    g("atucker_serve_pad_waste", "slack fraction of slot elements").set(
        stats.get("pad_waste", 0.0), service=service)
    for label, q in (("p50_ms", "p50"), ("p95_ms", "p95"), ("p99_ms", "p99")):
        if label in stats.get("latency", {}):
            g("atucker_serve_latency_ms",
              "windowed request latency percentiles").set(
                  stats["latency"][label], service=service, quantile=q)
    for bucket, b in stats.get("buckets", {}).items():
        for key in ("completed", "waves", "queue_depth"):
            g(f"atucker_bucket_{key}", f"per-bucket {key}").set(
                b[key], service=service, bucket=bucket)
        for key in ("pad_waste", "occupancy", "pipeline_occupancy"):
            g(f"atucker_bucket_{key}", f"per-bucket {key}").set(
                b[key], service=service, bucket=bucket)
        for label, q in (("p50_ms", "p50"), ("p95_ms", "p95"),
                         ("p99_ms", "p99")):
            g("atucker_bucket_latency_ms",
              "per-bucket latency percentiles").set(
                  b["latency"][label], service=service, bucket=bucket,
                  quantile=q)
        for solver, n in b.get("solvers", {}).items():
            g("atucker_bucket_solver_requests",
              "completed requests per solver").set(
                  n, service=service, bucket=bucket, solver=solver)


def quantile_from_histogram(hist: Histogram, q: float, **labels) -> float:
    """Linear-interpolated quantile estimate from a histogram's cumulative
    buckets (the registry-side mirror of LatencyWindow.percentile)."""
    ls = _labelset(labels)
    with hist._lock:
        counts = list(hist._counts.get(ls, ()))
    if not counts or not sum(counts):
        return 0.0
    total = sum(counts)
    target = q / 100.0 * total
    cum = 0
    lo = 0.0
    for bound, c in zip(hist.buckets, counts):
        if cum + c >= target and c:
            return lo + (bound - lo) * (target - cum) / c
        cum += c
        lo = bound
    return hist.buckets[-1] if not math.isinf(hist.buckets[-1]) else lo
