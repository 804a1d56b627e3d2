"""repro_torch.obs — unified observability: span tracing, metrics, drift.

The port's copy of ``repro.obs``: one event bus for the whole stack
(:mod:`repro_torch.obs.trace`), exporters to Chrome-trace/Perfetto and
JSONL (:mod:`repro_torch.obs.export`), a Prometheus-style metrics registry
(:mod:`repro_torch.obs.metrics`), and a predicted-vs-actual drift monitor
(:mod:`repro_torch.obs.drift`).  Nothing here imports jax or ``repro``.

Quick start::

    from repro_torch import obs

    with obs.capture() as buf:          # enables tracing for the block
        p = plan(x.shape, x.dtype, cfg)
        p.execute(x)
    obs.write_chrome(buf.events(), "trace.json")   # open in Perfetto

    print(obs.REGISTRY.render())        # Prometheus text exposition
    print(obs.MONITOR.report())         # predicted-vs-actual drift

Span tracing is OFF by default; enable with ``obs.enable()``, the
``ATUCKER_OBS=1`` env var, or an ``obs.capture()`` block.  The drift
monitor is fed directly by the execution layers and stays on always.
CLI: ``python -m repro_torch.obs report|export``.
"""

from .trace import (EventBuffer, add_sink, capture, disable, enable,
                    enabled, event, iter_spans, remove_sink, span)
from .metrics import (REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,
                      absorb_service_stats)
from .export import read_jsonl, to_chrome, write_chrome, write_jsonl
from .drift import MONITOR, DriftMonitor, MemoryWatch

__all__ = [
    # trace
    "EventBuffer", "add_sink", "capture", "disable", "enable", "enabled",
    "event", "iter_spans", "remove_sink", "span",
    # metrics
    "REGISTRY", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "absorb_service_stats",
    # export
    "read_jsonl", "to_chrome", "write_chrome", "write_jsonl",
    # drift
    "MONITOR", "DriftMonitor", "MemoryWatch",
]
