"""Predicted-vs-actual drift monitor for calibrations and selector models.

The port's copy of ``repro/obs/drift.py``.  Every plan stamps
``predicted_s`` on its steps when a calibrated
:class:`~repro_torch.core.cost_model.CostModel` is available, and every
recorded execution produces :class:`~repro_torch.core.sthosvd.ModeTrace`
rows with real wall-clock ``seconds``.  This module closes the loop:
execution layers feed ``(platform, backend, solver, predicted_s,
actual_s)`` observations into the process-wide :data:`MONITOR` (a few dict
ops — cheap enough to stay ON even when span tracing is off), which
accumulates log-ratio statistics per cell and flags cells whose
predictions have drifted.  The port's platform key is the device type,
``"cuda"`` or ``"cpu"``.

* ratio ``actual / predicted`` is tracked in log-space, so over- and
  under-prediction are symmetric and the geometric mean is the natural
  "how far off" scalar;
* a cell is **stale** when it has ``n >= min_samples`` observations, the
  one-sample-t-style z-score ``mean / (std / sqrt(n))`` clears
  ``z_threshold``, and the geometric-mean ratio sits outside
  ``[1/tolerance, tolerance]`` — all three, so a noisy-but-centred cell
  or a consistently-but-trivially-off cell is left alone;
* stale cells yield recommendations naming the command that repairs them
  (:data:`TUNE_CLI` ``calibrate`` for cost-model cells, ``... train`` when
  the selector itself chose the solver).

Memory drift is the same idea for space: modeled ``plan.peak_bytes`` vs
the high-water mark that :class:`MemoryWatch` reads on one device (the
CUDA allocator's peak on the card, the bytes of live tensors on the CPU;
the only torch import in this module, done lazily).
"""

from __future__ import annotations

import math
import threading
import time

__all__ = ["DriftCell", "DriftMonitor", "MONITOR", "MemoryWatch",
           "TUNE_CLI", "observe", "observe_traces", "reset"]

#: the command prefix of the repair recommendations (the port's autotune
#: flywheel, the counterpart of ``python -m repro.tune``)
TUNE_CLI = "python -m repro_torch.tune"


class DriftCell:
    """Running log-ratio statistics for one (platform, backend, solver)."""
    __slots__ = ("n", "sum_log", "sum_log2", "sum_pred", "sum_actual",
                 "last_t", "sources")

    def __init__(self):
        self.n = 0
        self.sum_log = 0.0
        self.sum_log2 = 0.0
        self.sum_pred = 0.0
        self.sum_actual = 0.0
        self.last_t = 0.0
        self.sources: dict[str, int] = {}

    def add(self, predicted_s: float, actual_s: float, source: str) -> None:
        r = math.log(actual_s / predicted_s)
        self.n += 1
        self.sum_log += r
        self.sum_log2 += r * r
        self.sum_pred += predicted_s
        self.sum_actual += actual_s
        self.last_t = time.time()
        self.sources[source] = self.sources.get(source, 0) + 1

    @property
    def mean_log(self) -> float:
        return self.sum_log / self.n if self.n else 0.0

    @property
    def std_log(self) -> float:
        if self.n < 2:
            return 0.0
        var = (self.sum_log2 - self.sum_log * self.sum_log / self.n) \
            / (self.n - 1)
        return math.sqrt(max(var, 0.0))

    @property
    def ratio(self) -> float:
        """Geometric-mean actual/predicted (1.0 = perfectly calibrated)."""
        return math.exp(self.mean_log)

    def z_score(self) -> float:
        """How many standard errors the mean log-ratio sits from 0."""
        if self.n < 2:
            return 0.0
        se = self.std_log / math.sqrt(self.n)
        if se == 0.0:
            # zero observed variance: any nonzero mean is infinitely
            # significant; cap so reports stay finite
            return 0.0 if self.mean_log == 0.0 else \
                math.copysign(99.0, self.mean_log)
        # near-identical observations (e.g. one wave's amortized shares)
        # make se vanishingly small; clamp so reports stay readable
        return max(-99.0, min(99.0, self.mean_log / se))


class DriftMonitor:
    """Aggregates timing + memory drift observations process-wide."""

    def __init__(self, *, min_samples: int = 5, z_threshold: float = 3.0,
                 tolerance: float = 1.5):
        self.min_samples = min_samples
        self.z_threshold = z_threshold
        self.tolerance = tolerance
        self._lock = threading.Lock()
        self._cells: dict[tuple[str, str, str], DriftCell] = {}
        # memory drift: keyed by backend → (modeled, observed, t) latest
        self._mem: dict[str, dict] = {}

    # ------------------------------------------------------------ feeding
    def observe(self, *, platform: str, backend: str, solver: str,
                predicted_s: float, actual_s: float,
                source: str = "execute") -> None:
        """Record one predicted-vs-actual pair.  Pairs without a positive
        prediction (uncalibrated plans) or measurement are ignored."""
        if not (predicted_s and predicted_s > 0.0 and actual_s
                and actual_s > 0.0):
            return
        key = (str(platform), str(backend), str(solver))
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells[key] = DriftCell()
            cell.add(predicted_s, actual_s, source)

    def observe_traces(self, traces, *, platform: str, backend: str,
                       source: str = "execute") -> int:
        """Feed a sequence of :class:`ModeTrace`-likes (needs ``method``,
        ``predicted_s``, ``seconds``).  Cached sweeps record ``seconds=0``
        per step and are skipped here.  Returns the number of pairs
        recorded."""
        n = 0
        for t in traces:
            pred = getattr(t, "predicted_s", 0.0) or 0.0
            actual = getattr(t, "seconds", 0.0) or 0.0
            if pred > 0.0 and actual > 0.0:
                self.observe(platform=platform, backend=backend,
                             solver=getattr(t, "method", "?"),
                             predicted_s=pred, actual_s=actual,
                             source=source)
                n += 1
        return n

    def observe_memory(self, *, backend: str, modeled_bytes: int,
                       observed_bytes: int) -> None:
        """Record one modeled-peak vs observed high-water pair."""
        if modeled_bytes <= 0 or observed_bytes <= 0:
            return
        with self._lock:
            self._mem[str(backend)] = {
                "modeled_bytes": int(modeled_bytes),
                "observed_bytes": int(observed_bytes),
                "ratio": observed_bytes / modeled_bytes,
                "t": time.time(),
            }

    # ---------------------------------------------------------- reporting
    def cells(self) -> dict[tuple[str, str, str], DriftCell]:
        with self._lock:
            return dict(self._cells)

    def _cell_report(self, key, cell: DriftCell) -> dict:
        platform, backend, solver = key
        z = cell.z_score()
        stale = (cell.n >= self.min_samples
                 and abs(z) > self.z_threshold
                 and not (1.0 / self.tolerance <= cell.ratio
                          <= self.tolerance))
        return {
            "platform": platform, "backend": backend, "solver": solver,
            "n": cell.n,
            "ratio": cell.ratio,
            "z": z,
            "stale": stale,
            "predicted_total_s": cell.sum_pred,
            "actual_total_s": cell.sum_actual,
            "sources": dict(cell.sources),
        }

    def report(self) -> dict:
        """Full drift report: per-cell stats, memory drift, and repair
        recommendations (the :data:`TUNE_CLI` command that refreshes the
        stale model)."""
        cells = [self._cell_report(k, c)
                 for k, c in sorted(self.cells().items())]
        recs = []
        for c in cells:
            if not c["stale"]:
                continue
            direction = "slower" if c["ratio"] > 1.0 else "faster"
            recs.append({
                "cell": (c["platform"], c["backend"], c["solver"]),
                "why": (f"{c['solver']} on ({c['platform']}, "
                        f"{c['backend']}) runs {c['ratio']:.2f}x "
                        f"{direction} than predicted "
                        f"(n={c['n']}, z={c['z']:.1f})"),
                "command": (f"{TUNE_CLI} calibrate --platform "
                            f"{c['platform']} --backend {c['backend']}"),
            })
            if c["solver"] in ("eig", "svd", "als", "rand"):
                recs.append({
                    "cell": (c["platform"], c["backend"], c["solver"]),
                    "why": ("selector rankings may be inverted where "
                            "predictions drifted"),
                    "command": (f"{TUNE_CLI} train --platform "
                                f"{c['platform']} --backend "
                                f"{c['backend']}"),
                })
        with self._lock:
            mem = {k: dict(v) for k, v in self._mem.items()}
        for backend, m in mem.items():
            if m["ratio"] > self.tolerance:
                recs.append({
                    "cell": ("memory", backend, "peak_bytes"),
                    "why": (f"memory high-water {m['ratio']:.2f}x the "
                            f"modeled peak on backend {backend}"),
                    "command": "review memory_cap_bytes",
                })
        return {
            "cells": cells,
            "memory": mem,
            "stale": [c for c in cells if c["stale"]],
            "recommendations": recs,
            "thresholds": {"min_samples": self.min_samples,
                           "z": self.z_threshold,
                           "tolerance": self.tolerance},
        }

    def summary(self) -> dict:
        """Compact summary (what a serve service's ``stats()`` carries)."""
        cells = self.cells()
        stale = [self._cell_report(k, c) for k, c in sorted(cells.items())]
        stale = [c for c in stale if c["stale"]]
        return {
            "cells": len(cells),
            "observations": sum(c.n for c in cells.values()),
            "stale": [
                {"cell": (c["platform"], c["backend"], c["solver"]),
                 "ratio": round(c["ratio"], 3), "n": c["n"],
                 "z": round(c["z"], 1)}
                for c in stale
            ],
        }

    def reset(self) -> None:
        with self._lock:
            self._cells.clear()
            self._mem.clear()


#: the process-wide monitor (execution layers feed this directly)
MONITOR = DriftMonitor()


def observe(**kw) -> None:
    """Module-level shorthand for :meth:`MONITOR.observe`."""
    MONITOR.observe(**kw)


def observe_traces(traces, **kw) -> int:
    """Module-level shorthand for :meth:`MONITOR.observe_traces`."""
    return MONITOR.observe_traces(traces, **kw)


def reset() -> None:
    """Clear the process-wide monitor (tests)."""
    MONITOR.reset()


class MemoryWatch:
    """High-water mark of one device's memory over a region.

    ``device`` None means ``cuda:0`` (raising without CUDA), as the port's
    entry points do; pass ``device="cpu"`` for the CPU.  On CUDA the
    allocator's peak counter is reset on entry and read on exit
    (``torch.cuda.max_memory_allocated``), so no short-lived peak slips
    between samples and no thread runs.  On the CPU a background thread
    samples the bytes of live CPU tensors (their distinct storages) every
    ``interval_s``.  Feed the result to :meth:`DriftMonitor.observe_memory`
    against the plan's modeled ``peak_bytes``::

        with MemoryWatch(plan.device) as mw:
            plan.execute(x)
        MONITOR.observe_memory(backend=plan.backend,
                               modeled_bytes=plan.peak_bytes,
                               observed_bytes=mw.high_water)
    """

    def __init__(self, device=None, interval_s: float = 0.002):
        from ..core.api import resolve_device  # lazy: obs imports no torch
        self.device = resolve_device(device)
        self.interval_s = interval_s
        self.high_water = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _sample(self) -> int:
        import gc

        import torch

        try:
            seen, total = set(), 0
            for o in gc.get_objects():
                if not issubclass(type(o), torch.Tensor):
                    continue
                if o.device.type == "cpu":
                    st = o.untyped_storage()
                    if st.data_ptr() not in seen:
                        seen.add(st.data_ptr())
                        total += st.nbytes()
            return total
        except Exception:  # noqa: BLE001 - sampling must never crash work
            return 0

    def _run(self) -> None:
        while not self._stop.is_set():
            self.high_water = max(self.high_water, self._sample())
            self._stop.wait(self.interval_s)

    def __enter__(self) -> "MemoryWatch":
        if self.device.type == "cuda":
            import torch
            torch.cuda.reset_peak_memory_stats(self.device)
            self.high_water = torch.cuda.max_memory_allocated(self.device)
            return self
        self.high_water = self._sample()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="atucker-memwatch")
        self._thread.start()
        return self

    def __exit__(self, *exc) -> bool:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)
            self.high_water = max(self.high_water,
                                  torch.cuda.max_memory_allocated(self.device))
            return False
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self.high_water = max(self.high_water, self._sample())
        return False
