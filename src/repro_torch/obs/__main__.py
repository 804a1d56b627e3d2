"""CLI for the port's observability layer.

Usage::

    # Convert a bus capture (JSONL) into a Perfetto-loadable Chrome trace:
    python -m repro_torch.obs export EVENTS.jsonl --to trace.json

    # Drift report: rebuild predicted-vs-actual cells from the "solve"
    # spans of an events file, or (with no file) run a small in-process
    # probe workload -- on the card, or on the CPU with --device cpu --
    # and report on the live monitor:
    python -m repro_torch.obs report [EVENTS.jsonl] [--json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

from .drift import DriftMonitor, MONITOR
from .export import read_jsonl, write_chrome


def _feed_from_events(events, monitor: DriftMonitor) -> int:
    """Rebuild drift observations from solve spans (which carry
    platform/backend/solver/predicted_s attrs and measured dur_s)."""
    n = 0
    for e in events:
        if e.get("kind") != "span" or e.get("name") != "solve":
            continue
        pred = e.get("predicted_s") or 0.0
        dur = e.get("dur_s") or 0.0
        if pred > 0.0 and dur > 0.0:
            monitor.observe(platform=e.get("platform", "?"),
                            backend=e.get("backend", "?"),
                            solver=e.get("solver", e.get("method", "?")),
                            predicted_s=pred, actual_s=dur,
                            source="events")
            n += 1
    return n


def _probe(monitor: DriftMonitor, device=None) -> None:
    """Run a tiny recorded execute so a bare ``report`` has data; ``device``
    None plans on ``cuda:0`` (raising without CUDA)."""
    import numpy as np

    from ..core.api import TuckerConfig, plan

    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 18, 20)).astype(np.float32)
    p = plan(x.shape, x.dtype, TuckerConfig(ranks=(4, 4, 4)), device=device)
    for _ in range(max(monitor.min_samples, 5)):
        p.execute(x, record=True)


def _print_report(rep: dict, as_json: bool) -> None:
    if as_json:
        json.dump(rep, sys.stdout, indent=2, default=str)
        sys.stdout.write("\n")
        return
    cells = rep["cells"]
    if not cells:
        print("no drift observations recorded")
    for c in cells:
        flag = "STALE" if c["stale"] else "ok"
        print(f"[{flag:>5}] ({c['platform']}, {c['backend']}, "
              f"{c['solver']}): actual/predicted x{c['ratio']:.3f} "
              f"n={c['n']} z={c['z']:.1f} sources={c['sources']}")
    for backend, m in rep.get("memory", {}).items():
        print(f"[  mem] backend {backend}: observed "
              f"{m['observed_bytes']:,} B vs modeled "
              f"{m['modeled_bytes']:,} B (x{m['ratio']:.2f})")
    for r in rep["recommendations"]:
        print(f"  -> {r['why']}\n     run: {r['command']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_rep = sub.add_parser("report", help="predicted-vs-actual drift report")
    p_rep.add_argument("events", nargs="?", default=None,
                       help="events JSONL (a bus capture); omit to "
                            "probe in-process")
    p_rep.add_argument("--json", action="store_true", dest="as_json",
                       help="emit the full report as JSON")
    p_rep.add_argument("--device", default=None,
                       help="device of the probe workload (default cuda:0; "
                            "'cpu' runs it on the CPU)")

    p_exp = sub.add_parser("export", help="events JSONL -> Chrome trace")
    p_exp.add_argument("events", help="events JSONL file")
    p_exp.add_argument("--to", required=True, help="output trace path")

    args = ap.parse_args(argv)

    if args.cmd == "export":
        events = read_jsonl(args.events)
        doc = write_chrome(events, args.to)
        print(f"wrote {len(doc['traceEvents'])} trace events -> {args.to}")
        return 0

    if args.events:
        monitor = DriftMonitor(min_samples=MONITOR.min_samples,
                               z_threshold=MONITOR.z_threshold,
                               tolerance=MONITOR.tolerance)
        n = _feed_from_events(read_jsonl(args.events), monitor)
        print(f"rebuilt {n} observations from {args.events}")
    else:
        monitor = MONITOR
        if not monitor.cells():
            _probe(monitor, args.device)
    _print_report(monitor.report(), args.as_json)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
