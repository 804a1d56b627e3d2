"""Event-stream exporters: Chrome trace-event JSON (Perfetto), JSONL.

The port's copy of ``repro/obs/export.py``, unchanged in behaviour.  The
bus speaks plain dicts (:mod:`repro_torch.obs.trace`); these functions turn
a captured stream into files tools understand:

* :func:`to_chrome` / :func:`write_chrome` — the Chrome trace-event
  format (``{"traceEvents": [...]}``), loadable in Perfetto / ``chrome://
  tracing``.  Spans become complete ``"X"`` events with their attrs as
  ``args``; serve ``wave`` events carry ``wall_s`` so they too render as
  duration slices; everything else is an instant ``"i"``.
* :func:`write_jsonl` / :func:`read_jsonl` — one event dict per line,
  the same schema the reference's serve ``TraceWriter`` produces, so
  its files and bus captures round-trip through the same readers.
"""

from __future__ import annotations

import json
from typing import Iterable

__all__ = ["to_chrome", "write_chrome", "write_jsonl", "read_jsonl"]

_US = 1e6  # trace-event timestamps are microseconds


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        return repr(v)


def to_chrome(events: Iterable[dict]) -> dict:
    """Convert a bus event stream to a Chrome trace-event document."""
    out = []
    for e in events:
        kind = e.get("kind", "event")
        pid = e.get("pid", 1)
        tid = e.get("tid", 1)
        args = {k: _jsonable(v) for k, v in e.items()
                if k not in ("t", "kind", "name", "dur_s", "pid", "tid")}
        if kind == "span":
            out.append({
                "name": e.get("name", "span"),
                "cat": "atucker",
                "ph": "X",
                "ts": e["t"] * _US,
                "dur": max(e.get("dur_s", 0.0), 0.0) * _US,
                "pid": pid, "tid": tid,
                "args": args,
            })
        elif kind == "wave" and "wall_s" in e:
            # TraceWriter logs waves at completion; rewind the start so
            # the slice lands where the work actually ran.
            wall = max(float(e["wall_s"]), 0.0)
            out.append({
                "name": f"wave {e.get('bucket', '')}".strip(),
                "cat": "serve",
                "ph": "X",
                "ts": (e["t"] - wall) * _US,
                "dur": wall * _US,
                "pid": pid, "tid": tid,
                "args": args,
            })
        else:
            out.append({
                "name": kind,
                "cat": "serve" if kind in ("submit", "done", "reject",
                                           "error") else "atucker",
                "ph": "i",
                "s": "t",
                "ts": e.get("t", 0.0) * _US,
                "pid": pid, "tid": tid,
                "args": args,
            })
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome(events: Iterable[dict], path) -> dict:
    """Write :func:`to_chrome` output to ``path``; returns the document."""
    doc = to_chrome(events)
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return doc


def write_jsonl(events: Iterable[dict], path) -> int:
    """Write one event dict per line; returns the number written."""
    n = 0
    with open(path, "w") as fh:
        for e in events:
            fh.write(json.dumps({k: _jsonable(v) for k, v in e.items()})
                     + "\n")
            n += 1
    return n


def read_jsonl(path) -> list[dict]:
    """Read a JSONL event file (bus capture or serve TraceWriter output);
    blank and malformed lines are skipped."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out
