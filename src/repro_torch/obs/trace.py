"""Process-wide span tracing + event bus for the port of the a-Tucker stack.

The port's copy of ``repro/obs/trace.py``: the same event schema, switch and
API, so that a capture from either package reads the same way.  Every layer
emits into ONE bus: ``plan()`` and its DP search, each
``TuckerPlan.execute`` (the cached sweep, eager per-mode solves, adaptive
sketch passes), the sweep cache (miss events, the first run's ``compile``
span and, on the card, one ``capture`` span per captured CUDA graph) and
the fallback ladder's hops.  Sinks subscribe to the bus: in-memory
:class:`EventBuffer` rings for the exporters (:mod:`repro_torch.obs.export`),
or anything callable.

Design constraints, in priority order:

1. **Disabled means free.**  Tracing is OFF by default (enable with
   :func:`enable`, the ``ATUCKER_OBS=1`` env var, or a :func:`capture`
   context).  A disabled :func:`span` returns one shared no-op object and
   a disabled :func:`event` is a single boolean test — the hot path never
   pays for observability it didn't ask for.  (The drift monitor is fed
   directly by the execution layers, not through this bus, precisely so
   predicted-vs-actual accounting stays on even when tracing is off.)
2. **Plain dicts, stdlib only.**  An event is ``{"t": unix_seconds,
   "kind": str, ...fields}`` — the exact shape the serve TraceWriter has
   always written — plus, for spans, ``name`` / ``dur_s`` / ``span`` /
   ``parent`` / ``tid`` / ``pid``.  No torch import, no device touch.
3. **Context propagation.**  Span parentage rides a :mod:`contextvars`
   ContextVar, so nesting works across the serve worker thread and any
   executor the caller brings, without threading span objects through
   call signatures.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import threading
import time
import warnings
from collections import deque
from typing import Callable, Iterable

__all__ = [
    "EventBuffer", "add_sink", "capture", "disable", "enable", "enabled",
    "event", "remove_sink", "span",
]

_enabled = bool(os.environ.get("ATUCKER_OBS"))
#: copy-on-write: _publish reads this tuple without taking the lock (one
#: atomic load per event); add/remove rebuild it under the lock
_sinks: tuple[Callable[[dict], None], ...] = ()
_sinks_lock = threading.Lock()
_PID = os.getpid()
_ids = itertools.count(1)
#: the innermost open span's id on this context (None = top level)
_current: contextvars.ContextVar[int | None] = \
    contextvars.ContextVar("atucker_obs_span", default=None)


def enabled() -> bool:
    """Whether span/event emission is on (see :func:`enable`)."""
    return _enabled


def enable() -> None:
    """Turn span/event emission on process-wide."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Turn span/event emission off (sinks stay registered)."""
    global _enabled
    _enabled = False


def add_sink(sink: Callable[[dict], None]) -> Callable[[dict], None]:
    """Register a bus subscriber; every emitted event dict is passed to it.
    Returns ``sink`` so the call can be used inline."""
    global _sinks
    with _sinks_lock:
        if sink not in _sinks:
            _sinks = (*_sinks, sink)
    return sink


def remove_sink(sink: Callable[[dict], None]) -> None:
    global _sinks
    with _sinks_lock:
        if sink in _sinks:
            # equality, not identity: a bound-method sink (writer.handle)
            # is a fresh object on every attribute access
            _sinks = tuple(s for s in _sinks if s != sink)


def _publish(evt: dict) -> None:
    for s in _sinks:
        try:
            s(evt)
        except Exception as e:  # noqa: BLE001 - a broken sink must not
            #                     take down the traced workload
            warnings.warn(f"obs sink {s!r} raised {e!r}; event dropped "
                          "for this sink", RuntimeWarning, stacklevel=2)


def event(kind: str, **fields) -> None:
    """Emit a point event onto the bus (no-op while tracing is disabled).

    The dict shape matches the serve TraceWriter's JSONL lines: ``t`` is
    wall-clock unix seconds, ``kind`` the event type, everything else
    free-form (JSON-serializable values only)."""
    if not _enabled:
        return
    sp = _current.get()
    evt = {"t": time.time(), "kind": kind, "pid": _PID,
           "tid": threading.get_ident(), **fields}
    if sp is not None:
        evt.setdefault("parent", sp)
    _publish(evt)


class _NullSpan:
    """The shared disabled span: enters/exits/sets for free."""
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Span:
    """One timed region, emitted as a single ``kind="span"`` event at exit
    (so a crashed region simply leaves no event — the JSONL stays whole).
    ``set(**attrs)`` adds attributes any time before exit; an exception
    escaping the region stamps ``error=repr(exc)``."""
    __slots__ = ("name", "attrs", "id", "parent", "_t0", "_wall", "_tok")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.id = next(_ids)
        self.parent: int | None = None
        self._t0 = 0.0
        self._wall = 0.0
        self._tok = None

    def __enter__(self) -> "Span":
        self.parent = _current.get()
        self._tok = _current.set(self.id)
        self._wall = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.perf_counter() - self._t0
        _current.reset(self._tok)
        if exc is not None:
            self.attrs["error"] = repr(exc)
        _publish({"t": self._wall, "kind": "span", "name": self.name,
                  "dur_s": dur, "span": self.id, "parent": self.parent,
                  "pid": _PID, "tid": threading.get_ident(),
                  **self.attrs})
        return False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """Open a traced region::

        with span("execute", backend="hopper", shape=[48, 224, 128]) as sp:
            ...
            sp.set(ranks=list(chosen))   # attrs may land late

    Returns the shared no-op span while tracing is disabled, so callers
    never branch on :func:`enabled` themselves."""
    if not _enabled:
        return _NULL_SPAN
    return Span(name, attrs)


class EventBuffer:
    """Ring-buffer sink: keeps the last ``maxlen`` events in memory for the
    exporters (and tests).  Thread-safe; register via :func:`add_sink` or
    use :func:`capture`."""

    def __init__(self, maxlen: int = 65536):
        self._events: deque[dict] = deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def __call__(self, evt: dict) -> None:
        with self._lock:
            self._events.append(evt)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


class capture:
    """Context manager that enables tracing into a fresh
    :class:`EventBuffer` and restores the previous enabled-state on exit::

        with capture() as buf:
            plan(...).execute(x)
        export.write_chrome(buf.events(), "trace.json")
    """

    def __init__(self, maxlen: int = 65536):
        self.buffer = EventBuffer(maxlen)
        self._was_enabled = False

    def __enter__(self) -> EventBuffer:
        self._was_enabled = _enabled
        add_sink(self.buffer)
        enable()
        return self.buffer

    def __exit__(self, *exc) -> bool:
        if not self._was_enabled:
            disable()
        remove_sink(self.buffer)
        return False


def iter_spans(events: Iterable[dict]) -> Iterable[dict]:
    """The span events of an event stream (exporter/report helper)."""
    return (e for e in events if e.get("kind") == "span")
