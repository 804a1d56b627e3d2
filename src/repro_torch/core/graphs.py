"""CUDA-graph capture of a fixed plan's sweep: the port's counterpart of the
reference's jitted sweep (``repro/core/api.py`` ``_make_sweep``).

A plan's sweep is a Python loop over its frozen steps; on the card each
step launches a handful of kernels, so an eager sweep spends much of its
time in the host's launch path.  :class:`CapturedSweep` records the sweep
once into CUDA graphs and replays them: one ``cudaGraphLaunch`` per graph
instead of one launch per kernel.

What cannot be captured runs eagerly between the graphs.  ``torch.linalg``'s
``eigh`` and ``svd`` check their ``info`` on the host (a synchronization,
illegal inside a capture), so the solvers call them through :func:`eigh` and
:func:`svd`: eagerly outside a capture, and during one they end the current
graph, run on its (replayed) output, and open the next graph.  A sweep is
thus ``1 + Σ HOST_OPS[method]`` graphs with those calls between them: an
ALS-only schedule is one graph.  Seeded draws (ALS's start, the sketch's
test tensor) come from :func:`seeded_randn`, since a CUDA generator cannot
be seeded inside a capture: the warm-up run keeps each draw and the capture
reads it back, a constant equal to the eager draw.

A graph reads and writes only the buffers it captured (the TMA descriptors
of the Hopper kernels encode their operands' addresses), so the sweep owns
a static input buffer that each call copies the caller's tensor into, and
each call returns clones of the static outputs.  The graphs share one
private memory pool, which stays reserved while the sweep lives.

Kernel launch counts (``repro_torch.kernels.launch_counts``) count launches:
the ticks a wrapper makes while being captured are taken back, and each
replay adds the graph's counts.

Capture is decided by the caller from the plan, never from catching an
error; a capture that fails raises.
"""

from __future__ import annotations

import gc
import threading
import time
import warnings
from contextlib import contextmanager
from typing import Callable

import torch

from .. import kernels
from ..obs import trace as _obs

#: calls that synchronize with the host per mode solve, by solver: each
#: ends a graph segment (``eig``: the Gram's ``eigh``; ``svd``: the
#: unfolding's ``svd``; ``rand``: the sketched Gram's ``eigh``)
HOST_OPS = {"eig": 1, "svd": 1, "rand": 1, "als": 0}

_local = threading.local()


def _recorder() -> "_Recorder | None":
    return getattr(_local, "rec", None)


@contextmanager
def _active(rec: "_Recorder"):
    prev, _local.rec = _recorder(), rec
    try:
        yield rec
    finally:
        _local.rec = prev


def seeded_randn(shape, *, seed: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """``torch.randn(shape)`` from a fresh ``torch.Generator`` seeded with
    ``seed`` on ``device``.  While a sweep is being captured the draw made
    by its warm-up run is returned instead (the same values)."""
    rec = _recorder()
    if rec is not None and rec.capturing:
        t = rec.constants[rec.k]
        rec.k += 1
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise RuntimeError(
                f"capture drew {tuple(shape)} {dtype} where its warm-up drew "
                f"{tuple(t.shape)} {t.dtype}: the sweep is not a fixed "
                "sequence of operations")
        return t
    gen = torch.Generator(device=device).manual_seed(seed)
    t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    if rec is not None:
        rec.constants.append(t)
    return t


def host_op(fn: Callable, *args, **kw):
    """``fn(*args, **kw)``, for a ``torch.linalg`` call that synchronizes
    with the host and takes ``out=``.  Inside a capture it runs eagerly
    between two graphs (:meth:`_Recorder.host_op`)."""
    rec = _recorder()
    if rec is None or not rec.capturing:
        return fn(*args, **kw)
    return rec.host_op(fn, args, kw)


def eigh(a: torch.Tensor):
    """``torch.linalg.eigh(a)`` (ascending eigenvalues, eigenvectors)."""
    return host_op(torch.linalg.eigh, a)


def svd(a: torch.Tensor):
    """``torch.linalg.svd(a, full_matrices=False)``."""
    return host_op(torch.linalg.svd, a, full_matrices=False)


class _Graph:
    """One captured segment and the kernel launches it replays."""
    __slots__ = ("graph", "launches")

    def __init__(self, graph: torch.cuda.CUDAGraph, launches: dict):
        self.graph = graph
        self.launches = launches

    def run(self) -> None:
        self.graph.replay()
        kernels.add_launches(self.launches)


class _HostOp:
    """An eager call between two segments, writing into the buffers its
    first call returned (which the next segment reads)."""
    __slots__ = ("fn", "args", "kw", "out")

    def __init__(self, fn, args, kw, out):
        self.fn, self.args, self.kw, self.out = fn, args, kw, out

    def run(self) -> None:
        self.fn(*self.args, out=tuple(self.out), **self.kw)


class _Recorder:
    """State of one sweep's warm-up (``capturing`` False: keep the seeded
    draws) and capture (``capturing`` True: cut segments at host ops)."""

    def __init__(self, on_capture: Callable[[], None] | None):
        self.on_capture = on_capture
        self.capturing = False
        self.constants: list[torch.Tensor] = []
        self.k = 0
        self.program: list[_Graph | _HostOp] = []
        self.pool = None
        self._graph: torch.cuda.CUDAGraph | None = None
        self._before: dict = {}
        self._t0 = self._wall = 0.0

    def begin(self) -> None:
        g = torch.cuda.CUDAGraph()
        self._before = kernels.launch_snapshot()
        self._t0 = time.perf_counter()
        self._wall = time.time()
        g.capture_begin(pool=self.pool)
        self._graph = g

    def end(self) -> None:
        g, self._graph = self._graph, None
        with warnings.catch_warnings():
            # a segment may hold no work (a host op that reads a view of
            # the input); its replay is a no-op
            warnings.filterwarnings("ignore",
                                    message="The CUDA Graph is empty")
            g.capture_end()
        if self.pool is None:     # the later segments share the first's pool
            self.pool = g.pool()
        # the wrappers ticked while being recorded; nothing ran yet
        launches = kernels.launches_since(self._before)
        kernels.add_launches(launches, -1)
        seg = _Graph(g, launches)
        self.program.append(seg)
        _obs.event("span", t=self._wall, name="capture",
                   dur_s=time.perf_counter() - self._t0,
                   segment=sum(isinstance(p, _Graph) for p in self.program)
                   - 1, launches=sum(v for (k, rt), v in launches.items()
                                     if rt is None))
        if self.on_capture is not None:
            self.on_capture()
        seg.run()   # the recording pass computes the first result

    def abort(self) -> None:
        """End a capture that an error interrupted (its own error, if any,
        is dropped: the caller re-raises the first one)."""
        g, self._graph = self._graph, None
        if g is not None:
            kernels.add_launches(kernels.launches_since(self._before), -1)
            try:
                g.capture_end()
            except Exception:  # noqa: BLE001 - the original error wins
                pass

    def host_op(self, fn, args, kw):
        self.end()
        out = fn(*args, **kw)
        self.program.append(_HostOp(fn, args, kw, out))
        self.begin()
        return out


def _clone(out):
    core, factors = out
    return core.clone(), [u.clone() for u in factors]


class CapturedSweep:
    """``run`` (a fixed sweep: ``x -> (core, factors)``) captured on
    ``device`` at its first call.

    The first call copies ``x`` into the sweep's static input, runs one
    eager warm-up on a side stream (so that cuBLAS/cuSOLVER handles and
    workspaces, the kernels' libraries and the seeded draws exist before
    capture), then captures the sweep segment by segment, replaying each
    segment as soon as it is captured so that the host ops between them
    see real data; ``on_capture`` is called once a segment.  Every later
    call copies ``x`` in and replays the program on the current stream.
    Each call returns clones of the static outputs."""

    def __init__(self, run: Callable, *, device: torch.device,
                 on_capture: Callable[[], None] | None = None):
        self.run = run
        self.device = device
        self.on_capture = on_capture
        self.program: list[_Graph | _HostOp] | None = None
        self.x: torch.Tensor | None = None
        self.outputs = None
        self.constants: list[torch.Tensor] = []
        self.pool_bytes = 0

    @property
    def segments(self) -> int:
        """Captured graphs (0 before the first call)."""
        return sum(isinstance(p, _Graph) for p in self.program or ())

    @property
    def input_bytes(self) -> int:
        """Bytes of the static input buffer (a second copy of x)."""
        return 0 if self.x is None else self.x.numel() * self.x.element_size()

    def stats(self) -> dict:
        """Segments, host ops, the private pool's reserved bytes (the
        ``memory_reserved`` growth across capture) and the static input's
        bytes."""
        return dict(segments=self.segments,
                    host_ops=sum(isinstance(p, _HostOp)
                                 for p in self.program or ()),
                    pool_bytes=self.pool_bytes,
                    input_bytes=self.input_bytes)

    def __call__(self, x: torch.Tensor):
        if self.program is None:
            return self._build(x)
        self.x.copy_(x)
        self.replay()
        return _clone(self.outputs)

    def replay(self) -> None:
        """Run the captured program once on the static input as it stands,
        with no copy in and no clones out (what the tune collector times);
        the results land in the static outputs."""
        for item in self.program:
            item.run()

    def _build(self, x: torch.Tensor):
        dev = self.device
        static = torch.empty(x.shape, dtype=x.dtype, device=dev)
        static.copy_(x)
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        rec = _Recorder(self.on_capture)
        with torch.cuda.device(dev), torch.cuda.stream(side):
            with _active(rec):
                self.run(static)                  # warm-up, result dropped
            torch.cuda.synchronize(dev)
            reserved = torch.cuda.memory_reserved(dev)
            rec.capturing = True
            # a CUDA graph that the cyclic collector frees during a capture
            # (cudaGraphExecDestroy) invalidates it: collect before, and
            # not during
            gc.collect()
            was_enabled = gc.isenabled()
            gc.disable()
            try:
                with _active(rec):
                    rec.begin()
                    try:
                        out = self.run(static)
                        rec.end()
                    except BaseException:
                        rec.abort()
                        raise
            finally:
                if was_enabled:
                    gc.enable()
            pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        cur.wait_stream(side)
        if rec.k != len(rec.constants):
            raise RuntimeError(f"capture drew {rec.k} of the warm-up's "
                               f"{len(rec.constants)} seeded tensors")
        self.x, self.outputs, self.constants = static, out, rec.constants
        self.program, self.pool_bytes = rec.program, pool_bytes
        return _clone(out)
