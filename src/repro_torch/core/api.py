"""Plan/execute front door for a-Tucker: ``TuckerConfig`` → ``TuckerPlan``.

All input-adaptive decisions move to a one-time ``plan`` step:

    cfg  = TuckerConfig(ranks=(10, 10, 5), methods="auto")
    p    = plan(x.shape, "float32", cfg)      # selector runs here, never again
    res  = p.execute(x)                       # runs the frozen schedule

``plan`` resolves the per-mode solver schedule, mode order and ops backend
against the static shapes and freezes them; ``execute`` only runs them.
Plans are JSON-serializable (``save``/``load``) in the reference's schema,
so a schedule planned by the JAX package runs here unchanged.

Devices: entry points run on the card.  ``plan(..., device=None)`` and
``TuckerPlan.load(path, device=None)`` mean ``cuda:0`` and raise when CUDA
is not available — they never drop to the CPU; pass ``device="cpu"`` to
run there.  ``execute`` copies a numpy array or a tensor on another device
onto the plan's device.  PyTorch runs eagerly: a plan's sweep is a Python
loop over the frozen steps (CUDA-graph capture of the sweep is later work).

This slice of the port covers fixed-rank plans on one device.  The
reference's rank-adaptive (``error_target``), sharded (``mesh``) and
schedule-search (``mode_order="opt"``, ``memory_cap_bytes``) paths, its
execute-time fallback ladder, ``execute_batch`` and ``for_shape`` arrive
with later slices; asking for them raises :class:`NotImplementedError`.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Sequence

import torch

from . import tensor_ops as T
from .backend import get_backend, resolve_backend
from .cost_model import DEFAULT_OVERSAMPLE, DEFAULT_POWER_ITERS
from .errors import (InputError, check_finite, check_result_finite,
                     classify_exception)
from .plan import (ModeStep, TimedSelector, VARIANTS, project,
                   resolve_schedule, run_schedule, solve_step, sweep_hooi,
                   sweep_sthosvd, sweep_thosvd)
from .solvers import DEFAULT_ALS_ITERS
from .sthosvd import ModeTrace, SthosvdResult, TuckerTensor

PLAN_FORMAT_VERSION = 1


def _later(feature: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(f"{feature} is not part of the PyTorch port "
                               f"yet; it lands with the {slice_name} slice")


@dataclass(frozen=True)
class TuckerConfig:
    """Frozen description of a Tucker decomposition job (the *what*).

    The fields, their defaults and ``to_dict``/``from_dict`` are the
    reference's, so configs and plans serialize identically.

    ``impl`` names an ops backend from :mod:`repro_torch.core.backend`
    (``matfree`` | ``explicit`` | ``hopper`` | custom) or ``"auto"``, which
    ``plan()`` resolves for the device and compute dtype (``hopper`` on
    CUDA for fp32/bf16).  ``compute_dtype`` casts inputs before the sweep.
    ``mode_order`` is ``None`` (the paper's 1..N), a permutation or
    ``"shrink"``; ``"opt"`` is stored (plans that carry it load and run
    their frozen schedule) but planning with it raises until the
    schedule-search slice, as does ``memory_cap_bytes``.  ``donate_input``
    is accepted, stored and serialized, and does nothing: the port's sweep
    never aliases its input.  ``mesh``, ``error_target`` and ``rank_grid``
    raise until their slices.
    """
    ranks: tuple[int, ...] | None = None
    variant: str = "sthosvd"
    methods: str | tuple[str, ...] = "auto"
    mode_order: tuple[int, ...] | str | None = None
    impl: str = "matfree"
    als_iters: int = DEFAULT_ALS_ITERS
    hooi_iters: int = 3
    compute_dtype: str | None = None
    mesh: Any = None
    shard_axis: str | None = None
    memory_cap_bytes: int | None = None
    donate_input: bool | None = None
    mode_parallel: str | int = "off"
    error_target: float | None = None
    rank_grid: tuple | None = None
    oversample: int = DEFAULT_OVERSAMPLE
    power_iters: int = DEFAULT_POWER_ITERS

    def __post_init__(self):
        if self.mesh is not None or self.shard_axis is not None:
            raise _later("multi-device execution (mesh=...)", "sharded")
        if self.error_target is not None or self.rank_grid is not None:
            raise _later("rank-adaptive planning (error_target=..., "
                         "rank_grid=...)", "rank-adaptive")
        if self.ranks is None:
            raise ValueError("TuckerConfig needs ranks=... (fixed-rank)")
        object.__setattr__(self, "ranks", tuple(int(r) for r in self.ranks))
        if self.oversample < 0 or self.power_iters < 0:
            raise ValueError("oversample and power_iters must be >= 0")
        if not isinstance(self.methods, str):
            object.__setattr__(self, "methods", tuple(self.methods))
        if isinstance(self.mode_order, (list, tuple)):
            object.__setattr__(self, "mode_order",
                               tuple(int(m) for m in self.mode_order))
        if isinstance(self.mode_order, str) and \
                self.mode_order not in ("shrink", "opt"):
            raise ValueError(f"mode_order {self.mode_order!r} must be a "
                             "permutation, 'shrink', 'opt', or None")
        if self.memory_cap_bytes is not None:
            object.__setattr__(self, "memory_cap_bytes",
                               int(self.memory_cap_bytes))
            if self.memory_cap_bytes <= 0:
                raise ValueError("memory_cap_bytes must be a positive byte "
                                 "count (None = uncapped)")
        if self.variant not in VARIANTS:
            raise ValueError(f"unknown variant {self.variant!r}; "
                             f"expected one of {VARIANTS}")
        if self.impl != "auto":
            get_backend(self.impl)   # ValueError on unregistered names
        if self.compute_dtype is not None:
            T.dtype_name(self.compute_dtype)
        if self.als_iters < 1 or self.hooi_iters < 0:
            raise ValueError("als_iters must be ≥1 and hooi_iters ≥0")
        mp = self.mode_parallel
        if isinstance(mp, bool) or \
                not (mp in ("off", "auto") or isinstance(mp, int)):
            raise ValueError(f"mode_parallel {mp!r} must be 'off', 'auto', "
                             "or an int max group size")
        if isinstance(mp, int) and mp < 1:
            raise ValueError(f"mode_parallel={mp} must be >= 1")

    def to_dict(self) -> dict:
        return {"ranks": list(self.ranks),
                "variant": self.variant,
                "methods": (self.methods if isinstance(self.methods, str)
                            else list(self.methods)),
                "mode_order": (list(self.mode_order)
                               if isinstance(self.mode_order, tuple)
                               else self.mode_order),
                "impl": self.impl, "als_iters": self.als_iters,
                "hooi_iters": self.hooi_iters,
                "compute_dtype": self.compute_dtype,
                "mesh": None,
                "shard_axis": self.shard_axis,
                "memory_cap_bytes": self.memory_cap_bytes,
                "donate_input": self.donate_input,
                "mode_parallel": self.mode_parallel}

    @classmethod
    def from_dict(cls, d: dict) -> "TuckerConfig":
        if d.get("mesh") is not None:
            raise _later("multi-device execution (a plan with a mesh)",
                         "sharded")
        return cls(ranks=tuple(d["ranks"]) if d["ranks"] is not None else None,
                   variant=d.get("variant", "sthosvd"),
                   methods=(d["methods"] if isinstance(d["methods"], str)
                            else tuple(d["methods"])),
                   mode_order=(tuple(d["mode_order"])
                               if isinstance(d.get("mode_order"), list)
                               else d.get("mode_order")),
                   impl=d.get("impl", "matfree"),
                   als_iters=d.get("als_iters", DEFAULT_ALS_ITERS),
                   hooi_iters=d.get("hooi_iters", 3),
                   compute_dtype=d.get("compute_dtype"),
                   shard_axis=d.get("shard_axis"),
                   memory_cap_bytes=d.get("memory_cap_bytes"),
                   donate_input=d.get("donate_input"),
                   mode_parallel=d.get("mode_parallel", "off"),
                   error_target=d.get("error_target"),
                   rank_grid=d.get("rank_grid"),
                   oversample=d.get("oversample", DEFAULT_OVERSAMPLE),
                   power_iters=d.get("power_iters", DEFAULT_POWER_ITERS))


def resolve_device(device=None) -> torch.device:
    """The device a plan runs on: ``cuda:0`` when ``device`` is None.  Raises
    when CUDA is asked for (or implied) and not available — never falls
    back to the CPU."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested (the default) but CUDA is not "
                "available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def _as_tensor(x) -> torch.Tensor:
    """``x`` as a tensor: a tensor as it is, an array (bf16 from ml_dtypes
    included) shared with torch where it can be, else copied once."""
    if isinstance(x, torch.Tensor):
        return x
    import numpy as np
    a = np.asarray(x)
    # torch tensors must own writable memory: copy read-only (e.g. jax-owned)
    # or strided arrays once, on the host
    a = np.array(a, order="C",
                 copy=not a.flags.writeable or not a.flags.c_contiguous)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bf16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


# ---------------------------------------------------------------------------
# TuckerPlan
# ---------------------------------------------------------------------------

@dataclass
class TuckerPlan:
    """A frozen, executable solver schedule for one (shape, dtype, config)
    on one device.

    ``schedule`` lists every mode solve in execution order with the solver
    the selector (or explicit methods) chose and the modeled FLOPs / peak
    working-set bytes of that step.  ``device`` is not serialized: a loaded
    plan runs on the device its loader names; left out, it is ``cuda:0``
    (raising without CUDA), as in :func:`plan`.
    """
    shape: tuple[int, ...]
    dtype: str
    config: TuckerConfig
    schedule: tuple[ModeStep, ...]
    select_seconds: float = 0.0     # one-time planning cost (selector calls)
    device: torch.device = field(default_factory=resolve_device)

    # -- introspection -------------------------------------------------------
    @property
    def backend(self) -> str:
        """The resolved ops backend this plan's steps run on (``config.impl``
        may be ``"auto"``; this is what it resolved to at plan time)."""
        names = {s.backend for s in self.schedule}
        return self.schedule[0].backend if len(names) == 1 else "mixed"

    @property
    def methods(self) -> tuple[str, ...]:
        """Resolved solver per mode (first visit order, sorted by mode)."""
        first: dict[int, str] = {}
        for s in self.schedule:
            first.setdefault(s.mode, s.method)
        return tuple(first[m] for m in sorted(first))

    @property
    def total_flops(self) -> float:
        return sum(s.flops for s in self.schedule)

    @property
    def total_predicted_s(self) -> float:
        """Sum of the per-step calibrated cost-model predictions (0.0 when
        no calibration was available at plan time)."""
        return sum(s.predicted_s for s in self.schedule)

    @property
    def input_bytes(self) -> int:
        """Bytes of the caller's input buffer in the plan's storage dtype."""
        return math.prod(self.shape) * T.itemsize(self.dtype)

    @property
    def donates(self) -> bool:
        """Always False: ``donate_input`` is recorded but the port's sweep
        never releases or aliases its input."""
        return False

    @property
    def peak_bytes(self) -> int:
        """Modeled peak across the sweep.  The sweep never donates, so an
        st-HOSVD sweep keeps the caller's (dead after step 0) input alive
        through every later step: those steps charge ``input_bytes`` on top
        of their own working set (the reference's undonated figure)."""
        peaks = [s.peak_bytes for s in self.schedule]
        if self.config.variant != "sthosvd" or len(peaks) == 1:
            # t-HOSVD/HOOI read X in (almost) every step — it is already
            # counted in their per-step io
            return max(peaks)
        return max(peaks[0], max(p + self.input_bytes for p in peaks[1:]))

    # -- execution -----------------------------------------------------------
    def _place(self, x) -> torch.Tensor:
        x = _as_tensor(x)
        if tuple(x.shape) != self.shape:
            raise InputError(f"plan is for shape {self.shape}, got "
                             f"{tuple(x.shape)}")
        if T.dtype_name(x.dtype) != self.dtype:
            raise InputError(f"plan is for dtype {self.dtype}, got "
                             f"{T.dtype_name(x.dtype)}")
        return x.to(self.device).contiguous()

    def execute(self, x, *, record: bool = False, donate: bool | None = None,
                validate: str | None = None) -> SthosvdResult:
        """Run the frozen schedule on ``x`` (a tensor or numpy array of the
        plan's shape and dtype, copied onto the plan's device if needed).

        ``record=True`` runs the per-step runner that synchronizes the
        device after every step, so each ``ModeTrace.seconds`` is real
        wall-clock.  ``donate`` is accepted for the reference's signature
        and ignored (the port never donates).  ``validate="finite"`` rejects
        NaN/Inf inputs with :class:`~repro_torch.core.errors.InputError`
        naming the offending mode and checks the outputs (raising
        :class:`~repro_torch.core.errors.NumericalError`).

        There is no fallback ladder: a failure is re-raised as its
        classified error (:func:`~repro_torch.core.errors.classify_exception`)
        when it has one, else as itself.  On the card a kernel that fails
        raises; nothing drops to ``matfree`` or the CPU.
        """
        del donate
        if validate not in (None, "none", "finite"):
            raise ValueError(
                f"validate must be None, 'none' or 'finite', got {validate!r}")
        for s in self.schedule:
            if s.n_shards > 1 or s.group is not None:
                raise _later("executing a sharded or mode-parallel schedule",
                             "sharded")
            if s.rank_grid is not None:
                raise _later("executing a rank-adaptive schedule",
                             "rank-adaptive")
        x = self._place(x)
        if validate == "finite":
            check_finite(x, name="input")
        try:
            res = self._run(x, record)
        except InputError:
            raise
        except Exception as e:  # noqa: BLE001 - classification is the point
            terr = classify_exception(e)
            if terr is not None and terr is not e:
                raise terr from e
            raise
        if validate == "finite":
            check_result_finite(res.tucker.core, res.tucker.factors,
                                context=f"{self.config.variant} sweep")
        return res

    def _run(self, x: torch.Tensor, record: bool) -> SthosvdResult:
        cfg = self.config
        if cfg.compute_dtype:
            x = x.to(T.torch_dtype(cfg.compute_dtype))
        steps = self.schedule
        n = len(self.shape)
        if record:
            core, factors, seconds = self._run_recorded(x)
        else:
            if cfg.variant == "sthosvd":
                core, factors = sweep_sthosvd(x, steps, als_iters=cfg.als_iters)
            elif cfg.variant == "thosvd":
                core, factors = sweep_thosvd(x, steps, als_iters=cfg.als_iters)
            else:
                core, factors = sweep_hooi(x, steps, als_iters=cfg.als_iters,
                                           n_init=n)
            seconds = [0.0] * len(steps)
        trace = [ModeTrace(s.mode, s.method, s.i_n, s.r_n, s.j_n, dt,
                           backend=s.backend, predicted_s=s.predicted_s)
                 for s, dt in zip(steps, seconds)]
        return SthosvdResult(tucker=TuckerTensor(core=core,
                                                 factors=list(factors)),
                             trace=trace, select_overhead_s=0.0)

    def _run_recorded(self, x: torch.Tensor):
        """The per-step runner: every mode solve synchronized and timed."""
        import time as _time
        cfg = self.config
        steps = self.schedule
        n = len(self.shape)
        if cfg.variant == "sthosvd":
            core, fdict, seconds = run_schedule(
                x, steps, sequential=True, als_iters=cfg.als_iters,
                block_until_ready=True)
            return core, [fdict[m] for m in range(n)], seconds
        if cfg.variant == "thosvd":
            _, fdict, seconds = run_schedule(
                x, steps, sequential=False, als_iters=cfg.als_iters,
                block_until_ready=True)
            factors = [fdict[m] for m in range(n)]
            return project(x, factors, steps[0].backend), factors, seconds
        # hooi: timed init sweep, then timed projected refinements
        _, fdict, seconds = run_schedule(
            x, steps[:n], sequential=True, als_iters=cfg.als_iters,
            block_until_ready=True)
        factors = [fdict[m] for m in range(n)]
        seconds = list(seconds)
        for step in steps[n:]:
            y = project(x, factors, step.backend, skip=step.mode)
            t0 = _time.perf_counter()
            res = solve_step(y, step, als_iters=cfg.als_iters)
            if res.u.device.type == "cuda":
                torch.cuda.synchronize(res.u.device)
            seconds.append(_time.perf_counter() - t0)
            factors[step.mode] = res.u
        return project(x, factors, steps[0].backend), factors, seconds

    # -- reporting -----------------------------------------------------------
    def describe(self) -> str:
        """Human-readable plan report (the reference's text): the frozen
        schedule in execution order with modeled cost and peak per step,
        plus the totals, donation policy, and memory cap."""
        cfg = self.config
        cap = cfg.memory_cap_bytes
        lines = [
            f"TuckerPlan {self.shape} {self.dtype} -> ranks {cfg.ranks} "
            f"[{cfg.variant}, backend={self.backend}]",
            f"  mode_order={cfg.mode_order!r}  "
            + (f"mode_parallel={cfg.mode_parallel!r}  "
               if cfg.mode_parallel != "off" else "")
            + f"memory_cap_bytes={cap if cap is not None else 'uncapped'}  "
            f"donate_input={'auto' if cfg.donate_input is None else cfg.donate_input}"
            " (resolves: undonated)",
        ]
        for k, s in enumerate(self.schedule):
            pred = f"  pred={s.predicted_s * 1e3:.3f}ms" if s.predicted_s \
                else ""
            lines.append(
                f"  step {k}: mode {s.mode} {s.method:>3s}  "
                f"I={s.i_n} R={s.r_n} J={s.j_n}  "
                f"flops={s.flops:.3g}  peak={s.peak_bytes:,}B{pred}")
        total_pred = self.total_predicted_s
        lines.append(
            f"  total: flops={self.total_flops:.3g}  "
            f"peak={self.peak_bytes:,}B"
            + (f"  predicted={total_pred * 1e3:.3f}ms" if total_pred else "")
            + (f"  cap_headroom={cap - self.peak_bytes:,}B"
               if cap is not None else ""))
        return "\n".join(lines)

    # -- persistence (the reference's schema) --------------------------------
    def to_dict(self) -> dict:
        return {"version": PLAN_FORMAT_VERSION, "shape": list(self.shape),
                "dtype": self.dtype, "config": self.config.to_dict(),
                "schedule": [s.to_dict() for s in self.schedule],
                "select_seconds": self.select_seconds}

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d: dict, *, device=None) -> "TuckerPlan":
        """Rebuild a plan from its dict; ``device`` as in :func:`plan`
        (None = ``cuda:0``, raising without CUDA)."""
        if d.get("version", 1) > PLAN_FORMAT_VERSION:
            raise ValueError(f"plan format {d['version']} newer than supported "
                             f"{PLAN_FORMAT_VERSION}")
        return cls(shape=tuple(d["shape"]), dtype=T.dtype_name(d["dtype"]),
                   config=TuckerConfig.from_dict(d["config"]),
                   schedule=tuple(ModeStep.from_dict(s) for s in d["schedule"]),
                   select_seconds=d.get("select_seconds", 0.0),
                   device=resolve_device(device))

    @classmethod
    def from_json(cls, s: str, *, device=None) -> "TuckerPlan":
        return cls.from_dict(json.loads(s), device=device)

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_json())

    @classmethod
    def load(cls, path: str | Path, *, device=None) -> "TuckerPlan":
        return cls.from_json(Path(path).read_text(), device=device)


# ---------------------------------------------------------------------------
# plan / decompose
# ---------------------------------------------------------------------------

def plan(shape: Sequence[int], dtype, config: TuckerConfig, *,
         selector: Callable[..., str] | None = None,
         device=None) -> TuckerPlan:
    """Resolve ``config`` against a concrete (shape, dtype) → ``TuckerPlan``.

    All selector/cost-model queries happen here, against the statically
    known per-mode problem sizes, and ``config.impl`` (possibly ``"auto"``)
    is resolved through the backend registry against the device's platform
    (``"cuda"`` or ``"cpu"``) and the compute dtype; ``TuckerPlan.execute``
    never selects or resolves again.  ``dtype`` is a name (``"float32"``),
    a ``torch.dtype`` or a numpy dtype.  ``device`` None means ``cuda:0``
    and raises when CUDA is not available.
    """
    shape = tuple(int(s) for s in shape)
    dtype = T.dtype_name(dtype)
    device = resolve_device(device)
    platform = device.type
    compute_dtype = T.dtype_name(config.compute_dtype or dtype)
    backend = resolve_backend(config.impl, platform=platform,
                              dtype=compute_dtype, shape=shape)
    # selector resolution sees the RESOLVED backend: a per-backend trained
    # model outranks the platform-pooled one, and its embedded (possibly
    # calibrated) cost model prices the schedule either way
    from .selector import default_selector
    timed = None
    if config.methods == "auto":
        if selector is None:
            selector = default_selector(platform, backend=backend.name)
        selector = timed = TimedSelector(selector)
    cost_model = getattr(selector, "cost_model", None) or \
        default_selector(platform, backend=backend.name).cost_model
    schedule = resolve_schedule(
        shape, config.ranks, variant=config.variant, methods=config.methods,
        mode_order=config.mode_order, selector=selector,
        als_iters=config.als_iters, hooi_iters=config.hooi_iters,
        itemsize=T.itemsize(compute_dtype), backend=backend.name,
        platform=platform, cost_model=cost_model,
        memory_cap_bytes=config.memory_cap_bytes,
        mode_parallel=config.mode_parallel)
    return TuckerPlan(shape=shape, dtype=dtype, config=config,
                      schedule=schedule,
                      select_seconds=timed.seconds if timed else 0.0,
                      device=device)


def decompose(x, config: TuckerConfig, *,
              selector: Callable[..., str] | None = None,
              device=None) -> SthosvdResult:
    """One-shot convenience: ``plan(x.shape, x.dtype, config).execute(x)``.
    ``device`` None means the device of a CUDA tensor ``x``, else
    ``cuda:0``."""
    x = _as_tensor(x)
    if device is None and x.device.type == "cuda":
        device = x.device
    return plan(x.shape, x.dtype, config, selector=selector,
                device=device).execute(x)
