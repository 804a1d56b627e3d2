"""Mode-wise flexible st-HOSVD (a-Tucker Alg. 2): results and the legacy
per-call entry points.

``sthosvd`` and the coarse-grained baselines ``sthosvd_eig`` /
``sthosvd_als`` / ``sthosvd_svd`` are the reference's legacy entry points,
kept as thin wrappers over the plan/execute front door
(:mod:`repro_torch.core.api`): each call plans (selector time reported as
``select_overhead_s``) and executes.  For repeated or batched execution use
``plan`` once and ``TuckerPlan.execute`` / ``execute_batch``.

``methods`` accepts:
  - "auto"              → adaptive selector (decision tree, cost-model fallback)
  - "eig"/"als"/"svd"   → coarse-grained single solver (paper baselines)
  - sequence per mode   → explicit mode-wise schedule, e.g. ("eig","als","als")
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Sequence

import torch

from . import tensor_ops as T
from .solvers import ALS, DEFAULT_ALS_ITERS, EIG, SVD


@dataclass
class TuckerTensor:
    """Result of a Tucker decomposition:  X ≈ G ×_1 U^(1) ··· ×_N U^(N)."""
    core: torch.Tensor
    factors: list[torch.Tensor]          # factors[n]: (I_n, R_n)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(u.shape[0] for u in self.factors)

    @property
    def ranks(self) -> tuple[int, ...]:
        return tuple(self.core.shape)

    def reconstruct(self) -> torch.Tensor:
        return T.reconstruct(self.core, self.factors)

    def rel_error(self, x) -> torch.Tensor:
        """‖X − X̂‖_F / ‖X‖_F; ``x`` (a tensor or numpy array) is moved to
        the core's device, and all operands to their promoted dtype."""
        x = torch.as_tensor(x)
        dt = torch.promote_types(x.dtype, self.core.dtype)
        return T.rel_error(x.to(device=self.core.device, dtype=dt),
                           self.core.to(dt), [u.to(dt) for u in self.factors])

    @property
    def n_elements(self) -> int:
        return int(self.core.numel() + sum(u.numel() for u in self.factors))

    @property
    def compression_ratio(self) -> float:
        return float(math.prod(self.shape)) / float(self.n_elements)


@dataclass
class ModeTrace:
    mode: int
    method: str
    i_n: int
    r_n: int
    j_n: int
    seconds: float             # measured wall-clock (0.0 inside fused sweeps)
    backend: str = "matfree"   # ops backend the solve ran on
    predicted_s: float = 0.0   # plan-time prediction from a calibrated cost
                               # model (0.0 = uncalibrated) — compare with
                               # ``seconds`` for predicted-vs-actual drift
    tail_err: float = 0.0      # discarded energy at this step as a fraction
                               # of ||X||² (rank-adaptive executions only;
                               # 0.0 = not measured).  Flows into the tune
                               # store as the achieved-error label.

    @property
    def delta_s(self) -> float:
        """Predicted-vs-actual drift: ``seconds - predicted_s`` (positive =
        slower than the calibrated model expected).  Only meaningful when
        both sides are real — a fused sweep has no per-step ``seconds`` and
        an uncalibrated plan no ``predicted_s``."""
        return self.seconds - self.predicted_s


@dataclass
class SthosvdResult:
    tucker: TuckerTensor
    trace: list[ModeTrace] = field(default_factory=list)
    select_overhead_s: float = 0.0
    error_bound: float | None = None  # rank-adaptive executions: guaranteed
                                      # relative-error upper bound
                                      # sqrt(Σ_n tail_err_n) from the HOSVD
                                      # inequality; None for fixed-rank runs

    @property
    def methods(self) -> tuple[str, ...]:
        return tuple(t.method for t in sorted(self.trace, key=lambda t: t.mode))

    def report(self) -> str:
        """Per-step execution report in schedule order: solver, problem
        size, measured seconds, and — when a calibrated cost model priced
        the plan — predicted seconds and the drift, so order-search wins
        (and calibration rot) are visible in traces, not just benches."""
        predicted = any(t.predicted_s for t in self.trace)
        head = "step  mode method backend    I     R     J    seconds"
        if predicted:
            head += "  predicted    delta"
        lines = [head]
        for k, t in enumerate(self.trace):
            row = (f"{k:>4}  {t.mode:>4} {t.method:>6} {t.backend:>8} "
                   f"{t.i_n:>5} {t.r_n:>5} {t.j_n:>5} {t.seconds:>9.4f}")
            if predicted:
                row += f" {t.predicted_s:>10.4f} {t.delta_s:>+8.4f}"
            lines.append(row)
        total_s = sum(t.seconds for t in self.trace)
        total = f"total{'':>38}{total_s:>9.4f}"
        if predicted:
            total_p = sum(t.predicted_s for t in self.trace)
            total += f" {total_p:>10.4f} {total_s - total_p:>+8.4f}"
        lines.append(total)
        return "\n".join(lines)


def legacy_plan(x, ranks, *, device=None, **cfg):
    """``(plan, x)`` of a legacy call: ``x`` as a tensor, planned for its
    shape and dtype on ``device`` — None means the device of a CUDA ``x``,
    else ``cuda:0`` (raising without CUDA), as in
    :func:`repro_torch.core.api.decompose`.  ``selector`` rides in ``cfg``
    to :func:`~repro_torch.core.api.plan`, the rest builds the config.
    With ``methods="auto"`` and no selector, the legacy calls select with
    the platform's pooled model, as the reference's do (``plan`` prefers a
    model trained for the resolved backend)."""
    from .api import TuckerConfig, _as_tensor, plan, resolve_device
    x = _as_tensor(x)
    if device is None and x.device.type == "cuda":
        device = x.device
    device = resolve_device(device)
    selector = cfg.pop("selector", None)
    if selector is None and cfg.get("methods", "auto") == "auto":
        from .selector import default_selector
        selector = default_selector(device.type)
    p = plan(x.shape, x.dtype, TuckerConfig(ranks=tuple(ranks), **cfg),
             selector=selector, device=device)
    return p, x


def sthosvd(
    x,
    ranks: Sequence[int],
    methods: str | Sequence[str] = "auto",
    *,
    selector: Callable[..., str] | None = None,
    mode_order: Sequence[int] | str | None = None,
    als_iters: int = DEFAULT_ALS_ITERS,
    impl: str = "matfree",
    memory_cap_bytes: int | None = None,
    block_until_ready: bool = False,
    device=None,
) -> SthosvdResult:
    """Flexible st-HOSVD (Alg. 2).  Returns factors, core, per-mode trace.

    ``mode_order`` defaults to the paper's 1..N sweep; ``"shrink"`` orders
    by compression ratio and ``"opt"`` runs the exact schedule search
    (order AND per-step solver, under ``memory_cap_bytes`` when set).
    ``memory_cap_bytes`` is the hard plan-time ceiling on each step's
    modeled peak working set.  ``impl`` names an ops backend (``matfree`` |
    ``explicit`` | ``hopper`` | custom) or ``"auto"``.
    ``block_until_ready=True`` runs the recorded per-step runner, so the
    trace's seconds are real; otherwise the plan's cached sweep runs.
    ``device`` as in :func:`legacy_plan`."""
    p, x = legacy_plan(x, ranks, device=device, methods=methods,
                       selector=selector, mode_order=mode_order,
                       als_iters=als_iters, impl=impl,
                       memory_cap_bytes=memory_cap_bytes)
    res = p.execute(x, record=block_until_ready)
    res.select_overhead_s = p.select_seconds
    return res


# Coarse-grained baselines (paper Sec. VI) -----------------------------------

def sthosvd_eig(x, ranks, **kw) -> SthosvdResult:
    return sthosvd(x, ranks, methods=EIG, **kw)


def sthosvd_als(x, ranks, **kw) -> SthosvdResult:
    return sthosvd(x, ranks, methods=ALS, **kw)


def sthosvd_svd(x, ranks, **kw) -> SthosvdResult:
    return sthosvd(x, ranks, methods=SVD, **kw)
