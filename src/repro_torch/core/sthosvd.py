"""Results of a Tucker decomposition: the tensor, per-mode trace, result.

The reference's legacy per-call entry points (``sthosvd`` & friends) are
not ported: the port's front door is :mod:`repro_torch.core.api`
(``plan`` → ``TuckerPlan.execute``), which returns these records.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from . import tensor_ops as T


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
