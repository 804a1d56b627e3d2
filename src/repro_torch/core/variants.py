"""Tucker-decomposition variants beyond st-HOSVD (paper §II-B / §VIII).

The paper names t-HOSVD and HOOI as the natural extensions of its
flexible st-HOSVD; both are built on the same matricization-free solvers
and the same adaptive selector:

  * t-HOSVD: every factor computed from the ORIGINAL tensor (no sequential
    shrinking), then one projection.
  * HOOI: higher-order orthogonal iteration — alternating refinement of the
    factors, initialized from st-HOSVD.  Each inner subproblem is a mode
    solve of the partially-projected tensor, so the EIG/ALS switch and the
    selector apply verbatim.

These are the reference's legacy entry points, thin wrappers over the
plan/execute front door (``variant="thosvd"`` / ``"hooi"``), with the
arguments of :func:`repro_torch.core.sthosvd.sthosvd`.
"""

from __future__ import annotations

import time

import torch

from .plan import project, solve_step
from .solvers import DEFAULT_ALS_ITERS
from .sthosvd import ModeTrace, SthosvdResult, TuckerTensor, legacy_plan


def thosvd(x, ranks, methods: str = "auto", *,
           selector=None, als_iters: int = DEFAULT_ALS_ITERS,
           impl: str = "matfree", memory_cap_bytes: int | None = None,
           block_until_ready: bool = False, device=None) -> SthosvdResult:
    """Truncated HOSVD: factors from the original tensor, one projection.

    ``memory_cap_bytes`` fails the plan loudly when any mode solve's modeled
    peak exceeds it — t-HOSVD has no order freedom, so the cap can only be
    met by a smaller solver (or not at all)."""
    p, x = legacy_plan(x, ranks, device=device, variant="thosvd",
                       methods=methods, selector=selector,
                       als_iters=als_iters, impl=impl,
                       memory_cap_bytes=memory_cap_bytes)
    res = p.execute(x, record=block_until_ready)
    res.select_overhead_s = p.select_seconds
    return res


def hooi(x, ranks, *, n_iters: int = 3, methods: str = "auto",
         selector=None, als_iters: int = DEFAULT_ALS_ITERS,
         impl: str = "matfree", mode_order=None,
         memory_cap_bytes: int | None = None,
         block_until_ready: bool = False,
         init: SthosvdResult | None = None, device=None) -> SthosvdResult:
    """Higher-order orthogonal iteration, st-HOSVD-initialized.

    Per sweep and mode: project x on all OTHER factors, then solve the mode
    with the flexible (selector-driven) solver.  Error is non-increasing in
    exact arithmetic; typically converges in 2–5 sweeps.

    ``mode_order`` (incl. ``"shrink"``/``"opt"``) orders the st-HOSVD INIT
    sweep — refinement sweeps always cycle 0..N-1; ``memory_cap_bytes``
    caps every step (init and refinements) at plan time.  ``init`` (an
    earlier result on the same x) replaces the init sweep: its factors
    start the refinements, which then run one by one on the plan's
    refinement steps, and its trace leads the returned one."""
    p, x = legacy_plan(x, ranks, device=device, variant="hooi",
                       hooi_iters=n_iters, methods=methods,
                       selector=selector, als_iters=als_iters, impl=impl,
                       mode_order=mode_order,
                       memory_cap_bytes=memory_cap_bytes)
    if init is None:
        res = p.execute(x, record=block_until_ready)
        res.select_overhead_s = p.select_seconds
        return res
    x = p._place(x)
    factors = [u.to(x.device) for u in init.tucker.factors]
    trace = list(init.trace)
    for step in p.schedule[x.ndim:]:    # the refinements after the init
        y = project(x, factors, step.backend, skip=step.mode)
        t0 = time.perf_counter()
        res = solve_step(y, step, als_iters=als_iters)
        if block_until_ready and res.u.device.type == "cuda":
            torch.cuda.synchronize(res.u.device)
        factors[step.mode] = res.u
        trace.append(ModeTrace(step.mode, step.method, step.i_n, step.r_n,
                               step.j_n, time.perf_counter() - t0,
                               backend=step.backend,
                               predicted_s=step.predicted_s))
    core = project(x, factors, p.backend)
    return SthosvdResult(TuckerTensor(core=core, factors=factors),
                         trace=trace, select_overhead_s=p.select_seconds)
