"""a-Tucker core on PyTorch: input-adaptive, matricization-free Tucker decomposition.

Public API:
  TuckerConfig / plan / TuckerPlan / decompose — plan/execute front door
      (static solver schedules, cached sweeps on the plan's device —
      captured into CUDA graphs on the card —, batched execution; fixed
      ranks or an error target; the execute-time fallback ladder; sharded
      and mode-parallel plans over a torch.distributed DeviceMesh)
  mesh_spec / mesh_from_spec — a mesh's JSON spec and its rebuild
  distributed — the sharded backend's execution engine (SPMD collectives,
      sthosvd_distributed legacy entry, pick_shard_mode)
  clear_sweep_cache / CACHE_STATS — the process-wide sweep cache
  sthosvd / sthosvd_eig / sthosvd_als / sthosvd_svd, variants.thosvd /
      variants.hooi — legacy per-call wrappers over plan/execute
  optimize_schedule / optimize_grouping / MemoryCapError — the schedule
      search (mode_order="opt") under a memory cap
  rand_sketch / rand_solve — the randomized solver behind rank-adaptive
      plans
  TuckerTensor — decomposition result (reconstruct, rel_error, ratio)
  Selector / default_selector — adaptive solver selector, resolved per
      (platform, backend); platform is "cuda" or "cpu"
  CostModel — Eq. 4/5 constants (textbook default, hardware-calibratable)
  tensor_ops — matricization-free TTM/TTT/Gram (+ explicit baselines)
  OpsBackend / register_backend / get_backend / resolve_backend /
      backend_names — pluggable ops-backend registry (matfree | explicit |
      hopper | sharded | custom) behind TuckerConfig.impl
"""

# NOTE: the attribute ``repro_torch.core.plan`` is the api.plan FUNCTION (the
# front-door entry point), which shadows the ``plan`` submodule on the
# package.  ``from repro_torch.core.plan import ...`` still resolves the
# module (sys.modules), and ``plan_lib`` aliases it for attribute access.
from . import (backend, cost_model, distributed, plan as plan_lib, tensor_ops,
               variants)
from .api import (CACHE_STATS, TuckerConfig, TuckerPlan, clear_sweep_cache,
                  decompose, fallback_hops, mesh_from_spec, mesh_spec, plan,
                  reset_fallback_hops, resolve_device)
from .backend import (
    OpsBackend,
    backend_names,
    get_backend,
    register_backend,
    resolve_backend,
)
from .cost_model import DEFAULT_COST_MODEL, CostModel
from .errors import (CancelledError, DeadlineError, InputError,
                     NumericalError, ResourceError, TuckerError,
                     check_finite, classify_exception, coerce_exception)
from .plan import ModeStep, resolve_schedule
from .schedule_opt import (MemoryCapError, ScheduleSearch, optimize_grouping,
                           optimize_schedule)
from .selector import Selector, default_selector, extract_features
from .solvers import (ALS, EIG, RAND, SVD, als_solve, eig_solve, rand_sketch,
                      rand_solve, svd_solve)
from .sthosvd import (SthosvdResult, TuckerTensor, sthosvd, sthosvd_als,
                      sthosvd_eig, sthosvd_svd)

__all__ = [
    "ALS", "CACHE_STATS", "DEFAULT_COST_MODEL", "EIG", "RAND", "SVD",
    "CancelledError", "CostModel", "DeadlineError", "InputError",
    "MemoryCapError", "ModeStep", "NumericalError", "OpsBackend",
    "ResourceError", "ScheduleSearch", "Selector", "SthosvdResult",
    "TuckerConfig", "TuckerError", "TuckerPlan", "TuckerTensor",
    "als_solve", "backend", "backend_names", "check_finite",
    "classify_exception", "clear_sweep_cache", "coerce_exception",
    "cost_model", "decompose",
    "default_selector", "distributed", "eig_solve", "extract_features",
    "fallback_hops", "get_backend", "mesh_from_spec", "mesh_spec",
    "optimize_grouping", "optimize_schedule", "plan",
    "plan_lib", "rand_sketch", "rand_solve", "register_backend",
    "reset_fallback_hops", "resolve_backend", "resolve_device",
    "resolve_schedule", "sthosvd", "sthosvd_als", "sthosvd_eig",
    "sthosvd_svd", "svd_solve", "tensor_ops", "variants",
]
