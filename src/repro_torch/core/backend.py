"""Pluggable ops backends: who actually computes TTM / Gram / TTT.

The paper separates *what* to solve per mode (the adaptive EIG/ALS/SVD
schedule, Sec. III–IV) from *how* the three tensor primitives run on the
hardware (the matricization-free CPU/GPU kernels, Sec. V).  This module is
that seam for the PyTorch port: an :class:`OpsBackend` bundles the three
primitives with capability metadata, and a process-wide registry maps names
to backends so every layer — solvers, schedules, plans — routes through one
dispatch point instead of pattern-matching an ``impl`` string.

Built-in backends:

  ``matfree``   torch.matmul/einsum contractions on the (A, I_n, B) view —
                no unfold copy (tensor_ops; the paper's Fig. 4 structure).
  ``explicit``  unfold → GEMM → fold baseline (paper Fig. 3 / Fig. 8).
  ``hopper``    hand-written CUDA kernels for sm_90a (kernels/ops.py): the
                boundary-mode GEMM, the interior-mode TTM and the TTT/Gram,
                taking the (A, I_n, B) view as it is — no padding.  Off the
                card the wrappers run the kernels' plain PyTorch versions,
                so an explicit ``impl="hopper"`` runs (as plain PyTorch) on
                the CPU too — the analogue of the reference's Pallas
                interpret mode.

  ``sharded``   st-HOSVD over a ``torch.distributed`` device mesh
                (core/distributed.py): each rank's partial Gram/TTT on its
                slab plus an all-reduce over the shard axis, local TTMs,
                and an all-to-all reshard to the largest remaining mode
                between steps.  Requires a mesh (``TuckerConfig(mesh=...)``);
                each rank's local primitives are its device's own ``auto``
                backend (:func:`local_backend`: ``hopper`` on CUDA,
                ``matfree`` on the CPU), so it never matricizes either.

``resolve_backend("auto", ...)`` picks the best available backend for the
plan's platform (``"cuda"`` or ``"cpu"``, a ``torch.device`` type) at
*plan* time, honouring each backend's dtype/platform capabilities (a mesh
→ ``sharded``).  Custom backends register via :func:`register_backend` and
are immediately usable as ``impl=`` values.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import torch

from . import tensor_ops as T

#: Ops signature: ttm(x, u, mode) with u (R, I_n); gram(x, mode) → (I_n, I_n);
#: ttt(x, y, mode) → (I_n, R_n).  All dispatch positionally.
OpsTriple = tuple[Callable, Callable, Callable]


@dataclass(frozen=True)
class OpsBackend:
    """One named implementation of the three mode-n primitives.

    ``loader`` defers the import of heavyweight kernel modules until the
    backend is first used; the resolved triple is cached on the instance.

    Capability metadata drives ``auto`` resolution and plan-time validation:

    dtypes
        dtype names the primitives accept (``"*"`` = anything torch takes).
    platforms
        device types this runs *natively* on (``"*"`` = any).  A backend
        with ``interpret_fallback=True`` additionally runs anywhere through
        plain PyTorch — correct but slow, for testing.
    matricizes
        True if the primitives materialize mode-n unfoldings (extra
        O(I_n·J_n) buffer; the paper's Fig. 8 memory axis).
    cost_scale
        Relative per-FLOP cost hint vs ``matfree`` on this backend's native
        platform; the cost model scales Eq. 4/5 estimates by it.
    solvers
        Solver families whose kernel mix this backend supports.
    max_extent
        Largest extent A, I_n or B of any mode's (A, I_n, B) view the
        primitives take (None = no limit).
    requires_mesh
        True if the backend executes across a device mesh: plans must carry
        one (``TuckerConfig(mesh=...)``), ``auto`` selects it only when a
        mesh is supplied, and per-step ``peak_bytes`` are per-device
        figures.
    """
    name: str
    loader: Callable[[], OpsTriple]
    dtypes: tuple[str, ...] = ("*",)
    platforms: tuple[str, ...] = ("*",)
    matricizes: bool = False
    cost_scale: float = 1.0
    interpret_fallback: bool = False
    solvers: tuple[str, ...] = ("eig", "als", "svd", "rand")
    max_extent: int | None = None
    requires_mesh: bool = False
    _ops: list = field(default_factory=list, repr=False, compare=False)

    def ops(self) -> OpsTriple:
        """Resolve (ttm, gram, ttt), importing lazily on first use."""
        if not self._ops:
            self._ops.append(self.loader())
        return self._ops[0]

    def supports_dtype(self, dtype) -> bool:
        return "*" in self.dtypes or T.dtype_name(dtype) in self.dtypes

    def supports_solver(self, method: str) -> bool:
        return "*" in self.solvers or method in self.solvers

    def native_on(self, platform: str) -> bool:
        return "*" in self.platforms or platform in self.platforms

    def supports_shape(self, shape) -> bool:
        """True if every mode's (A, I_n, B) view of ``shape`` fits
        ``max_extent``."""
        if self.max_extent is None:
            return True
        return all(max(math.prod(shape[:n]), s, math.prod(shape[n + 1:]))
                   <= self.max_extent for n, s in enumerate(shape))


_REGISTRY: dict[str, OpsBackend] = {}

#: backends of the reference that the port does not carry
_LATER = {"pallas": "no slice: the port's kernel backend is 'hopper'"}


def register_backend(backend: OpsBackend, *, overwrite: bool = False) -> OpsBackend:
    """Add ``backend`` to the registry (its name becomes a valid ``impl=``)."""
    if backend.name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {backend.name!r} already registered "
                         "(pass overwrite=True to replace)")
    if backend.name == "auto":
        raise ValueError("'auto' is reserved for plan-time resolution")
    _REGISTRY[backend.name] = backend
    return backend


def unregister_backend(name: str) -> None:
    _REGISTRY.pop(name, None)


def backend_names() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def get_backend(name: str) -> OpsBackend:
    """Look up a backend by name; raises ValueError listing known names
    (NotImplementedError for a reference backend not ported yet)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        if name in _LATER:
            raise NotImplementedError(
                f"backend {name!r} is not part of the PyTorch port yet: "
                f"{_LATER[name]}") from None
        raise ValueError(f"unknown backend {name!r}; registered: "
                         f"{backend_names()} (or 'auto')") from None


#: ``auto`` preference order per platform: first registered name that is
#: native on the platform and supports the dtype wins.
AUTO_ORDER: dict[str, tuple[str, ...]] = {
    "cuda": ("hopper", "matfree"),
    "cpu": ("matfree",),
}


def resolve_backend(impl: str, *, platform: str, dtype=None,
                    shape=None, mesh=None) -> OpsBackend:
    """Resolve an ``impl`` name (or ``"auto"``) to a concrete backend for
    ``platform`` (``"cuda"`` or ``"cpu"``).

    Explicit names are honoured even off their native platform when the
    backend has a plain-PyTorch path (``hopper`` on the CPU runs the
    kernels' plain versions) — asking for a backend by name means you want
    *that* code path.  ``"auto"`` only ever picks natively-supported
    backends, falling back to ``matfree``: ``hopper`` on CUDA for fp32 and
    bf16, ``matfree`` for fp64 (the kernels take no fp64) or for a ``shape``
    with a view extent beyond 2**31 - 1 (the kernels take int extents).
    With a ``mesh`` (a ``torch.distributed`` ``DeviceMesh``) ``"auto"``
    resolves to the ``sharded`` backend, and never without one.
    """
    if impl != "auto":
        b = get_backend(impl)
        if dtype is not None and not b.supports_dtype(dtype):
            raise ValueError(f"backend {b.name!r} does not support dtype "
                             f"{T.dtype_name(dtype)} (supported: {b.dtypes})")
        if b.requires_mesh and mesh is None:
            raise ValueError(f"backend {b.name!r} requires a mesh; pass "
                             "TuckerConfig(mesh=...) or call "
                             "sthosvd_distributed directly")
        if not b.native_on(platform) and not b.interpret_fallback:
            raise ValueError(f"backend {b.name!r} runs on {b.platforms}, not "
                             f"{platform!r}, and has no plain-PyTorch path")
        if shape is not None and not b.supports_shape(shape):
            raise ValueError(f"backend {b.name!r} takes no (A, I_n, B) view "
                             f"extent beyond {b.max_extent}; shape "
                             f"{tuple(shape)} has one")
        return b
    if mesh is not None:
        b = _REGISTRY.get("sharded")
        if b is not None and (dtype is None or b.supports_dtype(dtype)):
            return b
    for name in AUTO_ORDER.get(platform, ("matfree",)):
        b = _REGISTRY.get(name)
        if b is not None and b.native_on(platform) and \
                (dtype is None or b.supports_dtype(dtype)) and \
                (shape is None or b.supports_shape(shape)):
            return b
    return get_backend("matfree")


# ---------------------------------------------------------------------------
# Built-in backends
# ---------------------------------------------------------------------------

def _load_matfree() -> OpsTriple:
    return T.ttm, T.gram, T.ttt


def _load_explicit() -> OpsTriple:
    return T.ttm_explicit, T.gram_explicit, T.ttt_explicit


def _load_hopper() -> OpsTriple:
    """kernels/ops.py with dtype adapters matching matfree's contract.

    The kernels accumulate and return fp32; matfree keeps the input dtype
    for TTM and promotes to (at least) fp32 for Gram/TTT.  The adapters
    restore that contract so sweeps thread dtypes identically across
    backends (a bf16 plan shrinks a bf16 tensor either way).  A u of another
    dtype than x (the solvers never pass one) is cast to x's: it is small.
    """
    from ..kernels import ops as K

    def ttm(x, u, mode):
        return K.ttm(x, u.to(x.dtype), mode).to(x.dtype)

    def gram(x, mode, out=None):
        return K.gram(x, mode, out).to(
            torch.promote_types(x.dtype, torch.float32))

    def ttt(x, y, mode, out=None):
        return K.ttt(x, y.to(x.dtype), mode, out).to(
            torch.promote_types(x.dtype, torch.float32))

    return ttm, gram, ttt


register_backend(OpsBackend(
    name="matfree", loader=_load_matfree,
    dtypes=("*",), platforms=("*",), matricizes=False, cost_scale=1.0))

register_backend(OpsBackend(
    name="explicit", loader=_load_explicit,
    dtypes=("*",), platforms=("*",), matricizes=True,
    # the unfold copy is pure overhead; Fig. 8's explicit rows pay it
    cost_scale=1.3))

register_backend(OpsBackend(
    name="hopper", loader=_load_hopper,
    # the kernels convert bf16 to fp32 on load and take no fp64
    dtypes=("float32", "bfloat16"), platforms=("cuda",),
    matricizes=False,
    # no measured per-FLOP ratio against matfree yet: plan as matfree does
    cost_scale=1.0,
    # on CPU tensors the wrappers run the kernels' plain versions, so an
    # explicit impl="hopper" works — as plain PyTorch — on any platform
    interpret_fallback=True,
    # extents are C ints; memory is indexed in 64 bits
    max_extent=2 ** 31 - 1))


register_backend(OpsBackend(
    # the registry's own triple is matfree's, as in the reference; the
    # sharded runner (core/distributed.py) computes each rank's slab
    # through local_backend() instead and adds the all-reduces
    name="sharded", loader=_load_matfree,
    dtypes=("*",), platforms=("*",), matricizes=False,
    requires_mesh=True, cost_scale=1.0))


def local_backend(platform: str, dtype=None, shape=None) -> str:
    """The ops backend a ``sharded`` plan's ranks compute their slabs
    with: the device's own ``auto`` choice without a mesh (``hopper`` on
    CUDA for fp32/bf16, ``matfree`` on the CPU and for fp64)."""
    return resolve_backend("auto", platform=platform, dtype=dtype,
                           shape=shape).name


def backend_ops(impl: str) -> OpsTriple:
    """(ttm, gram, ttt) for a registered backend name — the solver hot path."""
    return get_backend(impl).ops()
