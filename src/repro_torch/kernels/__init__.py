"""Hand-written Hopper (sm_90a) kernels: a-Tucker's matricization-free hot
spots and the Mamba-1 selective scan of the LM serving path.

Kernels (CUDA C++ in ``csrc/``, built by ``_build`` and bound through
ctypes; each wrapper runs its plain version from ``ref.py`` on CPU tensors):
  matmul.matmul        — boundary-mode TTM GEMM       (csrc/matmul.cu)
  ttm.ttm_interior     — interior-mode TTM             (csrc/ttm.cu)
  ttt.ttt3             — TTT / Gram contraction        (csrc/ttt.cu)
  s6_scan.s6_scan      — Mamba-1 selective scan with
                         state carry                   (csrc/s6_scan.cu)
  s6_scan_bwd.s6_scan_bwd — its backward (the
                         gradient of ``S6Scan``)       (csrc/s6_scan_bwd.cu)

ops.py carries the mode-n dispatch behind the ``hopper`` ops backend;
``models/ssm.py`` calls ``s6_scan`` in every Mamba-1 layer, in prefill,
decode and training (where its gradient is ``s6_scan_bwd``).  The other
three kernels have no backward: on the card they refuse an input that
requires grad while grad is enabled (``_build.refuse_grad``).
"""

import importlib

from . import ops, ref
from .matmul import matmul
from .s6_scan import s6_scan
from .s6_scan_bwd import s6_scan_bwd
from .ttm import ttm_interior
from .ttt import ttt3

#: kernel name -> wrapper module holding its ``LAUNCHES`` counter
KERNEL_MODULES = {"ttt": "ttt", "matmul": "matmul", "ttm_interior": "ttm",
                  "s6_scan": "s6_scan", "s6_scan_bwd": "s6_scan_bwd"}


def _module(name: str):
    # the package attributes ``matmul``/``s6_scan``… are the functions, so go
    # through the import system for the modules themselves
    return importlib.import_module(f"{__name__}.{KERNEL_MODULES[name]}")


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {k: _module(k).LAUNCHES for k in KERNEL_MODULES}


def ttt_route_counts() -> dict[str, int]:
    """Launches of the TTT/Gram kernel since the last
    :func:`reset_launch_counts`, by route and symmetry
    (``"wgmma_tma/ttt"``, ``"tile16/gram"``, …)."""
    return dict(_module("ttt").ROUTE_LAUNCHES)


def matmul_route_counts() -> dict[str, int]:
    """Launches of the boundary GEMM since the last
    :func:`reset_launch_counts`, by route (``"slab"``, ``"wide"``)."""
    return dict(_module("matmul").ROUTE_LAUNCHES)


def ttm_route_counts() -> dict[str, int]:
    """Launches of the interior TTM since the last
    :func:`reset_launch_counts`, by route (``"slab"``, ``"plain"``,
    ``"wide"``)."""
    return dict(_module("ttm_interior").ROUTE_LAUNCHES)


#: the kernels whose wrappers also count their launches by route
ROUTED = ("ttt", "matmul", "ttm_interior")


def reset_launch_counts() -> None:
    for k in KERNEL_MODULES:
        _module(k).LAUNCHES = 0
    for k in ROUTED:
        _module(k).ROUTE_LAUNCHES.clear()


def launch_snapshot() -> dict:
    """Every launch counter at this moment, keyed (kernel, None) for the
    kernels' counts and (kernel, route) for the routes'."""
    out = {(k, None): _module(k).LAUNCHES for k in KERNEL_MODULES}
    for k in ROUTED:
        out.update(((k, rt), v) for rt, v in _module(k).ROUTE_LAUNCHES.items())
    return out


def launches_since(before: dict) -> dict:
    """The launches counted since ``before`` (a :func:`launch_snapshot`),
    the counters that did not move left out."""
    now = launch_snapshot()
    return {key: v - before.get(key, 0) for key, v in now.items()
            if v != before.get(key, 0)}


def add_launches(delta: dict, times: int = 1) -> None:
    """Add ``times`` × ``delta`` (as :func:`launches_since` gives it) to the
    counters: a CUDA graph's replay adds the launches it recorded, and the
    ticks a wrapper made while being recorded are taken back (``times`` =
    -1), since a capture launches nothing."""
    for (k, rt), v in delta.items():
        m = _module(k)
        if rt is None:
            m.LAUNCHES += v * times
            continue
        n = m.ROUTE_LAUNCHES.get(rt, 0) + v * times
        if n:
            m.ROUTE_LAUNCHES[rt] = n
        else:
            m.ROUTE_LAUNCHES.pop(rt, None)


__all__ = ["KERNEL_MODULES", "add_launches", "launch_counts",
           "launch_snapshot", "launches_since", "matmul",
           "matmul_route_counts", "ops", "ref", "reset_launch_counts",
           "s6_scan", "s6_scan_bwd", "ttm_interior", "ttm_route_counts", "ttt3",
           "ttt_route_counts"]
