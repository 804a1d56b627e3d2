"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded through :mod:`ctypes` -- no PyTorch
headers, so one build takes seconds, not minutes.  Libraries land in
``build/repro_torch/`` at the repository root, named by a hash of the
source (and the shared headers and flags), so an edited ``.cu`` rebuilds
and an unchanged one is reused.  :func:`build_all` starts one ``nvcc`` per
source, all at once.

Nothing here runs at import time: the CPU tests import every module, and
this machine may have no ``nvcc``.  A missing compiler or a failed build
raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("ttt", "matmul", "ttm", "s6_scan", "s6_scan_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
#: C signature of each library's entry points: name -> argtypes (all return int)
SIGNATURES = {
    "ttt": {"atucker_ttt": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _I, _P),
            "atucker_ttt_info": (_P, _P, _I, _I, _I, _I, _I, _I, _L, _I,
                                 _P)},
    "matmul": {"atucker_matmul": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
               "atucker_matmul_info": (_P, _P, _I, _I, _I, _I, _P)},
    "ttm": {"atucker_ttm_interior": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
            "atucker_ttm_interior_info": (_P, _I, _I, _I, _I, _I, _P)},
    "s6_scan": {"atucker_s6_scan": (_P,) * 9 + (_I,) * 4 + (_L,) * 4 + (_I, _P),
                "atucker_s6_scan_chunked": (_P,) * 11 + (_I,) * 5 + (_L,) * 4
                + (_I, _P),
                "atucker_s6_scan_info": (_I, _I, _I, _I, _I, _I, _I, _P)},
    "s6_scan_bwd": {"atucker_s6_scan_bwd": (_P,) * 21 + (_I,) * 10 + (_P,),
                    "atucker_s6_scan_bwd_info": (_I,) * 6 + (_P,)},
}

#: ptxas report (registers, shared memory, spills) of each build, by source
BUILD_LOG: dict[str, str] = {}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the Hopper "
        "kernels of repro_torch are compiled from csrc/ on first use")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for p in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}_{_digest(name)}.so"


def _start(name: str):
    """Start nvcc for one source unless its library is already built.
    Returns (name, target, tmp, process) or None."""
    target = lib_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, target, tmp, proc


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every named source that is not built yet, one nvcc each, all
    started together; raise naming every source that failed."""
    with _LOCK:
        jobs = [j for j in (_start(n) for n in names) if j is not None]
        failed = []
        for name, target, tmp, proc in jobs:
            out, _ = proc.communicate()
            BUILD_LOG[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, target)   # atomic: concurrent builders agree
        if failed:
            raise RuntimeError("building the Hopper kernels failed:\n"
                               + "\n".join(failed))
    return {n: lib_path(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            lib.atucker_error_string.argtypes = [ctypes.c_int]
            lib.atucker_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
    return lib


#: dtype codes of csrc/common.cuh
DTYPE_CODES = {"float32": 0, "bfloat16": 1}
_INT_MAX = 2 ** 31 - 1


def check_operands(what: str, shapes: dict, *tensors) -> str:
    """Validate a wrapper's operands before any pointer reaches C: one device,
    one dtype the kernels take, non-empty dims that each fit an int (the
    kernels index memory in 64 bits, so the element count may exceed one),
    and (on the card) contiguous storage.  ``shapes`` maps each tensor's name
    to its required ndim.  Returns the device type ("cpu" or "cuda")."""
    for (name, ndim), t in zip(shapes.items(), tensors):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what}: {name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if t.ndim != ndim:
            raise ValueError(f"{what}: {name} must be {ndim}-D, got shape "
                             f"{tuple(t.shape)}")
        dname = str(t.dtype).replace("torch.", "")
        if dname not in DTYPE_CODES:
            raise TypeError(f"{what}: {name} has dtype {dname}; the kernels "
                            f"take {tuple(DTYPE_CODES)}")
        if t.numel() == 0 or any(s > _INT_MAX for s in t.shape):
            raise ValueError(f"{what}: {name} of shape {tuple(t.shape)} is "
                             "empty or has a dimension beyond 2**31 - 1")
    first = tensors[0]
    for t in tensors[1:]:
        if t.dtype != first.dtype:
            raise TypeError(f"{what}: operands differ in dtype "
                            f"({first.dtype} vs {t.dtype})")
        if t.device != first.device:
            raise ValueError(f"{what}: operands on different devices "
                             f"({first.device} vs {t.device})")
    kind = first.device.type
    if kind == "cuda":
        for name, t in zip(shapes, tensors):
            if not t.is_contiguous():
                raise ValueError(f"{what}: {name} must be contiguous on the "
                                 "card (the kernel reads it in place)")
    elif kind != "cpu":
        raise ValueError(f"{what}: unsupported device {first.device}")
    return kind


def refuse_grad(what: str, *tensors) -> None:
    """Raise when grad is enabled and an operand requires grad: the kernel
    ``what`` has no backward, and its output, filled on the card through
    ctypes, would silently carry none.  Called by the wrappers of the
    kernels without a backward, on the card."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the Hopper kernel has no backward, and an operand "
            "requires grad while grad is enabled; run it under "
            "torch.no_grad() or detach the operands")


def dtype_code(t: torch.Tensor) -> int:
    return DTYPE_CODES[str(t.dtype).replace("torch.", "")]


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry point returned a nonzero ``cudaError_t``."""
    if err != 0:
        name = lib.atucker_error_string(err).decode()
        raise RuntimeError(f"{what}: kernel launch failed: cudaError {err} "
                           f"({name})")


def report(name: str, fn: str, *args) -> tuple[list[dict], list[int]]:
    """The launch figures that the C report function ``fn`` of library
    ``name`` gives for one call's shape ``args``: for each CUDA kernel the
    call runs, registers per thread, threads per block, resident blocks per
    SM (the occupancy calculator's, with the launch's shared memory), grid
    blocks and waves = grid blocks / (SMs × blocks per SM); and the four
    words after the three kernels' (out[12:16], zero unless the library
    reports more)."""
    lib = load(name)
    out = (ctypes.c_int * 16)()
    check(lib, getattr(lib, fn)(*args, ctypes.addressof(out)), fn)
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    rows = []
    for k in range(0, 12, 4):
        regs, threads, per_sm, blocks = out[k:k + 4]
        if threads == 0:
            break
        rows.append(dict(registers=regs, threads=threads, blocks_per_sm=per_sm,
                         grid_blocks=blocks,
                         waves=blocks / (sms * per_sm) if per_sm else None))
    return rows, list(out[12:16])


def launch_info(name: str, fn: str, *args) -> list[dict]:
    """The kernel rows of :func:`report`."""
    return report(name, fn, *args)[0]
