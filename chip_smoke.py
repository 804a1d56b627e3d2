#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. env      torch/CUDA versions, the card's name and power limit, TF32 off.
2. build    compile ``src/repro_torch/csrc/*.cu`` with nvcc for sm_90a (one
            process per source, all at once) into ``build/repro_torch/``.
3. kernels  hold every kernel against its plain PyTorch version on the card
            (``max|kernel - plain| <= 1e-4 * max|plain|``): first on the
            non-tiling shapes of the reference's kernel tests in fp32 and
            bf16, then on one operand of more than 2**31 elements (every
            kernel path), then at the main path's full-size shapes, where
            the kernel, its plain version and one PyTorch library call are
            timed (CUDA events, median of warm runs) beside the roofline
            bound.
4. main     ``plan -> execute`` with ``impl="auto"`` on the paper's Table III
            Boats (320, 240, 7000) and HSI (1021, 1340, 33, 8) tensors at full
            size: the plan must resolve to the ``hopper`` backend, every
            kernel must launch, rel_error must be <= 0.02 and the factors
            must match the same plan on ``matfree``.  Warm executes are
            timed on both backends (host clock around a synchronized
            execute), and one more execute runs under torch.profiler for
            the device's busy time, idle share and top kernels.
5. kernels  one JSON line listing every kernel with its numbers; then the
            ``nvidia-smi`` name/power-limit line; then the final
            ``{"ok": true, "device": ...}`` line.

Imports nothing of JAX nor of the JAX package ``repro``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
TOL = 1e-4          # max|kernel - plain| <= TOL * max|plain| (fp32 sums, reordered)
WARM_RUNS = 7
#: (HBM bytes/s, fp32 non-tensor FLOP/s) from NVIDIA's H100 data sheets
PEAKS = {"sxm": (3.35e12, 67e12), "pcie": (2.0e12, 51e12), "nvl": (3.9e12, 60e12)}
#: main-path configurations: the paper's Table III tensors at full size
BOATS = ((320, 240, 7000), (10, 10, 10))
HSI = ((1021, 1340, 33, 8), (10, 10, 10, 5))
KERNELS = {
    "ttt": dict(source="src/repro_torch/csrc/ttt.cu",
                replaces="src/repro/kernels/ttt.py:37"),
    "matmul": dict(source="src/repro_torch/csrc/matmul.cu",
                   replaces="src/repro/kernels/matmul.py:34"),
    "ttm_interior": dict(source="src/repro_torch/csrc/ttm.cu",
                         replaces="src/repro/kernels/ttm.py:39"),
}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# phase 1: environment
# ---------------------------------------------------------------------------

def phase_env(torch):
    require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    low = name.lower()
    variant = "pcie" if "pcie" in low else "nvl" if "nvl" in low else "sxm"
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=name,
         count=torch.cuda.device_count(), nvidia_smi=smi,
         peak_variant=variant,
         allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32)
    return smi, PEAKS[variant]


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    secs = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in _build.BUILD_LOG.items()}
    emit("build", seconds=secs, libraries=[str(p.relative_to(ROOT))
                                          for p in libs.values()],
         ptxas=ptxas)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def close(got, want) -> float:
    """max|got - want|, checked against TOL * max|want|."""
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    require(math.isfinite(err) and err <= TOL * max(scale, 1e-30),
            f"max|kernel - plain| = {err:.3e} exceeds {TOL:g} * {scale:.3e}")
    return err


def time_ms(torch, fn, runs: int = WARM_RUNS) -> float:
    """Median of ``runs`` warm CUDA-event timings of ``fn()``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def phase_kernel_shapes(torch):
    """The non-tiling shapes of the reference's kernel tests, fp32 and bf16."""
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device="cuda").manual_seed(1)
    ttm_cases = [((5, 37, 19), 1, 7), ((33, 12, 50), 0, 9),
                 ((13, 21, 40), 2, 5), ((4, 9, 11, 6), 2, 3),
                 ((130, 140, 3), 0, 64), ((3, 200, 129), 1, 130),
                 ((260, 7, 5), 0, 11), ((2, 3, 4, 5, 6), 2, 2),
                 ((8, 40, 24), 1, 6), ((77, 5, 300), 2, 40)]
    # the last entries of each list add split reductions, the last-mode
    # column path (B = 1) and mirrored multi-tile Grams
    gram_cases = [((5, 37, 19), 1), ((33, 12, 50), 0), ((13, 21, 40), 2),
                  ((4, 9, 11, 6), 3), ((129, 6, 7), 0), ((3, 150, 70), 1),
                  ((50, 300, 40), 1), ((600, 7, 13), 2)]
    ttt_cases = [((5, 37, 19), 1, 7), ((13, 21, 40), 2, 5), ((9, 8, 7), 0, 3),
                 ((6, 300, 5), 1, 20), ((600, 7, 130), 2, 9),
                 ((40, 260, 33), 1, 30)]
    worst = 0.0
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        def rnd(shape):
            return torch.randn(shape, generator=g, device="cuda").to(dtype)
        for shape, mode, r in ttm_cases:
            x, u = rnd(shape), rnd((r, shape[mode]))
            worst = max(worst, close(ops.ttm(x, u, mode),
                                     ref.ttm_full_ref(x, u, mode)))
            n += 1
        for shape, mode in gram_cases:
            x = rnd(shape)
            worst = max(worst, close(ops.gram(x, mode),
                                     ref.gram_full_ref(x, mode)))
            n += 1
        for shape, mode, r in ttt_cases:
            x = rnd(shape)
            y = rnd(shape[:mode] + (r,) + shape[mode + 1:])
            a = math.prod(shape[:mode])
            worst = max(worst, close(ops.ttt(x, y, mode), ref.ttt_ref(
                x.view(a, shape[mode], -1), y.view(a, r, -1))))
            n += 1
    torch.cuda.synchronize()
    emit("kernels_small", cases=n, dtypes=["float32", "bfloat16"],
         max_abs_err=worst, tol_rel=TOL, ok=True)


def phase_kernels_large(torch):
    """Every kernel path on an operand of more than 2**31 elements (9 GB in
    fp32): the kernels index memory in 64 bits, only extents are ints."""
    from repro_torch.kernels import matmul, ref, ttm_interior, ttt3
    g = torch.Generator(device="cuda").manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    x = rnd(2048, 1100, 1000)
    require(x.numel() > 2 ** 31, "the large operand must exceed 2**31 elements")
    xc = x.view(2048 * 1100, 1000, 1)          # the last-mode (B = 1) view
    u0, u1, u2 = rnd(10, 2048), rnd(10, 1100), rnd(1000, 10)
    y, yc = rnd(2048, 10, 1000), rnd(2048 * 1100, 10, 1)
    cases = {
        "ttt": (lambda: ttt3(x, y), lambda: ref.ttt_ref(x, y)),
        "ttt_cols": (lambda: ttt3(xc, yc), lambda: ref.ttt_ref(xc, yc)),
        "matmul_first": (lambda: matmul(u0, x.view(2048, -1)),
                         lambda: ref.matmul_ref(u0, x.view(2048, -1))),
        "matmul_last": (lambda: matmul(x.view(-1, 1000), u2),
                        lambda: ref.matmul_ref(x.view(-1, 1000), u2)),
        "ttm_interior": (lambda: ttm_interior(u1, x),
                         lambda: ref.ttm_interior_ref(u1, x)),
    }
    errs = {}
    for name, (kernel, plain) in cases.items():
        errs[name] = close(kernel(), plain())
        torch.cuda.empty_cache()
    del x, xc, y, yc
    torch.cuda.empty_cache()
    emit("kernels_large", elements=2048 * 1100 * 1000, max_abs_err=errs,
         tol_rel=TOL, ok=True)


def phase_kernels_full(torch, peaks):
    """Each kernel at the main path's shapes: correctness, times, bound."""
    from repro_torch.kernels import matmul, ref, ttm_interior, ttt3
    bw, fl = peaks
    g = torch.Generator(device="cuda").manual_seed(2)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    def bound(nbytes, flops):
        t_b, t_f = nbytes / bw * 1e3, flops / fl * 1e3
        return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")

    out = {}

    def measure(name, shape_desc, kernel, plain, library, nbytes, flops):
        got, want = kernel(), plain()
        err = close(got, want)
        del got, want
        b_ms, b_by = bound(nbytes, flops)
        out[name] = dict(shapes=shape_desc, max_abs_err=err,
                         ms=time_ms(torch, kernel),
                         plain_ms=time_ms(torch, plain),
                         library_ms=time_ms(torch, library),
                         bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                         flops=flops)
        emit("kernel_full", name=name, **out[name])

    # ttt: the Boats mode-2 ALS TTT (B = 1, a 76,800-deep reduction)
    x, y = rnd(76800, 7000, 1), rnd(76800, 10, 1)
    measure("ttt", "x (76800, 7000, 1) fp32, y (76800, 10, 1) fp32",
            lambda: ttt3(x, y), lambda: ref.ttt_ref(x, y),
            lambda: torch.tensordot(x, y, dims=([0, 2], [0, 2])),
            4 * (x.numel() + y.numel() + 7000 * 10), 2.0 * 76800 * 7000 * 10)
    # matmul: the Boats mode-2 TTM, x2 (76800, 7000) @ u^T (7000, 10)
    a, b = x.view(76800, 7000), rnd(7000, 10)
    measure("matmul", "(76800, 7000) @ (7000, 10) fp32",
            lambda: matmul(a, b), lambda: ref.matmul_ref(a, b),
            lambda: torch.matmul(a, b),
            4 * (a.numel() + b.numel() + 76800 * 10), 2.0 * 76800 * 7000 * 10)
    del x, y, a, b
    torch.cuda.empty_cache()
    # gram: the HSI mode-1 EIG Gram; ttm_interior: the HSI mode-1 TTM.  The
    # Gram is symmetric: the function needs only its I(I+1)/2 distinct
    # entries, 2·A·B·I(I+1)/2 flop
    x = rnd(1021, 1340, 264)
    measure("gram", "x (1021, 1340, 264) fp32 -> (1340, 1340)",
            lambda: ttt3(x, x), lambda: ref.gram_ref(x),
            lambda: torch.tensordot(x, x, dims=([0, 2], [0, 2])),
            4 * (x.numel() + 1340 * 1340), 1.0 * 1021 * 264 * 1340 * 1341)
    u = rnd(10, 1340)
    measure("ttm_interior", "u (10, 1340), x (1021, 1340, 264) fp32",
            lambda: ttm_interior(u, x), lambda: ref.ttm_interior_ref(u, x),
            lambda: torch.matmul(u, x),
            4 * (x.numel() + u.numel() + 1021 * 10 * 264),
            2.0 * 1021 * 264 * 1340 * 10)
    del x, u
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path, plan -> execute at full size
# ---------------------------------------------------------------------------

def lowrank(torch, shape, ranks, gen):
    """Low-rank tensor at ``ranks`` plus Gaussian noise at 1% of its norm,
    made on the card from ``gen``."""
    from repro_torch.core import tensor_ops as T
    core = torch.randn(ranks, generator=gen, device="cuda")
    us = [torch.linalg.qr(torch.randn((d, r), generator=gen, device="cuda"))[0]
          for d, r in zip(shape, ranks)]
    x = T.reconstruct(core, us)
    noise = torch.randn(shape, generator=gen, device="cuda")
    x.add_(noise, alpha=0.01 * float(T.fro_norm(x) / T.fro_norm(noise)))
    return x


def profile_execute(torch, p, x, wall_ms: float) -> dict:
    """One execute under torch.profiler: device busy time (kernels, copies
    and sets, summed over device events — one stream, so they do not
    overlap), the idle share of the unprofiled wall time, the host's
    kernel-launch calls, and the device time of the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        p.execute(x)
        torch.cuda.synchronize()
    busy, by_name, launches = 0.0, {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy += us
            by_name[e.name] = by_name.get(e.name, 0.0) + us
        elif e.name.startswith("cudaLaunchKernel"):
            launches += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return dict(device_busy_ms=busy / 1e3,
                idle_share=max(0.0, 1.0 - busy / 1e3 / wall_ms),
                host_kernel_launches=launches,
                top_device_ms=[[name[:80], us / 1e3] for name, us in top])


def projector_gap(torch, u1, u2) -> float:
    return float((u1 @ u1.T - u2 @ u2.T).abs().max())


def phase_main(torch):
    from repro_torch import kernels
    from repro_torch.core import TuckerConfig, plan
    cases = [("boats", *BOATS, "auto"), ("hsi", *HSI, "auto"),
             ("hsi_eig", *HSI, "eig")]
    gen = torch.Generator(device="cuda").manual_seed(0)
    data = {}
    launched = {k: 0 for k in KERNELS}
    results = []
    for name, shape, ranks, methods in cases:
        if shape not in data:
            data.clear()
            torch.cuda.empty_cache()
            data[shape] = lowrank(torch, shape, ranks, gen)
        x = data[shape]
        cfg = TuckerConfig(ranks=ranks, methods=methods, mode_order="shrink",
                           impl="auto")
        p = plan(shape, "float32", cfg)
        require(p.backend == "hopper",
                f"{name}: impl='auto' resolved to {p.backend!r}, not 'hopper'")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        res = p.execute(x)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        for k, v in counts.items():
            launched[k] += v
        rel = float(res.tucker.rel_error(x))
        require(math.isfinite(rel) and rel <= 0.02,
                f"{name}: rel_error {rel} > 0.02")
        pm = plan(shape, "float32", TuckerConfig(
            ranks=ranks, methods=p.methods, mode_order="shrink",
            impl="matfree"))
        ref_res = pm.execute(x)
        rel_m = float(ref_res.tucker.rel_error(x))
        gaps = [projector_gap(torch, a, b) for a, b in
                zip(res.tucker.factors, ref_res.tucker.factors)]
        require(max(gaps) <= 1e-3, f"{name}: projector gap {max(gaps)} > 1e-3")
        require(abs(rel - rel_m) <= 1e-4,
                f"{name}: |rel_error - matfree| = {abs(rel - rel_m)} > 1e-4")
        times = []
        p.execute(x)
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p.execute(x)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        tm = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pm.execute(x)
            torch.cuda.synchronize()
            tm.append(time.perf_counter() - t0)
        wall = statistics.median(times) * 1e3
        row = dict(case=name, shape=list(shape), ranks=list(ranks),
                   methods=list(p.methods),
                   schedule=[dict(mode=s.mode, method=s.method, i_n=s.i_n,
                                  r_n=s.r_n, j_n=s.j_n) for s in p.schedule],
                   rel_error=rel, rel_error_matfree=rel_m,
                   max_projector_gap=max(gaps),
                   execute_ms=wall, execute_ms_all=[t * 1e3 for t in times],
                   execute_ms_matfree=statistics.median(tm) * 1e3,
                   execute_ms_matfree_all=[t * 1e3 for t in tm],
                   peak_bytes=peak, launches=counts,
                   profile=profile_execute(torch, p, x, wall))
        emit("main", **row)
        results.append(row)
        del res, ref_res
    data.clear()
    torch.cuda.empty_cache()
    for k, v in launched.items():
        require(v > 0, f"kernel {k} never launched on the main path")
    return launched


# ---------------------------------------------------------------------------

def main() -> int:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py: src/repro_torch not found next to this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 3
    try:
        smi, peaks = phase_env(torch)
        phase_build()
        phase_kernel_shapes(torch)
        phase_kernels_large(torch)
        full = phase_kernels_full(torch, peaks)
        launched = phase_main(torch)
    except SmokeFailure as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        return 1
    rows = []
    for name, meta in KERNELS.items():
        # the ttt kernel carries both the TTT and the Gram; its row gives the
        # TTT numbers, the Gram's ride along under "gram"
        m = full[name]
        row = dict(name=name, route="cuda", **meta, launches=launched[name],
                   max_abs_err=m["max_abs_err"], ms=m["ms"],
                   plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
                   bound_by=m["bound_by"], library_ms=m["library_ms"])
        if name == "ttt":
            row["gram"] = {k: full["gram"][k] for k in
                           ("max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms")}
        rows.append(row)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
