#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

It drives the port's paths -- fixed-rank Tucker ``plan -> execute``, the
adaptive Tucker path (error targets, the fallback ladder's rand->eig hop,
the schedule search under a memory cap) and serving falcon-mamba-7b --
through four hand-written Hopper kernels: TTT/Gram, boundary GEMM,
interior TTM and the Mamba-1 selective scan (S6); then the tune flywheel
that trains the solver selector ``methods="auto"`` loads on the card.

Phases, each printing one JSON line (any failure exits non-zero):

1. env      torch/CUDA versions, the card's name, power limit, SM count and
            maximum SM clock, TF32 off.
2. build    compile ``src/repro_torch/csrc/*.cu`` with nvcc for sm_90a (one
            process per source, all at once) into ``build/repro_torch/``.
3. kernels  hold every kernel against its plain PyTorch version on the card
            (``max|kernel - plain| <= 1e-4 * max|plain|``): first on the
            non-tiling shapes of the reference's kernel tests in fp32 and
            bf16 (for S6 also ragged T, Di and N, T = 1 from a nonzero
            state, strided B/C, y and the final state; for the TTT/Gram
            every route of its tensor-core kernel -- TMA, plain-load, B = 1,
            misaligned, fp32 and bf16 -- also per entry, within 2e-4 of
            sqrt(ttt(x∘x, y∘y)) of the float64 result; for the boundary
            GEMM's wide route -- the first mode at R > 16 on the tensor
            cores -- R = 17 to 300 with K = 7 and 1021, ragged N, both of
            x's loads (TMA, plain) and a misaligned x, per entry within
            2e-4 of sqrt((u∘u) @ (x∘x))), then on operands of
            more than 2**31 elements (every kernel path), then at the main
            paths' full-size shapes, where the kernel, its plain version and
            one PyTorch library call (none computes a selective scan) are
            timed (CUDA events around one call, median of warm runs; and
            the CUDA kernels' own time under torch.profiler) beside the
            bound and each CUDA kernel's registers, resident blocks per SM,
            grid and waves (the Gram beside three bounds: bytes, FFMA and
            three TF32 products).  The adaptive path's widest range sample,
            a TTT with y ≠ x at R = 64 on the tensor-core route, is held
            per entry and timed the same way (beside ``tensordot``), and the
            interior TTM at the sketch's 64 rows; and the boundary GEMM at
            adapt_wide's mode 0, u (R, 1021) @ x (1021, 353760) at R = 64
            and 40 (row 2b), on its wide route beside the slab route it
            replaced and torch.matmul, per entry in fp32 and bf16.  S6 is
            also timed at every shape the serve run gives it, on both of
            its routes.
4. main     ``plan -> execute`` with ``impl="auto"`` on the paper's Table III
            Boats (320, 240, 7000) and HSI (1021, 1340, 33, 8) tensors at full
            size: the plan must resolve to the ``hopper`` backend, every
            kernel must launch, rel_error must be <= 0.02 and the factors
            must match the same plan on ``matfree``.  Warm executes are
            timed on both backends (host clock around a synchronized
            execute), and one more execute runs under torch.profiler for
            the device's busy time, idle share, top kernels and the
            tensor-core Gram's device time (hsi_eig must run it) and the
            first-mode GEMM's by route.  These executes replay the plans'
            captured sweeps (the first one captures them).  Each case also
            prints every mode's solver as the shipped cuda model picks it
            and as the textbook cost model picks it; where they differ,
            both plans' executes are timed in turns (3 warm runs each) and
            the textbook plan's rel_error is held to 0.02 too.
4b. graphs the cached sweep captured into CUDA graphs on main's inputs
            (hsi's, and boats' made again from the same seed): boats, hsi
            and hsi_eig on hopper and boats on matfree, each from a clear
            sweep cache.  The eager sweep (``TuckerPlan._run``) runs once
            under ``torch.cuda.set_sync_debug_mode("warn")`` to list its
            sync points; then 5 executes (builds 1, hits 4, one trace a
            captured segment), the captured result bitwise equal to the
            eager one, the kernels' launches (and TTT/GEMM routes) on one
            replay equal to one eager sweep's, eager and captured ms (3
            warm runs each, in turns), device busy ms, idle share and host
            launches (a graph replay counts once) of each, the segments,
            the graphs' pool bytes and the static input's bytes.  Then
            ``obs``: hsi planned and executed from a clear cache inside one
            ``obs.capture()`` and one ``MemoryWatch`` writes a Chrome trace
            to ``chiprun_out/graphs_hsi_trace.json`` holding the plan,
            execute, cache, capture (one a segment) and compile events, and
            the watch's high water is at least the eager sweep's peak; and
            ``chaos``: a ``sweep_out`` poison on boats takes the
            ``als_to_eig`` hop on hopper, counted once in the registry.
5. adaptive the adaptive path at full size with ``impl="auto"`` (every plan
            must resolve to ``hopper``), each case also on ``matfree`` and
            timed on both (host clock, median of 3 warm runs), the launch
            counts zeroed before each measured execute:
            adapt_hsi  HSI at ranks (10, 10, 10, 5) + 1% noise,
                       ``error_target=0.03, methods="rand"``: ranks (10, 10,
                       10, 5), error_bound <= 0.03, rel_error <= 1.05 x the
                       bound, matfree's ranks, projector gap <= 1e-3;
            adapt_miss the same input at ``error_target=0.005`` (below mode
                       0's noise floor), ``methods="rand"``, rank caps (16,
                       16, 16, 8): mode 0 misses its budget and keeps its
                       cap, the rand->eig hop is taken and counted,
                       rel_error <= 0.02, the missed bound reported;
            adapt_wide HSI at ranks (40, 40, 10, 5) + 1% noise,
                       ``error_target=0.03`` (sketch widths 16 -> 32 -> 64,
                       then the eig/als refinement): the same checks, and
                       the TTT ran its tensor-core route with y ≠ x;
            (Capped plans run their sweep eagerly: checked.)
            opt_cap    Boats under ``mode_order="opt"`` and a memory cap of
                       0.8 x the free plan's largest step peak, or the least
                       cap the search admits when that is infeasible: every
                       step's modeled peak fits, and step by step through
                       ``solve_step`` the input plus the memory allocated
                       beyond it fits the cap at every step boundary and
                       inside every step, and each step's modeled peak;
                       rel_error <= 0.02;
            opt_cap_eig the same input with ``methods="eig"`` at the least
                       cap the search admits on hopper (whose steps also
                       model the TTT's split-K workspace, eigh's workspace
                       and the held input), held the same way; matfree's
                       least cap reported beside; eigh's allocation at
                       every Gram size of the plans within its model.
            adapt_wide must run the GEMM's wide route; every case reports
            the GEMM's launches and device time by route.
            Each sketch also prints its widths, the tail at the chosen rank
            from the kernel's Gram and from a float64 Gram of the same b,
            and ||X||² in fp32 and float64.
6. serve    falcon-mamba-7b at its published size (64 layers, 7.3e9
            parameters, bf16, random weights from seed 0) in ``ServeEngine``
            with 4 slots answers 6 requests (prompts of 37 to 8191 tokens,
            32 new tokens each, one sampled at temperature 0.8): every
            request gets 32 valid tokens, all logits are finite, and the S6
            wrapper launches 64 times per prefill and per decode step (one
            CUDA kernel a call on its single-pass route, three on its
            chunked route).  Then
            the state carry: on the same model cast to fp32, a fresh prefill
            over a greedy request's prompt plus its first 8 tokens must
            reproduce the logits its decode step produced (same argmax, max
            difference <= 1e-3 of max|logits|; the bf16 figures are
            reported beside it).  Prints
            prefill ms by prompt length, decode ms per step, tokens/s, peak
            memory, and the idle share and top kernels of one profiled
            decode step.  The decode step is a CUDA graph captured when the
            engine is made; the same 6 requests then run on an engine whose
            decode step runs eagerly: every token identical, 64 S6 launches
            a step there too, decode ms and decode tokens/s of both.
7. tune     the tune flywheel (``repro_torch.tune``): a training set
            (seed 0) and a test set (seed 1) of tensors of order 3 and 4,
            dims log-uniform in [8, 8192], at most 2**29 elements, ranks
            up to min(64, I_n/2), each mode solved by EIG and ALS on
            ``hopper`` and ``matfree``, each solve captured into CUDA graphs
            and replayed (the test set also eagerly); the test set also
            holds every step of boats' and hsi's plans.  Trees and
            calibrated cost models are trained into
            ``chiprun_out/tune/models`` (their meta names the card and its
            power limit).  Prints per backend the test accuracy and the
            picked solvers' time over the oracle's for the phase's tree, the
            shipped tree, the textbook and calibrated cost models,
            always-EIG and always-ALS; each main step's times and picks;
            eager/replayed ratios.  Checks: every record finite and > 0;
            ``recording()`` around one execute of boats and of hsi yields one
            record a step with the plan's (I_n, R_n, J_n, method, backend);
            ``default_selector("cuda", "hopper")`` resolves to the shipped
            ``src/repro_torch/core/models/selector_cuda_hopper.json``.
8. kernels  one JSON line listing every kernel with its numbers (the TTT
            row carries the Gram's under "gram" and the range sample's under
            "sketch", the GEMM row its wide route's under "wide";
            ``launches_adaptive`` counts the adaptive phase), after a
            ``run`` line with the whole run's seconds; then the
            ``nvidia-smi`` name/power-limit line; then the final
            ``{"ok": true, "device": ...}`` line.

``python3 chip_smoke.py --only kernels`` runs phases 1-3 only (the quick
check after a kernel edit) and ``--only tune`` phases 1, 2 and 7 (the
command that trains the shipped cuda models); neither prints the kernels
line.

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
#: per-entry limit of the TTT/Gram tensor-core routes: |kernel - exact| <=
#: ENTRY_TOL * sqrt(ttt(x∘x, y∘y)), the entry's own scale, with "exact" the
#: plain version's einsum evaluated in float64.  max|plain| is the Gram's
#: largest diagonal entry, ~sqrt(K) times an off-diagonal one, so TOL alone
#: would let a single-TF32 product (1.1e-3 in these units at the main
#: path's depth) pass.  The plain version in fp32 is itself no yardstick at
#: this depth: its own error is reported beside the kernel's.
ENTRY_TOL = 2e-4
WARM_RUNS = 7
#: (HBM bytes/s, fp32 non-tensor FLOP/s, dense TF32 tensor FLOP/s) from
#: NVIDIA's H100 data sheets (TF32 dense is half the sheets' rate with
#: sparsity: SXM 989, NVL 835, PCIe 756 TFLOP/s)
PEAKS = {"sxm": (3.35e12, 67e12, 495e12), "pcie": (2.0e12, 51e12, 378e12),
         "nvl": (3.9e12, 60e12, 417.5e12)}
#: SFU exponentials per clock per SM on compute capability 9.0 (the CUDA C++
#: Programming Guide's arithmetic-instruction throughput table)
SFU_PER_CLOCK_SM = 16
#: main-path configurations: the paper's Table III tensors at full size
BOATS = ((320, 240, 7000), (10, 10, 10))
HSI = ((1021, 1340, 33, 8), (10, 10, 10, 5))
#: adaptive-path inputs: HSI's shape at its ranks, and at wider ranks that
#: make two modes double their sketch width twice (16 -> 32 -> 64)
ADAPT_HSI = HSI
ADAPT_WIDE = ((1021, 1340, 33, 8), (40, 40, 10, 5))
KERNELS = {
    "ttt": dict(source="src/repro_torch/csrc/ttt.cu",
                replaces="src/repro/kernels/ttt.py:37"),
    "matmul": dict(source="src/repro_torch/csrc/matmul.cu",
                   replaces="src/repro/kernels/matmul.py:34"),
    "ttm_interior": dict(source="src/repro_torch/csrc/ttm.cu",
                         replaces="src/repro/kernels/ttm.py:39"),
    "s6_scan": dict(source="src/repro_torch/csrc/s6_scan.cu",
                    replaces="src/repro/kernels/s6_scan.py:51"),
}
#: serve phase: prompt lengths of the 6 requests (the longest fills the
#: 8192-token context with one token to spare), new tokens per request, the
#: request sampled at temperature 0.8, and the greedy request whose decode
#: logits after K_CARRY generated tokens a fresh prefill must reproduce
PROMPTS = (37, 517, 1024, 2048, 4096, 8191)
MAX_NEW = 32
SAMPLED = 1
WATCH, K_CARRY = 0, 8
#: state carry, checked on the full-size model cast to fp32:
#: max|fresh prefill - decode logits| <= CARRY_TOL * max|logits|.  In fp32
#: the two paths differ only in the order of sums (GEMMs at M = 1 vs 45),
#: ~1e-5 of max|logits| after 64 layers; a state that is lost or misplaced
#: moves the logits by percents.  In bf16 the same rounding differences
#: grow to ~4% through 64 random layers and flip the argmax of the flat
#: random-weight logits (measured on the H100), so the bf16 figures are
#: reported, not held to a limit.
CARRY_TOL = 1e-3


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
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sfu = SFU_PER_CLOCK_SM * sms * clock_mhz * 1e6
    name = torch.cuda.get_device_name(0)
    low = name.lower()
    variant = "pcie" if "pcie" in low else "nvl" if "nvl" in low else "sxm"
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=name,
         count=torch.cuda.device_count(), nvidia_smi=smi,
         peak_variant=variant, sms=sms, max_sm_clock_mhz=clock_mhz,
         sfu_exp_per_s=sfu,
         allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32)
    return smi, (*PEAKS[variant], sfu)


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    secs = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "arning" in ln]
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


def entry_err(torch, got, x3, y3, check: bool = True) -> float:
    """max over entries of |got - z| in units of the entry's own scale
    sqrt(ttt(x3∘x3, y3∘y3)) (sqrt(gram(x∘x)) for a Gram), where z is
    ttt_ref's einsum in float64 (summed over chunks of a, so that an
    operand beyond 2**31 elements needs no float64 copy); checked against
    ENTRY_TOL unless ``check`` is False."""
    want = torch.zeros(got.shape, dtype=torch.float64, device=got.device)
    scale = torch.zeros_like(want)
    for lo in range(0, x3.shape[0], 64):
        xc, yc = x3[lo:lo + 64].double(), y3[lo:lo + 64].double()
        want += torch.einsum("aib,arb->ir", xc, yc)
        scale += torch.einsum("aib,arb->ir", xc.square(), yc.square())
        del xc, yc
    err = float(((got.double() - want).abs_() / scale.sqrt_().clamp_min_(1e-300)).max())
    require(not check or (math.isfinite(err) and err <= ENTRY_TOL),
            f"max |kernel - exact| / sqrt(ttt(x∘x, y∘y)) = {err:.3e} exceeds "
            f"{ENTRY_TOL:g}")
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
    phase_ttt_wide_shapes(torch)
    phase_matmul_wide_shapes(torch)
    phase_ttm_shapes(torch)
    phase_s6_shapes(torch)


def s6_inputs(torch, g, bsz, t, di, n, dtype, *, strided=False, h0=False,
              model_dt=False):
    """S6 operands on the card.  dt is |N(0, 1)| * 0.1 as in the reference's
    kernel test, or ``softplus(-4 + 0.6 N(0, 1))`` as the model's layer 0
    gives (mean ~ 0.022); ``strided`` makes B and C column slices of one
    (B, T, 8 + 2N) projection, as the model passes them."""
    def rnd(*shape, dt=dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dt)
    x = rnd(bsz, t, di)
    if model_dt:
        dt = torch.nn.functional.softplus(rnd(bsz, t, di, dt=torch.float32)
                                          .mul_(0.6).sub_(4.0))
    else:
        dt = rnd(bsz, t, di, dt=torch.float32).abs_().mul_(0.1)
    if strided:
        proj = rnd(bsz, t, 8 + 2 * n)
        bm, cm = proj[..., 8:8 + n], proj[..., 8 + n:]
    else:
        bm, cm = rnd(bsz, t, n), rnd(bsz, t, n)
    a = -rnd(di, n, dt=torch.float32).abs_()
    hz = rnd(bsz, di, n, dt=torch.float32) if h0 else None
    return x, dt, bm, cm, a, hz


def model_a(torch, di, n):
    """The model's a = -exp(a_log) = -(1..N) in every channel."""
    return -torch.arange(1, n + 1, dtype=torch.float32,
                         device="cuda").repeat(di, 1)


def phase_s6_shapes(torch):
    """The S6 kernel against its step recurrence: the shapes of the
    reference's kernel and scan tests, ragged T/Di/N, every states-per-lane
    width (N = 4 ... 64), T = 1 from a nonzero state (the decode step),
    strided B/C; y and the final state, fp32 and bf16.  Then both routes
    around the chunked route's edges: T at its threshold on the model's
    width (the wrapper's own choice), the chunked route forced at T = Lc - 1,
    Lc, Lc + 1, 2 Lc + 3 for its shortest chunk at batch 1 and 2, with and
    without h0, over every state width it templates, and longer chunks at
    their edges (batch 8 at the model's width, where the chunk grows)."""
    from repro_torch.kernels import ref, s6_scan
    s6 = s6_module()
    g = torch.Generator(device="cuda").manual_seed(4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lc = s6.CHUNK_MIN
    # (B, T, Di, N, strided, h0, force_route)
    cases = [(2, 128, 64, 8, False, False, None), (1, 64, 32, 4, False, False, None),
             (3, 96, 16, 16, False, False, None), (2, 37, 5, 4, False, True, None),
             (2, 77, 200, 16, True, True, None), (2, 33, 70, 5, True, False, None),
             (1, 40, 48, 32, False, True, None), (1, 50, 40, 64, True, True, None),
             (3, 1, 100, 16, True, True, None), (4, 1, 8192, 16, True, True, None)]
    t_min = -(-s6.CHUNKED_MIN_WORK // 8192)
    for bsz in (1, 2):
        tb = -(-t_min // bsz)
        cases += [(bsz, t, 8192, 16, True, h0, None)
                  for t in (tb - 1, tb, tb + 1) for h0 in (False, True)]
        cases += [(bsz, t, 200, n, True, h0, "chunked")
                  for t in (lc - 1, lc, lc + 1, 2 * lc + 3)
                  for n, h0 in ((16, False), (16, True), (5, True))]
    cases += [(2, 2 * lc + 3, 70, n, False, True, "chunked") for n in (4, 8, 32, 64)]
    cases += [(8, t, 8192, 16, True, True, None) for t in (255, 256, 257, 515, 1027)]
    chunks = sorted({s6.chunk_len(b, t, di, sms) for b, t, di, *_ in cases})
    worst, n_cases, routes = 0.0, 0, {"single": 0, "chunked": 0}
    for dtype in (torch.float32, torch.bfloat16):
        for bsz, t, di, ns, strided, h0, force in cases:
            ops = s6_inputs(torch, g, bsz, t, di, ns, dtype, strided=strided,
                            h0=h0)
            y, hf = s6_scan(*ops, force_route=force)
            yr, hr = ref.s6_scan_ref(*ops)
            worst = max(worst, close(y, yr), close(hf, hr))
            routes[force or s6.route(bsz, t, di)] += 1
            n_cases += 1
    torch.cuda.synchronize()
    emit("kernels_small", name="s6_scan", cases=n_cases, routes=routes,
         chunk_lens=chunks, chunked_min_work=s6.CHUNKED_MIN_WORK,
         dtypes=["float32", "bfloat16"], max_abs_err=worst, tol_rel=TOL,
         ok=True)


def phase_ttt_wide_shapes(torch):
    """The tensor-core routes of the TTT/Gram kernel (R > 16) on every
    route, fp32 (split TF32, three products) and bf16 (one product): TMA
    (rows of a 16-byte multiple of at least 128 bytes, aligned; B = 40, 48,
    64, 264, 600), and the plain-load route for rows of other lengths (B =
    19, 33, 70), B = 1 (MN-major operands) and a misaligned base.  Grams of
    one to several 128-row tiles (diagonal and upper tiles, ragged I, split
    and unsplit reductions) and TTTs with R = 20 to 200 across tiles.  Each
    is held per entry against ttt_ref's einsum in float64 (ENTRY_TOL of
    sqrt(ttt(x∘x, y∘y))).  Fails unless every route ran in both dtypes."""
    from repro_torch.kernels import ttt3
    ttt = ttt_module()
    g = torch.Generator(device="cuda").manual_seed(9)
    # (x3 shape, R of y3; None: the Gram, y3 is x3)
    cases = [((7, 300, 40), None), ((5, 200, 264), None), ((9, 100, 64), None),
             ((2, 150, 600), None), ((6, 150, 48), 40), ((4, 70, 264), 200),
             ((3, 150, 70), None), ((40, 260, 33), 30), ((5, 37, 19), None),
             ((273, 40, 1), None), ((300, 130, 1), 20)]
    worst, n, routes = 0.0, 0, {}
    for dtype in (torch.float32, torch.bfloat16):
        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda").to(dtype)
        ops = []
        for (a, i, b), r in cases:
            x = rnd(a, i, b)
            ops.append((x, x if r is None else rnd(a, r, b), b == 1))
        flat = rnd(2 * 5 * 140 * 264 + 1)     # one element in: misaligned
        xm = flat[1:5 * 140 * 264 + 1].view(5, 140, 264)
        ops += [(xm, xm, False),
                (xm, flat[1 + 5 * 140 * 264:1 + 5 * 170 * 264].view(5, 30, 264),
                 False)]
        for x, y, b1 in ops:
            rt = ttt.call_route(x, y)
            require(rt.startswith("wgmma"), f"ttt: {tuple(x.shape)} took {rt}")
            aligned = x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
            kind = "b1" if b1 else "misaligned" if not aligned else \
                "gram" if y is x else "ttt"
            key = f"{rt}/{kind}/{str(dtype)[6:]}"
            routes[key] = routes.get(key, 0) + 1
            worst = max(worst, entry_err(torch, ttt3(x, y), x, y))
            n += 1
    torch.cuda.synchronize()
    for want in ("wgmma_tma/gram", "wgmma_tma/ttt", "wgmma_plain/gram",
                 "wgmma_plain/ttt", "wgmma_plain/b1", "wgmma_plain/misaligned"):
        for dt in ("float32", "bfloat16"):
            require(f"{want}/{dt}" in routes,
                    f"ttt: no small case took {want} in {dt}")
    emit("kernels_small", name="ttt_wide", cases=n, routes=routes,
         dtypes=["float32", "bfloat16"], max_entry_err=worst,
         entry_tol=ENTRY_TOL, ok=True)


#: first-mode GEMMs of the wide route in kernels_small: every R with K = 7
#: and K = 1021, N cycling through an odd width (plain loads), a 16-byte
#: multiple for fp32 only and one for both dtypes (TMA); R = 130 and 300
#: split R between the warpgroups, 300 also crosses a chunk of 256
MATMUL_WIDE_CASES = [(r, k, (1283, 2052, 2056)[j % 3]) for j, (r, k) in
                     enumerate((r, k) for r in (17, 24, 40, 64, 130, 300)
                               for k in (7, 1021))]


def gemm_entry_err(torch, got, a, b, check: bool = True) -> float:
    """max over entries of |got - C| in units of the entry's own scale
    sqrt((a∘a) @ (b∘b)), with C = a @ b in float64; checked against
    ENTRY_TOL unless ``check`` is False."""
    ad, bd = a.double(), b.double()
    want = ad @ bd
    scale = (ad.square() @ bd.square()).sqrt_().clamp_min_(1e-300)
    del ad, bd
    err = float(((got.double() - want).abs_() / scale).max())
    require(not check or (math.isfinite(err) and err <= ENTRY_TOL),
            f"max |kernel - exact| / sqrt((a∘a) @ (b∘b)) = {err:.3e} exceeds "
            f"{ENTRY_TOL:g}")
    return err


def matmul_module():
    """The wrapper module of the boundary GEMM (the package attribute
    ``matmul`` is the function)."""
    import importlib
    return importlib.import_module("repro_torch.kernels.matmul")


def phase_matmul_wide_shapes(torch):
    """The wide route of the boundary GEMM (first mode, R > 16) on
    MATMUL_WIDE_CASES and on an x whose base is not 16-byte aligned, fp32
    (split TF32, three products) and bf16 (one product): each held per
    entry against ``matmul_ref``'s product in float64 (ENTRY_TOL of
    sqrt((a∘a) @ (b∘b))) and against ``matmul_ref`` itself
    (max|kernel - plain| <= TOL max|plain|).  Fails unless every case took
    the wide route -- the C library's report, checked against route() --
    and both of x's loads (TMA, plain) ran in both dtypes."""
    from repro_torch.kernels import matmul, ref
    mm = matmul_module()
    g = torch.Generator(device="cuda").manual_seed(11)
    worst, worst_plain, n, seen = 0.0, 0.0, 0, {}
    for dtype in (torch.float32, torch.bfloat16):
        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda").to(dtype)
        ops = [(rnd(r, k), rnd(k, nn)) for r, k, nn in MATMUL_WIDE_CASES]
        flat = rnd(33 * 2056 + 1)            # one element in: misaligned
        ops.append((rnd(40, 33), flat[1:].view(33, 2056)))
        for a, b in ops:
            info = mm.launch_info(a, b)[0]
            require(info["route"] == "wide",
                    f"matmul: {tuple(a.shape)} @ {tuple(b.shape)} took "
                    f"{info['route']}")
            key = f"{info['loads']}/{str(dtype)[6:]}"
            seen[key] = seen.get(key, 0) + 1
            got = matmul(a, b)
            worst_plain = max(worst_plain, close(got, ref.matmul_ref(a, b)))
            worst = max(worst, gemm_entry_err(torch, got, a, b))
            n += 1
    torch.cuda.synchronize()
    for want in ("tma", "plain"):
        for dt in ("float32", "bfloat16"):
            require(f"{want}/{dt}" in seen,
                    f"matmul: no small case loaded x by {want} in {dt}")
    emit("kernels_small", name="matmul_wide", cases=n, loads=seen,
         dtypes=["float32", "bfloat16"], max_entry_err=worst,
         entry_tol=ENTRY_TOL, max_abs_err=worst_plain, tol_rel=TOL, ok=True)


def phase_ttm_shapes(torch):
    """The interior TTM on its own: R across the widths it templates and
    its slabs (4, 10, 16, 20), B = 1 and 8 (the plain-load path), 264 (the
    bulk-copy ring on tiles of whole values of a) and 1536 (the ring on
    1024-column ranges that cut across values of a), u in two shared-memory
    segments (I = 2000 at R = 16), and x at an address that is not 16-byte
    aligned (the plain path), fp32 and bf16."""
    from repro_torch.kernels import ref, ttm_interior
    g = torch.Generator(device="cuda").manual_seed(7)
    worst, n = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda").to(dtype)
        cases = [(rnd(r, 45), rnd(7, 45, b)) for r in (4, 10, 16, 20)
                 for b in (1, 8, 264)]
        cases += [(rnd(r, 45), rnd(3, 45, 1536)) for r in (10, 20)]
        cases.append((rnd(16, 2000), rnd(3, 2000, 264)))
        flat = rnd(5 * 37 * 264 + 1)
        cases.append((rnd(10, 37), flat[1:].view(5, 37, 264)))
        for u, x in cases:
            worst = max(worst, close(ttm_interior(u, x),
                                     ref.ttm_interior_ref(u, x)))
            n += 1
    torch.cuda.synchronize()
    emit("kernels_small", name="ttm_interior", cases=n,
         dtypes=["float32", "bfloat16"], max_abs_err=worst, tol_rel=TOL,
         ok=True)


def ttt_module():
    """The wrapper module of the TTT/Gram kernel (the package attribute
    ``ttt3`` is the function)."""
    import importlib
    return importlib.import_module("repro_torch.kernels.ttt")


def s6_module():
    """The wrapper module of the S6 kernel (the package attribute
    ``s6_scan`` is the function)."""
    import importlib
    return importlib.import_module("repro_torch.kernels.s6_scan")


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
    uw = rnd(40, 2048)          # the boundary GEMM's wide route
    y, yc = rnd(2048, 10, 1000), rnd(2048 * 1100, 10, 1)
    cases = {
        "ttt": (lambda: ttt3(x, y), lambda: ref.ttt_ref(x, y)),
        "ttt_cols": (lambda: ttt3(xc, yc), lambda: ref.ttt_ref(xc, yc)),
        "matmul_first": (lambda: matmul(u0, x.view(2048, -1)),
                         lambda: ref.matmul_ref(u0, x.view(2048, -1))),
        "matmul_first_wide": (lambda: matmul(uw, x.view(2048, -1)),
                              lambda: ref.matmul_ref(uw, x.view(2048, -1))),
        "matmul_last": (lambda: matmul(x.view(-1, 1000), u2),
                        lambda: ref.matmul_ref(x.view(-1, 1000), u2)),
        "ttm_interior": (lambda: ttm_interior(u1, x),
                         lambda: ref.ttm_interior_ref(u1, x)),
    }
    errs = {}
    for name, (kernel, plain) in cases.items():
        errs[name] = close(kernel(), plain())
        torch.cuda.empty_cache()
    del xc, y, yc
    # the Gram of I = 1100 on the TMA route: 9 GB of boxes behind one map.
    # At a 2.05e6-deep reduction every fp32 rounding of an entry near 2e6 is
    # already 5e-5 of its scale, so the kernel is held per entry to the
    # larger of ENTRY_TOL and the plain fp32 version's own error
    require(ttt_module().call_route(x, x) == "wgmma_tma", "large Gram off the TMA route")
    got = ttt3(x, x)
    errs["gram_wgmma_tma"] = close(got, ref.gram_ref(x))
    errs["gram_wgmma_tma_entry"] = entry_err(torch, got, x, x, check=False)
    errs["gram_plain_entry"] = entry_err(torch, ref.gram_ref(x), x, x, check=False)
    require(errs["gram_wgmma_tma_entry"] <= max(ENTRY_TOL, errs["gram_plain_entry"]),
            f"large Gram: per-entry error {errs['gram_wgmma_tma_entry']:.3e} exceeds "
            f"both {ENTRY_TOL:g} and the plain version's {errs['gram_plain_entry']:.3e}")
    del x, got
    torch.cuda.empty_cache()
    emit("kernels_large", elements=2048 * 1100 * 1000, max_abs_err=errs,
         tol_rel=TOL, ok=True)
    phase_s6_large(torch)


def phase_s6_large(torch):
    """The S6 kernel over x, dt and y of 2.16e9 elements each (B, T, Di =
    16, 16500, 8192; bf16 x, 21.6 GB in all): only the last batch row, whose
    offsets lie beyond 2**31, is held against the plain version.  a is the
    model's -(1..N), as on the main path: with random a near 0 a channel
    remembers all 16,500 steps, and the two versions' fp32 roundings then
    drift apart by ~2e-4 of max|y| (measured on the H100), which says
    nothing about the indexing this case is for."""
    from repro_torch.kernels import ref, s6_scan
    g = torch.Generator(device="cuda").manual_seed(5)
    bsz, t, di, n = 16, 16500, 8192, 16
    require(bsz * t * di > 2 ** 31, "the S6 operands must exceed 2**31 elements")
    x, dt, bm, cm, _, h0 = s6_inputs(torch, g, bsz, t, di, n, torch.bfloat16,
                                     strided=True, h0=True, model_dt=True)
    a = model_a(torch, di, n)
    y, hf = s6_scan(x, dt, bm, cm, a, h0)
    row = [v[-1:] for v in (x, dt, bm, cm)]
    yr, hr = ref.s6_scan_ref(*row, a, h0[-1:])
    errs = {"y": close(y[-1:], yr), "h_final": close(hf[-1:], hr)}
    del x, dt, bm, cm, y, hf, yr, hr, row
    torch.cuda.empty_cache()
    emit("kernels_large", name="s6_scan", shape=[bsz, t, di, n],
         elements=bsz * t * di, max_abs_err=errs, tol_rel=TOL, ok=True)


def phase_kernels_full(torch, peaks):
    """Each kernel at the main paths' shapes: correctness, times, bound, and
    the launch figures of each CUDA kernel it runs (registers per thread,
    resident blocks per SM, grid blocks and waves)."""
    import importlib
    from repro_torch.kernels import matmul, ref, s6_scan, ttm_interior, ttt3
    ttt_mod, matmul_mod, ttm_mod = (importlib.import_module(
        f"repro_torch.kernels.{m}") for m in ("ttt", "matmul", "ttm"))
    bw, fl, tf32, sfu = peaks
    g = torch.Generator(device="cuda").manual_seed(2)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    def bound(nbytes, flops):
        t_b, t_f = nbytes / bw * 1e3, flops / fl * 1e3
        return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")

    def tf32x3_bound(nbytes, flops):
        """At fp32 accuracy on the tensor cores each product is three TF32
        products: the bound is the larger of the bytes and 3 x flop at the
        dense TF32 rate (the FFMA term is reported beside).  Returns
        ((ms, bound_by), terms)."""
        terms = {"bytes": nbytes / bw * 1e3, "fp32_ffma": flops / fl * 1e3,
                 "tf32x3": 3 * flops / tf32 * 1e3}
        by = "bytes" if terms["bytes"] >= terms["tf32x3"] else "operations"
        return (max(terms["bytes"], terms["tf32x3"]), by), terms

    out = {}

    def measure(name, shape_desc, kernel, plain, library, nbytes, flops,
                launch, b=None):
        got, want = kernel(), plain()
        err = close(got, want)
        del got, want
        b_ms, b_by = b or bound(nbytes, flops)
        out[name] = dict(shapes=shape_desc, max_abs_err=err,
                         ms=time_ms(torch, kernel),
                         plain_ms=time_ms(torch, plain),
                         library_ms=time_ms(torch, library),
                         device_ms=device_ms(torch, kernel),
                         library_device_ms=device_ms(torch, library),
                         bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                         flops=flops, launch=launch)
        emit("kernel_full", name=name, **out[name])

    # s6_scan: the longest prefill, (B, T, Di, N) = (1, 8191, 8192, 16), as
    # the model hands it over: bf16 x, strided bf16 B/C, fp32 dt from the
    # dt_bias softplus, the model's a = -(1..N), the zeroed cached state.
    # Bound: the function's own (s6_bound), whatever route runs it.  The
    # plain version is a T-step loop: timed over 3 runs.
    s6 = s6_module()
    t, di, n = 8191, 8192, 16
    g6 = torch.Generator(device="cuda").manual_seed(6)
    x6, dt6, bm6, cm6, _, _ = s6_inputs(torch, g6, 1, t, di, n, torch.bfloat16,
                                        strided=True, model_dt=True)
    a6 = model_a(torch, di, n)
    h06 = torch.zeros((1, di, n), dtype=torch.float32, device="cuda")
    s6_args = (x6, dt6, bm6, cm6, a6, h06)
    (y6, hf6), (yr6, hr6) = s6_scan(*s6_args), ref.s6_scan_ref(*s6_args)
    err6 = max(close(y6, yr6), close(hf6, hr6))
    del y6, hf6, yr6, hr6
    terms, by, nbytes6, exps = s6_bound(1, t, di, n, 2, peaks)
    out["s6_scan"] = dict(
        shapes="x (1, 8191, 8192) bf16, dt fp32, B/C (1, 8191, 16) bf16 "
               "strided, a (8192, 16), h0 zeros",
        route=s6.route(1, t, di),
        dt_mean=float(dt6.mean()), dt_p99=float(dt6.flatten()[
            :: 97].quantile(0.99)),
        max_abs_err=err6, ms=time_ms(torch, lambda: s6_scan(*s6_args)),
        device_ms=device_ms(torch, lambda: s6_scan(*s6_args)),
        plain_ms=time_ms(torch, lambda: ref.s6_scan_ref(*s6_args), runs=3),
        library_ms=None, bound_ms=terms[by],
        bound_by="bytes" if by == "bytes" else "operations",
        bound_terms_ms=terms, bytes=nbytes6, exponentials=exps,
        rates={"hbm_bytes_per_s": bw, "sfu_exp_per_s": sfu,
               "fp32_flop_per_s": fl},
        launch={r: s6.launch_info(1, t, di, n, torch.bfloat16, r)
                for r in s6.ROUTES})
    emit("kernel_full", name="s6_scan", **out["s6_scan"])
    del x6, dt6, bm6, cm6, a6, h06, s6_args
    torch.cuda.empty_cache()
    out["s6_scan"]["by_shape"] = phase_s6_by_shape(torch, peaks)

    # ttt: the Boats mode-2 ALS TTT (B = 1, a 76,800-deep reduction)
    x, y = rnd(76800, 7000, 1), rnd(76800, 10, 1)
    measure("ttt", "x (76800, 7000, 1) fp32, y (76800, 10, 1) fp32",
            lambda: ttt3(x, y), lambda: ref.ttt_ref(x, y),
            lambda: torch.tensordot(x, y, dims=([0, 2], [0, 2])),
            4 * (x.numel() + y.numel() + 7000 * 10), 2.0 * 76800 * 7000 * 10,
            ttt_mod.launch_info(x, y))
    # matmul: the Boats mode-2 TTM, x2 (76800, 7000) @ u^T (7000, 10)
    a, b = x.view(76800, 7000), rnd(7000, 10)
    measure("matmul", "(76800, 7000) @ (7000, 10) fp32",
            lambda: matmul(a, b), lambda: ref.matmul_ref(a, b),
            lambda: torch.matmul(a, b),
            4 * (a.numel() + b.numel() + 76800 * 10), 2.0 * 76800 * 7000 * 10,
            matmul_mod.launch_info(a, b))
    del x, y, a, b
    torch.cuda.empty_cache()
    # gram: the HSI mode-1 EIG Gram; ttm_interior: the HSI mode-1 TTM.  The
    # Gram is symmetric: the function needs only its I(I+1)/2 distinct
    # entries, 2·A·B·I(I+1)/2 flop, priced by tf32x3_bound
    x = rnd(1021, 1340, 264)
    g_bytes, g_flops = 4 * (x.numel() + 1340 * 1340), 1.0 * 1021 * 264 * 1340 * 1341
    b, terms = tf32x3_bound(g_bytes, g_flops)
    measure("gram", "x (1021, 1340, 264) fp32 -> (1340, 1340)",
            lambda: ttt3(x, x), lambda: ref.gram_ref(x),
            lambda: torch.tensordot(x, x, dims=([0, 2], [0, 2])),
            g_bytes, g_flops, ttt_mod.launch_info(x, x), b=b)
    out["gram"].update(route=ttt_mod.call_route(x, x), bound_terms_ms=terms,
                       max_entry_err=entry_err(torch, ttt3(x, x), x, x),
                       plain_max_entry_err=entry_err(torch, ref.gram_ref(x), x, x,
                                                     check=False),
                       entry_tol=ENTRY_TOL)
    emit("kernel_full", name="gram", route=out["gram"]["route"],
         bound_terms_ms=terms, max_entry_err=out["gram"]["max_entry_err"],
         plain_max_entry_err=out["gram"]["plain_max_entry_err"])
    # ttt_sketch: the range sample of the adaptive path's widest sketch, the
    # HSI mode-1 TTT with y ≠ x at R = 64 on the tensor-core route, its
    # 2·A·B·I·R flop priced by tf32x3_bound.  The 128-wide output tile is
    # half empty at R = 64 (reported as tile_fill).
    ys = rnd(1021, 64, 264)
    require(ttt_mod.call_route(x, ys) == "wgmma_tma",
            f"ttt_sketch: took {ttt_mod.call_route(x, ys)}, not wgmma_tma")
    s_bytes = 4 * (x.numel() + ys.numel() + 1340 * 64)
    s_flops = 2.0 * 1021 * 264 * 1340 * 64
    b, terms = tf32x3_bound(s_bytes, s_flops)
    measure("ttt_sketch", "x (1021, 1340, 264) fp32, y (1021, 64, 264) fp32 "
            "-> (1340, 64)", lambda: ttt3(x, ys), lambda: ref.ttt_ref(x, ys),
            lambda: torch.tensordot(x, ys, dims=([0, 2], [0, 2])),
            s_bytes, s_flops, ttt_mod.launch_info(x, ys), b=b)
    out["ttt_sketch"].update(
        route=ttt_mod.call_route(x, ys), bound_terms_ms=terms,
        max_entry_err=entry_err(torch, ttt3(x, ys), x, ys),
        plain_max_entry_err=entry_err(torch, ref.ttt_ref(x, ys), x, ys,
                                      check=False),
        entry_tol=ENTRY_TOL, tiles=math.ceil(1340 / 128), tile_fill=64 / 128)
    emit("kernel_full", name="ttt_sketch", route=out["ttt_sketch"]["route"],
         bound_terms_ms=terms,
         max_entry_err=out["ttt_sketch"]["max_entry_err"],
         plain_max_entry_err=out["ttt_sketch"]["plain_max_entry_err"],
         tile_fill=64 / 128)
    del ys
    u = rnd(10, 1340)
    measure("ttm_interior", "u (10, 1340), x (1021, 1340, 264) fp32",
            lambda: ttm_interior(u, x), lambda: ref.ttm_interior_ref(u, x),
            lambda: torch.matmul(u, x),
            4 * (x.numel() + u.numel() + 1021 * 10 * 264),
            2.0 * 1021 * 264 * 1340 * 10, ttm_mod.launch_info(u, x))
    # the sketch's projection at ℓ = 64: the TTM runs its 16-row slabs, each
    # reading x again (4 here).  Its 2·A·B·I·ℓ flop priced as the TTT's
    # (tf32x3_bound): the card could do them at fp32 accuracy that way.
    u = rnd(64, 1340)
    t_bytes, t_flops = 4 * (x.numel() + u.numel() + 1021 * 64 * 264), \
        2.0 * 1021 * 264 * 1340 * 64
    b, terms = tf32x3_bound(t_bytes, t_flops)
    measure("ttm_interior_l64", "u (64, 1340), x (1021, 1340, 264) fp32",
            lambda: ttm_interior(u, x), lambda: ref.ttm_interior_ref(u, x),
            lambda: torch.matmul(u, x), t_bytes, t_flops,
            ttm_mod.launch_info(u, x), b=b)
    out["ttm_interior_l64"]["bound_terms_ms"] = terms
    emit("kernel_full", name="ttm_interior_l64", bound_terms_ms=terms)
    del u
    phase_matmul_wide_full(torch, x.view(1021, -1), rnd, tf32x3_bound,
                           measure, out)
    del x
    torch.cuda.empty_cache()
    return out


def phase_matmul_wide_full(torch, xw, rnd, tf32x3_bound, measure, out):
    """Row 2b: the boundary GEMM's wide route at adapt_wide's mode 0, u (R,
    1021) @ x (1021, 353,760) fp32 at R = 64 (the sketch's projection) and R
    = 40 (the refinement), beside the slab route it replaced (16-row slabs,
    each reading x: run as R <= 16 calls on the same u and x, which take
    that route) and torch.matmul:
    ms and device ms of each, the plain version, the tf32x3_bound terms,
    per-entry errors (kernel, slab, plain fp32) in units of sqrt((u∘u) @
    (x∘x)), achieved bytes/s by device time, and each route's launch
    figures.  bf16 operands of the same shape are held per entry too."""
    from repro_torch.kernels import matmul, ref
    mm = matmul_module()
    k, n = xw.shape
    for r in (64, 40):
        u = rnd(r, k)
        require(mm.route(r, n) == "wide", f"matmul R = {r}: not the wide route")
        nbytes = 4 * (xw.numel() + u.numel() + r * n)
        flops = 2.0 * r * k * n
        b, terms = tf32x3_bound(nbytes, flops)
        name = f"matmul_wide_r{r}"
        measure(name, f"u ({r}, {k}) @ x ({k}, {n}) fp32",
                lambda: matmul(u, xw), lambda: ref.matmul_ref(u, xw),
                lambda: torch.matmul(u, xw), nbytes, flops,
                mm.launch_info(u, xw), b=b)
        row = out[name]

        def slab():
            return [matmul(u[i:i + 16], xw) for i in range(0, r, 16)]
        row.update(
            route="wide", bound_terms_ms=terms,
            max_entry_err=gemm_entry_err(torch, matmul(u, xw), u, xw),
            plain_max_entry_err=gemm_entry_err(
                torch, ref.matmul_ref(u, xw), u, xw, check=False),
            slab_max_entry_err=gemm_entry_err(torch, torch.cat(slab()), u,
                                              xw, check=False),
            entry_tol=ENTRY_TOL,
            slab_ms=time_ms(torch, slab), slab_device_ms=device_ms(torch, slab),
            slab_launch=mm.launch_info(u[:16], xw),
            bytes_per_s=nbytes / (row["device_ms"] * 1e-3),
            slab_bytes_per_s=None)
        row["slab_bytes_per_s"] = nbytes / (row["slab_device_ms"] * 1e-3)
        if r == 64:
            ub, xb = u.bfloat16(), xw.bfloat16()
            row["bf16_max_entry_err"] = gemm_entry_err(torch, matmul(ub, xb),
                                                       ub, xb)
            del ub, xb
        emit("kernel_full", name=name, **{key: row[key] for key in (
            "route", "bound_terms_ms", "max_entry_err", "plain_max_entry_err",
            "slab_max_entry_err", "slab_ms", "slab_device_ms", "slab_launch",
            "bytes_per_s", "slab_bytes_per_s") if key in row},
            bf16_max_entry_err=row.get("bf16_max_entry_err"))
        del u
        torch.cuda.empty_cache()


def s6_bound(bsz, t, di, n, xbytes, peaks):
    """The selective scan's own bound at (bsz, t, di, n): the larger of its
    bytes (x, dt, B, C, a, h0 read once; y, h_final written once; B and C
    bf16 when x is) over HBM, its T·Di·N exponentials over the SFU rate and
    its 6·T·Di·N other fp32 operations over the FP32 rate.  Returns (terms
    in ms, the name of the largest, bytes, exponentials)."""
    bw, fl, _, sfu = peaks
    nbytes = (bsz * t * di * (xbytes + 4 + 4) + 2 * bsz * t * n * xbytes
              + di * n * 4 + 2 * bsz * di * n * 4)
    exps = bsz * t * di * n
    terms = {"bytes": nbytes / bw * 1e3, "exponentials": exps / sfu * 1e3,
             "fp32 operations": 6.0 * exps / fl * 1e3}
    return terms, max(terms, key=terms.get), nbytes, exps


def device_ms(torch, fn, runs: int = 5) -> float:
    """Device time of one call of ``fn``: the CUDA kernels' durations summed
    under torch.profiler over ``runs`` warm calls, divided by ``runs``.
    Unlike CUDA events around a call, it leaves out the host's time, which
    at small shapes is longer than the kernels'."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / runs / 1e3


def phase_s6_by_shape(torch, peaks):
    """S6 at each shape the serve run gives it -- batch-1 prefills of the
    six prompt lengths and the 4-slot decode step -- on the route the
    wrapper picks, and on both routes ("single" is the one-pass kernel of
    PR 12), each beside the function's own bound: CUDA events around a
    call (ms) and the kernels' own time (device_ms); then the route sweep
    that places the chunked route's threshold at (1, T, 8192, 16)."""
    from repro_torch.kernels import s6_scan
    s6 = s6_module()
    g = torch.Generator(device="cuda").manual_seed(8)
    di, n = 8192, 16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = [(1, t) for t in PROMPTS] + [(4, 1)]
    rows = []
    for bsz, t in shapes:
        x, dt, bm, cm, _, h0 = s6_inputs(torch, g, bsz, t, di, n,
                                         torch.bfloat16, strided=True,
                                         h0=True, model_dt=True)
        a = model_a(torch, di, n)
        terms, by, _, _ = s6_bound(bsz, t, di, n, 2, peaks)
        ms, dev = {}, {}
        for r in s6.ROUTES:
            def call(r=r):
                return s6_scan(x, dt, bm, cm, a, h0, force_route=r)
            ms[r], dev[r] = time_ms(torch, call, runs=21), device_ms(torch, call)
        route = s6.route(bsz, t, di)
        rows.append(dict(shape=[bsz, t, di, n], route=route, ms=ms[route],
                         ms_by_route=ms, device_ms_by_route=dev,
                         chunk_len=s6.chunk_len(bsz, t, di, sms),
                         bound_ms=terms[by], bound_by=by,
                         launch=s6.launch_info(bsz, t, di, n, torch.bfloat16)))
        emit("s6_by_shape", **rows[-1])
        del x, dt, bm, cm, a, h0
    sweep = []
    for t in (32, 64, 96, 128, 160, 192, 256, 384, 512):
        x, dt, bm, cm, _, h0 = s6_inputs(torch, g, 1, t, di, n, torch.bfloat16,
                                         strided=True, h0=True, model_dt=True)
        a = model_a(torch, di, n)
        row = dict(t=t, work=t * di)
        for r in s6.ROUTES:
            def call(r=r):
                return s6_scan(x, dt, bm, cm, a, h0, force_route=r)
            row[r], row[r + "_device"] = (time_ms(torch, call, runs=21),
                                          device_ms(torch, call))
        sweep.append(row)
    emit("s6_route_sweep", shape="(1, T, 8192, 16) bf16", rows=sweep,
         chunked_min_work=s6.CHUNKED_MIN_WORK)
    torch.cuda.empty_cache()
    return rows


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


def profile_call(torch, fn, wall_ms: float) -> dict:
    """One call of ``fn`` under torch.profiler: device busy time (kernels,
    copies and sets, summed over device events — one stream, so they do not
    overlap), the idle share of the unprofiled wall time, the host's
    kernel-launch calls, and the device time of the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
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
                top_device_ms=[[name[:80], us / 1e3] for name, us in top],
                ttt_wide_device_ms=sum(us for name, us in by_name.items()
                                       if "ttt_wide_kernel" in name) / 1e3,
                gemm_first_mode_device_ms=gemm_by_route(by_name))


def gemm_by_route(by_name: dict) -> dict:
    """Device ms of the first-mode boundary GEMM by route, from profiler
    kernel names: ``wide`` (gemm_wide_kernel and the kernel that splits u)
    and ``slab`` (contract_kernel's 16 x 128 tile; its 128 x 16 tile is the
    last mode's and the TTT's)."""
    out = {"wide": 0.0, "slab": 0.0}
    for name, us in by_name.items():
        if "gemm_wide_kernel" in name or "gemm_image_kernel" in name:
            out["wide"] += us / 1e3
        elif "contract_kernel" in name and ", 16, 128, " in name:
            out["slab"] += us / 1e3
    return out


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
    launched["matmul_routes"] = {}
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
        for rt, v in kernels.matmul_route_counts().items():
            launched["matmul_routes"][rt] = launched["matmul_routes"].get(rt, 0) + v
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
                   profile=profile_call(torch, lambda: p.execute(x), wall))
        if name == "hsi_eig":   # its 1340^2 Gram runs on the tensor cores
            require(row["profile"]["ttt_wide_device_ms"] > 0,
                    "hsi_eig: the Gram never ran on the wgmma route")
        emit("main", **row)
        results.append(row)
        del res, ref_res
        picks_vs_textbook(torch, name, p, x)
    for k in ("ttt", "matmul", "ttm_interior"):
        require(launched[k] > 0, f"kernel {k} never launched on the main path")
    # the graphs phase reuses the last input (hsi) and the rows' peaks
    return launched, data, {r["case"]: r for r in results}


def picks_vs_textbook(torch, name, p, x) -> dict:
    """Each mode's solver as the shipped model picks it (plan ``p``) and as
    the textbook cost model picks it (the fallback without a trained
    model); where they differ, both plans' captured executes timed in turns
    on ``x`` (shipped, textbook, textbook, shipped: 3 warm runs each) and
    the textbook plan's rel_error held to 0.02 too."""
    from repro_torch.core import Selector, default_selector, plan
    pt = plan(p.shape, p.dtype, p.config,
              selector=Selector(platform="cuda", backend=p.backend))
    sel = default_selector("cuda", p.backend)
    row = dict(case=name, shipped=list(p.methods), textbook=list(pt.methods),
               selector=dict(tree=sel.tree is not None, backend=sel.backend,
                             cost_model=sel.cost_model.source,
                             store_digest=sel.meta.get("store_digest")))
    if pt.methods != p.methods:
        ms, mt = [], []
        for q, out in ((p, ms), (pt, mt), (pt, mt), (p, ms)):
            q.execute(x)
            out.extend(synced_ms(torch, lambda: q.execute(x),
                                 1 if out else 2))
        rel_t = float(pt.execute(x).tucker.rel_error(x))
        row.update(execute_ms_shipped=statistics.median(ms),
                   execute_ms_shipped_all=ms,
                   execute_ms_textbook=statistics.median(mt),
                   execute_ms_textbook_all=mt, rel_error_textbook=rel_t)
        require(math.isfinite(rel_t) and rel_t <= 0.02,
                f"{name}: the textbook plan's rel_error {rel_t} > 0.02")
    emit("main_picks", **row)
    return row


# ---------------------------------------------------------------------------
# phase 4b: the cached sweep captured into CUDA graphs, against the eager
# sweep; the obs trace and a chaos hop on the card
# ---------------------------------------------------------------------------

#: warm runs a case, eager and captured each
GRAPH_RUNS = 3
#: host calls that put work on the device, as the profiler names them (a
#: graph replay is one)
ENQUEUES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
            "cudaMemcpyAsync", "cudaMemsetAsync", "cudaLaunchCooperative")


def profile_enqueues(torch, fn, wall_ms: float) -> dict:
    """One call of ``fn`` under torch.profiler: device busy ms (summed
    device events, one stream), the idle share of the unprofiled wall time,
    the host calls that enqueue device work by name (a graph replay counts
    once), and the device events seen."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy, n_dev, calls = 0.0, 0, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy += e.time_range.elapsed_us()
            n_dev += 1
        elif e.name.startswith(ENQUEUES):
            calls[e.name] = calls.get(e.name, 0) + 1
    return dict(device_busy_ms=busy / 1e3, device_events=n_dev,
                idle_share=max(0.0, 1.0 - busy / 1e3 / wall_ms),
                host_launches=sum(calls.values()), host_calls=calls)


def sync_points(torch, fn) -> dict:
    """The calls of ``fn`` that synchronize the host with the card, by
    source line, from ``torch.cuda.set_sync_debug_mode("warn")``."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    out = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{Path(w.filename).name}:{w.lineno}"
            out[key] = out.get(key, 0) + 1
    return out


def all_launches(kernels) -> dict:
    counts = kernels.launch_counts()
    counts["ttt_routes"] = kernels.ttt_route_counts()
    counts["matmul_routes"] = kernels.matmul_route_counts()
    return counts


def synced_ms(torch, fn, runs: int = GRAPH_RUNS) -> list[float]:
    """Host-clock ms of ``runs`` synchronized calls of ``fn``."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def same_tucker(torch, a, b) -> bool:
    return torch.equal(a.core, b.core) and all(
        torch.equal(u, v) for u, v in zip(a.factors, b.factors))


def graph_case(torch, name, shape, ranks, methods, impl, x) -> dict:
    """One uncapped plan, eager sweep (``TuckerPlan._run``) against the
    captured one (``execute``): the eager sweep's sync points, 5 executes
    from a clear cache (builds 1, hits 4, one trace a segment), the
    captured result bitwise equal to the eager one, the same kernel
    launches (and routes) on one replay as on one eager sweep, eager and
    captured ms, device busy ms, idle share and host launches."""
    from repro_torch import kernels
    from repro_torch.core import CACHE_STATS, TuckerConfig, clear_sweep_cache
    from repro_torch.core import plan
    clear_sweep_cache()
    p = plan(shape, "float32", TuckerConfig(
        ranks=ranks, methods=methods, mode_order="shrink", impl=impl))
    require(p.captures, f"{name}: an uncapped plan on the card must capture")
    eager_run = lambda: p._run(x, False)   # noqa: E731 - the eager sweep
    syncs = sync_points(torch, eager_run)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    eager = eager_run().tucker
    torch.cuda.synchronize()
    eager_counts = all_launches(kernels)
    eager_peak = torch.cuda.max_memory_allocated()
    reserved0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    first = p.execute(x).tucker
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    for _ in range(4):
        got = p.execute(x).tucker
    stats = dict(CACHE_STATS)
    segments = p.graph_segments
    require(stats == {"builds": 1, "hits": 4, "traces": segments},
            f"{name}: CACHE_STATS after 5 executes {stats}, want builds 1, "
            f"hits 4, traces {segments}")
    kernels.reset_launch_counts()
    got = p.execute(x).tucker
    torch.cuda.synchronize()
    replay_counts = all_launches(kernels)
    require(replay_counts == eager_counts,
            f"{name}: launches on a replay {replay_counts} != eager "
            f"{eager_counts}")
    bitwise = same_tucker(torch, got, eager) and same_tucker(torch, first,
                                                             eager)
    require(bitwise, f"{name}: the captured sweep is not bitwise the eager "
            "one: max |core diff| "
            f"{float((got.core - eager.core).abs().max())}")
    gstats = p.graph_stats()
    require(gstats["segments"] == segments,
            f"{name}: {gstats['segments']} graphs captured, the plan names "
            f"{segments}")
    # in turns (eager, captured, captured, eager), each turn after one
    # untimed call: 3 timed runs of each
    eager_ms, graph_ms = [], []
    for fn, out in ((eager_run, eager_ms), (lambda: p.execute(x), graph_ms),
                    (lambda: p.execute(x), graph_ms), (eager_run, eager_ms)):
        fn()
        out.extend(synced_ms(torch, fn, 1 if out else 2))
    med_e, med_g = statistics.median(eager_ms), statistics.median(graph_ms)
    row = dict(case=name, impl=p.backend, methods=list(p.methods),
               segments=segments, host_ops=gstats["host_ops"],
               describe=p.describe().splitlines()[2:],
               sync_points_eager=syncs, cache_stats=stats,
               bitwise_equal=bitwise, launches=replay_counts,
               execute_ms_eager=med_e, execute_ms_eager_all=eager_ms,
               execute_ms_captured=med_g, execute_ms_captured_all=graph_ms,
               first_execute_ms=build_ms,
               pool_bytes=gstats["pool_bytes"],
               static_input_bytes=gstats["input_bytes"],
               reserved_growth_bytes=torch.cuda.memory_reserved() - reserved0,
               eager_peak_beyond_input=eager_peak - base,
               eager_peak_bytes=eager_peak,
               profile_eager=profile_enqueues(torch, eager_run, med_e),
               profile_captured=profile_enqueues(
                   torch, lambda: p.execute(x), med_g))
    emit("graphs", **row)
    del eager, first, got
    return row


def graphs_obs_check(torch, x, eager_peak: int, main_peak: int) -> dict:
    """hsi planned and executed inside one obs.capture() and one
    MemoryWatch, from a clear cache: the Chrome trace under chiprun_out/
    holds the plan, execute, cache, capture and compile events, and the
    watch's high-water mark is at least the eager sweep's peak."""
    from repro_torch import obs
    from repro_torch.core import TuckerConfig, clear_sweep_cache, plan
    from repro_torch.obs.drift import MemoryWatch
    clear_sweep_cache()
    shape, ranks = HSI
    with MemoryWatch() as mw, obs.capture() as buf:
        p = plan(shape, "float32", TuckerConfig(
            ranks=ranks, mode_order="shrink", impl="auto"))
        p.execute(x)
    out = ROOT / "chiprun_out" / "graphs_hsi_trace.json"
    out.parent.mkdir(exist_ok=True)
    doc = obs.write_chrome(buf.events(), out)
    events = buf.events()
    spans = {e["name"] for e in obs.iter_spans(events)}
    kinds = {e["kind"] for e in events}
    require({"plan", "execute", "capture", "compile"} <= spans
            and "cache" in kinds,
            f"obs: the trace holds spans {sorted(spans)}, kinds "
            f"{sorted(kinds)}")
    n_capture = sum(e.get("name") == "capture" for e in events)
    require(n_capture == p.graph_segments,
            f"obs: {n_capture} capture spans for {p.graph_segments} graphs")
    require(mw.high_water >= eager_peak,
            f"obs: MemoryWatch high water {mw.high_water} < the eager "
            f"sweep's peak {eager_peak}")
    row = dict(check="obs", trace=str(out.relative_to(ROOT)),
               trace_events=len(doc["traceEvents"]), spans=sorted(spans),
               kinds=sorted(kinds), capture_spans=n_capture,
               memory_high_water=mw.high_water,
               eager_sweep_peak=eager_peak, main_phase_peak=main_peak)
    emit("graphs", **row)
    return row


def graphs_chaos_check(torch, x) -> dict:
    """A sweep_out poison on boats (its auto plan, or the all-ALS plan when
    that has no ALS step): validate="finite" turns it into a NumericalError,
    the ladder takes the als_to_eig hop on hopper (every ALS step becomes
    EIG), and the registry counts it."""
    from repro_torch import chaos
    from repro_torch.core import (TuckerConfig, fallback_hops, plan,
                                  reset_fallback_hops)
    from repro_torch.core.api import HOPS_METRIC
    from repro_torch.obs import REGISTRY
    shape, ranks = BOATS
    p = plan(shape, "float32", TuckerConfig(ranks=ranks, mode_order="shrink",
                                            impl="auto"))
    if "als" not in p.methods:   # the rung needs an ALS step to replace
        p = plan(shape, "float32", TuckerConfig(
            ranks=ranks, methods="als", mode_order="shrink", impl="auto"))
    want = tuple("eig" if m == "als" else m for m in p.methods)
    reset_fallback_hops()
    chaos.install([chaos.Rule(seam="sweep_out", action="nan", at=0,
                              times=1)])
    try:
        res = p.execute(x, validate="finite")
    finally:
        fired = chaos.fired()
        chaos.reset()
    torch.cuda.synchronize()
    hops = fallback_hops()
    counted = REGISTRY.counter(HOPS_METRIC).value(hop="als_to_eig",
                                                  backend="hopper")
    rel = float(res.tucker.rel_error(x))
    row = dict(check="chaos", plan_methods=list(p.methods),
               result_methods=list(res.methods), fired=fired,
               hops={f"{h}/{b}": n for (h, b), n in hops.items()},
               registry_count=counted, rel_error=rel)
    emit("graphs", **row)
    require(hops == {("als_to_eig", "hopper"): 1} and counted == 1,
            f"chaos: hops {hops}, registry {counted}")
    require(res.methods == want and math.isfinite(rel)
            and rel <= 0.02, f"chaos: methods {res.methods} (want {want}), "
            f"rel {rel}")
    reset_fallback_hops()
    return row


def phase_graphs(torch, data, main_rows):
    """The cached sweep captured into CUDA graphs, on main's inputs (hsi's
    kept, boats' made again from the same seed): boats, hsi and hsi_eig on
    hopper and boats on matfree (graph_case); then the obs trace and the
    chaos hop."""
    from repro_torch.core import clear_sweep_cache
    x_hsi = data[HSI[0]]
    gen = torch.Generator(device="cuda").manual_seed(0)
    x_boats = lowrank(torch, *BOATS, gen)       # main's first draw
    rows = [graph_case(torch, "boats", *BOATS, "auto", "auto", x_boats),
            graph_case(torch, "hsi", *HSI, "auto", "auto", x_hsi),
            graph_case(torch, "hsi_eig", *HSI, "eig", "auto", x_hsi),
            graph_case(torch, "boats_matfree", *BOATS,
                       main_rows["boats"]["methods"], "matfree", x_boats)]
    for r in rows[:3]:
        require(r["impl"] == "hopper", f"{r['case']}: backend {r['impl']}")
    graphs_obs_check(torch, x_hsi, rows[1]["eager_peak_bytes"],
                     main_rows["hsi"]["peak_bytes"])
    graphs_chaos_check(torch, x_boats)
    clear_sweep_cache()
    del x_boats
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 5: the adaptive path -- error targets, the fallback ladder's
# rand->eig hop, and the schedule search under a memory cap, at full size
# ---------------------------------------------------------------------------

def execute_ms(torch, p, x, runs: int = 3) -> list[float]:
    """Host-clock ms of ``runs`` synchronized executes after one warm-up."""
    p.execute(x)
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p.execute(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


class SketchProbe:
    """Wraps ``solvers.rand_sketch`` (the sketch pass looks it up per call)
    to record, for each mode, the widths it ran and, at its last width, the
    eigenvalues of the kernel's fp32 Gram of b beside those of a float64
    Gram of the same b, and ||y||² in fp32 (as the pass computes it) and in
    float64.  Used on an execute that is not timed."""

    def __init__(self, torch):
        self.torch, self.log = torch, {}

    def __enter__(self):
        from repro_torch.core import solvers
        self.solvers, self.orig = solvers, solvers.rand_sketch
        solvers.rand_sketch = self.probed
        return self

    def __exit__(self, *exc):
        self.solvers.rand_sketch = self.orig

    def probed(self, y, mode, width, **kw):
        torch = self.torch
        out = self.orig(y, mode, width, **kw)
        q, b, evals, vecs, energy = out
        b3 = b.double().reshape(math.prod(b.shape[:mode]), width, -1)
        rec = self.log.setdefault(mode, {"widths": []})
        rec["widths"].append(width)
        rec.update(
            evals=evals.double().cpu(), energy=float(energy),
            evals64=torch.linalg.eigvalsh(
                torch.einsum("aib,ajb->ij", b3, b3)).cpu(),
            energy64=float(torch.linalg.vector_norm(y.double()) ** 2),
            y=y, q=q, b=b, vecs=vecs)
        del b3
        return out

    def exact_tails(self, mode, r):
        """In float64, for the rank-r factor the pass builds at ``mode``'s
        last width, u = q·V_r (V from the kernel's Gram): the discarded
        energy ||y - u uᵀ y||² itself, and E - Σ_{i<r} ||(V_rᵀ b)_i||² (the
        pass's formula, exactly), with max|uᵀu - I|."""
        from repro_torch.core import tensor_ops as T
        torch = self.torch
        rec = self.log[mode]
        v = rec["vecs"].double().flip(1)[:, :r]
        u = rec["q"].double() @ v
        y64 = rec["y"].double()
        resid = y64 - T.ttm(T.ttm(y64, u.T, mode), u, mode)
        true = float(torch.linalg.vector_norm(resid) ** 2)
        del resid, y64
        z = T.ttm(rec["b"].double(), v.T, mode)
        cap = float(torch.linalg.vector_norm(z) ** 2)
        ortho = float((u.T @ u - torch.eye(r, dtype=u.dtype,
                                           device=u.device)).abs().max())
        return true, rec["energy64"] - cap, ortho

    def gram_entry_err(self, mode):
        """The kernel's Gram of ``mode``'s last b, per entry against the
        float64 einsum, in units of sqrt(gram(b∘b)) (:func:`entry_err`)."""
        from repro_torch.core.backend import backend_ops
        b = self.log[mode]["b"]
        b3 = b.reshape(math.prod(b.shape[:mode]), b.shape[mode], -1)
        got = backend_ops("hopper")[1](b, mode)
        return entry_err(self.torch, got, b3, b3, check=False)

    def tails(self, ranks, first_mode, pass_tails):
        """Per mode: its widths and the discarded energy at its chosen rank
        as a fraction of the step-0 energy: the pass's own figure (summed
        from the rotated sketch core), the true one and the pass's formula
        in float64 (:meth:`exact_tails`), and energy minus the top-r
        eigenvalues of the kernel's fp32 Gram (the reference's formula) and
        of a float64 Gram of the same b; plus the step-0 energy as the pass
        sums it and in float64."""
        t32 = self.log[first_mode]["energy"]
        t64 = self.log[first_mode]["energy64"]
        out = {}
        for mode, rec in sorted(self.log.items()):
            r = ranks[mode]
            true, formula, ortho = self.exact_tails(mode, r)
            out[mode] = dict(
                widths=rec["widths"], rank=r, tail_pass=pass_tails[mode],
                tail_true_float64=true / t64,
                tail_pass_formula_float64=formula / t64,
                factor_orthonormality=ortho,
                gram_entry_err=self.gram_entry_err(mode),
                tail_kernel_gram=(rec["energy"] - float(
                    rec["evals"].flip(0)[:r].sum())) / t32,
                tail_float64_gram=(rec["energy64"] - float(
                    rec["evals64"].flip(0)[:r].sum())) / t64)
        self.log.clear()
        return dict(energy_fp32=t32, energy_float64=t64,
                    energy_rel_diff=(t32 - t64) / t64, modes=out)


def adaptive_case(torch, name, x, cfg_kw, want_ranks, launched,
                  same_subspace=True):
    """One error-targeted case on ``hopper`` (impl="auto") and ``matfree``:
    the launch counts are zeroed just before the measured execute and read
    just after.  Emits the row, then checks the ranks on both backends
    (against ``want_ranks`` unless it is None) and the projectors against matfree (``same_subspace``; a rank beyond the
    input's own takes noise directions that rounding may pick either way,
    so there the two rel_errors are held within 1e-4 instead)."""
    from repro_torch import kernels
    from repro_torch.core import (TuckerConfig, fallback_hops, plan,
                                  reset_fallback_hops)
    p = plan(x.shape, "float32", TuckerConfig(impl="auto", **cfg_kw))
    require(p.backend == "hopper",
            f"{name}: impl='auto' resolved to {p.backend!r}, not 'hopper'")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    reset_fallback_hops()
    res = p.execute(x)
    torch.cuda.synchronize()
    counts, routes = kernels.launch_counts(), kernels.ttt_route_counts()
    mroutes = kernels.matmul_route_counts()
    hops = {f"{h}/{b}": n for (h, b), n in fallback_hops().items()}
    peak = torch.cuda.max_memory_allocated()
    for k, v in counts.items():
        launched[k] += v
    # matfree refines with the solvers hopper's refinement picked (each
    # backend's model picks for itself)
    kw_m = dict(cfg_kw)
    if cfg_kw.get("methods") != "rand":
        kw_m["methods"] = res.methods
    pm = plan(x.shape, "float32", TuckerConfig(impl="matfree", **kw_m))
    res_m = pm.execute(x)
    gaps = [projector_gap(torch, a, b) for a, b in
            zip(res.tucker.factors, res_m.tucker.factors)]
    with SketchProbe(torch) as probe:
        p.execute(x)
    times, times_m = execute_ms(torch, p, x), execute_ms(torch, pm, x)
    wall = statistics.median(times)
    row = dict(case=name, shape=list(x.shape), config=cfg_kw,
               ranks=list(res.tucker.ranks),
               rel_error=float(res.tucker.rel_error(x)),
               error_bound=res.error_bound,
               ranks_matfree=list(res_m.tucker.ranks),
               rel_error_matfree=float(res_m.tucker.rel_error(x)),
               error_bound_matfree=res_m.error_bound,
               max_projector_gap=max(gaps),
               trace=[dict(mode=t.mode, method=t.method, backend=t.backend,
                           r_n=t.r_n, j_n=t.j_n, tail_err=t.tail_err)
                      for t in res.trace],
               select_overhead_s=res.select_overhead_s,
               sketch=probe.tails(res.tucker.ranks, p.schedule[0].mode,
                                  {t.mode: t.tail_err for t in res.trace}),
               hops=hops, launches=counts, ttt_routes=routes,
               matmul_routes=mroutes,
               execute_ms=wall, execute_ms_all=times,
               execute_ms_matfree=statistics.median(times_m),
               execute_ms_matfree_all=times_m, peak_bytes=peak,
               profile=profile_call(torch, lambda: p.execute(x), wall),
               profile_matfree=profile_call(torch, lambda: pm.execute(x),
                                            statistics.median(times_m)))
    emit("adaptive", **row)
    require(res.tucker.ranks == res_m.tucker.ranks and
            want_ranks in (None, res.tucker.ranks),
            f"{name}: ranks {res.tucker.ranks} (matfree "
            f"{res_m.tucker.ranks}), want {want_ranks}")
    require(all(t.backend == "hopper" for t in res.trace),
            f"{name}: a step ran off hopper")
    if same_subspace:
        require(max(gaps) <= 1e-3,
                f"{name}: projector gap {max(gaps)} > 1e-3")
    else:
        require(abs(row["rel_error"] - row["rel_error_matfree"]) <= 1e-4,
                f"{name}: |rel_error - matfree| > 1e-4")
    return row


def least_cap(plan_capped) -> int:
    """The least ``memory_cap_bytes`` ``plan_capped(cap)`` admits
    (bisection; the search is pure Python and takes microseconds)."""
    from repro_torch.core import MemoryCapError
    lo, hi = 1, 1 << 40
    while hi - lo > 1:
        mid = (lo + hi) // 2
        try:
            plan_capped(mid)
            hi = mid
        except MemoryCapError:
            lo = mid
    return hi


def capped_steps(torch, name, p, x, cap):
    """Run plan ``p``'s steps one by one through ``solve_step`` on ``x`` and
    hold its memory to ``cap`` with the input beside every step (the port
    never frees it): the input plus the memory allocated beyond it at every
    step boundary and inside every step fits the cap, and inside every step
    fits that step's own modeled peak (a ``hopper`` step models the input
    it holds).  Returns (the core, the factors by mode, the boundary and
    in-step figures beyond the input, the launch counts)."""
    from repro_torch import kernels
    from repro_torch.core.plan import solve_step
    require(not p.captures, f"{name}: a capped plan must run its sweep "
            "eagerly (no CUDA graph pool beside its steps)")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    y, factors, boundary, inside = x, {}, [], []
    for step in p.schedule:
        torch.cuda.reset_peak_memory_stats()
        res = solve_step(y, step, als_iters=p.config.als_iters)
        torch.cuda.synchronize()
        inside.append(torch.cuda.max_memory_allocated() - base)
        factors[step.mode], y = res.u, res.y_new
        del res
        boundary.append(torch.cuda.memory_allocated() - base)
    x_bytes = x.numel() * x.element_size()
    require(x_bytes + max(boundary) <= cap and x_bytes + max(inside) <= cap,
            f"{name}: the input's {x_bytes} bytes and {max(boundary)} beyond "
            f"it at a step boundary or {max(inside)} inside a step exceed "
            f"the cap {cap} (steps over: "
            f"{[k for k, b in enumerate(inside) if x_bytes + b > cap]})")
    over = [k for k, (s, b) in enumerate(zip(p.schedule, inside))
            if x_bytes + b > s.peak_bytes]
    require(not over, f"{name}: steps {over} allocated more than their "
            f"modeled peaks {[s.peak_bytes for s in p.schedule]} (input "
            f"plus in-step: {[x_bytes + b for b in inside]})")
    counts = kernels.launch_counts()
    counts["matmul_routes"] = kernels.matmul_route_counts()
    return y, factors, boundary, inside, counts


def opt_cap_eig_case(torch, x, launched):
    """Boats with ``methods="eig"`` under ``mode_order="opt"`` at the least
    cap the search admits on hopper: each EIG step models the TTT's split-K
    workspace (9,011,200 B for mode 0's Gram on 132 SMs), ``eigh``'s
    cuSOLVER workspace (about 4 I² beside the eigenvectors) and, after the
    first step, the held input.  Held step by step as opt_cap is; the
    matfree plan's least cap (the reference's figure) is reported beside.
    Then ``eigh``'s own allocation at each Gram size the plans run is held
    to its model (``repro_torch.core.plan._eigh_bytes``)."""
    from repro_torch.core import TuckerConfig, plan
    from repro_torch.core import tensor_ops as T
    from repro_torch.core.plan import _eigh_bytes
    shape, ranks = BOATS

    def capped(c, impl="auto"):
        return plan(shape, "float32", TuckerConfig(
            ranks=ranks, methods="eig", mode_order="opt",
            memory_cap_bytes=c, impl=impl))
    cap = least_cap(capped)
    cap_matfree = least_cap(lambda c: capped(c, "matfree"))
    p = capped(cap)
    require(p.backend == "hopper",
            f"opt_cap_eig: impl='auto' resolved to {p.backend!r}")
    y, factors, boundary, inside, counts = capped_steps(
        torch, "opt_cap_eig", p, x, cap)
    mroutes = counts.pop("matmul_routes")
    for k, v in counts.items():
        launched[k] += v
    x_bytes = x.numel() * x.element_size()
    rel = float(T.rel_error(x, y, [factors[m] for m in range(len(shape))]))
    del y, factors
    eigh = []
    for n in sorted({*shape, *HSI[0]}):
        g = torch.randn((n, n), device="cuda")
        g = g @ g.T
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = torch.linalg.eigh(g)
        torch.cuda.synchronize()
        eigh.append(dict(n=n, allocated=torch.cuda.max_memory_allocated()
                         - before, modeled=_eigh_bytes(n, 4)))
        del g, out
    torch.cuda.empty_cache()
    row = dict(case="opt_cap_eig", shape=list(shape), ranks=list(ranks),
               cap=cap, cap_matfree=cap_matfree,
               schedule=[dict(mode=s.mode, method=s.method, i_n=s.i_n,
                              r_n=s.r_n, j_n=s.j_n, peak_bytes=s.peak_bytes)
                         for s in p.schedule],
               input_bytes=x_bytes, cap_room_beside_input=cap - x_bytes,
               allocated_beyond_input_at_boundaries=boundary,
               max_allocated_beyond_input_inside_steps=inside,
               max_allocated_with_input_inside_steps=[x_bytes + b
                                                      for b in inside],
               eigh_fp32_bytes=eigh,
               rel_error=rel, launches=counts, matmul_routes=mroutes)
    emit("adaptive", **row)
    require(math.isfinite(rel) and rel <= 0.02,
            f"opt_cap_eig: rel_error {rel} > 0.02")
    require(all(e["allocated"] <= e["modeled"] for e in eigh),
            f"opt_cap_eig: eigh allocated more than its model: {eigh}")
    return row


def opt_cap_case(torch, gen, launched):
    """Boats under a memory cap with ``mode_order="opt"``: 0.8 x the free
    plan's largest step peak, or the least cap the search admits when that
    is infeasible.  Every step's modeled peak must fit; run step by step
    through ``solve_step`` (capped_steps), the held input plus the memory
    allocated beyond it must fit the cap at every step boundary and inside
    every step (the port never frees the input), and each step's own
    modeled peak.  Then the EIG case on the same input (opt_cap_eig_case).
    Returns both rows."""
    from repro_torch.core import MemoryCapError, TuckerConfig, plan
    from repro_torch.core import tensor_ops as T
    shape, ranks = BOATS
    x = lowrank(torch, shape, ranks, gen)
    free = plan(shape, "float32", TuckerConfig(ranks=ranks, impl="auto"))
    cap = int(0.8 * max(s.peak_bytes for s in free.schedule))

    def capped(c, impl="auto"):
        return plan(shape, "float32", TuckerConfig(
            ranks=ranks, mode_order="opt", memory_cap_bytes=c, impl=impl))
    try:
        p, cap_rule = capped(cap), "0.8 x the free plan's largest step peak"
    except MemoryCapError as e:
        infeasible = str(e)
        cap = least_cap(capped)
        p, cap_rule = capped(cap), "the least cap the search admits"
    else:
        infeasible = None
    # matfree runs the order and solvers hopper's search chose (each
    # backend's cost model searches for itself)
    pm = plan(shape, "float32", TuckerConfig(
        ranks=ranks, methods=p.methods,
        mode_order=tuple(s.mode for s in p.schedule),
        memory_cap_bytes=cap, impl="matfree"))
    require(p.backend == "hopper",
            f"opt_cap: impl='auto' resolved to {p.backend!r}, not 'hopper'")
    require(all(s.peak_bytes <= cap for s in p.schedule),
            f"opt_cap: a step models more than the cap {cap}")
    y, factors, boundary, inside, counts = capped_steps(torch, "opt_cap", p,
                                                        x, cap)
    mroutes = counts.pop("matmul_routes")
    for k, v in counts.items():
        launched[k] += v
    x_bytes = x.numel() * x.element_size()
    rel = float(T.rel_error(x, y, [factors[m] for m in range(len(shape))]))
    res = p.execute(x)
    res_m = pm.execute(x)
    rel_x, rel_m = (float(r.tucker.rel_error(x)) for r in (res, res_m))
    gaps = [projector_gap(torch, a, b) for a, b in
            zip(res.tucker.factors, res_m.tucker.factors)]
    rel_free = float(free.execute(x).tucker.rel_error(x))
    del res, res_m
    times, times_m = execute_ms(torch, p, x), execute_ms(torch, pm, x)
    row = dict(case="opt_cap", shape=list(shape), ranks=list(ranks),
               cap=cap, cap_rule=cap_rule, infeasible_at_0_8=infeasible,
               free_schedule=[dict(mode=s.mode, method=s.method,
                                   peak_bytes=s.peak_bytes)
                              for s in free.schedule],
               schedule=[dict(mode=s.mode, method=s.method, i_n=s.i_n,
                              r_n=s.r_n, j_n=s.j_n, peak_bytes=s.peak_bytes)
                         for s in p.schedule],
               input_bytes=x_bytes,
               allocated_beyond_input_at_boundaries=boundary,
               max_allocated_beyond_input_inside_steps=inside,
               max_allocated_with_input_inside_steps=[x_bytes + b
                                                      for b in inside],
               cap_room_beside_input=cap - x_bytes,
               rel_error=rel, rel_error_execute=rel_x,
               rel_error_matfree=rel_m, max_projector_gap=max(gaps),
               rel_error_free_plan=rel_free, launches=counts,
               matmul_routes=mroutes,
               execute_ms=statistics.median(times), execute_ms_all=times,
               execute_ms_matfree=statistics.median(times_m),
               execute_ms_matfree_all=times_m)
    emit("adaptive", **row)
    require(math.isfinite(rel) and rel <= 0.02,
            f"opt_cap: step-by-step rel_error {rel} > 0.02")
    require(rel_x <= 0.02, f"opt_cap: execute's rel_error {rel_x} > 0.02")
    require(max(gaps) <= 1e-3,
            f"opt_cap: projector gap {max(gaps)} to matfree > 1e-3")
    del y, factors
    eig_row = opt_cap_eig_case(torch, x, launched)
    del x
    torch.cuda.empty_cache()
    return row, eig_row


def phase_adaptive(torch):
    """The adaptive path at full size (HSI, Boats), each case on hopper and
    matfree; fails unless each Tucker kernel launched in it and the TTT ran
    its tensor-core route with y ≠ x.  Returns the launches per kernel."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    launched = {k: 0 for k in KERNELS}
    rows = []
    x = lowrank(torch, *ADAPT_HSI, gen)
    rows.append(adaptive_case(torch, "adapt_hsi", x, dict(
        error_target=0.03, methods="rand"), ADAPT_HSI[1], launched))
    caps = (16, 16, 16, 8)
    row = adaptive_case(torch, "adapt_miss", x, dict(
        error_target=0.005, methods="rand", ranks=caps), None, launched,
        same_subspace=False)
    # below the noise floor of mode 0: its budget tau = 0.005² / 4 of
    # ||X||² is missed at the cap width (the noise holds ~1e-4), so it keeps
    # its cap rank 16; later modes are budgeted on the residual after the
    # earlier truncations (mode 1 sees ~16/1021 of the noise) and may fit.
    # Every miss keeps its cap; the rand->eig hop refines with eig and the
    # measured bound is reported as it is
    tau = 0.005 ** 2 / 4
    tails = {t["mode"]: t["tail_err"] for t in row["trace"]}
    missed = sorted(m for m, t in tails.items() if t > tau)
    emit("adaptive_miss", budget=tau, tails=tails, missed_modes=missed)
    require(0 in missed and all(row["ranks"][m] == caps[m] for m in missed),
            f"adapt_miss: tails {tails} against the budget {tau}, ranks "
            f"{row['ranks']}")
    require(row["hops"] == {"rand_to_eig/hopper": 1},
            f"adapt_miss: hops {row['hops']}, want one rand_to_eig")
    require(all(t["method"] == "eig" for t in row["trace"]),
            "adapt_miss: the hop did not refine with eig")
    require(row["rel_error"] <= 0.02 and row["error_bound"] > 0.005,
            f"adapt_miss: rel_error {row['rel_error']}, bound "
            f"{row['error_bound']}")
    rows.append(row)
    del x
    torch.cuda.empty_cache()
    x = lowrank(torch, *ADAPT_WIDE, gen)
    row = adaptive_case(torch, "adapt_wide", x, dict(error_target=0.03),
                        ADAPT_WIDE[1], launched)
    require(all(t["method"] in ("eig", "als") for t in row["trace"])
            and row["select_overhead_s"] > 0,
            "adapt_wide: the refinement did not run eig/als after the sketch")
    require(row["ttt_routes"].get("wgmma_tma/ttt", 0) > 0,
            f"adapt_wide: no TTT with y ≠ x on wgmma_tma: {row['ttt_routes']}")
    require(row["matmul_routes"].get("wide", 0) > 0,
            f"adapt_wide: no first-mode GEMM on the wide route: "
            f"{row['matmul_routes']}")
    rows.append(row)
    del x
    torch.cuda.empty_cache()
    for row in rows:
        if row["case"] != "adapt_miss":
            require(row["error_bound"] <= 0.03,
                    f"{row['case']}: bound {row['error_bound']} > 0.03")
            require(row["rel_error"] <= 1.05 * row["error_bound"],
                    f"{row['case']}: rel_error {row['rel_error']} > 1.05 x "
                    f"bound {row['error_bound']}")
    rows.extend(opt_cap_case(torch, gen, launched))
    for k in ("ttt", "matmul", "ttm_interior"):
        require(launched[k] > 0,
                f"kernel {k} never launched on the adaptive path")
    launched["ttt_sketch"] = sum(r["ttt_routes"].get("wgmma_tma/ttt", 0)
                                 for r in rows if "ttt_routes" in r)
    launched["matmul_routes"] = {
        rt: sum(r.get("matmul_routes", {}).get(rt, 0) for r in rows)
        for rt in ("slab", "wide")}
    return launched


# ---------------------------------------------------------------------------
# phase 6: serving falcon-mamba-7b at full size
# ---------------------------------------------------------------------------

def phase_serve(torch):
    from repro_torch import configs, kernels
    from repro_torch.models import build
    from repro_torch.serve import Request, ServeEngine
    cfg = configs.get("falcon-mamba-7b")
    bundle = build(cfg)
    t0 = time.perf_counter()
    params = bundle.init(0, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    eng = ServeEngine(bundle, params, batch_slots=4, max_len=8320)
    g = torch.Generator(device="cuda").manual_seed(1)
    reqs = [Request(prompt=torch.randint(0, cfg.vocab, (n,), generator=g,
                                         device="cuda").tolist(),
                    max_new_tokens=MAX_NEW, rid=i,
                    temperature=0.8 if i == SAMPLED else 0.0)
            for i, n in enumerate(PROMPTS)]

    prefill_ms, decode_ms, active, watched = {}, [], [], {}
    finite = [True]
    inner_prefill, inner_decode = eng._prefill, eng._decode

    def synced(fn, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    def timed_prefill(tokens, cache):
        (logits, c), ms = synced(inner_prefill, tokens, cache)
        prefill_ms[int(tokens.shape[1])] = ms
        finite[0] &= bool(torch.isfinite(logits).all())
        return logits, c

    def timed_decode(tok, cache, pos):
        (logits, c), ms = synced(inner_decode, tok, cache, pos)
        decode_ms.append(ms)
        active.append(sum(r is not None for r in eng.slot_req))
        finite[0] &= bool(torch.isfinite(logits).all())
        row = watched_row(eng, logits)
        if row is not None:
            watched["logits"] = row
        return logits, c

    eng._prefill, eng._decode = timed_prefill, timed_decode
    # warm-up: cuBLAS handles and the first launch of each op, off the count
    with torch.no_grad():
        inner_prefill(torch.zeros((1, 16), dtype=torch.long, device="cuda"),
                      bundle.init_cache(1, 16, device="cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    require(finite[0], "serve: non-finite logits")
    for r in reqs:
        require(len(r.output) == MAX_NEW and all(0 <= v < cfg.vocab
                                                 for v in r.output),
                f"serve: request {r.rid} got {len(r.output)} tokens "
                f"(want {MAX_NEW} in [0, {cfg.vocab}))")
    steps = len(prefill_ms) + len(decode_ms)
    require(len(prefill_ms) == len(reqs), "serve: a prefill was not timed")
    require(counts["s6_scan"] > 0 and
            counts["s6_scan"] == cfg.n_layers * steps,
            f"serve: s6_scan launched {counts['s6_scan']} times, want "
            f"{cfg.n_layers} x {steps} (prefills + decode steps)")

    require("logits" in watched, "serve: the watched decode step never ran")
    carry_bf16 = carry_stats(torch, bundle, params, reqs[WATCH],
                             watched["logits"])

    # one decode step of all 4 slots under the profiler
    wall = statistics.median(decode_ms)
    tok = torch.zeros((eng.b, 1), dtype=torch.long, device="cuda")
    pos = torch.from_numpy(eng.pos.copy())
    with torch.no_grad():
        prof = profile_call(torch, lambda: inner_decode(tok, eng.cache, pos),
                            wall)
    decode_tokens = sum(active)
    row = dict(
        model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        d_inner=cfg.d_inner, vocab=cfg.vocab, dtype=cfg.dtype,
        params=n_params, param_bytes=param_bytes, init_s=init_s,
        slots=eng.b, requests=len(reqs), prompt_lens=list(PROMPTS),
        max_new_tokens=MAX_NEW,
        prefill_ms={str(k): v for k, v in sorted(prefill_ms.items())},
        decode_steps=len(decode_ms), decode_ms_median=wall,
        decode_ms_all=decode_ms,
        decode_tokens_per_s=decode_tokens / (sum(decode_ms) / 1e3),
        run_s=run_s,
        tokens_per_s=sum(len(q.output) for q in reqs) / run_s,
        peak_bytes=peak, launches=counts, state_carry_bf16=carry_bf16,
        profile_decode_step=prof,
        outputs={q.rid: q.output[:8] for q in reqs})

    row["graphs"] = serve_graph_check(torch, bundle, params, reqs, decode_ms,
                                      decode_tokens, eng, inner_decode)

    # the state-carry check: the same full-size model in fp32, the watched
    # request alone on 4 slots (decode at batch 4, the fresh prefill at 1)
    del eng
    torch.cuda.empty_cache()
    params.float()
    bundle32 = build(cfg.with_(dtype="float32"))
    eng32 = ServeEngine(bundle32, params, batch_slots=4, max_len=8320)
    inner32, rec = eng32._decode, {}

    def recording_decode(tok, cache, pos):
        logits, c = inner32(tok, cache, pos)
        row32 = watched_row(eng32, logits)
        if row32 is not None:
            rec["logits"] = row32
        return logits, c

    eng32._decode = recording_decode
    req32 = Request(prompt=reqs[WATCH].prompt, max_new_tokens=K_CARRY + 1,
                    rid=WATCH)
    eng32.run([req32])
    require("logits" in rec, "serve: the fp32 watched decode step never ran")
    carry = carry_stats(torch, bundle32, params, req32, rec["logits"])
    carry["tol_rel"] = CARRY_TOL
    row["state_carry_fp32"] = carry
    emit("serve", **row)
    require(carry["argmax_prefill"] == carry["argmax_decode"] == carry["token"]
            and carry["max_abs_diff"] <= CARRY_TOL * carry["max_abs_logit"],
            f"serve: state carry broken: {carry}")
    del eng32, params
    torch.cuda.empty_cache()
    return counts["s6_scan"]


def serve_graph_check(torch, bundle, params, reqs, decode_ms, decode_tokens,
                      eng, replay) -> dict:
    """The same 6 requests on an engine whose decode step runs eagerly
    (its ``_eager_decode``, the step it captured): every request's 32
    tokens identical to the captured engine's, 64 S6 launches a step there
    too; decode-step ms and decode tokens/s of both, and one profiled step
    of each (host launches per step, a graph replay counting once)."""
    from repro_torch import kernels
    from repro_torch.serve import Request, ServeEngine
    require(eng.captured, "serve: the engine on the card did not capture "
            "its decode step")
    eager = ServeEngine(bundle, params, batch_slots=4, max_len=8320)
    inner, ms, active = eager._eager_decode, [], []

    def timed(tok, cache, pos):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(tok, cache, pos)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        active.append(sum(r is not None for r in eager.slot_req))
        return out

    eager._decode = timed
    again = [Request(prompt=r.prompt, max_new_tokens=MAX_NEW, rid=r.rid,
                     temperature=r.temperature) for r in reqs]
    kernels.reset_launch_counts()
    with torch.no_grad():
        eager.run(again)
    torch.cuda.synchronize()
    s6 = kernels.launch_counts()["s6_scan"]
    same = {r.rid: r.output == q.output for r, q in zip(reqs, again)}
    steps = len(reqs) + len(ms)
    tok = torch.zeros((eager.b, 1), dtype=torch.long, device="cuda")
    pos = torch.from_numpy(eager.pos.copy())
    med_e, med_g = statistics.median(ms), statistics.median(decode_ms)
    with torch.no_grad():
        prof_e = profile_enqueues(torch, lambda: inner(tok, eager.cache, pos),
                                  med_e)
        prof_g = profile_enqueues(torch, lambda: replay(tok, eng.cache, pos),
                                  med_g)
    row = dict(decode_ms_eager=med_e, decode_ms_eager_all=ms,
               decode_ms_captured=med_g,
               decode_tokens_per_s_eager=sum(active) / (sum(ms) / 1e3),
               decode_tokens_per_s_captured=decode_tokens
               / (sum(decode_ms) / 1e3),
               tokens_identical=same, s6_launches_eager=s6,
               s6_per_step_eager=s6 / steps,
               graph_launches_per_replay={f"{k}/{rt}": v for (k, rt), v in
                                          eng._graph_launches.items()},
               profile_step_eager=prof_e, profile_step_captured=prof_g)
    emit("graphs", check="serve", **row)
    require(all(same.values()), f"serve: the eager engine's tokens differ "
            f"from the captured engine's: {same}")
    require(s6 == 64 * steps, f"serve: eager S6 launches {s6}, want 64 x "
            f"{steps}")
    del eager
    torch.cuda.empty_cache()
    return row


def watched_row(eng, logits):
    """The logits row (a copy) that the WATCH request's decode step produced
    after K_CARRY generated tokens, or None in any other step."""
    for s, r in enumerate(eng.slot_req):
        if r is not None and r.rid == WATCH and len(r.output) == K_CARRY:
            return logits[s, 0].clone()
    return None


def carry_stats(torch, bundle, params, req, dec) -> dict:
    """A fresh prefill over ``req``'s prompt plus its first K_CARRY tokens,
    against ``dec``, the logits its decode step produced at that point."""
    with torch.no_grad():
        toks = torch.tensor([req.prompt + req.output[:K_CARRY]], device="cuda")
        fresh, _ = bundle.prefill(params, {"tokens": toks},
                                  bundle.init_cache(1, 16, device="cuda"))
    fresh = fresh[0, -1]
    diff = float((fresh - dec).abs().max())
    scale = float(dec.abs().max())
    return dict(rid=req.rid, prompt_len=len(req.prompt), k=K_CARRY,
                max_abs_diff=diff, max_abs_logit=scale, rel=diff / scale,
                argmax_decode=int(dec.argmax()),
                argmax_prefill=int(fresh.argmax()), token=req.output[K_CARRY])


# ---------------------------------------------------------------------------
# phase 7: the tune flywheel -- collect, train and calibrate on the card
# ---------------------------------------------------------------------------

#: the sampling grid of the shipped cuda models: tensors of order 3 and 4,
#: dims log-uniform in [8, 8192], at most 2**29 elements (Boats' 537.6 M),
#: ranks log-uniform up to min(64, I_n/2), both backends, best of 2
TUNE_GRID = dict(dim_range=(8, 8192), orders=(3, 4), max_elements=1 << 29,
                 max_rank=64, backends=("hopper", "matfree"), reps=2)
#: (seed, tensors) of the training set and of the test set (which also
#: holds the main path's steps)
TUNE_TRAIN = (0, 128)
TUNE_TEST = (1, 40)
TUNE_OUT = ROOT / "chiprun_out" / "tune"
SHIPPED_MODELS = SRC / "repro_torch" / "core" / "models"
CUDA_MODEL_FILES = {"selector_cuda.json", "selector_cuda_hopper.json",
                    "selector_cuda_matfree.json", "cost_cuda_hopper.json",
                    "cost_cuda_matfree.json"}


def main_steps():
    """(case, step, the shape of the tensor the step solves) of boats' and
    hsi's plans as the main phase makes them (``mode_order="shrink"``)."""
    from repro_torch.core import TuckerConfig, plan
    out = []
    for name, (shape, ranks) in (("boats", BOATS), ("hsi", HSI)):
        p = plan(shape, "float32", TuckerConfig(
            ranks=ranks, mode_order="shrink", impl="auto"))
        cur = list(shape)
        for s in p.schedule:
            out.append((name, s, tuple(cur), ranks))
            cur[s.mode] = s.r_n
    return out


def tune_pickers(backend: str, trained: Path) -> dict:
    """The solver pickers the tune phase scores: the phase's trained tree,
    the shipped tree, the textbook and the calibrated cost models, and the
    two constant picks; each ``(i, r, j) -> "eig" | "als"`` (None when its
    file is missing)."""
    from repro_torch.core import DEFAULT_COST_MODEL, CostModel, Selector

    def tree(d: Path):
        for stem in (f"selector_cuda_{backend}", "selector_cuda"):
            if (d / f"{stem}.json").exists():
                sel = Selector.load(d / f"{stem}.json")
                return lambda i, r, j: sel(i_n=i, r_n=r, j_n=j)
        return None

    cost = trained / f"cost_cuda_{backend}.json"
    cal = CostModel.from_dict(json.loads(cost.read_text())) \
        if cost.exists() else None
    return {"trained_tree": tree(trained),
            "shipped_tree": tree(SHIPPED_MODELS),
            "textbook": lambda i, r, j: DEFAULT_COST_MODEL.predicted_best(
                i, r, j),
            "calibrated": None if cal is None else
            (lambda i, r, j: cal.predicted_best(i, r, j)),
            "always_eig": lambda i, r, j: "eig",
            "always_als": lambda i, r, j: "als"}


def tune_scores(pickers: dict, recs) -> dict:
    """Each picker on the labeled examples of ``recs``: its accuracy and
    the sum of the times of the solvers it picks over the oracle's (the
    faster of the two at every point)."""
    import numpy as np
    from repro_torch.tune import labeled_examples
    feats, labels, times = labeled_examples(recs)
    oracle = float(times.min(1).sum())
    out = dict(examples=int(len(labels)), als_share=float(labels.mean()),
               oracle_s=oracle)
    for name, pick in pickers.items():
        if pick is None:
            out[name] = None
            continue
        k = np.array([0 if pick(int(i), int(r), int(j)) == "eig" else 1
                      for i, r, j in feats[:, :3]])
        out[name] = dict(
            accuracy=float((k == labels).mean()),
            time_over_oracle=float(times[np.arange(len(k)), k].sum())
            / oracle)
    return out


def phase_tune(torch, smi: str) -> dict:
    """The tune flywheel on the card: a training set (seed 0) and a test
    set (seed 1, plus every step of boats' and hsi's plans with both
    solvers) collected at TUNE_GRID on ``hopper`` and ``matfree``, each
    solve captured into CUDA graphs and replayed (the test set also times
    it eagerly); then the stratified trees and calibrated cost models are
    trained into chiprun_out/tune/models.  Prints, per backend, the test
    accuracy and the time over the oracle of the trained tree, the shipped
    tree, the textbook and calibrated cost models, always-EIG and
    always-ALS; each main step's times and picks; eager/replayed ratios.
    Checks: every record finite and > 0; ``recording()`` around one
    execute of boats and of hsi yields one record a step with the plan's
    (I_n, R_n, J_n, method, backend); ``default_selector("cuda",
    "hopper")`` resolves to the shipped file."""
    import gc
    import shutil

    from repro_torch.core import TuckerConfig, plan
    from repro_torch.core.selector import (clear_selector_cache,
                                           default_selector)
    from repro_torch.tune import (RecordStore, calibrate_store, recording,
                                  train_stratified)
    from repro_torch.tune.collect import collect, measure
    from repro_torch.tune.records import device_fingerprint
    t_phase = time.perf_counter()
    # every captured solve runs gc.collect() before its capture
    # (core/graphs.py): freeze what the earlier phases left alive, so that
    # those collections scan only the phase's own objects
    t0 = time.perf_counter()
    gc.collect()
    gc_collect_s = time.perf_counter() - t0
    gc.freeze()
    frozen = gc.get_freeze_count()
    shutil.rmtree(TUNE_OUT, ignore_errors=True)
    models = TUNE_OUT / "models"
    train, test = (RecordStore(TUNE_OUT / f"{s}.jsonl")
                   for s in ("train", "test"))
    t0 = time.perf_counter()
    train.append(collect(TUNE_TRAIN[1], seed=TUNE_TRAIN[0], device="cuda",
                         **TUNE_GRID))
    collect_train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eager: dict = {}
    test.append(collect(TUNE_TEST[1], seed=TUNE_TEST[0], device="cuda",
                        eager=eager, **TUNE_GRID))
    gen = torch.Generator(device="cuda").manual_seed(TUNE_TEST[0])
    steps = []
    for name, s, shp, ranks in main_steps():
        y = torch.randn(shp, generator=gen, device="cuda")
        ms = measure(y, ranks, modes=(s.mode,),
                     backends=TUNE_GRID["backends"], reps=TUNE_GRID["reps"],
                     eager=eager)
        del y
        test.append(ms)
        steps.append((name, s, ms))
    torch.cuda.empty_cache()
    collect_test_s = time.perf_counter() - t0
    recs = train.load() + test.load()
    bad = [m.to_dict() for m in recs
           if not (math.isfinite(m.seconds) and m.seconds > 0)]
    require(not bad, f"tune: {len(bad)} records not finite and > 0: "
            f"{bad[:3]}")
    meta = dict(card=smi, sampling=dict(
        TUNE_GRID, seed=TUNE_TRAIN[0], n_tensors=TUNE_TRAIN[1],
        timing="each solve captured into CUDA graphs (cut at eigh) and "
               "replayed, synchronized, best of reps"))
    t0 = time.perf_counter()
    written = train_stratified(train, platform="cuda", model_dir=models,
                               meta=meta)
    written.update(calibrate_store(train, platform="cuda", model_dir=models,
                                   meta=meta))
    train_s = time.perf_counter() - t0
    # training cached its trees in-process: resolve the shipped files again
    clear_selector_cache()
    require({Path(p).name for p in written} == CUDA_MODEL_FILES,
            f"tune: wrote {sorted(Path(p).name for p in written)}")
    emit("tune", step="collect", train_records=len(train),
         test_records=len(test), train_tensors=TUNE_TRAIN[1],
         test_tensors=TUNE_TEST[1], grid=TUNE_GRID,
         collect_train_s=collect_train_s, collect_test_s=collect_test_s,
         train_s=train_s, store_digest=train.digest(), gc_frozen=frozen,
         gc_collect_s_before_freeze=gc_collect_s,
         trees={Path(p).name: {k: info.get(k) for k in (
             "n_examples", "cv_accuracy", "test_accuracy", "max_depth",
             "label_balance_als")} for p, info in written.items()
             if Path(p).name.startswith("selector")})
    scores = {}
    for b in TUNE_GRID["backends"]:
        picks = tune_pickers(b, models)
        scores[b] = tune_scores(picks, test.filter(backend=b))
        emit("tune", step="scores", backend=b, **scores[b])
        for name, s, ms in steps:
            e, a = (m for m in ms if m.backend == b)
            emit("tune", step="main_step", backend=b, case=name,
                 mode=s.mode, i_n=s.i_n, r_n=s.r_n, j_n=s.j_n,
                 eig_ms=e.seconds * 1e3, als_ms=a.seconds * 1e3,
                 eig_eager_ms=eager[e.key()] * 1e3,
                 als_eager_ms=eager[a.key()] * 1e3,
                 oracle="eig" if e.seconds <= a.seconds else "als",
                 **{k: (None if f is None else f(s.i_n, s.r_n, s.j_n))
                    for k, f in picks.items() if not k.startswith("always")})
    # eager/replayed of the same solve at a few points of the test set
    pts = sorted((m for m in test if m.source == "collect"),
                 key=lambda m: m.seconds)
    emit("tune", step="eager_over_replayed", points=[
        dict(backend=m.backend, method=m.method, i_n=m.i_n, r_n=m.r_n,
             j_n=m.j_n, replayed_ms=m.seconds * 1e3,
             eager_ms=eager[m.key()] * 1e3,
             ratio=eager[m.key()] / m.seconds)
        for m in pts[::max(1, len(pts) // 10)]])
    # the recording hook on the main path's plans
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, (shape, ranks) in (("boats", BOATS), ("hsi", HSI)):
        x = lowrank(torch, shape, ranks, gen)
        p = plan(shape, "float32", TuckerConfig(
            ranks=ranks, mode_order="shrink", impl="auto"))
        with recording() as sink:
            res = p.execute(x)
        got = [(m.i_n, m.r_n, m.j_n, m.method, m.backend)
               for m in sink.measurements]
        want = [(s.i_n, s.r_n, s.j_n, s.method, s.backend)
                for s in p.schedule]
        emit("tune", step="record", case=name, records=[
            dict(i_n=m.i_n, r_n=m.r_n, j_n=m.j_n, method=m.method,
                 backend=m.backend, seconds=m.seconds,
                 predicted_s=m.predicted_s, device=m.device)
            for m in sink.measurements],
            rel_error=float(res.tucker.rel_error(x)))
        require(got == want, f"tune: recording() gave {got}, the plan "
                f"{want}")
        require(all(m.platform == "cuda" and math.isfinite(m.seconds)
                    and m.seconds > 0 for m in sink.measurements),
                f"tune: {name}'s records are not finite cuda timings")
        del x, res
        torch.cuda.empty_cache()
    clear_selector_cache()
    sel = default_selector("cuda", "hopper")
    shipped = SHIPPED_MODELS / "selector_cuda_hopper.json"
    fp = device_fingerprint("cuda")
    emit("tune", step="resolve", file=str(shipped.relative_to(ROOT)),
         exists=shipped.exists(), tree=sel.tree is not None,
         backend=sel.backend, card=sel.meta.get("card"),
         store_digest=sel.meta.get("store_digest"),
         devices=sel.meta.get("devices"), fingerprint=fp,
         fingerprint_matches=fp in sel.meta.get("devices", ()),
         cost_model=sel.cost_model.source,
         phase_s=time.perf_counter() - t_phase)
    gc.unfreeze()
    require(shipped.exists() and sel.tree is not None
            and sel.backend == "hopper"
            and sel.meta.get("store_digest")
            == json.loads(shipped.read_text())["meta"]["store_digest"],
            "tune: default_selector('cuda', 'hopper') did not resolve to "
            f"{shipped.relative_to(ROOT)}")
    return scores


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("kernels", "tune"),
                    help="kernels: run env, build and the kernel phases "
                         "(small and full-size shapes) only: no large "
                         "operands, main path or serve run; tune: env, "
                         "build and the tune phase only; neither prints the "
                         "kernels line")
    args = ap.parse_args(argv)
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
    t_run = time.perf_counter()
    try:
        smi, peaks = phase_env(torch)
        phase_build()
        if args.only == "tune":
            phase_tune(torch, smi)
            emit("run", seconds=time.perf_counter() - t_run)
            print(smi, flush=True)
            return 0
        phase_kernel_shapes(torch)
        if args.only == "kernels":
            phase_kernels_full(torch, peaks)
            print(smi, flush=True)
            return 0
        phase_kernels_large(torch)
        full = phase_kernels_full(torch, peaks)
        launched, data, main_rows = phase_main(torch)
        phase_graphs(torch, data, main_rows)
        del data
        adaptive = phase_adaptive(torch)
        launched["s6_scan"] = phase_serve(torch)
        phase_tune(torch, smi)
    except SmokeFailure as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        return 1
    emit("run", seconds=time.perf_counter() - t_run)
    rows = []
    for name, meta in KERNELS.items():
        # the ttt kernel carries both the TTT and the Gram; its row gives the
        # TTT numbers, the Gram's ride along under "gram"
        m = full[name]
        row = dict(name=name, route="cuda", **meta, launches=launched[name],
                   launches_adaptive=adaptive.get(name),
                   max_abs_err=m["max_abs_err"], ms=m["ms"],
                   plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
                   bound_by=m["bound_by"], library_ms=m["library_ms"],
                   device_ms=m["device_ms"],
                   library_device_ms=m.get("library_device_ms"),
                   launch=m["launch"])
        if name == "s6_scan":
            row["by_shape"] = m["by_shape"]
        if name == "ttt":
            row["gram"] = {k: full["gram"][k] for k in
                           ("route", "max_abs_err", "max_entry_err",
                            "plain_max_entry_err", "ms",
                            "plain_ms", "bound_ms", "bound_by",
                            "bound_terms_ms", "library_ms", "device_ms",
                            "library_device_ms", "launch")}
            # the adaptive path's range sample (y ≠ x, R = 64); launches:
            # its wgmma_tma TTTs with y ≠ x on the adaptive path
            row["sketch"] = dict(
                {k: full["ttt_sketch"][k] for k in
                 ("shapes", "route", "max_abs_err", "max_entry_err",
                  "plain_max_entry_err", "ms", "plain_ms", "bound_ms",
                  "bound_by", "bound_terms_ms", "library_ms", "device_ms",
                  "library_device_ms", "tile_fill", "launch")},
                launches=adaptive["ttt_sketch"])
        if name == "matmul":
            # row 2b: the first-mode GEMM at R > 16 on its wide route (R =
            # 64 and 40 at adapt_wide's mode 0), with the slab route it
            # replaced; launches: wrapper calls by route on each path
            row["wide"] = {f"r{r}": {k: full[f"matmul_wide_r{r}"][k] for k in (
                "shapes", "route", "max_abs_err", "max_entry_err",
                "plain_max_entry_err", "ms", "device_ms", "plain_ms",
                "bound_ms", "bound_by", "bound_terms_ms", "library_ms",
                "library_device_ms", "slab_ms", "slab_device_ms",
                "bytes_per_s", "launch")} for r in (64, 40)}
            row["wide"]["launches"] = launched["matmul_routes"].get("wide", 0)
            row["wide"]["launches_adaptive"] = \
                adaptive["matmul_routes"].get("wide", 0)
            row["launches_by_route"] = launched["matmul_routes"]
            row["launches_adaptive_by_route"] = adaptive["matmul_routes"]
        if name == "ttm_interior":
            # the sketch's projection at ℓ = 64 (four 16-row slabs)
            row["l64"] = {k: full["ttm_interior_l64"][k] for k in
                          ("shapes", "max_abs_err", "ms", "plain_ms",
                           "bound_ms", "bound_by", "bound_terms_ms",
                           "library_ms", "device_ms", "library_device_ms")}
        rows.append(row)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
