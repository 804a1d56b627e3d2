#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

It drives the port's paths -- fixed-rank Tucker ``plan -> execute``, the
adaptive Tucker path (error targets, the fallback ladder's rand->eig hop,
the schedule search under a memory cap), serving falcon-mamba-7b and
training it -- through five hand-written Hopper kernels: TTT/Gram,
boundary GEMM, interior TTM, the Mamba-1 selective scan (S6) and its
backward; serving the dense, MoE, hybrid and vlm LM families, whose
checkpoints go through the Tucker kernels; then the streaming Tucker service
(``repro_torch.serve.TuckerService``) over those kernels, and the tune
flywheel that trains the solver selector ``methods="auto"`` loads on the
card.

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
            every route of its tensor-core kernel -- TMA, plain-load, a B = 1
            Gram, the B = 1 TTT on the wide GEMM (wgmma_cols), misaligned,
            output tiles 32, 64 and 128 wide, fp32 and bf16 -- also per
            entry, within 2e-4 of sqrt(ttt(x∘x, y∘y)) of the float64
            result; for the boundary GEMM's wide route -- R > 16 on the
            tensor cores, the first mode and the last (x read K-major) --
            R = 17 to 300 with K = 7 and 1021 (and 1024 on the last mode),
            ragged N or M, both of x's loads (TMA, plain) and a misaligned
            x, per entry within 2e-4 of sqrt((u∘u) @ (x∘x)), and the sums'
            energy bias on both sides), then on operands of
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
            replaced and torch.matmul, per entry in fp32 and bf16; the last
            mode at R = 64 (row 2c) beside its old slab route, Cavity's
            last-mode GEMM and TTT at R = 20 (rows 2d, 1d), the main-path
            Gram in bf16 and MNIST's interior TTM at R = 142 (row 3c).
            S6 is also timed at every shape the serve run gives it, on both
            of its routes.  The S6 backward (``csrc/s6_scan_bwd.cu``) is
            held against ``s6_scan_bwd_ref`` (the reverse recurrence) on the
            S6 test shapes, ragged T/Di/N (N = 4 ... 64, one and several
            state groups), T = 1, a nonzero h0 and dh_final, strided B/C,
            fp32 and bf16, from the 8-step checkpoints of both forward
            routes, and at widths whose chunks hold several sub-chunks:
            every gradient within 1e-4 of its
            max|plain| (a bf16 output also within 2**-7 of the entry: each
            side rounds its own fp32 sum once); then at the training shape
            (2, 2048, 8192, 16), bitwise equal on a second run, timed
            beside its bound (the larger of its bytes and the
            exponentials the gradient needs, one per (b, t, d, n)), with
            each of its four CUDA kernels' registers, spills, shared
            memory, blocks and warps per SM and device ms, and the
            forward's time with and without its checkpoints.
4. main     ``plan -> execute`` with ``impl="auto"`` on the paper's Table III
            Boats (320, 240, 7000), HSI (1021, 1340, 33, 8), Cavity (100,
            100, 10000) and MNIST (784, 5000, 10) tensors at full size
            (Cavity and MNIST from a generator of their own): the plan must
            resolve to the ``hopper`` backend, every kernel must launch
            (Cavity its last-mode wide GEMM and wgmma_cols TTT, MNIST the
            interior TTM's wide route and the TTT's wgmma_plain and
            wgmma_tma), rel_error must be <= 0.02 and the factors must
            match the same plan on ``matfree``; Cavity's and MNIST's
            plans also run under the least cap the hopper model admits,
            step by step, each step's memory held to the cap and to its
            modeled peak.  Warm executes are
            timed on both backends (host clock around a synchronized
            execute), and one more execute runs under torch.profiler for
            the device's busy time, idle share, top kernels and the
            tensor-core Gram's device time (hsi_eig must run it) and the
            GEMMs' by kernel (wide on X (K, N) or x (N, K), slab).  These executes replay the plans'
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
6a. dense   the dense LM family (no hand kernel on its serve path: the
            attention is the reference's blockwise softmax in plain fp32
            PyTorch).  serve_dense: gemma2-9b at its published size (42
            layers, 9.24e9 parameters, bf16, random weights from seed 0)
            in ``ServeEngine`` with 4 slots and max_len 8224 answers 6
            requests (prompts of 37, 1021, 3000, 4097, 6000 and 8191 tokens,
            two past the 4096 window; 32 new tokens each): 32 valid tokens
            a request, finite logits; prints prefill ms by prompt length,
            captured and eager decode ms, tokens/s, the peak, host launches
            of a decode step (captured and eager); then one decode step
            eager and replayed on the same inputs, whose logits must agree
            (same argmax, max|d| <= 1e-4 of max|logits|; bitwise printed).
            Then gemma3-1b at its 26 layers with the same traffic, and
            phi3-mini-3.8b and minitron-4b at full width cut to 4 layers, 2
            requests each (37 and 8191 tokens).  dense_cache: gemma2-9b cut
            to 2 layers and gemma3-1b to 6 (one local:global period each),
            fp32: a 5000-token prompt, then 16 decode steps of the same
            random sequence through the KV cache; the 17 positions' logits
            against the no-cache forward over the 5016 tokens, within 1e-4
            of max|logits|.  ckpt_codec_dense: gemma2-9b at full width cut
            to 8 layers saved with ``CompressionConfig()``: its seven
            stacked 3-D leaves ((8, 3584, 4096), (8, 3584, 2048) x 2, (8,
            4096, 3584), (8, 3584, 14336) x 2, (8, 14336, 3584)) through the
            Tucker tier on ``hopper`` (ttt, matmul and ttm_interior must
            launch), each within 1e-4 of ``matfree``'s rel_error, with its
            ``codec_diag`` (and ``als_gate``) lines; then restored and
            serving 4 requests x 32 tokens.
6e. families the MoE, hybrid and vlm families (no hand kernel on their
            serve paths: the experts, the SSD scan and the vision
            projector are plain PyTorch, as the reference's are jnp), each
            through :func:`serve_lm_case` (dense's checks, the captured
            step bitwise the eager one, a replayed step's top kernels).
            serve_moe: granite-moe-3b-a800m at its published size (32
            layers, 40 experts top-8, 3.30e9 parameters, bf16) with
            serve_dense's 6 requests, and mixtral-8x22b at full width cut
            to 8 of its 56 layers (280 GB in bf16; 8 are 40.9 GB) on its
            4096-position ring cache, 4 requests (37, 4097, 6000, 8191
            tokens); each prefill's entries dropped by capacity, by layer.
            serve_hybrid: zamba2-1.2b at its 38 layers with the 6 requests,
            the shared block at its 6 sites a step.  serve_vlm:
            internvl2-2b at its 24 layers, the 6 text requests through the
            engine, then 4 image requests (1024 fp32 patches, seed 0, and
            prompts of 37, 1021, 3000 and 6000 tokens) prefilled by
            ``bundle.prefill`` into a 4-slot cache of 1024 + 6000 + 32
            positions and decoded 32 steps at n_patches + len(prompt) + i
            by the engine's captured ``bundle.decode`` (32 valid tokens,
            finite logits, the captured step bitwise the eager one).
            family_cache: granite and mixtral cut to 2 layers, zamba2 to 6
            (one site; 20 SSD chunks, the last ragged) and internvl2 to 2
            (1024 patches + 3976 tokens), fp32: 5000 positions prefilled,
            16 decoded, the 17 positions' logits against the no-cache
            forward within 1e-4 of max|logits| -- for an MoE model only
            where the forward dropped no entry by capacity (both drop
            counts printed by layer); its layer-0 KV cache (mixtral's
            ring slots included) is held against a no-cache computation
            from the embeddings either way.  ckpt_codec_moe: granite uncut
            through the Tucker codec: the 4-way expert leaves (32, 40,
            1536, 512) x 2 and (32, 40, 512, 1536) at ranks (32, 10, 64,
            64), the router (32, 1536, 40) and the attention leaves, as
            ckpt_codec_dense, and on the 4-way leaves rows 2b, 3, 3b and
            2c's routes must launch; restored and serving 4 x 32 tokens.
6b. tucker_serve the streaming Tucker service with ``impl="auto"`` (every
            plan must resolve to ``hopper``; gc frozen for the phase), in
            three parts.  stream_ref: the reference's serve bench stream
            (``benchmarks/serve_bench.py --full``) rebuilt from its numpy
            draws (seed 0): 200 requests of shapes jittered (0-5 below)
            about (48, 40, 32), (64, 48, 32), (40, 40, 40), ranks (4, 4, 4),
            ``methods="eig"``, Poisson arrivals at 3x the rate of a warm
            singleton execute on the first anchor (median of 5, measured
            here); one-shot arm ``TuckerBatchEngine().run([req])`` per
            arrival, then (from a clear sweep cache) the service arm: mask
            buckets of grid 8, max_pad_ratio 8, 8 wave slots, 3 waves in
            flight, queue 800, "block", a worker.  Prints per arm requests/s,
            p50/p95/p99 ms, plans built, the captured sweeps' first-call
            seconds and bytes held (static inputs + pools), per-bucket rows.
            hsi_tiles: 64 tiles of HSI's tensor (ranks (10, 10, 10, 5) + 1%
            noise, seed 11) cut at random offsets, modes 0 and 1 from [505,
            512], ranks (10, 10, 10, 5), ``methods="auto"``, through a mask
            service (grid (8, 8, 1, 1), max_pad_ratio 2, 4 wave slots, 2
            waves in flight, queue 16, "block", a worker) closed loop:
            all 64 complete, TTT, GEMM and interior TTM launch, each
            rel_error <= 0.02, 8 sampled tiles against a direct plan
            (projector gap <= 1e-3, |d rel_error| <= 1e-4), peak memory <=
            50% of the card; prints the slack rows of one padded lane run
            through the bucket plan untrimmed (max per mode; exactly zero
            or not), requests/s, p50/p95/p99, per-bucket occupancy and
            pipeline occupancy, one profiled wave's idle share; then 8
            tiles (2 at (512, 512, 33, 8), 6 padded of distinct shapes)
            through an exact-mode service, each bitwise equal to a direct
            ``decompose``.  resilience, on a (16, 16, 16) mask bucket at
            ranks (3, 3, 3): a ``wave_job`` raise on one rid of a wave of 4
            fails it classified, the other 3 bitwise a clean wave's,
            bisections >= 1; a ``wave_job_data`` NaN lane is quarantined
            and recovered (bitwise the clean lane); 2 failed waves open a
            breaker at threshold 2, isolated waves run, a probe after the
            cooldown closes it; a request past its deadline fails with
            DeadlineError; the capture race: the worker is held inside its
            first capture of a new bucket while this thread admits 32 CUDA
            inputs with ``validate="finite"``; nothing fails and every
            result is bitwise a serial run's.
6d. train  falcon-mamba-7b at full width (d_model 4096, d_inner 8192,
            N 16, vocab 65,024, bf16, remat) cut to 16 layers (the training
            state of 64 layers, 114 GB, does not fit the card; printed with
            its reckoning) trains 8 steps of SyntheticLM(seed 0) at 2 x 2048
            tokens with launch/train's AdamW recipe and the Tucker-
            compressed step (``CompressionConfig()``, the factors refreshed
            at step 0).  Prints per step ms, tokens/s, peak allocated bytes,
            loss, grad norm and the compressor's dense/compressed bytes;
            the last step runs under torch.profiler (device busy ms, idle
            share, top device ops).  Gates: finite losses, the last below
            the first; S6 backward launches = 16 x 8; on the refresh step
            every compressed leaf's factors orthonormal (1e-4), g_hat +
            error = g_fb (1e-5 of max|g_fb|) and the reduced gradient
            bitwise g_hat in bf16; the peak under 90% of the card.
    ckpt_codec the trained weights saved with ``compress_cfg=
            CompressionConfig()``: every eligible stacked leaf through the
            Tucker tier, on ``hopper`` (ttt, matmul and ttm_interior must
            launch), each leaf's rel_error within 1e-4 of the same methods
            on ``matfree``; per leaf its shape, ranks, solvers, ms,
            rel_error and bytes, and a ``codec_diag`` line: the leaf's
            st-HOSVD step by step on both backends (each mode's solver,
            launches by route, projector gap against matfree) and an
            ``als_gate`` line (below); then restored into a fresh model that serves 4 requests x 32
            tokens through ServeEngine (valid tokens, finite logits).
    als_gate (in main, adaptive, tucker_serve's sampled tiles and
            ckpt_codec) every decomposition with an ALS mode again, step by
            step on hopper: its ALS iterations, how many of them the
            resolution gate of ``solvers._spd_inverse`` changed against
            the reference's jitter ladder, and where it changed one, both
            rel_errors and each factor's projector gap.
    train_resume falcon-mamba SMOKE on the card through ``Trainer``
            (compressed steps, ckpt_every=3): 6 steps, then a new Trainer
            restores and runs to 8; parameters, optimizer and compressor
            state bitwise those of an uninterrupted 8-step run.  The three
            phases print their seconds; their checkpoints go to temporary
            directories that are removed.
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
6c. sharded the sharded backend (``repro_torch.core.distributed``) on
            ``torch.distributed`` ranks, each a child process on the card
            (one ``FileStore``, a 1-D ``DeviceMesh`` over axis "data";
            each spawn's children have 180-360 s and each process group
            300 s, and a hang or a non-zero exit fails the phase; no NCCL
            collective runs at world 1), three spawns:
            world 1 on NCCL: Boats with ``methods="auto"`` and ``"eig"`` and
            HSI with ``"auto"`` at full size (``mode_order="shrink"``, as in
            main): ``impl="auto"`` + the mesh must resolve to ``sharded``
            computing on ``hopper``; against the single-device hopper plan
            on the same input rel_error <= 0.02, projector gap <= 1e-3 and
            |d rel_error| <= 1e-4 (whether the results are bitwise equal is
            printed); warm executes timed beside the hopper plan's captured
            and eager sweeps (the sharded layer's own overhead).
            world 4 on gloo, four processes time-sharing the one card (no
            speed-up measure): the same cases plus HSI at
            ``mode_parallel=2`` and ``"auto"``, each rank passing the global
            input: the same checks on rank 0, every rank's factors bitwise
            equal to rank 0's, ``describe()``'s shard modes, and the calls,
            bytes and ms of each collective (one execute with the device
            synchronized around each collective); then the per-device cap:
            Boats with ``mode_order="opt"`` under half the least cap the
            single-device hopper search admits — that plan must refuse it
            and the 4-way plan admit it — each rank making only its slab on
            the card and passing it as a ``DTensor``; step by step, the
            slab plus what is allocated beyond it within the cap and within
            each step's modeled peak on every rank, rel_error <= 0.02 over
            the mesh.  world 2 on gloo: ``TuckerBatchEngine(mesh=...)`` on 6
            requests of three shapes, against the single-device engine.
            On worlds 4 and 2, ``service``: every rank starts a mesh
            ``TuckerService`` (rank 0 decides the waves, expiry and the
            breaker) and submits the same 24 requests of the engine's
            shapes at ranks (4, 4, 4), ``methods="eig"``, waves of 4; four
            carry a deadline only rank 0's clock has passed, and the last
            rank's ``wave`` seam raises once; the outcome of every rid (a
            digest or an error class) equal on every rank, the factors
            bitwise equal across ranks, each unexpired result bitwise the
            synchronous mesh service's (``drain()``), exactly the four
            expired.  ``ttt``, ``matmul`` and ``ttm_interior`` must launch
            on every rank of every full-size case and of ``service``.
8. kernels  one JSON line listing every kernel with its numbers (the TTT
            row carries the Gram's under "gram" and the range sample's under
            "sketch", the GEMM row its wide route's under "wide";
            ``launches_adaptive`` counts the adaptive phase,
            ``launches_tucker_serve`` the streams of tucker_serve,
            ``launches_sharded`` the sharded phase's ranks,
            ``launches_train`` and ``launches_ckpt_codec`` phase 6d's,
            ``launches_ckpt_codec_dense`` phase 6a's codec,
            ``launches_ckpt_codec_moe`` phase 6e's,
            ``launches_service`` the sharded phase's service cases; the
            ``s6_scan_bwd`` row's launches are the train phase's), after a
            ``run`` line with the whole run's seconds; then the
            ``nvidia-smi`` name/power-limit line; then the final
            ``{"ok": true, "device": ...}`` line.

``python3 chip_smoke.py --only kernels`` runs phases 1-3 only (the quick
check after a kernel edit), ``--only tune`` phases 1, 2 and 7 (the
command that trains the shipped cuda models), ``--only tucker_serve``
phases 1, 2 and 6b, ``--only sharded`` phases 1, 2 and 6c, ``--only
train`` phases 1, 2, the S6 scan's and its backward's checks of phase 3
and 6d, ``--only dense`` phases 1, 2 and 6a, and ``--only families``
phases 1, 2 and 6e; none prints the kernels line.  The whole script runs
6e after 6a.

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
CAVITY = ((100, 100, 10000), (20, 20, 20))
MNIST = ((784, 5000, 10), (65, 142, 10))
#: the Table III cases whose inputs come from a generator of their own (so
#: that main's seed-0 stream, which the graphs phase replays, is unshifted),
#: and the routes each must launch: cavity's last mode at R = 20 (its ALS
#: GEMM on the last-mode wide route, its TTT on wgmma_cols), mnist's mode 1
#: at R = 142 (the interior TTM's wide route, the TTT on 128-column tiles
#: with plain loads at B = 10) and mode 0 at R = 65 (the TTT on TMA)
OWN_SEED = 13
WANT_ROUTES = {"cavity": {"matmul": ("wide/last",), "ttt": ("wgmma_cols/ttt",)},
               "mnist": {"ttm_interior": ("wide",),
                         "ttt": ("wgmma_plain/ttt", "wgmma_tma/ttt")}}
#: adaptive-path inputs: HSI's shape at its ranks, and at wider ranks that
#: make two modes double their sketch width twice (16 -> 32 -> 64)
ADAPT_HSI = HSI
ADAPT_WIDE = ((1021, 1340, 33, 8), (40, 40, 10, 5))
#: adapt_wide's certified bound on hopper against matfree on the same
#: input: the wide routes' sums must not lean (a truncating accumulator
#: summed over 32-deep stages put them 1.7e-5 apart)
WIDE_BOUND_GAP = 2e-6
KERNELS = {
    "ttt": dict(source="src/repro_torch/csrc/ttt.cu",
                replaces="src/repro/kernels/ttt.py:37"),
    "matmul": dict(source="src/repro_torch/csrc/matmul.cu",
                   replaces="src/repro/kernels/matmul.py:34"),
    "ttm_interior": dict(source="src/repro_torch/csrc/ttm.cu",
                         replaces="src/repro/kernels/ttm.py:39"),
    "s6_scan": dict(source="src/repro_torch/csrc/s6_scan.cu",
                    replaces="src/repro/kernels/s6_scan.py:51"),
    # no Pallas kernel: the reference's training differentiates its jnp
    # chunked scan
    "s6_scan_bwd": dict(source="src/repro_torch/csrc/s6_scan_bwd.cu",
                        replaces="none (jax.grad of src/repro/models/ssm.py:69"
                                 " _s6_scan)"),
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
#: the S6 scan's shape in the train phase: (B, T, Di, N) of falcon-mamba-7b
#: at 2 sequences of 2048 tokens
TRAIN_S6 = (2, 2048, 8192, 16)
#: the codec on hopper against matfree, the same methods on the same leaf:
#: |Δ rel_error| <= CODEC_REL_TOL on every eligible leaf.  (Until the ALS
#: least-squares step kept a numerically singular RᵀR from amplifying its
#: own rounding noise, the near rank-1 stacked a_log came back at 3.0e-3 on
#: hopper against 2.1e-4 on matfree on an H100 at 700 W, and passed only by
#: an energy clause; core/solvers.py _spd_inverse.)
CODEC_REL_TOL = 1e-4
#: the train phase: falcon-mamba-7b at full width cut to TRAIN_LAYERS
#: layers (the training state of 64 does not fit the card: PERF.md §4),
#: TRAIN_STEPS steps of TRAIN_BATCH sequences of TRAIN_SEQ tokens
TRAIN_LAYERS, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 16, 8, 2, 2048


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
    ptxas = {n: [ln.strip()[:160] for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "arning" in ln
                 or "Function properties" in ln]
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
    phase_s6_bwd_shapes(torch)


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


#: the S6 backward's tolerance: each gradient within TOL * max|plain|; an
#: output in bf16 (dx, dB, dC when x is bf16) also within 2**-7 of the
#: entry, since each side rounds its own fp32 sum to bf16 once and two
#: nearby sums may round one bf16 unit (2**-7 relative at most) apart
BF16_UNIT = 2.0 ** -7
S6_GRADS = ("dx", "ddt", "dB", "dC", "da", "dh0")


def close_grad(torch, got, want) -> float:
    """max|got - want| / max|want| of one gradient, checked against TOL
    (plus BF16_UNIT of the entry for a bf16 output)."""
    d = (got.float() - want.float()).abs()
    w = want.float().abs()
    scale = float(w.max())
    room = TOL * max(scale, 1e-30) + (BF16_UNIT * w if got.dtype ==
                                      torch.bfloat16 else 0.0)
    require(bool(torch.isfinite(d).all()) and bool((d <= room).all()),
            f"s6_scan_bwd: max|kernel - plain| = {float(d.max()):.3e} beyond "
            f"{TOL:g} * {scale:.3e}" + (" + 2**-7 |plain|"
                                        if got.dtype == torch.bfloat16 else ""))
    return float(d.max()) / max(scale, 1e-30)


def s6_bwd_check(torch, g, ops, force, dh_final):
    """The backward kernel on one case against s6_scan_bwd_ref: returns the
    worst relative error of each gradient."""
    from repro_torch.kernels import ref, s6_scan_bwd
    s6 = s6_module()
    x, dt, bm, cm, a, h0 = ops
    y, hf, states, stride = s6.forward_with_states(*ops, force_route=force)
    dy = torch.randn(y.shape, generator=g, device="cuda")
    dhf = (torch.randn(hf.shape, generator=g, device="cuda")
           if dh_final else None)
    got = s6_scan_bwd(*ops, dy, dhf, states=states, stride=stride)
    want = ref.s6_scan_bwd_ref(*ops, dy, dhf)
    return {k: close_grad(torch, gv, wv)
            for k, gv, wv in zip(S6_GRADS, got, want)}


def phase_s6_bwd_shapes(torch):
    """The S6 backward kernel against its plain reverse recurrence on the
    card: the shapes of the reference's S6 tests, ragged T, Di and N (every
    state width N = 4 ... 64, one and several state groups), T = 1, a
    nonzero h0 and dh_final, strided B/C, fp32 and bf16, from the
    checkpoints of both forward routes (each keeps the state entering every
    8th step), the chunked route at its chunk edges, and two widths whose
    backward chunks hold several sub-chunks."""
    s6 = s6_module()
    g = torch.Generator(device="cuda").manual_seed(6)
    lc = s6.CHUNK_MIN
    # (B, T, Di, N, strided, h0, dh_final)
    cases = [(2, 128, 64, 8, False, False, False), (1, 64, 32, 4, False, False, True),
             (3, 96, 16, 16, False, True, False), (2, 37, 5, 4, False, True, True),
             (2, 77, 200, 16, True, True, True), (2, 33, 70, 5, True, False, True),
             (1, 40, 48, 32, False, True, False), (1, 50, 40, 64, True, True, True),
             (3, 1, 100, 16, True, True, True), (1, lc - 1, 200, 16, True, True, True),
             (2, lc + 1, 70, 16, True, False, True), (2, 2 * lc + 3, 200, 5, True, True, True),
             (1, 3 * lc + 17, 300, 16, True, False, False),
             (2, 45, 70, 20, True, True, True), (3, 100, 8192, 16, True, True, True),
             (1, 77, 4096, 64, True, True, True)]
    worst = dict.fromkeys(S6_GRADS, 0.0)
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for bsz, t, di, n, strided, h0, dhf in cases:
            ops = s6_inputs(torch, g, bsz, t, di, n, dtype, strided=strided,
                            h0=h0)
            for force in s6.ROUTES:
                errs = s6_bwd_check(torch, g, ops, force, dhf)
                worst = {k: max(worst[k], errs[k]) for k in worst}
                n_cases += 1
    torch.cuda.synchronize()
    emit("kernels_small", name="s6_scan_bwd", cases=n_cases,
         routes=list(s6.ROUTES), dtypes=["float32", "bfloat16"],
         max_rel_err=worst, tol_rel=TOL, bf16_unit=BF16_UNIT, ok=True)


def s6_bwd_bound(bsz, t, di, n, xbytes, peaks):
    """The S6 backward's bound at (bsz, t, di, n): the larger of its bytes
    (x, dt, B, C, a, h0, dy and dh_final read once; dx, ddt, dB, dC, da and
    dh0 written once) over HBM and the exponentials that the gradient
    needs, exp(dt_t·a) once for each (b, t, d, n) as in row 4's bound, over
    the SFU rate.  The kernel takes each three times (the local pass's
    walk, the chunk pass's recompute and walk) and reads the forward's
    checkpoints: that is part of the gap to the bound, not of the bound.
    Returns (terms in ms, the largest's name, bytes, exponentials)."""
    bw, _, _, sfu = peaks
    nbytes = (bsz * t * di * (2 * xbytes + 4 + 4 + 4) + 4 * bsz * t * n * xbytes
              + 2 * di * n * 4 + 3 * bsz * di * n * 4)
    exps = bsz * t * di * n
    terms = {"bytes": nbytes / bw * 1e3, "exponentials": exps / sfu * 1e3}
    return terms, max(terms, key=terms.get), nbytes, exps


def kernel_device_ms(torch, fn, names, runs: int = 5) -> dict:
    """Device ms per call of ``fn`` of each CUDA kernel whose name holds
    one of ``names`` (torch.profiler, ``runs`` warm calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for k in names:
                if k in e.name:
                    out[k] += e.time_range.elapsed_us() / runs / 1e3
    return out


def s6_bwd_full(torch, peaks) -> dict:
    """Row 4b: the S6 backward at the training shape, (B, T, Di, N) = (2,
    2048, 8192, 16), bf16 x and strided B/C as the model gives them, from
    the checkpoints of the route the training forward takes (h0 none):
    held to its plain version, bitwise equal on a second run, timed with
    CUDA events (ms) and under torch.profiler (device_ms, and each of its
    four kernels' device ms beside its registers, spills, shared memory,
    blocks and warps per SM), beside its bound; and the forward's time
    with and without the checkpoints it writes."""
    import importlib
    from repro_torch.kernels import ref
    s6 = s6_module()
    bwd = importlib.import_module("repro_torch.kernels.s6_scan_bwd")
    bsz, t, di, n = TRAIN_S6
    g = torch.Generator(device="cuda").manual_seed(9)
    ops = s6_inputs(torch, g, bsz, t, di, n, torch.bfloat16, strided=True,
                    model_dt=True)
    ops = (*ops[:4], model_a(torch, di, n), None)
    _, hf, states, stride = s6.forward_with_states(*ops)
    fwd_ms = {"checkpoints": time_ms(torch, lambda: s6.forward_with_states(*ops)),
              "plain": time_ms(torch, lambda: s6.s6_scan(*ops))}
    dy = torch.randn((bsz, t, di), generator=g, device="cuda")
    dhf = torch.zeros_like(hf)

    def call():
        return bwd.s6_scan_bwd(*ops, dy, dhf, states=states, stride=stride)
    got, again = call(), call()
    require(all(torch.equal(p, q) for p, q in zip(got[:5], again[:5])),
            "s6_scan_bwd: two runs on the same inputs differ")
    want = ref.s6_scan_bwd_ref(*ops, dy, dhf)
    errs = {k: close_grad(torch, gv, wv)
            for k, gv, wv in zip(S6_GRADS[:5], got[:5], want[:5])}
    max_abs = max(float((gv.float() - wv.float()).abs().max())
                  for gv, wv in zip(got[:5], want[:5]))
    del got, again, want
    terms, by, nbytes, exps = s6_bwd_bound(bsz, t, di, n, 2, peaks)
    # the device memory one layer's scan adds under training: the forward
    # with its checkpoints, then the backward's outputs and scratch
    del states
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _, _, states, _ = s6.forward_with_states(*ops)
    grads = bwd.s6_scan_bwd(*ops, dy, dhf, states=states, stride=stride)
    torch.cuda.synchronize()
    s6_peak = torch.cuda.max_memory_allocated() - held
    del grads
    launch = bwd.launch_info(bsz, t, di, n, torch.bfloat16)
    per_kernel = kernel_device_ms(torch, call, [
        f"s6_bwd_{k}_kernel" for k in bwd.KERNEL_NAMES])
    for row in launch:
        row["device_ms"] = per_kernel[f"s6_bwd_{row['kernel']}_kernel"]
    out = dict(shapes=[bsz, t, di, n], route=s6.route(bsz, t, di),
               checkpoint_stride=stride, chunk_len=launch[0]["chunk_len"],
               checkpoint_bytes=states.numel() * 4, peak_bytes=s6_peak,
               forward_ms=fwd_ms,
               max_abs_err=max_abs, max_rel_err=errs,
               bitwise_repeat=True, ms=time_ms(torch, call),
               device_ms=device_ms(torch, call),
               plain_ms=time_ms(torch, lambda: ref.s6_scan_bwd_ref(
                   *ops, dy, dhf), runs=1),
               bound_ms=terms[by], bound_by=("bytes" if by == "bytes"
                                             else "operations"),
               bound_terms_ms=terms, bytes=nbytes, exponentials=exps,
               library_ms=None, launch=launch)
    emit("kernel_full", name="s6_scan_bwd", **out)
    del ops, states, dy
    torch.cuda.empty_cache()
    return out


def phase_ttt_wide_shapes(torch):
    """The tensor-core routes of the TTT/Gram kernel (R > 16) on every
    route, fp32 (split TF32, three products) and bf16 (one product): TMA
    (rows of a 16-byte multiple of at least 128 bytes, aligned; B = 40, 48,
    64, 264, 600), and the plain-load route for rows of other lengths (B =
    10, 19, 33, 70), a B = 1 Gram (MN-major operands) and a misaligned
    base; a TTT of B = 1 on wgmma_cols (the wide GEMM, split along A: one
    to 18 splits; TMA and plain loads, misaligned).  Grams of one to
    several 128-row tiles (diagonal and upper tiles, ragged I, split and
    unsplit reductions) and TTTs with R = 20 to 200 across tiles, on
    output tiles 32, 64 and 128 columns wide (tile_r).  Each is held per
    entry against ttt_ref's einsum in float64 (ENTRY_TOL of sqrt(ttt(x∘x,
    y∘y))).  Fails unless every route ran in both dtypes, and each tile
    width."""
    from repro_torch.kernels import ttt3
    ttt = ttt_module()
    g = torch.Generator(device="cuda").manual_seed(9)
    # (x3 shape, R of y3; None: the Gram, y3 is x3)
    cases = [((7, 300, 40), None), ((5, 200, 264), None), ((9, 100, 64), None),
             ((2, 150, 600), None), ((6, 150, 48), 40), ((4, 70, 264), 200),
             ((3, 150, 70), None), ((40, 260, 33), 30), ((5, 37, 19), None),
             ((273, 40, 1), None), ((300, 130, 1), 20),
             # the fitted tiles (R = 20 -> 32, 64 -> 64, 142 -> 128) on TMA
             # and plain loads, and wgmma_cols at R = 20 ... 200, split
             ((9, 300, 264), 20), ((9, 300, 264), 64), ((9, 300, 10), 20),
             ((9, 300, 10), 142), ((300, 130, 1), 130), ((2000, 1000, 1), 200),
             ((5000, 300, 1), 64), ((3000, 257, 1), 20)]
    worst, n, routes, tiles = 0.0, 0, {}, set()
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
        flat = rnd(300 * 150 + 1)             # B = 1 on wgmma_cols, misaligned
        ops.append((flat[1:300 * 130 + 1].view(300, 130, 1),
                    flat[1 + 300 * 130:].view(300, 20, 1), True))
        for x, y, b1 in ops:
            rt = ttt.call_route(x, y)
            require(rt.startswith("wgmma"), f"ttt: {tuple(x.shape)} took {rt}")
            aligned = x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
            kind = "b1" if b1 else "misaligned" if not aligned else \
                "gram" if y is x else "ttt"
            if rt == "wgmma_cols" and not aligned:
                kind = "b1_misaligned"
            key = f"{rt}/{kind}/{str(dtype)[6:]}"
            routes[key] = routes.get(key, 0) + 1
            info = ttt.launch_info(x, y)[0]
            tiles.add(f"{rt}/{info['tile'][1]}/{str(dtype)[6:]}")
            worst = max(worst, entry_err(torch, ttt3(x, y), x, y))
            n += 1
    torch.cuda.synchronize()
    for want in ("wgmma_tma/gram", "wgmma_tma/ttt", "wgmma_plain/gram",
                 "wgmma_plain/ttt", "wgmma_plain/b1", "wgmma_plain/misaligned",
                 "wgmma_cols/b1", "wgmma_cols/b1_misaligned"):
        for dt in ("float32", "bfloat16"):
            require(f"{want}/{dt}" in routes,
                    f"ttt: no small case took {want} in {dt}")
    for want in ("wgmma_tma/32", "wgmma_tma/64", "wgmma_tma/128",
                 "wgmma_plain/32", "wgmma_plain/128"):
        for dt in ("float32", "bfloat16"):
            require(f"{want}/{dt}" in tiles,
                    f"ttt: no small case ran {want}-column tiles in {dt}")
    emit("kernels_small", name="ttt_wide", cases=n, routes=routes,
         tiles=sorted(tiles), dtypes=["float32", "bfloat16"],
         max_entry_err=worst, entry_tol=ENTRY_TOL, ok=True)


#: first-mode GEMMs of the wide route in kernels_small: every R with K = 7
#: and K = 1021, N cycling through an odd width (plain loads), a 16-byte
#: multiple for fp32 only and one for both dtypes (TMA); R = 130 and 300
#: split R between the warpgroups and cross a chunk of 128
MATMUL_WIDE_CASES = [(r, k, (1283, 2052, 2056)[j % 3]) for j, (r, k) in
                     enumerate((r, k) for r in (17, 24, 40, 64, 130, 300)
                               for k in (7, 1021))]
#: last-mode GEMMs x (M, K) @ uᵀ (K, R) of the wide route in kernels_small:
#: every R with K = 7 and 1021 (rows of x no 16-byte multiple: plain
#: loads) and 1024 (TMA), M = 2053 (16 tiles and a ragged one)
MATMUL_LAST_CASES = [(r, k, 2053) for r in (17, 20, 40, 64, 130, 300)
                     for k in (7, 1021, 1024)]


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


def energy_bias(got, want) -> float:
    """(‖got‖² - ‖want‖²) / ‖want‖², in float64: how far the sums of a
    route lean toward zero (a truncating accumulator) or away from it."""
    e = float(want.double().square().sum())
    return (float(got.double().square().sum()) - e) / e


#: the wide route's energy bias, measured at adapt_wide's mode-0 depth: u
#: (64, 1021) @ x (1021, 65536), seed 12
BIAS_SHAPE = (64, 1021, 65536)
#: |energy bias| an fp32 input may show (the tests' limit on the emulation),
#: and the most a bf16 input's truncating stage sums may read high (the
#: rounding of the fp32 adds of the stage sums, nothing more)
BIAS_TOL, BF16_BIAS_TOL = 3e-8, 2e-9


def bias_operands(torch, kind: str, g):
    """u (64, 1021) and x (1021, 65536) on the card for an energy-bias case:
    ``normal`` (standard normal, adapt_wide's signed data), ``uint8``
    (x whole numbers 0..255 as a video's pixels, u orthonormal rows),
    ``positive`` (x = 3|z| + 1, a radiance cube's positive values),
    ``both_positive`` (x as uint8, u's rows positive: a nonnegative
    tensor's leading direction, where the products share one sign) and
    ``bf16`` (normal, rounded to bf16: one product a k-step)."""
    r, k, n = BIAS_SHAPE
    u = torch.randn((r, k), generator=g, device="cuda")
    if kind == "normal" or kind == "bf16":
        x = torch.randn((k, n), generator=g, device="cuda")
    elif kind == "positive":
        x = torch.randn((k, n), generator=g, device="cuda").abs() * 3 + 1
    else:
        x = torch.randint(0, 256, (k, n), generator=g, device="cuda").float()
    if kind == "both_positive":
        u = u.abs() + 1
        u = u / u.norm(dim=1, keepdim=True)
    elif kind != "bf16":
        u = torch.linalg.qr(u.T.double())[0].T.float().contiguous()
    if kind == "bf16":
        u, x = u.bfloat16(), x.bfloat16()
    return u, x


def wide_energy_bias(torch) -> dict:
    """The energy bias of the wide route's sums on the card (one call of
    the kernel against the float64 product of its operands) on signed,
    nonnegative, whole-number and bf16 data, beside the emulation of its
    scheme (``matmul_tf32x3_ref(truncate=True, scheme="grid")``) and of the
    stage sums it replaced (``scheme="stage"``) on the normal operands.
    Fails when an fp32 case's |bias| reaches BIAS_TOL or the bf16 case
    reads more than BF16_BIAS_TOL high."""
    from repro_torch.kernels import matmul, ref
    g = torch.Generator(device="cuda").manual_seed(12)
    out = dict(shape=list(BIAS_SHAPE))
    for kind in ("normal", "uint8", "positive", "both_positive", "bf16"):
        u, x = bias_operands(torch, kind, g)
        exact = u.double() @ x.double()
        out[kind] = energy_bias(matmul(u, x), exact)
        # the last mode on the same data: xᵀ (65536, 1021) @ uᵀ (1021, 64)
        out[f"last_{kind}"] = energy_bias(
            matmul(x.T.contiguous(), u.T.contiguous()), exact.T)
        if kind == "normal":
            out["emulated_grid"] = energy_bias(ref.matmul_tf32x3_ref(
                u, x, truncate=True, scheme="grid"), exact)
            out["emulated_stage"] = energy_bias(ref.matmul_tf32x3_ref(
                u, x, truncate=True, scheme="stage"), exact)
            out["plain_fp32"] = energy_bias(ref.matmul_ref(u, x), exact)
        if kind == "bf16":
            out["emulated_bf16"] = energy_bias(ref.matmul_tf32x3_ref(
                u, x, products=1, truncate=True, scheme="grid"), exact)
        del u, x, exact
    torch.cuda.empty_cache()
    bad = {p + k: out[p + k] for k in ("normal", "uint8", "positive",
                                       "both_positive") for p in ("", "last_")
           if not abs(out[p + k]) < BIAS_TOL}
    for k in ("bf16", "last_bf16"):
        if not out[k] <= BF16_BIAS_TOL:
            bad[k] = out[k]
    require(not bad, f"wide route energy bias out of bounds: {bad} (fp32 "
          f"|bias| < {BIAS_TOL:g}, bf16 <= {BF16_BIAS_TOL:g})")
    return out


def matmul_module():
    """The wrapper module of the boundary GEMM (the package attribute
    ``matmul`` is the function)."""
    import importlib
    return importlib.import_module("repro_torch.kernels.matmul")


def phase_matmul_wide_shapes(torch):
    """The wide route of the boundary GEMM (R > 16) on MATMUL_WIDE_CASES
    (the first mode) and MATMUL_LAST_CASES (the last mode, x read
    K-major), each side also on an x whose base is not 16-byte aligned,
    fp32 (split TF32, three products) and bf16 (one product): each held per
    entry against ``matmul_ref``'s product in float64 (ENTRY_TOL of
    sqrt((a∘a) @ (b∘b))) and against ``matmul_ref`` itself
    (max|kernel - plain| <= TOL max|plain|).  Fails unless every case took
    the wide route on its side -- the C library's report, checked against
    route() and side() -- and both of x's loads (TMA, plain) ran on both
    sides in both dtypes."""
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
        ops += [(rnd(m, k), rnd(k, r)) for r, k, m in MATMUL_LAST_CASES]
        flat = rnd(2053 * 1024 + 1)
        ops.append((flat[1:].view(2053, 1024), rnd(1024, 40)))
        for a, b in ops:
            info = mm.launch_info(a, b)[0]
            require(info["route"] == "wide",
                    f"matmul: {tuple(a.shape)} @ {tuple(b.shape)} took "
                    f"{info['route']}")
            key = f"{info['side']}/{info['loads']}/{str(dtype)[6:]}"
            seen[key] = seen.get(key, 0) + 1
            got = matmul(a, b)
            worst_plain = max(worst_plain, close(got, ref.matmul_ref(a, b)))
            worst = max(worst, gemm_entry_err(torch, got, a, b))
            n += 1
    torch.cuda.synchronize()
    for want in ("first/tma", "first/plain", "last/tma", "last/plain"):
        for dt in ("float32", "bfloat16"):
            require(f"{want}/{dt}" in seen,
                    f"matmul: no small case loaded x by {want} in {dt}")
    emit("kernels_small", name="matmul_wide", cases=n, loads=seen,
         dtypes=["float32", "bfloat16"], max_entry_err=worst,
         entry_tol=ENTRY_TOL, max_abs_err=worst_plain, tol_rel=TOL,
         energy_bias=wide_energy_bias(torch), ok=True)


def ttm_module():
    """The wrapper module of the interior TTM (the package attribute
    ``ttm_interior`` is the function)."""
    import importlib
    return importlib.import_module("repro_torch.kernels.ttm")


def phase_ttm_shapes(torch):
    """The interior TTM on its own: R across the widths the FFMA routes
    template (4, 10, 16) and the wide route's (20, 40, 64; 100 splits R
    between the warpgroups, 130 crosses a chunk of 128), B = 1 and 8 (plain
    loads on both routes), 264 (the FFMA ring on tiles of whole values of
    a; the wide route's TMA boxes, 264 of 288 columns filled) and 1536 (the
    ring on 1024-column ranges that cut across values of a), u in two
    shared-memory segments (I = 2000 at R = 16), K = 1340 (a ragged last
    stage), and x at an address that is not 16-byte aligned (plain loads),
    fp32 and bf16.  Each is held against ``ttm_interior_ref``; the wide
    route also against its arithmetic written out, ``ttm_tf32x3_ref``
    (TOL), and per entry against the float64 product (ENTRY_TOL of
    sqrt((u∘u) @ (x∘x))).  Fails unless each route ran, and the wide route
    with both of x's loads in both dtypes -- the C library's report,
    checked against route() and loads()."""
    from repro_torch.kernels import ref, ttm_interior
    tm = ttm_module()
    g = torch.Generator(device="cuda").manual_seed(7)
    worst, worst_emu, worst_entry, n, seen = 0.0, 0.0, 0.0, 0, {}
    for dtype in (torch.float32, torch.bfloat16):
        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda").to(dtype)
        cases = [(rnd(r, 45), rnd(7, 45, b)) for r in (4, 10, 16, 20, 40, 64)
                 for b in (1, 8, 264)]
        cases += [(rnd(r, 45), rnd(3, 45, 1536)) for r in (10, 20)]
        cases += [(rnd(100, 45), rnd(5, 45, 264)), (rnd(130, 33), rnd(4, 33, 8)),
                  (rnd(64, 1340), rnd(3, 1340, 264))]
        cases.append((rnd(16, 2000), rnd(3, 2000, 264)))
        flat = rnd(5 * 37 * 264 + 1)
        cases += [(rnd(r, 37), flat[1:].view(5, 37, 264)) for r in (10, 40)]
        for u, x in cases:
            info = tm.launch_info(u, x)[0]
            key = info["route"] + (f"/{info['loads']}" if "loads" in info else "")
            key += f"/{str(dtype)[6:]}"
            seen[key] = seen.get(key, 0) + 1
            got = ttm_interior(u, x)
            worst = max(worst, close(got, ref.ttm_interior_ref(u, x)))
            if info["route"] == "wide":
                worst_emu = max(worst_emu, close(got, ref.ttm_tf32x3_ref(u, x)))
                cols = x.transpose(0, 1).reshape(x.shape[1], -1)
                worst_entry = max(worst_entry, gemm_entry_err(
                    torch, got.transpose(0, 1).reshape(u.shape[0], -1), u, cols))
            n += 1
    torch.cuda.synchronize()
    for want in ("slab", "plain", "wide/tma", "wide/plain"):
        for dt in ("float32", "bfloat16"):
            require(f"{want}/{dt}" in seen,
                    f"ttm_interior: no small case took {want} in {dt}")
    emit("kernels_small", name="ttm_interior", cases=n, routes=seen,
         dtypes=["float32", "bfloat16"], max_abs_err=worst,
         wide_max_abs_err_vs_emulation=worst_emu, wide_max_entry_err=worst_entry,
         entry_tol=ENTRY_TOL, tol_rel=TOL, ok=True)


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
    uw2 = rnd(1000, 40)         # ... on the last mode
    y, yc = rnd(2048, 10, 1000), rnd(2048 * 1100, 10, 1)
    yw = rnd(2048 * 1100, 20, 1)    # the B = 1 TTT on wgmma_cols
    cases = {
        "ttt": (lambda: ttt3(x, y), lambda: ref.ttt_ref(x, y)),
        "ttt_cols": (lambda: ttt3(xc, yc), lambda: ref.ttt_ref(xc, yc)),
        "matmul_first": (lambda: matmul(u0, x.view(2048, -1)),
                         lambda: ref.matmul_ref(u0, x.view(2048, -1))),
        "matmul_first_wide": (lambda: matmul(uw, x.view(2048, -1)),
                              lambda: ref.matmul_ref(uw, x.view(2048, -1))),
        "matmul_last": (lambda: matmul(x.view(-1, 1000), u2),
                        lambda: ref.matmul_ref(x.view(-1, 1000), u2)),
        "matmul_last_wide": (lambda: matmul(x.view(-1, 1000), uw2),
                             lambda: ref.matmul_ref(x.view(-1, 1000), uw2)),
        "ttt_cols_wide": (lambda: ttt3(xc, yw), lambda: ref.ttt_ref(xc, yw)),
        "ttm_interior": (lambda: ttm_interior(u1, x),
                         lambda: ref.ttm_interior_ref(u1, x)),
    }
    errs = {}
    for name, (kernel, plain) in cases.items():
        errs[name] = close(kernel(), plain())
        torch.cuda.empty_cache()
    del xc, y, yc, yw
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
    out["s6_scan_bwd"] = s6_bwd_full(torch, peaks)

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
    # row 2c: Boats' last mode at R = 64, x2 (76800, 7000) @ u^T (7000, 64),
    # on the wide route (one pass over x, read K-major), its flop priced by
    # tf32x3_bound; beside it the slab route it replaced (128 x 16 tiles,
    # run as four R = 16 calls on the same x, each reading x), per-entry
    # errors in units of sqrt((x∘x) @ (u∘u)) on the first 8,192 rows
    b = rnd(7000, 64)
    c_bytes, c_flops = 4 * (a.numel() + b.numel() + 76800 * 64), \
        2.0 * 76800 * 7000 * 64
    bnd, terms = tf32x3_bound(c_bytes, c_flops)
    require(matmul_mod.route(76800, 64) == "wide", "row 2c: not the wide route")
    measure("matmul_last_r64", "(76800, 7000) @ (7000, 64) fp32",
            lambda: matmul(a, b), lambda: ref.matmul_ref(a, b),
            lambda: torch.matmul(a, b), c_bytes, c_flops,
            matmul_mod.launch_info(a, b), b=bnd)
    bs = [b[:, i:i + 16].contiguous() for i in range(0, 64, 16)]

    def slab():
        return [matmul(a, q) for q in bs]
    row = out["matmul_last_r64"]
    row.update(route="wide", side="last", bound_terms_ms=terms,
               max_entry_err=gemm_entry_err(torch, matmul(a[:8192], b),
                                            a[:8192], b),
               slab_ms=time_ms(torch, slab), slab_device_ms=device_ms(torch, slab),
               slab_launch=matmul_mod.launch_info(a, bs[0]))
    row["bytes_per_s"] = c_bytes / (row["device_ms"] * 1e-3)
    emit("kernel_full", name="matmul_last_r64", **{k: row[k] for k in (
        "route", "side", "bound_terms_ms", "max_entry_err", "slab_ms",
        "slab_device_ms", "slab_launch", "bytes_per_s")})
    del x, y, a, b, bs
    torch.cuda.empty_cache()
    phase_cavity_full(torch, rnd, tf32x3_bound, measure, out)
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
    # row 3b, the sketch's projection of an interior mode at ℓ = 64, on the
    # wide route (one pass over x, split-TF32 wgmma), its 2·A·B·I·ℓ flop
    # priced by tf32x3_bound; beside it the route it replaced, 16-row
    # slabs each reading x (run as R = 16 calls on the same u and x, which
    # take the FFMA ring), per-entry errors in units of sqrt((u∘u) @
    # (x∘x)), the energy bias of the sums, and the tile fill (264 of 288
    # columns: TMA boxes do not straddle two values of a)
    u = rnd(64, 1340)
    require(ttm_mod.route(64, 264) == "wide", "ttm_interior R = 64: not wide")
    t_bytes, t_flops = 4 * (x.numel() + u.numel() + 1021 * 64 * 264), \
        2.0 * 1021 * 264 * 1340 * 64
    b, terms = tf32x3_bound(t_bytes, t_flops)
    measure("ttm_interior_l64", "u (64, 1340), x (1021, 1340, 264) fp32",
            lambda: ttm_interior(u, x), lambda: ref.ttm_interior_ref(u, x),
            lambda: torch.matmul(u, x), t_bytes, t_flops,
            ttm_mod.launch_info(u, x), b=b)
    row = out["ttm_interior_l64"]

    def slab():
        return [ttm_interior(u[i:i + 16], x) for i in range(0, 64, 16)]
    got = ttm_interior(u, x)
    row.update(route="wide", bound_terms_ms=terms,
               tile_fill=264 / (math.ceil(264 / 32) * 32),
               slab_ms=time_ms(torch, slab),
               slab_device_ms=device_ms(torch, slab),
               slab_launch=ttm_mod.launch_info(u[:16], x),
               **ttm_exactness(torch, got, torch.cat(slab(), dim=1), u, x))
    row["bytes_per_s"] = t_bytes / (row["device_ms"] * 1e-3)
    del got
    emit("kernel_full", name="ttm_interior_l64", **{k: row[k] for k in (
        "route", "bound_terms_ms", "tile_fill", "slab_ms", "slab_device_ms",
        "slab_launch", "max_entry_err", "slab_max_entry_err", "energy_bias",
        "slab_energy_bias", "bytes_per_s")})
    del u
    phase_matmul_wide_full(torch, x.view(1021, -1), rnd, tf32x3_bound,
                           measure, out)
    # the Gram's bf16 row: the same x rounded to bf16 (one product a
    # k-step), its I(I+1)/2 entries' flop at the dense bf16 rate (twice
    # TF32's), per entry against float64
    xb = x.bfloat16()
    del x
    torch.cuda.empty_cache()
    gb_bytes = 2 * xb.numel() + 4 * 1340 * 1340
    t_b, t_f = gb_bytes / bw * 1e3, g_flops / (2 * tf32) * 1e3
    measure("gram_bf16", "x (1021, 1340, 264) bf16 -> (1340, 1340)",
            lambda: ttt3(xb, xb), lambda: ref.gram_ref(xb),
            lambda: torch.tensordot(xb, xb, dims=([0, 2], [0, 2])),
            gb_bytes, g_flops, ttt_mod.launch_info(xb, xb),
            b=(t_b, "bytes") if t_b >= t_f else (t_f, "operations"))
    out["gram_bf16"].update(
        route=ttt_mod.call_route(xb, xb),
        bound_terms_ms={"bytes": t_b, "bf16": t_f},
        max_entry_err=entry_err(torch, ttt3(xb, xb), xb, xb),
        entry_tol=ENTRY_TOL)
    emit("kernel_full", name="gram_bf16", route=out["gram_bf16"]["route"],
         max_entry_err=out["gram_bf16"]["max_entry_err"])
    del xb
    torch.cuda.empty_cache()
    phase_mnist_ttm_full(torch, rnd, tf32x3_bound, measure, out)
    return out


def phase_cavity_full(torch, rnd, tf32x3_bound, measure, out):
    """Rows 2d and 1d: Cavity's last mode (the paper's Table III, (100, 100,
    10000) at ranks (20, 20, 20)) as its ALS iterations run it, the GEMM x
    (10000, 10000) @ uᵀ (10000, 20) on the wide route and the TTT of x
    (10000, 10000, 1) with y (10000, 20, 1) on wgmma_cols, each beside
    torch.matmul / tensordot, the plain version and its bound (400 MB of
    x: bytes), per entry against the float64 product."""
    from repro_torch.kernels import matmul, ref, ttt3
    mm, tt = matmul_module(), ttt_module()
    x, u = rnd(10000, 10000), rnd(10000, 20)
    nbytes = 4 * (x.numel() + u.numel() + 10000 * 20)
    flops = 2.0 * 10000 * 10000 * 20
    b, terms = tf32x3_bound(nbytes, flops)
    require(mm.route(10000, 20) == "wide", "row 2d: not the wide route")
    measure("matmul_cavity", "(10000, 10000) @ (10000, 20) fp32",
            lambda: matmul(x, u), lambda: ref.matmul_ref(x, u),
            lambda: torch.matmul(x, u), nbytes, flops, mm.launch_info(x, u),
            b=b)
    out["matmul_cavity"].update(
        route="wide", side="last", bound_terms_ms=terms,
        max_entry_err=gemm_entry_err(torch, matmul(x, u), x, u))
    emit("kernel_full", name="matmul_cavity", bound_terms_ms=terms,
         max_entry_err=out["matmul_cavity"]["max_entry_err"])
    x3, y3 = x.view(10000, 10000, 1), u.view(10000, 20, 1)
    require(tt.call_route(x3, y3) == "wgmma_cols",
            f"row 1d: took {tt.call_route(x3, y3)}, not wgmma_cols")
    measure("ttt_cavity", "x (10000, 10000, 1), y (10000, 20, 1) fp32 -> "
            "(10000, 20)", lambda: ttt3(x3, y3), lambda: ref.ttt_ref(x3, y3),
            lambda: torch.tensordot(x3, y3, dims=([0, 2], [0, 2])),
            nbytes, flops, tt.launch_info(x3, y3), b=b)
    out["ttt_cavity"].update(
        route="wgmma_cols", bound_terms_ms=terms,
        max_entry_err=entry_err(torch, ttt3(x3, y3), x3, y3),
        entry_tol=ENTRY_TOL)
    emit("kernel_full", name="ttt_cavity", bound_terms_ms=terms,
         max_entry_err=out["ttt_cavity"]["max_entry_err"])
    del x, u, x3, y3
    torch.cuda.empty_cache()


def phase_mnist_ttm_full(torch, rnd, tf32x3_bound, measure, out):
    """Row 3c: MNIST's mode-1 TTM (the paper's Table III, (784, 5000, 10)
    at ranks (65, 142, 10)), u (142, 5000) against x (784, 5000, 10) on the
    interior TTM's wide route: a chunk of 128 outputs, the two warpgroups
    splitting it (the SPLIT instantiation), then one of 14; rows of x of
    40 bytes take the plain loads.  Beside torch.matmul, the plain version,
    its bound and per-entry errors."""
    from repro_torch.kernels import ref, ttm_interior
    tm = ttm_module()
    x, u = rnd(784, 5000, 10), rnd(142, 5000)
    nbytes = 4 * (x.numel() + u.numel() + 784 * 142 * 10)
    flops = 2.0 * 784 * 10 * 5000 * 142
    b, terms = tf32x3_bound(nbytes, flops)
    require(tm.route(142, 10) == "wide", "row 3c: not the wide route")
    measure("ttm_interior_r142", "u (142, 5000), x (784, 5000, 10) fp32",
            lambda: ttm_interior(u, x), lambda: ref.ttm_interior_ref(u, x),
            lambda: torch.matmul(u, x), nbytes, flops, tm.launch_info(u, x),
            b=b)
    got = ttm_interior(u, x)
    cols = x.transpose(0, 1).reshape(5000, -1)
    out["ttm_interior_r142"].update(
        route="wide", bound_terms_ms=terms,
        max_entry_err=gemm_entry_err(
            torch, got.transpose(0, 1).reshape(142, -1), u, cols))
    emit("kernel_full", name="ttm_interior_r142", bound_terms_ms=terms,
         max_entry_err=out["ttm_interior_r142"]["max_entry_err"])
    del x, u, got, cols
    torch.cuda.empty_cache()


def ttm_exactness(torch, got, slab, u, x) -> dict:
    """Per-entry errors (ENTRY_TOL of sqrt((u∘u) @ (x∘x)), checked for the
    kernel) and energy biases of a TTM's output ``got`` and of the slab
    route's ``slab`` against the float64 product, over chunks of a."""
    err = slab_err = 0.0
    sums = [0.0, 0.0, 0.0]
    ud, u2 = u.double(), u.double().square()
    for lo in range(0, x.shape[0], 64):
        xd = x[lo:lo + 64].double()
        want = torch.matmul(ud, xd)
        scale = torch.matmul(u2, xd.square_()).sqrt_().clamp_min_(1e-300)
        del xd
        for i, v in enumerate((got, slab)):
            d = (v[lo:lo + 64].double() - want).abs_().div_(scale)
            if i == 0:
                err = max(err, float(d.max()))
            else:
                slab_err = max(slab_err, float(d.max()))
        sums[0] += float(want.square().sum())
        sums[1] += float(got[lo:lo + 64].double().square().sum())
        sums[2] += float(slab[lo:lo + 64].double().square().sum())
        del want, scale
    require(math.isfinite(err) and err <= ENTRY_TOL,
            f"ttm wide: max |kernel - exact| / scale = {err:.3e} exceeds "
            f"{ENTRY_TOL:g}")
    return dict(max_entry_err=err, slab_max_entry_err=slab_err,
                entry_tol=ENTRY_TOL,
                energy_bias=(sums[1] - sums[0]) / sums[0],
                slab_energy_bias=(sums[2] - sums[0]) / sums[0])


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


#: profiles ``device_ms`` may take to find one that kept every call's
#: kernels
DEVICE_MS_TRIES = 4


def device_ms(torch, fn, runs: int = 5) -> float:
    """Device time of one call of ``fn``: the CUDA kernels' durations summed
    under torch.profiler over ``runs`` warm calls, divided by ``runs``.
    Unlike CUDA events around a call, it leaves out the host's time, which
    at small shapes is longer than the kernels'.  Every warm call launches
    the same kernels, so a profile whose count of device events is not a
    positive multiple of ``runs`` lost some (the profiler does, now and
    then, on this card): it is taken again, up to DEVICE_MS_TRIES times,
    and then the profile with the most events stands (reported on
    stderr).  A function none of whose profiles kept an event fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best: list = []
    for _ in range(DEVICE_MS_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if events and len(events) % runs == 0:
            best = events
            break
        if len(events) > len(best):
            best = events
    else:
        require(bool(best), f"device_ms: {DEVICE_MS_TRIES} profiles of "
                f"{runs} calls recorded no device event")
        print(f"chip_smoke.py: device_ms kept a profile of {len(best)} "
              f"device events over {runs} calls", file=sys.stderr)
    return sum(e.time_range.elapsed_us() for e in best) / runs / 1e3


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
                gemm_device_ms=gemm_by_route(by_name))


def gemm_by_route(by_name: dict) -> dict:
    """Device ms of the tensor-core GEMMs of csrc/wgmma.cuh and of the
    first-mode slab GEMM, from profiler kernel names: ``wide_kn`` (the wide
    kernel on X (K, N): the first mode, the interior TTM, the TTT's
    wgmma_cols), ``wide_nk`` (x (N, K): the last mode), ``wide_image`` (the
    kernel that splits u) and ``slab`` (contract_kernel's 16 x 128 tile;
    its 128 x 16 tile is the last mode's at R <= 16 and the TTT's)."""
    out = {"wide_kn": 0.0, "wide_nk": 0.0, "wide_image": 0.0, "slab": 0.0}
    for name, us in by_name.items():
        if "wide::image_kernel<" in name:
            out["wide_image"] += us / 1e3
        elif "wide::kernel<" in name:
            args = name.split("wide::kernel<", 1)[1].split(">", 1)[0]
            out["wide_nk" if args.endswith("true") else "wide_kn"] += us / 1e3
        elif "contract_kernel" in name and ", 16, 128, " in name:
            out["slab"] += us / 1e3
    return out


def projector_gap(torch, u1, u2) -> float:
    return float((u1 @ u1.T - u2 @ u2.T).abs().max())


def phase_main(torch):
    from repro_torch import kernels
    from repro_torch.core import TuckerConfig, plan
    cases = [("boats", *BOATS, "auto"), ("hsi", *HSI, "auto"),
             ("hsi_eig", *HSI, "eig"), ("cavity", *CAVITY, "auto"),
             ("mnist", *MNIST, "auto")]
    gen = torch.Generator(device="cuda").manual_seed(0)
    own = torch.Generator(device="cuda").manual_seed(OWN_SEED)
    data = {}
    launched = {k: 0 for k in KERNELS}
    launched["matmul_routes"], launched["ttm_routes"] = {}, {}
    launched["ttt_routes"] = {}
    results = []
    for name, shape, ranks, methods in cases:
        if name in WANT_ROUTES:     # data keeps hsi's input
            x = lowrank(torch, shape, ranks, own)
        else:
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
        by_route = {"matmul": kernels.matmul_route_counts(),
                    "ttm_interior": kernels.ttm_route_counts(),
                    "ttt": kernels.ttt_route_counts()}
        for key, k in (("matmul_routes", "matmul"),
                       ("ttm_routes", "ttm_interior"), ("ttt_routes", "ttt")):
            for rt, v in by_route[k].items():
                launched[key][rt] = launched[key].get(rt, 0) + v
        for k, want in WANT_ROUTES.get(name, {}).items():
            for rt in want:
                require(by_route[k].get(rt, 0) > 0,
                        f"{name}: {k} never launched on route {rt} "
                        f"(routes {by_route[k]})")
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
                   launches_by_route=by_route,
                   profile=profile_call(torch, lambda: p.execute(x), wall))
        if name == "hsi_eig":   # its 1340^2 Gram runs on the tensor cores
            require(row["profile"]["ttt_wide_device_ms"] > 0,
                    "hsi_eig: the Gram never ran on the wgmma route")
        emit("main", **row)
        results.append(row)
        del res, ref_res
        if "als" in p.methods:
            als_gate(torch, "main", name, x, ranks, p.methods,
                     [st.mode for st in p.schedule])
        picks_vs_textbook(torch, name, p, x)
        if name in WANT_ROUTES:
            main_capped(torch, name, p, x)
        del x
    for k in ("ttt", "matmul", "ttm_interior"):
        require(launched[k] > 0, f"kernel {k} never launched on the main path")
    # the graphs phase reuses the last input (hsi) and the rows' peaks
    return launched, data, {r["case"]: r for r in results}


def main_capped(torch, name, p, x) -> dict:
    """The plan of a Table III case under the least memory cap the hopper
    model admits, its steps run one by one on ``x`` (``capped_steps``): the
    input plus what every step allocates stays within the cap and within
    that step's modeled peak, which prices the last mode's GEMM image and
    the B = 1 TTT's workspace."""
    from repro_torch.core import TuckerConfig, plan

    def capped(cap):
        return plan(p.shape, p.dtype, TuckerConfig(
            ranks=p.config.ranks, methods=p.methods, mode_order="shrink",
            impl="hopper", memory_cap_bytes=cap))
    cap = least_cap(capped)
    pc = capped(cap)
    _, _, boundary, inside, _ = capped_steps(torch, name, pc, x, cap)
    x_bytes = x.numel() * x.element_size()
    row = dict(case=name, cap=cap,
               step_peaks=[s.peak_bytes for s in pc.schedule],
               input_plus_inside=[x_bytes + b for b in inside],
               input_plus_boundary=[x_bytes + b for b in boundary])
    emit("main_capped", **row)
    return row


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
    counts["ttm_routes"] = kernels.ttm_route_counts()
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
    troutes = kernels.ttm_route_counts()
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
               matmul_routes=mroutes, ttm_routes=troutes,
               execute_ms=wall, execute_ms_all=times,
               execute_ms_matfree=statistics.median(times_m),
               execute_ms_matfree_all=times_m, peak_bytes=peak,
               profile=profile_call(torch, lambda: p.execute(x), wall),
               profile_matfree=profile_call(torch, lambda: pm.execute(x),
                                            statistics.median(times_m)))
    emit("adaptive", **row)
    by_mode = {t.mode: t.method for t in res.trace}
    if "als" in by_mode.values() and set(by_mode.values()) <= {"eig", "als"}:
        als_gate(torch, "adaptive", name, x, res.tucker.ranks,
                 [by_mode[m] for m in range(x.ndim)],
                 [t.mode for t in res.trace])
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
    counts["ttm_routes"] = kernels.ttm_route_counts()
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
    troutes = counts.pop("ttm_routes")
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
               rel_error=rel, launches=counts, matmul_routes=mroutes,
               ttm_routes=troutes)
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
    troutes = counts.pop("ttm_routes")
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
               matmul_routes=mroutes, ttm_routes=troutes,
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
    require(row["ttm_routes"].get("wide", 0) > 0,
            f"adapt_wide: no interior TTM on the wide route: "
            f"{row['ttm_routes']}")
    gap = abs(row["error_bound"] - row["error_bound_matfree"])
    require(gap <= WIDE_BOUND_GAP,
            f"adapt_wide: the hopper bound {row['error_bound']} is {gap:.3g} "
            f"from matfree's {row['error_bound_matfree']} (limit "
            f"{WIDE_BOUND_GAP:g}): the tensor-core sums lean")
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
    for key in ("ttt_routes", "matmul_routes", "ttm_routes"):
        launched[key] = add_routes(r.get(key, {}) for r in rows)
    return launched


def add_routes(counts) -> dict:
    """Route counts (dicts of route -> launches) added up."""
    out = {}
    for c in counts:
        for rt, v in c.items():
            out[rt] = out.get(rt, 0) + v
    return out


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
# phase 6b: the dense family -- serving gemma2-9b at full width and depth,
# its KV cache against the full forward, and the Tucker codec on its leaves
# ---------------------------------------------------------------------------

#: serve_dense's traffic: two prompts cross gemma2's 4096 window
DENSE_PROMPTS = (37, 1021, 3000, 4097, 6000, 8191)
DENSE_MAX_LEN = 8224
#: (architecture, layers it is cut to (None: all), prompt lengths); full
#: width
DENSE_SERVE = (("gemma2-9b", None, DENSE_PROMPTS),
               ("gemma3-1b", None, DENSE_PROMPTS),
               ("phi3-mini-3.8b", 4, (DENSE_PROMPTS[0], DENSE_PROMPTS[-1])),
               ("minitron-4b", 4, (DENSE_PROMPTS[0], DENSE_PROMPTS[-1])))
#: dense_cache: (architecture, layers = one local:global period), a prompt
#: past gemma2's window, then decode steps through the cache
DENSE_CACHE = (("gemma2-9b", 2), ("gemma3-1b", 6))
CACHE_PROMPT, CACHE_STEPS = 5000, 16
#: the cached decode against the no-cache forward in fp32:
#: max|Δ logits| <= CACHE_TOL * max|logits| (only the order of sums differs)
CACHE_TOL = 1e-4
#: ckpt_codec_dense: gemma2-9b at full width cut to 4 local:global periods
CODEC_DENSE_LAYERS = 8


def serve_lm_case(torch, arch: str, layers, lens, *, phase="serve_dense",
                  bitwise=False, keep=False):
    """``arch`` at full width (cut to ``layers``), bf16, random weights from
    seed 0, on 4 slots with ``max_len`` DENSE_MAX_LEN: one request a prompt
    length of ``lens``, MAX_NEW new tokens each.  Checks 32 valid tokens a
    request and finite logits; prints prefill ms by prompt length (and,
    for an MoE model, the entries each prefill dropped by capacity),
    captured decode ms, tokens/s, the peak and a replayed step's top
    device kernels; then one decode step eager
    and one replayed on the same tokens, positions and cache (the replay
    rewrites the slots the eager step wrote, with the same values): their
    logits must agree, bitwise where ``bitwise`` (else same argmax and
    within CACHE_TOL; bitwise is reported), and the host launches of each
    are counted.  A hybrid model's eager step counts the shared block's
    calls, which must be its sites.  ``keep``: also return the bundle,
    the parameters and the engine, for the caller's own requests."""
    from repro_torch import configs
    from repro_torch.models import build, lm, moe
    from repro_torch.serve import Request, ServeEngine
    cfg = configs.get(arch)
    if layers:
        cfg = cfg.with_(n_layers=layers)
    bundle = build(cfg)
    t0 = time.perf_counter()
    params = bundle.init(0, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    with torch.no_grad():   # cuBLAS handles and first launches, off the clock
        bundle.prefill(params, {"tokens": torch.zeros(
            (1, 16), dtype=torch.long, device="cuda")},
            bundle.init_cache(1, 16, device="cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(bundle, params, batch_slots=4, max_len=DENSE_MAX_LEN)
    require(eng.captured, f"{phase} {arch}: the engine did not capture "
            "its decode step")
    cache_bytes = sum(v.numel() * v.element_size() for v in eng.cache.values())
    g = torch.Generator(device="cuda").manual_seed(1)
    reqs = [Request(prompt=torch.randint(0, cfg.vocab, (n,), generator=g,
                                         device="cuda").tolist(),
                    max_new_tokens=MAX_NEW, rid=i)
            for i, n in enumerate(lens)]
    prefill_ms, decode_ms, active, dropped = {}, [], [], {}
    finite = [True]
    inner_prefill, inner_decode = eng._prefill, eng._decode

    def synced(fn, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    def timed_prefill(tokens, cache):
        with moe.count_drops() as drops:
            (logits, c), ms = synced(inner_prefill, tokens, cache)
        prefill_ms[int(tokens.shape[1])] = ms
        if cfg.n_experts:
            dropped[int(tokens.shape[1])] = [int(d) for d in drops]
        finite[0] &= bool(torch.isfinite(logits).all())
        return logits, c

    def timed_decode(tok, cache, pos):
        (logits, c), ms = synced(inner_decode, tok, cache, pos)
        decode_ms.append(ms)
        active.append(sum(r is not None for r in eng.slot_req))
        finite[0] &= bool(torch.isfinite(logits[:, 0, :cfg.vocab]).all())
        return logits, c

    eng._prefill, eng._decode = timed_prefill, timed_decode
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    require(finite[0], f"{phase} {arch}: non-finite logits")
    for r in reqs:
        require(len(r.output) == MAX_NEW and all(0 <= v < cfg.vocab
                                                 for v in r.output),
                f"{phase} {arch}: request {r.rid} got {len(r.output)} "
                f"tokens (want {MAX_NEW} in [0, {cfg.vocab}))")
    # one step eager, then replayed, on the same inputs; the eager step
    # counts the hybrid's shared-block calls
    tok = torch.randint(0, cfg.vocab, (eng.b, 1), generator=g,
                        device="cuda")
    pos = torch.from_numpy(eng.pos.copy())
    shared_calls, shared_block = [], lm._shared_attn_block

    def counted(*a, **kw):
        shared_calls.append(1)
        return shared_block(*a, **kw)
    lm._shared_attn_block = counted
    try:
        with torch.no_grad():
            eager = eng._eager_decode(tok, eng.cache, pos)[0].clone()
    finally:
        lm._shared_attn_block = shared_block
    with torch.no_grad():
        replayed = inner_decode(tok, eng.cache, pos)[0].clone()
    diff = float((eager - replayed)[..., :cfg.vocab].abs().max())
    scale = float(eager[..., :cfg.vocab].abs().max())
    same_argmax = bool(torch.equal(eager[..., :cfg.vocab].argmax(-1),
                                   replayed[..., :cfg.vocab].argmax(-1)))
    wall = statistics.median(decode_ms)
    with torch.no_grad():
        t_e = synced(eng._eager_decode, tok, eng.cache, pos)[1]
        prof_g = profile_enqueues(torch, lambda: inner_decode(
            tok, eng.cache, pos), wall)
        prof_e = profile_enqueues(torch, lambda: eng._eager_decode(
            tok, eng.cache, pos), t_e)
        top = profile_call(torch, lambda: inner_decode(tok, eng.cache, pos),
                           wall)["top_device_ms"]
    row = dict(
        model=cfg.name, family=cfg.family, layers=cfg.n_layers,
        d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads, cfg.hd],
        d_ff=cfg.d_ff, act=cfg.act, vocab=cfg.vocab, dtype=cfg.dtype,
        params=n_params, init_s=init_s, slots=eng.b, max_len=DENSE_MAX_LEN,
        cache_len=lm.cache_len(cfg, DENSE_MAX_LEN),
        ring=lm.cache_len(cfg, DENSE_MAX_LEN) < DENSE_MAX_LEN,
        cache_bytes=cache_bytes, requests=len(reqs), prompt_lens=list(lens),
        max_new_tokens=MAX_NEW,
        prefill_ms={str(k): v for k, v in sorted(prefill_ms.items())},
        decode_steps=len(decode_ms), decode_ms_captured=wall,
        decode_ms_eager=t_e, decode_ms_all=decode_ms,
        decode_tokens_per_s=sum(active) / (sum(decode_ms) / 1e3),
        run_s=run_s, tokens_per_s=sum(len(q.output) for q in reqs) / run_s,
        peak_bytes=peak, eager_vs_captured=dict(
            max_abs_diff=diff, max_abs_logit=scale, bitwise=diff == 0.0,
            same_argmax=same_argmax),
        host_launches_captured=prof_g["host_launches"],
        host_launches_eager=prof_e["host_launches"],
        device_busy_ms_captured=prof_g["device_busy_ms"],
        idle_share_captured=prof_g["idle_share"],
        top_device_ms_captured=top,
        outputs={q.rid: q.output[:8] for q in reqs})
    if cfg.n_experts:
        row.update(experts=[cfg.n_experts, cfg.top_k],
                   capacity_factor=cfg.capacity_factor,
                   dropped_by_prefill={str(k): v for k, v in
                                       sorted(dropped.items())})
    if cfg.family == "hybrid":
        row.update(shared_calls_per_step=len(shared_calls),
                   sites=[i for i, v in enumerate(cfg.shared_attn_sites())
                          if v])
    emit(phase, **row)
    if bitwise:
        require(diff == 0.0, f"{phase} {arch}: the captured decode is not "
                f"bitwise the eager one: max|d| {diff} of {scale}")
    require(same_argmax and diff <= CACHE_TOL * scale,
            f"{phase} {arch}: the captured decode differs from the eager "
            f"one: max|d| {diff} of {scale}")
    if cfg.family == "hybrid":
        require(len(shared_calls) == sum(cfg.shared_attn_sites()),
                f"{phase} {arch}: the shared block ran {len(shared_calls)} "
                f"times in a step, want {sum(cfg.shared_attn_sites())}")
    del eager, replayed
    if keep:
        return row, (bundle, params, eng)
    del eng, params
    torch.cuda.empty_cache()
    return row


def phase_serve_dense(torch) -> dict:
    return {arch: serve_lm_case(torch, arch, layers, lens)
            for arch, layers, lens in DENSE_SERVE}


def layer0_kv(torch, params, cfg, seq, patches):
    """Layer 0's keys and values over the whole sequence, computed without
    a cache from its inputs (the embeddings; no expert or state before
    it): (k, v) of (1, T, Hkv, D) in fp32."""
    from repro_torch.models import layers, lm
    lp = params.layers[0]
    x = layers.norm_apply(lp.norm_attn, lm.embed_tokens(params, cfg, seq,
                                                        patches), cfg)
    t = x.shape[1]
    window, theta = lm.layer_schedule(cfg)[0]
    pos = torch.arange(t, device=x.device)[None]
    k = (x @ lp.attn["wk"]).reshape(1, t, cfg.n_kv_heads, cfg.hd)
    v = (x @ lp.attn["wv"]).reshape(1, t, cfg.n_kv_heads, cfg.hd)
    return layers.rope(k, pos, theta), v


def layer0_router_stats(torch, params, cfg, seq) -> dict:
    """Layer 0's routing of ``seq`` as one group: each expert's load
    (entries routed to it) against the capacity, for the router's input
    as it is and with its mean over the tokens taken out; and that mean's
    share of the input's energy, ||mean||² / mean ||x||²."""
    from repro_torch.models import layers, lm, moe
    lp = params.layers[0]
    t = seq.shape[1]
    h = lm.embed_tokens(params, cfg, seq)
    h, _ = lm._attn_block(lp, h, cfg, positions=torch.arange(
        t, device=h.device)[None], window=lm.layer_schedule(cfg)[0][0],
        theta=lm.layer_schedule(cfg)[0][1])
    x = layers.norm_apply(lp.norm_mlp, h, cfg)[0].float()

    def loads(v):
        top = torch.topk(torch.softmax(v @ lp.moe["router"], -1),
                         cfg.top_k, -1).indices.reshape(-1)
        return torch.zeros(cfg.n_experts, device=v.device).scatter_add_(
            0, top, torch.ones_like(top, dtype=torch.float32))

    mean = x.mean(0)
    raw, centred = loads(x), loads(x - mean)
    return dict(capacity=moe.capacity(t, cfg), mean_load=t * cfg.top_k
                / cfg.n_experts, max_load=float(raw.max()),
                max_load_centred=float(centred.max()),
                mean_energy_share=float(mean.square().sum()
                                        / x.square().sum(-1).mean()))


def cache_case(torch, phase: str, arch: str, layers: int,
               prompt: int) -> dict:
    """Cached decode against the no-cache forward at full width in fp32:
    ``arch`` cut to ``layers`` prefills CACHE_PROMPT positions (``prompt``
    tokens, with a vlm's patches before them), then decodes CACHE_STEPS
    tokens of the same random sequence through the cache (a ring wraps in
    the prefill and the decode; zamba2's SSD runs 20 chunks, the last
    ragged, then its recurrence); the last prompt position's and every
    decoded position's logits against the no-cache forward over all
    CACHE_PROMPT + CACHE_STEPS positions, within CACHE_TOL of max|logits|.

    An MoE model's comparison holds only where the no-cache forward drops
    no entry by capacity (a prefill of T tokens is one group at capacity
    ⌈T·k/E·cf⌉, and an overloaded expert drops its latest tokens: those
    the decode steps, groups of one, never drop).  The entries dropped by
    the prefill and by the forward are printed by layer; where the forward
    dropped some, the logits are printed, not held, and the KV cache is
    held instead where no expert reaches it: layer 0's keys and values
    (ring slots included) against a no-cache computation from the
    embeddings, within CACHE_TOL of their max.  Layer 0's expert loads
    are printed (:func:`layer0_router_stats`)."""
    from repro_torch import configs
    from repro_torch.models import build, lm, moe
    cfg = configs.get(arch).with_(n_layers=layers, dtype="float32")
    bundle = build(cfg)
    params = bundle.init(0, "cuda")
    n_pat = cfg.n_patches if cfg.family == "vlm" else 0
    total = prompt + CACHE_STEPS
    g = torch.Generator(device="cuda").manual_seed(4)
    seq = torch.randint(0, cfg.vocab, (1, total), generator=g,
                        device="cuda")
    pats = (torch.randn((1, n_pat, cfg.d_model), generator=g,
                        device="cuda") if n_pat else None)
    batch = {"tokens": seq[:, :prompt]}
    if n_pat:
        batch["patches"] = pats
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        cache = bundle.init_cache(1, n_pat + total, device="cuda")
        with moe.count_drops() as drops_prefill:
            first, cache = bundle.prefill(params, batch, cache)
        got = [first[:, 0]]
        for s in range(prompt, total):
            logits, cache = bundle.decode(
                params, seq[:, s:s + 1], cache,
                torch.tensor([n_pat + s]), n_pat + total)
            got.append(logits[:, 0])
        torch.cuda.synchronize()
        cached_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with moe.count_drops() as drops_forward:
            h = lm.forward_hidden(params, cfg, seq, patches=pats)[0]
        want = lm.logits_from_hidden(params, cfg, h[:, n_pat + prompt - 1:])
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
    got = torch.stack(got, 1)[..., :cfg.vocab]
    want = want[..., :cfg.vocab]
    diff = float((got - want).abs().max())
    scale = float(want.abs().max())
    dropped = [int(d) for d in drops_forward]
    s_c = lm.cache_len(cfg, n_pat + total)
    row = dict(model=cfg.name, family=cfg.family, layers=layers,
               kinds=list(cfg.layer_kinds()), window=cfg.sliding_window,
               prompt=prompt, n_patches=n_pat, decode_steps=CACHE_STEPS,
               positions=got.shape[1], cache_len=s_c,
               ring=s_c < n_pat + total,
               max_abs_diff=diff, max_abs_logit=scale, rel=diff / scale,
               tol=CACHE_TOL, argmax_equal=bool(torch.equal(
                   got.argmax(-1), want.argmax(-1))),
               cached_s=cached_s, full_forward_s=full_s,
               peak_bytes=torch.cuda.max_memory_allocated())
    if cfg.family == "hybrid":
        row.update(ssd_chunks=-(-prompt // cfg.ssm_chunk),
                   sites=[i for i, v in enumerate(cfg.shared_attn_sites())
                          if v])
    held = not cfg.n_experts or sum(dropped) == 0
    if cfg.n_experts:
        row.update(capacity_factor=cfg.capacity_factor,
                   capacity_prefill=moe.capacity(prompt, cfg),
                   capacity_forward=moe.capacity(total, cfg),
                   dropped_prefill=[int(d) for d in drops_prefill],
                   dropped_forward=dropped, logits_held=held)
        with torch.no_grad():
            k0, v0 = layer0_kv(torch, params, cfg, seq, pats)
            row["layer0_router"] = layer0_router_stats(torch, params,
                                                       cfg, seq)
        n = n_pat + total
        p_kept = torch.arange(max(0, n - s_c), n, device="cuda")
        slots = p_kept % s_c
        kv_err = max(
            float((cache[c][0, 0, slots].float() - r[0, p_kept]).abs()
                  .max() / r[0, p_kept].abs().max())
            for c, r in (("k", k0), ("v", v0)))
        row.update(layer0_kv_rel=kv_err, layer0_kv_positions=[
            int(p_kept[0]), int(p_kept[-1])])
        require(kv_err <= CACHE_TOL, f"{phase} {arch}: layer 0's KV cache "
                f"against the no-cache keys and values: {kv_err} > "
                f"{CACHE_TOL}")
    emit(phase, **row)
    require(bool(torch.isfinite(got).all()),
            f"{phase} {arch}: non-finite cached logits")
    if held:
        require(diff <= CACHE_TOL * scale,
                f"{phase} {arch}: cached decode vs the full forward "
                f"max|d| {diff} > {CACHE_TOL} x {scale}")
    del params, cache, h, want, got
    torch.cuda.empty_cache()
    return row


def phase_dense_cache(torch) -> dict:
    """:func:`cache_case` for each DENSE_CACHE model (one whole
    local:global period) at a CACHE_PROMPT-token prompt."""
    return {arch: cache_case(torch, "dense_cache", arch, layers, CACHE_PROMPT)
            for arch, layers in DENSE_CACHE}


def phase_ckpt_codec_dense(torch) -> dict:
    """gemma2-9b at full width cut to CODEC_DENSE_LAYERS layers (bf16,
    random weights from seed 0) saved with the Tucker codec
    (``CompressionConfig()``): every stacked 3-D leaf -- wq, wk, wv, wo and
    the MLP's three -- through ``sthosvd(methods="auto", impl="auto")``,
    which must resolve to ``hopper`` and launch ttt, matmul and
    ttm_interior; the 2-D embedding and norms stay dense.  Each leaf's ms,
    bytes and rel_error, its rel_error within CODEC_REL_TOL of the same
    methods on ``matfree`` and its :func:`codec_diag`; then restored into
    a fresh model that serves 4 requests x 32 tokens."""
    import tempfile
    from repro_torch import configs, kernels
    from repro_torch.checkpoint.checkpointer import (Checkpointer,
                                                     tree_flatten)
    from repro_torch.core.sthosvd import sthosvd
    from repro_torch.models import build
    from repro_torch.models.convert import load_tree, tree_from_params
    from repro_torch.optim.grad_compress import CompressionConfig
    from repro_torch.serve import Request, ServeEngine
    cfg = configs.get("gemma2-9b").with_(n_layers=CODEC_DENSE_LAYERS)
    bundle = build(cfg)
    comp = CompressionConfig()
    with tempfile.TemporaryDirectory(prefix="ckpt_dense_") as d:
        tree = tree_from_params(bundle.init(0, "cuda"))
        flat = tree_flatten(tree)
        eligible = [i for i, v in enumerate(flat)
                    if comp.ranks_for(tuple(v.shape)) is not None]
        require(all(flat[i].dim() == 3 for i in eligible) and
                len(eligible) == 7, f"ckpt_codec_dense: eligible leaves "
                f"{[tuple(flat[i].shape) for i in eligible]}")
        ck = Checkpointer(d)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        ck.save(1, tree, compress_cfg=comp, blocking=True)
        save_s = time.perf_counter() - t0
        counts = kernels.launch_counts()
        routes = dict(ttt_routes=kernels.ttt_route_counts(),
                      matmul_routes=kernels.matmul_route_counts(),
                      ttm_routes=kernels.ttm_route_counts())
        log = ck.tucker_log
        require([r["index"] for r in log] == eligible,
                f"ckpt_codec_dense: Tucker leaves {[r['index'] for r in log]}"
                f", eligible {eligible}")
        require(all(r["backend"] == "hopper" for r in log),
                f"ckpt_codec_dense: backends {[r['backend'] for r in log]}")
        for k in ("ttt", "matmul", "ttm_interior"):
            require(counts[k] > 0, f"ckpt_codec_dense: {k} never launched")
        for r in log:
            x = flat[r["index"]].float()
            ref = sthosvd(x, r["ranks"], methods=tuple(r["methods"]),
                          impl="matfree", device=x.device,
                          block_until_ready=True)
            r["rel_error_matfree"] = float(ref.tucker.rel_error(x))
            r["d_rel_error"] = r["rel_error"] - r["rel_error_matfree"]
            del ref
            emit("ckpt_codec_dense_leaf", **r)
            codec_diag(torch, x, r)
            if "als" in r["methods"]:
                als_gate(torch, "ckpt_codec_dense", f"leaf{r['index']}", x,
                         r["ranks"], r["methods"], range(len(r["ranks"])))
            del x
            require(abs(r["d_rel_error"]) <= CODEC_REL_TOL,
                    f"ckpt_codec_dense: leaf {r['index']} rel_error "
                    f"{r['rel_error']} vs matfree {r['rel_error_matfree']}")
        disk = sum(p.stat().st_size for p in Path(d).rglob("*") if p.is_file())
        del tree, flat
        torch.cuda.empty_cache()
        fresh = bundle.init(1, "cuda")
        restored, step = Checkpointer(d).restore(tree_from_params(fresh,
                                                                  "cpu"))
        load_tree(fresh, restored)
        del restored
    eng = ServeEngine(bundle, fresh, batch_slots=4, max_len=64)
    finite = [True]
    inner_prefill, inner_decode = eng._prefill, eng._decode

    def watch(fn):
        def run(*args):
            logits, c = fn(*args)
            finite[0] &= bool(torch.isfinite(logits[..., :cfg.vocab]).all())
            return logits, c
        return run
    eng._prefill, eng._decode = watch(inner_prefill), watch(inner_decode)
    g = torch.Generator(device="cuda").manual_seed(2)
    reqs = [Request(prompt=torch.randint(0, cfg.vocab, (8,), generator=g,
                                         device="cuda").tolist(),
                    max_new_tokens=32, rid=i) for i in range(4)]
    eng.run(reqs)
    torch.cuda.synchronize()
    require(finite[0], "ckpt_codec_dense: non-finite logits from the "
            "restored model")
    for r in reqs:
        require(len(r.output) == 32 and all(0 <= v < cfg.vocab
                                            for v in r.output),
                f"ckpt_codec_dense: request {r.rid} got {r.output}")
    out = dict(layers=CODEC_DENSE_LAYERS, leaves=len(log), save_s=save_s,
               disk_bytes=disk, bytes_raw=sum(r["bytes_raw"] for r in log),
               bytes_tucker=sum(r["bytes_tucker"] for r in log),
               launches={k: v for k, v in counts.items() if v}, **routes,
               restored_step=step,
               served_tokens=sum(len(r.output) for r in reqs), ok=True)
    emit("ckpt_codec_dense", **out)
    del eng, fresh
    torch.cuda.empty_cache()
    return out


def phase_dense(torch) -> dict:
    """serve_dense, dense_cache and ckpt_codec_dense; returns the codec's
    kernel launches."""
    phase_serve_dense(torch)
    phase_dense_cache(torch)
    return phase_ckpt_codec_dense(torch)


# ---------------------------------------------------------------------------
# phase 6e: the MoE, hybrid and vlm families -- serving granite-moe,
# mixtral (on its ring cache), zamba2 and internvl2 (with images), their
# caches against the full forward, and the Tucker codec on granite's 4-way
# expert leaves
# ---------------------------------------------------------------------------

#: serve_moe / serve_hybrid / serve_vlm: (architecture, layers it is cut to
#: (None: all), prompt lengths); full width.  mixtral's 56 layers are 280
#: GB in bf16: 8 of them with the untied embedding and head are 40.9 GB.
#: Its window and ring cache are 4096: three prompts pass it.
FAMILY_SERVE = {"serve_moe": (("granite-moe-3b-a800m", None, DENSE_PROMPTS),
                              ("mixtral-8x22b", 8, (37, 4097, 6000, 8191))),
                "serve_hybrid": (("zamba2-1.2b", None, DENSE_PROMPTS),),
                "serve_vlm": (("internvl2-2b", None, DENSE_PROMPTS),)}
#: serve_vlm's image requests: internvl2's 1024 patches (fp32, seed 0) and
#: these prompts, decoded MAX_NEW steps at n_patches + len(prompt) + i
VLM_IMAGE_PROMPTS = (37, 1021, 3000, 6000)
#: family_cache: (architecture, layers, prompt tokens) at full width in
#: fp32; the prompt, with internvl2's 1024 patches before it, fills
#: CACHE_PROMPT positions (mixtral's 4096 ring wraps in the prefill);
#: zamba2's 6 layers hold one shared-block site (layer 5)
FAMILY_CACHE = (("granite-moe-3b-a800m", 2, CACHE_PROMPT),
                ("mixtral-8x22b", 2, CACHE_PROMPT),
                ("zamba2-1.2b", 6, CACHE_PROMPT),
                ("internvl2-2b", 2, CACHE_PROMPT - 1024))


def serve_vlm_images(torch, bundle, params) -> dict:
    """internvl2's image requests: a cache of 4 slots sized to n_patches +
    the longest prompt + MAX_NEW (an engine's, for its captured decode
    step); each prompt of VLM_IMAGE_PROMPTS with 1024 random fp32 patches
    (seed 0) prefilled by ``bundle.prefill`` into its slot's stripe, then
    MAX_NEW decode steps of all four rows at their own positions
    n_patches + len(prompt) + i through the engine's captured
    ``bundle.decode``; 32 valid tokens a request, finite logits; one more
    step eager and replayed must be bitwise equal.  Prints prefill ms with
    patches, decode ms, the peak."""
    from repro_torch.serve import ServeEngine
    cfg = bundle.cfg
    g = torch.Generator(device="cuda").manual_seed(0)
    n_pat = cfg.n_patches
    pats = torch.randn((len(VLM_IMAGE_PROMPTS), n_pat, cfg.d_model),
                       generator=g, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(bundle, params, batch_slots=len(VLM_IMAGE_PROMPTS),
                      max_len=n_pat + max(VLM_IMAGE_PROMPTS) + MAX_NEW)
    prefill_ms, last, finite = {}, [], True
    with torch.no_grad():
        for row, n in enumerate(VLM_IMAGE_PROMPTS):
            toks = torch.randint(0, cfg.vocab, (1, n), generator=g,
                                 device="cuda")
            stripe = {k: v[:, row:row + 1] for k, v in eng.cache.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = bundle.prefill(params, {"tokens": toks,
                                                "patches": pats[row:row + 1]},
                                       stripe)
            torch.cuda.synchronize()
            prefill_ms[str(n)] = (time.perf_counter() - t0) * 1e3
            finite &= bool(torch.isfinite(logits[..., :cfg.vocab]).all())
            last.append(int(logits[0, -1, :cfg.vocab].argmax()))
        tok = torch.tensor(last, device="cuda")[:, None]
        base = torch.tensor([n_pat + n for n in VLM_IMAGE_PROMPTS])
        outs, decode_ms = [[] for _ in VLM_IMAGE_PROMPTS], []
        for i in range(MAX_NEW):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = eng._decode(tok, eng.cache, base + i)
            torch.cuda.synchronize()
            decode_ms.append((time.perf_counter() - t0) * 1e3)
            finite &= bool(torch.isfinite(logits[:, 0, :cfg.vocab]).all())
            tok = logits[:, :, :cfg.vocab].argmax(-1)
            for row, t in enumerate(tok[:, 0].tolist()):
                outs[row].append(t)
        pos = base + MAX_NEW
        eager = eng._eager_decode(tok, eng.cache, pos)[0].clone()
        replayed = eng._decode(tok, eng.cache, pos)[0].clone()
    diff = float((eager - replayed)[..., :cfg.vocab].abs().max())
    row = dict(model=cfg.name, n_patches=n_pat, prompt_lens=list(
        VLM_IMAGE_PROMPTS), max_len=eng.max_len,
        prefill_ms_with_patches=prefill_ms,
        decode_steps=MAX_NEW, decode_ms=statistics.median(decode_ms),
        decode_ms_all=decode_ms,
        decode_tokens_per_s=len(VLM_IMAGE_PROMPTS) * MAX_NEW
        / (sum(decode_ms) / 1e3),
        peak_bytes=torch.cuda.max_memory_allocated(),
        eager_vs_captured=dict(max_abs_diff=diff, bitwise=diff == 0.0),
        outputs={i: o[:8] for i, o in enumerate(outs)})
    emit("serve_vlm_images", **row)
    require(finite, "serve_vlm images: non-finite logits")
    for i, o in enumerate(outs):
        require(len(o) == MAX_NEW and all(0 <= v < cfg.vocab for v in o),
                f"serve_vlm images: request {i} got {o}")
    require(diff == 0.0, f"serve_vlm images: the captured decode is not "
            f"bitwise the eager one: max|d| {diff}")
    del eng, eager, replayed
    return row


def phase_family_serve(torch) -> dict:
    """serve_moe, serve_hybrid and serve_vlm (FAMILY_SERVE) through
    :func:`serve_lm_case`, the captured step bitwise the eager one; then
    internvl2's image requests (:func:`serve_vlm_images`)."""
    out = {}
    for phase, cases in FAMILY_SERVE.items():
        for arch, layers, lens in cases:
            vlm = phase == "serve_vlm"
            got = serve_lm_case(torch, arch, layers, lens, phase=phase,
                                bitwise=True, keep=vlm)
            if vlm:
                out[arch], (bundle, params, eng) = got
                del eng
                torch.cuda.empty_cache()
                out[arch + "/images"] = serve_vlm_images(torch, bundle,
                                                         params)
                del bundle, params
                torch.cuda.empty_cache()
            else:
                out[arch] = got
    return out


def phase_family_cache(torch) -> dict:
    """:func:`cache_case` for each FAMILY_CACHE model."""
    return {arch: cache_case(torch, "family_cache", arch, layers, prompt)
            for arch, layers, prompt in FAMILY_CACHE}


def phase_ckpt_codec_moe(torch) -> dict:
    """granite-moe-3b-a800m uncut (bf16, random weights from seed 0) saved
    with the Tucker codec (``CompressionConfig()``): its eligible stacked
    leaves -- the 4-way expert leaves w_gate, w_up (32, 40, 1536, 512) and
    w_down (32, 40, 512, 1536) at ranks (32, 10, 64, 64), the fp32 router
    (32, 1536, 40) at (32, 64, 10) and the four attention leaves -- through
    ``sthosvd(methods="auto", impl="auto")``, which must resolve to
    ``hopper`` and launch ttt, matmul and ttm_interior; on the 4-way
    leaves the first-mode wide GEMM (row 2b), the interior TTM at R <= 16
    (row 3) and on its wide route (3b) and the last-mode wide GEMM (2c)
    must launch (:func:`codec_diag`'s routes).  Each leaf's ms, bytes and
    rel_error, within CODEC_REL_TOL of the same methods on ``matfree``,
    its ``codec_diag`` and ``als_gate`` lines; then restored into a fresh
    model that serves 4 requests x 32 tokens."""
    import tempfile
    from repro_torch import configs, kernels
    from repro_torch.checkpoint.checkpointer import (Checkpointer,
                                                     tree_flatten)
    from repro_torch.core.sthosvd import sthosvd
    from repro_torch.models import build
    from repro_torch.models.convert import load_tree, tree_from_params
    from repro_torch.optim.grad_compress import CompressionConfig
    from repro_torch.serve import Request, ServeEngine
    cfg = configs.get("granite-moe-3b-a800m")
    bundle = build(cfg)
    comp = CompressionConfig()
    with tempfile.TemporaryDirectory(prefix="ckpt_moe_") as d:
        tree = tree_from_params(bundle.init(0, "cuda"))
        flat = tree_flatten(tree)
        eligible = [i for i, v in enumerate(flat)
                    if comp.ranks_for(tuple(v.shape)) is not None]
        four_way = [i for i in eligible if flat[i].dim() == 4]
        require(len(four_way) == 3 and len(eligible) == 8,
                f"ckpt_codec_moe: eligible leaves "
                f"{[tuple(flat[i].shape) for i in eligible]}")
        ck = Checkpointer(d)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        ck.save(1, tree, compress_cfg=comp, blocking=True)
        save_s = time.perf_counter() - t0
        counts = kernels.launch_counts()
        routes = dict(ttt_routes=kernels.ttt_route_counts(),
                      matmul_routes=kernels.matmul_route_counts(),
                      ttm_routes=kernels.ttm_route_counts())
        log = ck.tucker_log
        require([r["index"] for r in log] == eligible,
                f"ckpt_codec_moe: Tucker leaves {[r['index'] for r in log]}"
                f", eligible {eligible}")
        require(all(r["backend"] == "hopper" for r in log),
                f"ckpt_codec_moe: backends {[r['backend'] for r in log]}")
        for k in ("ttt", "matmul", "ttm_interior"):
            require(counts[k] > 0, f"ckpt_codec_moe: {k} never launched")
        four_routes = {}
        for r in log:
            x = flat[r["index"]].float()
            ref = sthosvd(x, r["ranks"], methods=tuple(r["methods"]),
                          impl="matfree", device=x.device,
                          block_until_ready=True)
            r["rel_error_matfree"] = float(ref.tucker.rel_error(x))
            r["d_rel_error"] = r["rel_error"] - r["rel_error_matfree"]
            del ref
            emit("ckpt_codec_moe_leaf", **r)
            diag = codec_diag(torch, x, r)
            if r["index"] in four_way:
                for md in diag["modes"]:
                    for key, v in md["routes"].items():
                        four_routes[key] = four_routes.get(key, 0) + v
            if "als" in r["methods"]:
                als_gate(torch, "ckpt_codec_moe", f"leaf{r['index']}", x,
                         r["ranks"], r["methods"], range(len(r["ranks"])))
            del x, diag
            torch.cuda.empty_cache()
            require(abs(r["d_rel_error"]) <= CODEC_REL_TOL,
                    f"ckpt_codec_moe: leaf {r['index']} rel_error "
                    f"{r['rel_error']} vs matfree {r['rel_error_matfree']}")
        emit("ckpt_codec_moe_routes", four_way=four_routes)
        want = {"2b": ("matmul:wide",), "2c": ("matmul:wide/last",),
                "3": ("ttm_interior:slab", "ttm_interior:plain"),
                "3b": ("ttm_interior:wide",)}
        for row, keys in want.items():
            require(any(four_routes.get(k, 0) for k in keys),
                    f"ckpt_codec_moe: row {row}'s route {keys} never "
                    f"launched on the 4-way leaves: {four_routes}")
        disk = sum(p.stat().st_size for p in Path(d).rglob("*") if p.is_file())
        del tree, flat
        torch.cuda.empty_cache()
        fresh = bundle.init(1, "cuda")
        restored, step = Checkpointer(d).restore(tree_from_params(fresh,
                                                                  "cpu"))
        load_tree(fresh, restored)
        del restored
    eng = ServeEngine(bundle, fresh, batch_slots=4, max_len=64)
    finite = [True]
    inner_prefill, inner_decode = eng._prefill, eng._decode

    def watch(fn):
        def run(*args):
            logits, c = fn(*args)
            finite[0] &= bool(torch.isfinite(logits[..., :cfg.vocab]).all())
            return logits, c
        return run
    eng._prefill, eng._decode = watch(inner_prefill), watch(inner_decode)
    g = torch.Generator(device="cuda").manual_seed(2)
    reqs = [Request(prompt=torch.randint(0, cfg.vocab, (8,), generator=g,
                                         device="cuda").tolist(),
                    max_new_tokens=32, rid=i) for i in range(4)]
    eng.run(reqs)
    torch.cuda.synchronize()
    require(finite[0], "ckpt_codec_moe: non-finite logits from the "
            "restored model")
    for r in reqs:
        require(len(r.output) == 32 and all(0 <= v < cfg.vocab
                                            for v in r.output),
                f"ckpt_codec_moe: request {r.rid} got {r.output}")
    out = dict(leaves=len(log), four_way=len(four_way), save_s=save_s,
               disk_bytes=disk, bytes_raw=sum(r["bytes_raw"] for r in log),
               bytes_tucker=sum(r["bytes_tucker"] for r in log),
               launches={k: v for k, v in counts.items() if v}, **routes,
               four_way_routes=four_routes, restored_step=step,
               served_tokens=sum(len(r.output) for r in reqs), ok=True)
    emit("ckpt_codec_moe", **out)
    del eng, fresh
    torch.cuda.empty_cache()
    return out


def phase_families(torch) -> dict:
    """serve_moe, serve_hybrid, serve_vlm, family_cache and
    ckpt_codec_moe; returns the codec's kernel launches."""
    phase_family_serve(torch)
    phase_family_cache(torch)
    return phase_ckpt_codec_moe(torch)


# ---------------------------------------------------------------------------
# phase 6d: training falcon-mamba-7b at full width, the Tucker checkpoint
# codec on its weights, and a bitwise resume
# ---------------------------------------------------------------------------

def train_memory(cfg, layers: int) -> dict:
    """The training state's bytes at ``layers`` layers: bf16 parameters and
    gradients (4 B), AdamW's fp32 m and v (8 B), and the compressor's fp32
    error feedback on the eligible stacked leaves (4 B)."""
    from repro_torch.optim.grad_compress import CompressionConfig
    d, di, n, v = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.vocab_padded
    r = max(1, math.ceil(d / 16))
    per_layer = {"in_proj": (d, 2 * di), "conv_w": (cfg.ssm_conv, di),
                 "x_proj": (di, r + 2 * n), "dt_proj": (r, di), "a_log": (di, n),
                 "conv_b": (di,), "dt_bias": (di,), "d_skip": (di,),
                 "out_proj": (di, d), "norm": (d,)}
    comp = CompressionConfig()
    layer = sum(math.prod(s) for s in per_layer.values())
    eligible = sum(math.prod(s) for s in per_layer.values()
                   if comp.ranks_for((layers,) + s) is not None)
    top = 2 * v * d + d
    params = layers * layer + top
    return dict(params_per_layer=layer, params_top=top, params=params,
                bytes=params * 12 + layers * eligible * 4)


def phase_train(torch) -> tuple:
    """falcon-mamba-7b at full width and TRAIN_LAYERS layers trained for
    TRAIN_STEPS compressed steps on SyntheticLM(seed 0) at TRAIN_BATCH x
    TRAIN_SEQ tokens, with launch/train's AdamW recipe and
    CompressionConfig() (the factors refreshed at step 0).  Returns (the
    trained model, the S6 launches of the run)."""
    from repro_torch import configs, kernels
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import build
    from repro_torch.models.convert import leaves, param_tree
    from repro_torch.optim import grad_compress as gc
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.train_step import (init_state,
                                              make_compressed_train_step)
    full = configs.get("falcon-mamba-7b")
    cfg = full.with_(n_layers=TRAIN_LAYERS)
    total = torch.cuda.get_device_properties(0).total_memory
    emit("train_config", model=cfg.name, layers=cfg.n_layers,
         published_layers=full.n_layers, d_model=cfg.d_model,
         d_inner=cfg.d_inner, ssm_state=cfg.ssm_state, vocab=cfg.vocab,
         dtype=cfg.dtype, remat=cfg.remat, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         steps=TRAIN_STEPS, card_bytes=total,
         state_at_published_depth=train_memory(full, full.n_layers),
         state_at_cut=train_memory(full, TRAIN_LAYERS),
         cut_reason="bf16 params and grads, fp32 AdamW moments and fp32 "
                    "error feedback at 64 layers exceed the card; 16 layers "
                    "leave room for the step's transients")
    bundle = build(cfg)
    opt = AdamW(lr=cosine_schedule(3e-4, TRAIN_STEPS // 10, TRAIN_STEPS))
    comp = gc.CompressionConfig()
    t0 = time.perf_counter()
    state = init_state(bundle, opt, 0, compression=comp, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    steps = make_compressed_train_step(bundle, opt, comp)
    src = SyntheticLM(DataConfig(seed=0), cfg, TRAIN_SEQ, TRAIN_BATCH,
                      device="cuda")
    checks = {}
    real = gc.compress_psum

    def checked(cfg_, grads, st, *, refresh, group=None):
        """The refresh step's compressor, with g_fb kept on the host."""
        g_fb = {}
        for path, g in leaves(grads):
            s = dict(state_leaves(st))[path]
            if s is not None:
                parts = g if isinstance(g, list) else [g]
                g_fb[path] = torch.stack([p.float().cpu() for p in parts]) \
                    .reshape(s["error"].shape) + s["error"].cpu()
        red, new, stats = real(cfg_, grads, st, refresh=refresh, group=group)
        for path, fb in g_fb.items():
            s = dict(state_leaves(new))[path]
            fb = fb.cuda()
            g_hat = gc._expand(gc._project(fb, s["factors"]), s["factors"])
            r = dict(leaves(red))[path]
            r = torch.stack(r) if isinstance(r, list) else r
            same = bool(torch.equal(r, g_hat.to(r.dtype).reshape(r.shape)))
            del r
            gap = float(g_hat.add_(s["error"]).sub_(fb).abs().max()
                        / fb.abs().max())
            ortho = max(float((u.T @ u - torch.eye(u.shape[1], device="cuda"))
                              .abs().max()) for u in s["factors"] if u is not None)
            checks["/".join(path)] = dict(
                shape=list(fb.shape), feedback_rel_gap=gap,
                reduced_is_bf16_of_g_hat=same, factors_orthonormality=ortho)
            del fb, g_hat
        return red, new, stats

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    rows, prof = [], None
    for step in range(TRAIN_STEPS):
        batch = src.batch_at(step)
        refresh = step % comp.refresh_every == 0
        fn = steps[refresh]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if step == TRAIN_STEPS - 1:        # the last step under the profiler
            held = {}

            def run():
                held["out"] = steps[False](state, batch)
            prof = profile_call(torch, run, rows[-1]["ms"])
            state, m = held.pop("out")
        elif refresh:
            gc.compress_psum = checked
            try:
                state, m = fn(state, batch)
            finally:
                gc.compress_psum = real
        else:
            state, m = fn(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rows.append(dict(step=step, refresh=refresh,
                         profiled=step == TRAIN_STEPS - 1, ms=ms,
                         tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / ms * 1e3,
                         peak_allocated=torch.cuda.max_memory_allocated(),
                         loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                         bytes_dense=int(m["bytes_dense"]),
                         bytes_compressed=int(m["bytes_compressed"])))
        emit("train_step", **rows[-1])
    counts = kernels.launch_counts()
    losses = [r["loss"] for r in rows]
    peak = max(r["peak_allocated"] for r in rows)
    require(all(math.isfinite(v) for v in losses), f"train: losses {losses}")
    require(losses[-1] < losses[0],
            f"train: last loss {losses[-1]} not below the first {losses[0]}")
    require(counts["s6_scan_bwd"] == cfg.n_layers * TRAIN_STEPS,
            f"train: s6_scan_bwd launched {counts['s6_scan_bwd']} times, want "
            f"{cfg.n_layers} x {TRAIN_STEPS}")
    require(len(checks) == sum(s is not None for _, s in
                               state_leaves(state.compressor)),
            "train: a compressed leaf was not checked")
    for name, c in checks.items():
        require(c["factors_orthonormality"] <= 1e-4,
                f"train: {name}'s factors are not orthonormal: "
                f"{c['factors_orthonormality']:.2e}")
        require(c["feedback_rel_gap"] <= 1e-5,
                f"train: {name}: g_hat + error - g_fb = "
                f"{c['feedback_rel_gap']:.2e} of max|g_fb|")
        require(c["reduced_is_bf16_of_g_hat"],
                f"train: {name}'s reduced gradient is not g_hat in bf16")
    require(peak < 0.9 * total,
            f"train: peak {peak} B is not under 90% of the card's {total} B")
    plain = [r["ms"] for r in rows if not r["refresh"] and not r["profiled"]]
    emit("train", layers=cfg.n_layers, steps=TRAIN_STEPS, init_s=init_s,
         refresh_ms=rows[0]["ms"], step_ms_median=statistics.median(plain),
         tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / statistics.median(plain) * 1e3,
         peak_allocated=peak, card_bytes=total, losses=losses,
         launches={k: v for k, v in counts.items() if v},
         refresh_checks=checks, profiled_step=prof, ok=True)
    params = state.params
    del state, steps
    torch.cuda.empty_cache()
    return params, counts


def state_leaves(tree, prefix=()):
    """(path, leaf state) of a compressor state (None: not compressed)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict) and "error" not in v:
            out += state_leaves(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def reference_ladder(torch, a):
    """The reference's ``_spd_inverse`` (``src/repro/core/solvers.py``) in
    PyTorch: the first jitter rung (1e-12, 1e-8, 1e-4 of tr(A), the last
    plus 1e-6) whose Cholesky succeeds, with no resolution gate."""
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    scale = torch.trace(a)
    nan = torch.full_like(a, float("nan"))
    inv = nan
    for i, jitter in enumerate((1e-12, 1e-8, 1e-4)):
        reg = jitter * scale + (1e-6 if i == 2 else 0.0)
        c, info = torch.linalg.cholesky_ex(a + reg * eye)
        cand = torch.where(info == 0, torch.cholesky_solve(eye, c), nan)
        inv = torch.where(torch.isfinite(inv).all(), inv, cand)
    return inv


def als_gate(torch, phase, name, x, ranks, methods, order) -> dict:
    """Whether the resolution gate of ``solvers._spd_inverse`` changed any
    ALS iteration of ``x``'s st-HOSVD on ``hopper`` (the per-step runner,
    ``methods`` by mode, modes in ``order``): each iteration's inverse is
    held against :func:`reference_ladder`'s on the same Gram.  Where one
    differs, the same decomposition with the reference's ladder gives how
    far each factor moved (projector gap) and both rel_errors."""
    from unittest import mock

    from repro_torch.core import solvers
    from repro_torch.core.sthosvd import sthosvd
    gated = solvers._spd_inverse
    seen = [0, 0]

    def watch(a):
        inv = gated(a)
        ref = reference_ladder(torch, a)
        seen[0] += 1
        seen[1] += int(not bool(((inv == ref) | (inv.isnan() & ref.isnan()))
                                .all()))
        return inv

    def run(inverse):
        with mock.patch.object(solvers, "_spd_inverse", inverse):
            return sthosvd(x, list(ranks), methods=tuple(methods),
                           mode_order=list(order), impl="hopper",
                           device=x.device, block_until_ready=True)
    res = run(watch)
    row = dict(of=phase, case=name, shape=list(x.shape), ranks=list(ranks),
               methods=list(methods), iterations=seen[0], fired=seen[1],
               rel_error=float(res.tucker.rel_error(x)))
    if seen[1]:
        ref = run(lambda a: reference_ladder(torch, a))
        row.update(rel_error_reference_ladder=float(ref.tucker.rel_error(x)),
                   gaps=[projector_gap(torch, u.float(), v.float()) for u, v
                         in zip(res.tucker.factors, ref.tucker.factors)])
        del ref
    del res
    emit("als_gate", **row)
    return row


def codec_diag(torch, x, rec) -> dict:
    """One codec leaf's st-HOSVD step by step on ``hopper`` and on
    ``matfree`` (the codec's methods, modes in order, ALS seed 0, as the
    plan's per-step runner solves them): per mode the solver, the launches
    by route and the projector gap max|UUᵀ - U_mU_mᵀ| against matfree's
    factor, and the rel_error."""
    from repro_torch import kernels
    from repro_torch.core import solvers
    from repro_torch.core import tensor_ops as T
    from repro_torch.core.backend import backend_ops
    methods, ranks = rec["methods"], rec["ranks"]

    def run(ops):
        y, us, modes = x, [], []
        for m, meth in enumerate(methods):
            before = kernels.launch_snapshot()
            u, y = solvers.SOLVERS[meth](y, m, ranks[m], impl=ops)
            routes = {f"{k}:{rt}": v for (k, rt), v in
                      kernels.launches_since(before).items() if rt}
            modes.append(dict(mode=m, solver=meth, routes=routes))
            us.append(u)
        return us, modes, float(T.rel_error(x, y, us))

    ref_us, _, ref_err = run(backend_ops("matfree"))
    us, modes, err = run(backend_ops("hopper"))
    for md, u, v in zip(modes, us, ref_us):
        md["gap"] = projector_gap(torch, u.float(), v.float())
    out = dict(index=rec["index"], shape=rec["shape"], ranks=ranks,
               methods=methods, rel_error_matfree=ref_err,
               rel_error_hopper=err, modes=modes)
    emit("codec_diag", **out)
    return out


def phase_ckpt_codec(torch, params) -> dict:
    """The trained TRAIN_LAYERS-layer weights saved with the Tucker codec
    (``CompressionConfig()``): every eligible stacked leaf through
    ``sthosvd(methods="auto", impl="auto")`` on the card, which must
    resolve to ``hopper`` and launch ttt, matmul and ttm_interior; each
    leaf's rel_error within CODEC_REL_TOL = 1e-4 of the same methods on
    ``matfree``, and each leaf's step-by-step diagnosis (:func:`codec_diag`)
    printed; then restored into a fresh model that serves 4 requests x 32
    tokens through ServeEngine (valid tokens, finite logits)."""
    import tempfile
    from repro_torch import configs, kernels
    from repro_torch.checkpoint.checkpointer import (Checkpointer,
                                                     tree_flatten)
    from repro_torch.core.sthosvd import sthosvd
    from repro_torch.models import build
    from repro_torch.models.convert import load_tree, tree_from_params
    from repro_torch.optim.grad_compress import CompressionConfig
    from repro_torch.serve import Request, ServeEngine
    cfg = configs.get("falcon-mamba-7b").with_(n_layers=TRAIN_LAYERS)
    comp = CompressionConfig()
    with tempfile.TemporaryDirectory(prefix="ckpt_codec_") as d:
        tree = tree_from_params(params)
        flat = tree_flatten(tree)
        eligible = [i for i, v in enumerate(flat)
                    if comp.ranks_for(tuple(v.shape)) is not None]
        ck = Checkpointer(d)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        ck.save(1, tree, compress_cfg=comp, blocking=True)
        save_s = time.perf_counter() - t0
        counts = kernels.launch_counts()
        log = ck.tucker_log
        require([r["index"] for r in log] == eligible,
                f"ckpt_codec: Tucker leaves {[r['index'] for r in log]}, "
                f"eligible {eligible}")
        require(all(r["backend"] == "hopper" for r in log),
                f"ckpt_codec: backends {[r['backend'] for r in log]}")
        for k in ("ttt", "matmul", "ttm_interior"):
            require(counts[k] > 0, f"ckpt_codec: {k} never launched")
        for r in log:
            x = flat[r["index"]].float()
            ref = sthosvd(x, r["ranks"], methods=tuple(r["methods"]),
                          impl="matfree", device=x.device,
                          block_until_ready=True)
            r["rel_error_matfree"] = float(ref.tucker.rel_error(x))
            r["d_rel_error"] = r["rel_error"] - r["rel_error_matfree"]
            del x, ref
            emit("ckpt_codec_leaf", **r)
            codec_diag(torch, flat[r["index"]].float(), r)
            if "als" in r["methods"]:
                als_gate(torch, "ckpt_codec", f"leaf{r['index']}",
                         flat[r["index"]].float(), r["ranks"], r["methods"],
                         range(len(r["ranks"])))
            require(abs(r["d_rel_error"]) <= CODEC_REL_TOL,
                    f"ckpt_codec: leaf {r['index']} rel_error "
                    f"{r['rel_error']} vs matfree {r['rel_error_matfree']}")
        disk = sum(p.stat().st_size for p in Path(d).rglob("*") if p.is_file())
        del tree, flat, params
        torch.cuda.empty_cache()
        bundle = build(cfg)
        fresh = bundle.init(1, "cuda")
        restored, step = Checkpointer(d).restore(tree_from_params(fresh, "cpu"))
        load_tree(fresh, restored)
        del restored
    eng = ServeEngine(bundle, fresh, batch_slots=4, max_len=64)
    finite = [True]
    inner_prefill, inner_decode = eng._prefill, eng._decode

    def watch(fn):
        def run(*args):
            logits, c = fn(*args)
            finite[0] &= bool(torch.isfinite(logits).all())
            return logits, c
        return run
    eng._prefill, eng._decode = watch(inner_prefill), watch(inner_decode)
    g = torch.Generator(device="cuda").manual_seed(2)
    reqs = [Request(prompt=torch.randint(0, cfg.vocab, (8,), generator=g,
                                         device="cuda").tolist(),
                    max_new_tokens=32, rid=i) for i in range(4)]
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    require(finite[0], "ckpt_codec: non-finite logits from the restored model")
    for r in reqs:
        require(len(r.output) == 32 and all(0 <= v < cfg.vocab for v in r.output),
                f"ckpt_codec: request {r.rid} got {r.output}")
    out = dict(leaves=len(log), save_s=save_s, disk_bytes=disk,
               bytes_raw=sum(r["bytes_raw"] for r in log),
               bytes_tucker=sum(r["bytes_tucker"] for r in log),
               launches={k: v for k, v in counts.items() if v},
               ttt_routes=kernels.ttt_route_counts(),
               matmul_routes=kernels.matmul_route_counts(),
               ttm_routes=kernels.ttm_route_counts(),
               restored_step=step, served_tokens=sum(len(r.output) for r in reqs),
               serve_s=serve_s, ok=True)
    emit("ckpt_codec", **out)
    del eng, fresh
    torch.cuda.empty_cache()
    return out


def phase_train_resume(torch) -> dict:
    """falcon-mamba SMOKE on the card through Trainer (compressed steps,
    ckpt_every=3): 6 steps, then a new Trainer restores and runs to 8; its
    parameters and optimizer and compressor state must be bitwise those of
    an uninterrupted 8-step run."""
    import tempfile
    from repro_torch import configs
    from repro_torch.checkpoint.checkpointer import tree_flatten
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import build
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.optim.grad_compress import CompressionConfig
    from repro_torch.train.train_step import (init_state,
                                              make_compressed_train_step)
    from repro_torch.train.trainer import Trainer, TrainerConfig, state_tree
    cfg = configs.get_smoke("falcon-mamba-7b")
    bundle = build(cfg)
    opt = AdamW(lr=cosine_schedule(1e-2, 2, 8))
    comp = CompressionConfig(min_size=1024, refresh_every=4)
    steps = make_compressed_train_step(bundle, opt, comp)

    def trainer(total, d):
        state = init_state(bundle, opt, 0, compression=comp, device="cuda")
        src = SyntheticLM(DataConfig(seed=0), cfg, 128, 4, device="cuda")
        tc = TrainerConfig(total_steps=total, ckpt_every=3, log_every=1,
                           ckpt_dir=d, refresh_every=comp.refresh_every)
        return Trainer(tc, steps, state, src)

    with tempfile.TemporaryDirectory(prefix="train_resume_") as d:
        whole = trainer(8, f"{d}/whole")
        whole.run()
        trainer(6, f"{d}/split").run()
        second = trainer(8, f"{d}/split")
        at = second.restore_if_available()
        hist = second.run(start_step=at)
    a = tree_flatten(state_tree(whole.state, "cpu"))
    b = tree_flatten(state_tree(second.state, "cpu"))
    same = len(a) == len(b) and all(torch.equal(x.cpu(), y.cpu())
                                    for x, y in zip(a, b))
    require(at == 6, f"train_resume: restored at step {at}, want 6")
    require(same, "train_resume: the resumed run is not bitwise the "
                  "uninterrupted one")
    out = dict(model=cfg.name, restored_at=at, leaves=len(a), bitwise=same,
               losses=[h["loss"] for h in hist], ok=True)
    emit("train_resume", **out)
    return out


def phase_training(torch) -> dict:
    """Phases train, ckpt_codec and train_resume, with the seconds each
    took; returns the launches of the train and codec runs."""
    t0 = time.perf_counter()
    params, train_counts = phase_train(torch)
    t1 = time.perf_counter()
    codec = phase_ckpt_codec(torch, params)
    del params
    t2 = time.perf_counter()
    phase_train_resume(torch)
    t3 = time.perf_counter()
    emit("training_seconds", train=t1 - t0, ckpt_codec=t2 - t1,
         train_resume=t3 - t2)
    return {"train": train_counts, "ckpt_codec": codec["launches"]}


# ---------------------------------------------------------------------------
# phase 6b: the streaming Tucker service on the card
# ---------------------------------------------------------------------------

#: stream_ref: the reference's serve bench stream (benchmarks/serve_bench.py
#: --full): shapes hug three anchors, each dim drawn from [anchor - 5,
#: anchor], Poisson arrivals at 3x the rate of a warm singleton execute
SERVE_ANCHORS = ((48, 40, 32), (64, 48, 32), (40, 40, 40))
SERVE_RANKS, SERVE_JITTER, SERVE_N, SERVE_RATE = (4, 4, 4), 6, 200, 3.0
#: hsi_tiles: 64 tiles of the HSI tensor, modes 0 and 1 drawn from [505,
#: 512], modes 2 and 3 whole
TILES_N, TILE_LO, TILE_HI, TILES_SAMPLED = 64, 505, 512, 8
#: resilience: one (16, 16, 16) mask bucket at ranks (3, 3, 3)
RES_SHAPES = ((16, 16, 16), (15, 16, 16), (16, 14, 16), (16, 16, 13))
RES_RANKS = (3, 3, 3)
#: the capture race: a new bucket's first wave against 32 admissions
RACE_BUCKET, RACE_N, RACE_WAIT_S = (24, 24, 24), 32, 60.0


def sweep_cache_held() -> dict:
    """What the process-wide sweep cache holds: captured sweeps, their
    static inputs' and private pools' bytes, and the seconds their first
    calls took (warm-up, capture, first replay)."""
    from repro_torch.core import api
    held = [fn.graphs.stats() for fn in api._SWEEP_CACHE.values()
            if fn.graphs is not None and fn.graphs.program is not None]
    return dict(entries=len(api._SWEEP_CACHE), captured=len(held),
                input_bytes=sum(s["input_bytes"] for s in held),
                pool_bytes=sum(s["pool_bytes"] for s in held),
                bytes_held=sum(s["input_bytes"] + s["pool_bytes"]
                               for s in held),
                capture_s=sum(s["build_s"] for s in held))


def require_hopper(plans, where: str) -> None:
    bad = sorted({p.backend for p in plans} - {"hopper"})
    require(not bad, f"{where}: impl='auto' resolved to {bad}, not 'hopper'")


def serve_row(stats: dict, n: int, total_s: float) -> dict:
    lat = stats["latency"]
    return dict(n=n, requests=stats["requests"], failed=stats["failed"],
                requests_per_s=n / total_s, total_s=total_s,
                p50_ms=lat["p50_ms"], p95_ms=lat["p95_ms"],
                p99_ms=lat["p99_ms"], plans_built=stats["plans_built"],
                batches=stats["batches"])


def bucket_rows(stats: dict) -> dict:
    return {label: {k: b[k] for k in ("completed", "waves", "padded",
                                      "pad_waste", "occupancy",
                                      "pipeline_occupancy", "avg_inflight")}
            | {"p95_ms": b["latency"]["p95_ms"]}
            for label, b in stats["buckets"].items()}


def serve_stream_ref(torch) -> dict:
    """The reference's --full stream, rebuilt: the same numpy draws (seed
    0) for the calibration tensor, arrivals, shapes and data; the arrival
    rate 3x a warm singleton execute on the first anchor, measured here;
    then the one-shot arm (``TuckerBatchEngine().run([req])`` per arrival)
    and the service arm (mask buckets of grid 8, a worker, up to 3 waves
    in flight), each from a clear sweep cache."""
    import numpy as np

    from repro_torch.core import TuckerConfig, clear_sweep_cache, plan
    from repro_torch.serve import (BucketPolicy, TuckerBatchEngine,
                                   TuckerRequest, TuckerService)
    from repro_torch.serve.metrics import LatencyWindow
    rng = np.random.default_rng(0)
    cfg = TuckerConfig(ranks=SERVE_RANKS, methods="eig", impl="auto")
    anchor = SERVE_ANCHORS[0]
    x0 = torch.from_numpy(rng.standard_normal(anchor).astype(np.float32)
                          ).cuda()
    p0 = plan(anchor, "float32", cfg)
    require_hopper([p0], "stream_ref")
    p0.execute(x0)
    single = synced_ms(torch, lambda: p0.execute(x0), 5)
    t_single = statistics.median(single) / 1e3
    rate = SERVE_RATE / t_single
    stream, t = [], 0.0
    for _ in range(SERVE_N):
        t += float(rng.exponential(1.0 / rate))
        base = SERVE_ANCHORS[int(rng.integers(len(SERVE_ANCHORS)))]
        dims = tuple(max(int(b - rng.integers(0, SERVE_JITTER)), r + 1)
                     for b, r in zip(base, SERVE_RANKS))
        stream.append((t, rng.standard_normal(dims).astype(np.float32)))
    stream = [(a, torch.from_numpy(x).cuda()) for a, x in stream]
    torch.cuda.synchronize()

    def replay(submit):
        t0 = time.perf_counter()
        for arrival, x in stream:
            lag = arrival - (time.perf_counter() - t0)
            if lag > 0:
                time.sleep(lag)
            submit(arrival, x, t0)
        return t0

    out = dict(arrival_rps=rate, single_ms=single,
               distinct_shapes=len({tuple(x.shape) for _, x in stream}))
    clear_sweep_cache()
    eng = TuckerBatchEngine()
    lat = LatencyWindow()

    def oneshot(arrival, x, t0):
        eng.run([TuckerRequest(x=x, config=cfg)])
        lat.add(time.perf_counter() - t0 - arrival)

    t0 = replay(oneshot)
    total = time.perf_counter() - t0
    st = eng.stats
    require(st["requests"] == SERVE_N and st["failed"] == 0,
            f"stream_ref oneshot: {st['requests']} of {SERVE_N} completed")
    require_hopper(eng._plans.values(), "stream_ref oneshot")
    one = serve_row(st, SERVE_N, total) | lat.snapshot_ms() | \
        {"sweep_cache": sweep_cache_held()}
    del eng

    def service_arm(validate: str) -> dict:
        clear_sweep_cache()
        svc = TuckerService(
            policy=BucketPolicy(grid=8, max_pad_ratio=8.0, pad_mode="mask",
                                wave_slots=8),
            max_queue=4 * SERVE_N, backpressure="block",
            max_inflight_waves=3)
        svc.start()
        tickets, submit_ms = [], []

        def admit(arrival, x, t0):
            ts = time.perf_counter()
            tickets.append(svc.submit(x, cfg, validate=validate))
            submit_ms.append((time.perf_counter() - ts) * 1e3)

        t0 = replay(admit)
        replay_s = time.perf_counter() - t0
        results = [svc.wait(tk, timeout=600) for tk in tickets]
        total = time.perf_counter() - t0
        st = svc.stats()
        svc.stop()
        where = f"stream_ref service (validate={validate!r})"
        require(st["requests"] == SERVE_N and st["failed"] == 0,
                f"{where}: {st['requests']} of {SERVE_N} completed")
        require_hopper(svc._plans.values(), where)
        bad = [i for i, ((_, x), r) in enumerate(zip(stream, results))
               if r.tucker.core.shape != SERVE_RANKS
               or [u.shape[0] for u in r.tucker.factors] != list(x.shape)
               or not bool(torch.isfinite(r.tucker.core).all())]
        require(not bad, f"{where}: malformed results {bad[:5]}")
        row = serve_row(st, SERVE_N, total) | {
            "pad_waste": st["pad_waste"], "buckets": bucket_rows(st),
            "sweep_cache": sweep_cache_held(),
            "replay_s": replay_s, "arrival_span_s": stream[-1][0],
            "submit_ms": {"p50": statistics.median(submit_ms),
                          "max": max(submit_ms), "sum": sum(submit_ms)}}
        if validate == "finite":
            # one warm wave of 8 lanes of the first request's bucket, run
            # inline (the worker stopped): ms a lane against the singleton
            first = svc._policy.bucket_shape(stream[0][1].shape)
            lanes = [x for _, x in stream
                     if svc._policy.bucket_shape(x.shape) == first][:8]

            def one_wave():
                for x in lanes:
                    svc.submit(x, cfg)
                svc.drain()

            wall = statistics.median(synced_ms(torch, one_wave, 3))
            row["wave_profile"] = dict(
                lanes=len(lanes), wall_ms=wall, ms_per_lane=wall / len(lanes),
                **profile_call(torch, one_wave, wall))
        return row

    srv = service_arm("finite")
    out.update(oneshot=one, service=srv,
               service_over_oneshot=srv["requests_per_s"]
               / one["requests_per_s"],
               service_validate_none=service_arm("none"))
    return out


def hsi_tiles(torch, launched: dict) -> dict:
    """64 tiles of the HSI tensor (ranks (10, 10, 10, 5) + 1% noise, made on
    the card from seed 11) through a mask-mode service, closed loop; checks
    and prints as the phase's docstring says.  Then 8 tiles through a fresh
    exact-mode service, each result bitwise equal to a direct
    ``decompose`` of its tile."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.core import TuckerConfig, decompose, plan
    from repro_torch.serve import BucketPolicy, TuckerService, pad_block
    shape, ranks = HSI
    gen = torch.Generator(device="cuda").manual_seed(11)
    base = lowrank(torch, shape, ranks, gen)
    rng = np.random.default_rng(11)

    def cut(d0, d1):
        o0 = int(rng.integers(0, shape[0] - d0 + 1))
        o1 = int(rng.integers(0, shape[1] - d1 + 1))
        return base[o0:o0 + d0, o1:o1 + d1]

    tiles = [cut(int(rng.integers(TILE_LO, TILE_HI + 1)),
                 int(rng.integers(TILE_LO, TILE_HI + 1)))
             for _ in range(TILES_N)]
    cfg = TuckerConfig(ranks=ranks, methods="auto", impl="auto")
    policy = BucketPolicy(grid=(8, 8, 1, 1), max_pad_ratio=2.0,
                          pad_mode="mask", wave_slots=4)
    svc = TuckerService(policy=policy, max_inflight_waves=2, max_queue=16,
                        backpressure="block")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    svc.start()
    t0 = time.perf_counter()
    tickets = [svc.submit(x, cfg) for x in tiles]
    results = [svc.wait(tk, timeout=600) for tk in tickets]
    total = time.perf_counter() - t0
    st = svc.stats()
    svc.stop()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts = kernels.launch_counts()
    for k in ("ttt", "matmul", "ttm_interior"):
        launched[k] += counts[k]
        require(counts[k] > 0, f"hsi_tiles: kernel {k} never launched")
    require(st["requests"] == TILES_N and st["failed"] == 0,
            f"hsi_tiles: {st['requests']} completed, {st['failed']} failed")
    require_hopper(svc._plans.values(), "hsi_tiles")
    rels = [float(r.tucker.rel_error(x)) for x, r in zip(tiles, results)]
    require(all(math.isfinite(e) and e <= 0.02 for e in rels),
            f"hsi_tiles: rel_error up to {max(rels)} > 0.02")
    total_mem = torch.cuda.get_device_properties(0).total_memory
    require(peak <= 0.5 * total_mem,
            f"hsi_tiles: peak memory {peak} > 50% of {total_mem}")
    sweep_mask = sweep_cache_held()

    # mask mode against unpadded execution, on 8 sampled tiles
    picks = [int(i) for i in rng.choice(TILES_N, TILES_SAMPLED,
                                        replace=False)]
    direct = []
    for i in picks:
        p = plan(tuple(tiles[i].shape), "float32", cfg)
        require_hopper([p], "hsi_tiles direct")
        ref = p.execute(tiles[i])
        if "als" in p.methods:
            als_gate(torch, "tucker_serve", f"tile{i}", tiles[i], ranks,
                     p.methods, [st.mode for st in p.schedule])
        gap = max(projector_gap(torch, a, b) for a, b in
                  zip(results[i].tucker.factors, ref.tucker.factors))
        d_rel = abs(rels[i] - float(ref.tucker.rel_error(tiles[i])))
        direct.append(dict(tile=i, shape=list(tiles[i].shape),
                           methods=list(p.methods), projector_gap=gap,
                           d_rel_error=d_rel))
        require(gap <= 1e-3 and d_rel <= 1e-4,
                f"hsi_tiles: tile {i} against direct decompose: projector "
                f"gap {gap}, |d rel_error| {d_rel}")

    # slack rows of one padded lane, run through the bucket plan untrimmed
    bucket = policy.bucket_shape(tiles[0].shape)
    lane = next(i for i, x in enumerate(tiles) if tuple(x.shape) != bucket)
    bp = svc.plan_for(bucket, "float32", cfg)
    raw = bp.execute(pad_block(tiles[lane], bucket))
    slack = [float(u[s:].abs().max()) if u.shape[0] > s else 0.0
             for u, s in zip(raw.tucker.factors, tiles[lane].shape)]
    slack_row = dict(tile=lane, shape=list(tiles[lane].shape),
                     bucket=list(bucket), methods=list(bp.methods),
                     slack_max_by_mode=slack,
                     exactly_zero=all(v == 0.0 for v in slack))

    # the idle share of one profiled wave (4 tiles, on the warm bucket)
    def one_wave():
        ts = [svc.submit(x, cfg) for x in tiles[:4]]
        svc.drain()
        return ts

    wall = statistics.median(synced_ms(torch, one_wave, 3))
    prof = profile_call(torch, one_wave, wall)

    # exact mode: 2 whole-bucket tiles and 6 padded of distinct shapes
    sizes = [(TILE_HI, TILE_HI)] * 2
    while len(sizes) < 8:
        d = (int(rng.integers(TILE_LO, TILE_HI)),
             int(rng.integers(TILE_LO, TILE_HI)))
        if d not in sizes:
            sizes.append(d)
    ex_tiles = [cut(*d) for d in sizes]
    ex = TuckerService(policy=BucketPolicy(grid=(8, 8, 1, 1),
                                           max_pad_ratio=2.0, wave_slots=8),
                       max_queue=16)
    ex_tickets = [ex.submit(x, cfg) for x in ex_tiles]
    ex.drain()
    ex_bitwise = []
    for x, tk in zip(ex_tiles, ex_tickets):
        got, want = ex.poll(tk).tucker, decompose(x, cfg).tucker
        ex_bitwise.append(same_tucker(torch, got, want))
    require(all(ex_bitwise), f"hsi_tiles exact mode: lanes not bitwise "
            f"equal to direct decompose: {ex_bitwise}")
    require_hopper(ex._plans.values(), "hsi_tiles exact")
    ex_st = ex.stats()
    out = dict(serve_row(st, TILES_N, total), launches=counts,
               peak_bytes=peak, peak_share=peak / total_mem,
               rel_error_max=max(rels), buckets=bucket_rows(st),
               solvers=st["solvers"], direct=direct, slack=slack_row,
               wave_profile=dict(wall_ms=wall, **prof),
               sweep_cache_mask=sweep_mask,
               exact=dict(shapes=[list(x.shape) for x in ex_tiles],
                          bitwise=ex_bitwise,
                          plans_built=ex_st["plans_built"],
                          batches=ex_st["batches"],
                          sweep_cache=sweep_cache_held()))
    del base, tiles, ex_tiles, results
    return out


def resilience_checks(torch) -> dict:
    """Bisection, the NaN-lane quarantine, the breaker, a deadline and the
    capture race, all on the card."""
    import numpy as np

    from repro_torch import chaos
    from repro_torch.core import (DeadlineError, TuckerConfig, TuckerError,
                                  clear_sweep_cache)
    from repro_torch.serve import BucketPolicy, TuckerService
    cfg = TuckerConfig(ranks=RES_RANKS, impl="auto")
    policy = BucketPolicy(grid=8, pad_mode="mask", wave_slots=8)
    rng = np.random.default_rng(5)
    xs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).cuda()
          for s in RES_SHAPES]

    def run(svc, inputs, **kw):
        ts = [svc.submit(x, cfg, rid=i, **kw) for i, x in enumerate(inputs)]
        svc.drain()
        out = []
        for t in ts:
            try:
                out.append(svc.poll(t))
            except Exception as e:  # noqa: BLE001 - checked below
                out.append(e)
        return out

    def mask_service(**kw):
        return TuckerService(policy=policy, max_queue=64, **kw)

    out = {}
    chaos.reset()
    clean_svc = mask_service()
    clean = run(clean_svc, xs)
    require(all(not isinstance(r, Exception) for r in clean),
            "resilience: the clean wave failed")
    require_hopper(clean_svc._plans.values(), "resilience")
    try:
        chaos.install([chaos.Rule(seam="wave_job", action="raise",
                                  times=None, match={"rid": 2},
                                  message="synthetic poisoned request")])
        svc = mask_service()
        got = run(svc, xs)
        chaos.reset()
        res = svc.stats()["resilience"]
        ok = [i for i in (0, 1, 3) if not isinstance(got[i], Exception)
              and same_tucker(torch, got[i].tucker, clean[i].tucker)]
        require(isinstance(got[2], TuckerError) and ok == [0, 1, 3]
                and res["bisections"] >= 1,
                f"resilience bisection: rid 2 -> {type(got[2]).__name__}, "
                f"bitwise clean lanes {ok}, bisections {res['bisections']}")
        out["bisection"] = dict(error=type(got[2]).__name__,
                                bitwise_clean=ok,
                                bisections=res["bisections"])

        chaos.install([chaos.Rule(seam="wave_job_data", action="nan",
                                  times=1, match={"rid": 1})])
        svc = mask_service()
        got = run(svc, xs)
        chaos.reset()
        res = svc.stats()["resilience"]
        same = [not isinstance(r, Exception)
                and same_tucker(torch, r.tucker, c.tucker)
                for r, c in zip(got, clean)]
        require(all(same) and res["quarantined"] >= 1
                and res["recovered"] >= 1,
                f"resilience quarantine: bitwise {same}, {res}")
        out["quarantine"] = dict(quarantined=res["quarantined"],
                                 recovered=res["recovered"], bitwise=same)

        chaos.install([chaos.Rule(seam="wave", action="raise", times=None)])
        svc = mask_service(breaker_threshold=2, breaker_cooldown_s=0.2)
        for _ in range(3):
            got = run(svc, xs[:2])
            require(all(not isinstance(r, Exception) for r in got),
                    "resilience breaker: a request failed while open")
        res = svc.stats()["resilience"]
        degraded = svc.health()["status"]
        require(res["breaker_trips"] == 1 and res["isolated_waves"] >= 1
                and degraded == "degraded",
                f"resilience breaker: {res}, health {degraded}")
        chaos.reset()
        time.sleep(0.25)
        got = run(svc, xs[:2])
        res2 = svc.stats()["resilience"]
        healed = svc.health()["status"]
        require(all(not isinstance(r, Exception) for r in got)
                and res2["probe_waves"] >= 1 and res2["breakers_open"] == 0
                and healed == "ok",
                f"resilience breaker probe: {res2}, health {healed}")
        out["breaker"] = dict(trips=res["breaker_trips"],
                              isolated_waves=res["isolated_waves"],
                              probe_waves=res2["probe_waves"],
                              health=[degraded, healed])
    finally:
        chaos.reset()

    svc = mask_service()
    t = svc.submit(xs[1], cfg, deadline_s=0.001)
    time.sleep(0.01)
    svc.drain()
    try:
        svc.poll(t)
        expired = None
    except DeadlineError as e:
        expired = type(e).__name__
    require(expired == "DeadlineError"
            and svc.stats()["resilience"]["deadline_expired"] == 1,
            f"resilience deadline: {expired}")
    out["deadline"] = expired

    row, got, race = capture_race(torch)
    failed = [i for i, r in enumerate(got) if isinstance(r, Exception)]
    require(row["opened"], "capture race: the worker never began a capture")
    require(not failed and not row["submit_errors"],
            f"capture race: requests {failed[:5]} failed: "
            f"{[repr(got[i])[:200] for i in failed[:2]]}; "
            f"{row['submit_errors']} admission errors, the first "
            f"{row['first_submit_error']}")
    clear_sweep_cache()
    serial = run(TuckerService(policy=policy, max_queue=2 * RACE_N), race)
    same = [not isinstance(s, Exception)
            and same_tucker(torch, g.tucker, s.tucker)
            for g, s in zip(got, serial)]
    require(all(same), f"capture race: results not bitwise a serial run: "
            f"{same}")
    require(row["admitted_during_capture"] == RACE_N,
            f"capture race: only {row['admitted_during_capture']} of "
            f"{RACE_N} admissions ran while the capture was open")
    out["capture_race"] = dict(row, bitwise_serial=all(same),
                               control_global=race_control())
    return out


def capture_race(torch) -> tuple[dict, list, list]:
    """Hold the service's worker inside its first capture of a new bucket
    (the first segment's ``capture_begin`` has run) while this thread
    admits RACE_N CUDA inputs with ``validate="finite"`` (each a device
    synchronization); then release it.  Returns the row, each request's
    result or error, and the inputs.  Raises nothing itself."""
    import threading

    import numpy as np

    from repro_torch.core import TuckerConfig, clear_sweep_cache
    from repro_torch.core import graphs as G
    from repro_torch.serve import BucketPolicy, TuckerService
    cfg = TuckerConfig(ranks=RES_RANKS, impl="auto")
    rng = np.random.default_rng(6)
    race = [torch.from_numpy(rng.standard_normal(
        RACE_BUCKET if i % 2 == 0 else (23, 22, 24)).astype(np.float32)
        ).cuda() for i in range(RACE_N + 1)]
    torch.cuda.synchronize()
    clear_sweep_cache()
    opened, release = threading.Event(), threading.Event()
    held = {"n": 0}
    begin = G._Recorder.begin

    def holding_begin(rec):
        begin(rec)
        if threading.current_thread().name == "tucker-service" \
                and not held["n"]:
            held["n"] += 1
            opened.set()
            release.wait(timeout=RACE_WAIT_S)

    svc = TuckerService(policy=BucketPolicy(grid=8, pad_mode="mask",
                                            wave_slots=8),
                        max_queue=2 * RACE_N)
    tickets, submit_errors, inside = [], [], 0
    G._Recorder.begin = holding_begin
    try:
        svc.start()
        tickets.append(svc.submit(race[0], cfg))
        if opened.wait(timeout=RACE_WAIT_S):
            for x in race[1:]:
                try:
                    tickets.append(svc.submit(x, cfg, validate="finite"))
                except Exception as e:  # noqa: BLE001 - reported
                    submit_errors.append(repr(e)[:200])
                inside += not release.is_set()
        release.set()
        got = []
        for tk in tickets:
            try:
                got.append(svc.wait(tk, timeout=120))
            except Exception as e:  # noqa: BLE001 - reported
                got.append(e)
        st = svc.stats()
        svc.stop(force=True, join_timeout=60)
    finally:
        release.set()
        G._Recorder.begin = begin
    row = dict(capture_mode=G.CAPTURE_MODE, opened=opened.is_set(),
               admitted_during_capture=inside, requests=len(got),
               failed=sum(isinstance(r, Exception) for r in got),
               submit_errors=len(submit_errors),
               first_submit_error=submit_errors[0] if submit_errors else None,
               plans_built=st["plans_built"],
               errors=[repr(r)[:200] for r in got
                       if isinstance(r, Exception)][:2])
    return row, got, race


def race_control() -> dict:
    """The capture race again in a child process with captures in torch's
    default ``"global"`` mode, where another thread's synchronizing call is
    illegal during a capture: the control that shows the race reaches the
    hazard.  Reported, not required (the child's CUDA context may not
    survive it)."""
    import os
    code = ("import json, sys, torch\n"
            "import chip_smoke as C\n"
            "from repro_torch.core import graphs as G\n"
            "G.CAPTURE_MODE = 'global'\n"
            "row, got, race = C.capture_race(torch)\n"
            "print(json.dumps(row))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(SRC), str(ROOT)]))
    try:
        proc = subprocess.run([sys.executable, "-c", code], env=env,
                              capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired:
        return dict(exit="timeout after 300 s")
    lines = proc.stdout.strip().splitlines()
    try:
        row = json.loads(lines[-1]) if lines else {}
    except json.JSONDecodeError:
        row = {"stdout_tail": proc.stdout[-300:]}
    return dict(row, exit=proc.returncode, stderr_tail=proc.stderr[-300:])


def phase_tucker_serve(torch) -> dict:
    """The port's TuckerService on the card: stream_ref, hsi_tiles and
    resilience (see the module docstring); returns the TTT, GEMM and
    interior-TTM launches of the two streams."""
    import gc

    from repro_torch import kernels
    from repro_torch.core import clear_sweep_cache
    t_phase = time.perf_counter()
    gc.collect()
    gc.freeze()     # as in phase_tune: each capture runs gc.collect()
    launched = {k: 0 for k in ("ttt", "matmul", "ttm_interior")}
    try:
        clear_sweep_cache()
        kernels.reset_launch_counts()
        ref = serve_stream_ref(torch)
        for k in launched:
            launched[k] += kernels.launch_counts()[k]
        routes = [kernels.ttt_route_counts()]
        emit("tucker_serve", part="stream_ref", **ref)
        clear_sweep_cache()
        torch.cuda.empty_cache()
        tiles = hsi_tiles(torch, launched)
        routes.append(kernels.ttt_route_counts())
        launched["ttt_routes"] = add_routes(routes)
        emit("tucker_serve", part="hsi_tiles", **tiles)
        clear_sweep_cache()
        torch.cuda.empty_cache()
        res = resilience_checks(torch)
        emit("tucker_serve", part="resilience", **res)
    finally:
        gc.unfreeze()
        clear_sweep_cache()
        torch.cuda.empty_cache()
    emit("tucker_serve", part="summary", launches=launched,
         phase_s=time.perf_counter() - t_phase)
    return launched


# ---------------------------------------------------------------------------
# phase 6c: sharded -- the sharded backend on torch.distributed ranks
# ---------------------------------------------------------------------------

#: the accuracy limits of the main path (PERF.md §2): against the
#: single-device hopper plan on the same input
SHARD_GAP, SHARD_DREL, SHARD_REL = 1e-3, 1e-4, 0.02
#: seconds a rank's process group waits in a collective before it fails
RANK_TIMEOUT = 300
#: the engine run's request shapes (the tucker_serve anchors) and ranks
ENGINE_SHAPES = ((48, 40, 32), (64, 48, 32), (40, 40, 40))


def _digest(ts) -> str:
    import hashlib
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _kernel_counts(kernels) -> dict:
    c = kernels.launch_counts()
    return dict({k: c[k] for k in ("ttt", "matmul", "ttm_interior")},
                ttt_routes=kernels.ttt_route_counts(),
                matmul_routes=kernels.matmul_route_counts(),
                ttm_routes=kernels.ttm_route_counts())


def sharded_main_case(torch, mesh, world, rank, name, shape, ranks, methods,
                      mode_parallel="off") -> dict:
    """One full-size case on the mesh: the global input (the same on every
    rank, made from seed 0) through a sharded plan with ``impl="auto"``;
    rank 0 also runs the single-device hopper plan on it.  Returns this
    rank's row (the checks against the single-device plan on rank 0)."""
    from repro_torch import kernels
    from repro_torch.core import TuckerConfig, clear_sweep_cache, plan
    from repro_torch.core import distributed as D
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = lowrank(torch, shape, ranks, gen)
    cfg = dict(ranks=ranks, methods=methods, mode_order="shrink")
    ps = plan(shape, "float32", TuckerConfig(impl="auto", mesh=mesh,
                                             mode_parallel=mode_parallel,
                                             **cfg))
    require(ps.backend == "sharded" and ps.local_backend == "hopper",
            f"{name}: impl='auto' + mesh resolved to {ps.backend!r} on "
            f"{ps.local_backend!r}, not 'sharded' on 'hopper'")
    if mode_parallel != "off":
        require(any(s.group is not None for s in ps.schedule),
                f"{name}: mode_parallel={mode_parallel!r} formed no group")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    res = ps.execute(x)
    torch.cuda.synchronize()
    launches = _kernel_counts(kernels)
    D.reset_collective_stats()
    with D.timed_collectives():
        ps.execute(x)
    coll = D.collective_stats()
    t_sharded = synced_ms(torch, lambda: ps.execute(x), 3)   # warm: 2 ran
    ph = xp = None
    if rank == 0:
        clear_sweep_cache()
        ph = plan(shape, "float32", TuckerConfig(impl="auto", **cfg))
        require(ph.backend == "hopper",
                f"{name}: the single-device plan resolved to {ph.backend!r}")
        xp = ph._place(x)
    row = dict(case=name, world=world, rank=rank, shape=list(shape),
               ranks=list(ranks), methods=list(ps.methods),
               mode_parallel=mode_parallel,
               schedule=[dict(mode=s.mode, method=s.method,
                              shard_mode=s.shard_mode, n_shards=s.n_shards,
                              group=s.group, peak_bytes=s.peak_bytes)
                         for s in ps.schedule],
               describe=ps.describe().splitlines(),
               factors_digest=_digest(res.tucker.factors),
               core_digest=_digest([res.tucker.core]),
               launches=launches, collectives=coll,
               execute_ms=statistics.median(t_sharded),
               execute_ms_all=t_sharded)
    if rank == 0:
        ref = ph.execute(x)
        rel = float(res.tucker.rel_error(x))
        rel_h = float(ref.tucker.rel_error(x))
        gaps = [projector_gap(torch, a, b) for a, b in
                zip(res.tucker.factors, ref.tucker.factors)]
        bitwise = all(torch.equal(a, b) for a, b in
                      zip([res.tucker.core, *res.tucker.factors],
                          [ref.tucker.core, *ref.tucker.factors]))
        ph._run(xp, False)   # warm (ph.execute ran above)
        if world == 1:
            # in turns, so that the three share the card's state: the
            # sharded execute, the hopper plan's eager and captured sweeps
            ps.execute(x)   # its cache entry went with clear_sweep_cache
            ts, t_he, t_h = [], [], []
            for _ in range(3):
                for out, fn in ((ts, lambda: ps.execute(x)),
                                (t_he, lambda: ph._run(xp, False)),
                                (t_h, lambda: ph.execute(x))):
                    out.extend(synced_ms(torch, fn, 1))
            row.update(execute_ms=statistics.median(ts), execute_ms_all=ts)
        else:
            t_h = synced_ms(torch, lambda: ph.execute(x), 3)
            t_he = synced_ms(torch, lambda: ph._run(xp, False), 3)
        row.update(rel_error=rel, rel_error_hopper=rel_h,
                   max_projector_gap=max(gaps),
                   bitwise_equal_hopper=bitwise,
                   hopper_methods=list(ph.methods),
                   hopper_execute_ms=statistics.median(t_h),
                   hopper_execute_ms_all=t_h,
                   hopper_eager_ms=statistics.median(t_he),
                   hopper_eager_ms_all=t_he)
        require(math.isfinite(rel) and rel <= SHARD_REL,
                f"{name} (world {world}): rel_error {rel} > {SHARD_REL}")
        require(max(gaps) <= SHARD_GAP,
                f"{name} (world {world}): projector gap {max(gaps)} to the "
                f"single-device hopper plan > {SHARD_GAP}")
        require(abs(rel - rel_h) <= SHARD_DREL,
                f"{name} (world {world}): |rel_error - hopper| = "
                f"{abs(rel - rel_h)} > {SHARD_DREL}")
        del ref, xp
        clear_sweep_cache()
    del res, x
    torch.cuda.empty_cache()
    _barrier(world)
    return row


def profiled_device_ms(torch, fn) -> float:
    """The CUDA kernels' time of one synchronized call of ``fn`` under
    torch.profiler (CPU and CUDA activities)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3


def _barrier(world: int) -> None:
    """Wait for every rank (nothing to wait for at world 1, whose NCCL
    group then never starts a communicator)."""
    if world > 1:
        import torch.distributed as dist
        dist.barrier()


def sharded_fault_case(torch, mesh, world, rank) -> dict:
    """A rank-local out-of-memory in the middle of a sweep: Boats on the
    mesh (``methods="eig"``, a per-device cap of twice the plan's own
    capped peak, so the ladder's replan_cap rung has room), an OOM planted
    through the ``"solve"`` chaos seam at step 1 on the last rank alone --
    after step 0's collectives.  Every rank must read it in the next
    collective, take replan_cap (and nothing else), finish with factors
    equal across ranks (the phase compares digests) and within SHARD_REL
    of the input; the execute is timed beside a clean one."""
    from repro_torch import chaos, kernels
    from repro_torch.core import (TuckerConfig, clear_sweep_cache,
                                  fallback_hops, plan, reset_fallback_hops)
    shape, ranks = BOATS
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = lowrank(torch, shape, ranks, gen)
    cfg = dict(ranks=ranks, methods="eig", mode_order="shrink", impl="auto",
               mesh=mesh)
    cap = 2 * plan(shape, "float32", TuckerConfig(**cfg)).capped_peak_bytes
    p = plan(shape, "float32", TuckerConfig(memory_cap_bytes=cap, **cfg))
    t_clean = synced_ms(torch, lambda: p.execute(x), 2)
    reset_fallback_hops()
    kernels.reset_launch_counts()
    if rank == world - 1:
        chaos.install([chaos.Rule(seam="solve", action="oom", at=1)])
    t0 = time.perf_counter()
    try:
        res = p.execute(x)
        torch.cuda.synchronize()
    finally:
        fired = chaos.fired()
        chaos.reset()
    t_fault = (time.perf_counter() - t0) * 1e3
    launches = _kernel_counts(kernels)
    hops = {f"{h}/{b}": n for (h, b), n in fallback_hops().items()}
    rel = float(res.tucker.rel_error(x))
    require(hops == {"replan_cap/sharded": 1},
            f"fault (world {world}, rank {rank}): hops {hops}, not one "
            "replan_cap")
    require(math.isfinite(rel) and rel <= SHARD_REL,
            f"fault (world {world}): rel_error {rel} > {SHARD_REL}")
    row = dict(case="fault", world=world, rank=rank, cap=cap,
               planted=rank == world - 1, fired=fired, hops=hops,
               rel_error=rel, factors_digest=_digest(res.tucker.factors),
               core_digest=_digest([res.tucker.core]), launches=launches,
               execute_ms=t_fault, clean_execute_ms=t_clean)
    del res, x
    clear_sweep_cache()
    torch.cuda.empty_cache()
    _barrier(world)
    return row


def sharded_device_case(torch, mesh, world, rank) -> dict:
    """The sweeps' device time on the mesh: boats and hsi (``auto``,
    ``shrink``), each executed once warm and once under torch.profiler on
    every rank at once, and nothing after it in the rank process but the
    next such execute (in the NCCL spawn, the case after a profiled one
    once never finished: PERF.md §7).  Returns boats' row with hsi's
    beside it."""
    from repro_torch import kernels
    from repro_torch.core import TuckerConfig, clear_sweep_cache, plan
    out = {}
    for name, (shape, ranks) in (("boats", BOATS), ("hsi", HSI)):
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = lowrank(torch, shape, ranks, gen)
        p = plan(shape, "float32", TuckerConfig(ranks=ranks, mode_order="shrink",
                                                impl="auto", mesh=mesh))
        res = p.execute(x)
        wall = synced_ms(torch, lambda: p.execute(x), 1)
        kernels.reset_launch_counts()
        dev = profiled_device_ms(torch, lambda: p.execute(x))
        out[name] = dict(device_ms=dev, execute_ms=wall[0],
                         launches=_kernel_counts(kernels),
                         factors_digest=_digest(res.tucker.factors))
        del res, x
        clear_sweep_cache()
        torch.cuda.empty_cache()
        _barrier(world)
    head = out["boats"]
    return dict(case="device", world=world, rank=rank, hsi=out["hsi"], **head)


#: the profiler probe's variants (``--only profiler``): (world, backend,
#: who profiles -- every rank at once, the CPU activity alone, rank 0
#: alone, or one rank after another -- and what the rank process runs after
#: the profiled executes: more sharded executes, or a single-device plan's
#: first execute, which captures CUDA graphs)
PROFILE_VARIANTS = {
    "gloo4_cpu_cuda": (4, "gloo", "all", "sharded"),
    "gloo4_cpu": (4, "gloo", "cpu", "sharded"),
    "gloo4_cuda_rank0": (4, "gloo", "rank0", "sharded"),
    "gloo4_seq": (4, "gloo", "seq", "sharded"),
    "nccl1_then_sharded": (1, "nccl", "all", "sharded"),
    "nccl1_then_capture": (1, "nccl", "all", "capture"),
    "gloo4_then_capture": (4, "gloo", "all", "capture"),
}


def sharded_profile_case(torch, mesh, world, rank, variant) -> dict:
    """One variant of the profiler probe (PROFILE_VARIANTS): hsi on the
    mesh, two executes under torch.profiler (each its own session: the
    second tells a one-off start-up cost from a cost of every session),
    then what the variant runs after them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import TuckerConfig, clear_sweep_cache, plan
    _, _, who, after = PROFILE_VARIANTS[variant]
    shape, ranks = HSI
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = lowrank(torch, shape, ranks, gen)
    cfg = dict(ranks=ranks, mode_order="shrink", impl="auto")
    p = plan(shape, "float32", TuckerConfig(mesh=mesh, **cfg))
    res = p.execute(x)
    torch.cuda.synchronize()
    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    acts = {"all": both, "seq": both, "cpu": [ProfilerActivity.CPU],
            "rank0": both if rank == 0 else None}[who]
    turns = range(world) if who == "seq" else [rank]
    dev_ms = again_ms = None
    t0 = time.perf_counter()
    for turn in turns:
        # two executes a turn on every rank (the sweep needs them all); with
        # "seq" the others run theirs unprofiled meanwhile
        for k in range(2):
            t1 = time.perf_counter()
            if turn == rank and acts is not None:
                with profile(activities=acts) as prof:
                    p.execute(x)
                    torch.cuda.synchronize()
                if k == 0:
                    dev_ms = sum(e.time_range.elapsed_us()
                                 for e in prof.events()
                                 if e.device_type == DeviceType.CUDA) / 1e3
                else:
                    again_ms = (time.perf_counter() - t1) * 1e3
            else:
                p.execute(x)
                torch.cuda.synchronize()
        if who == "seq":
            _barrier(world)
    t_prof = (time.perf_counter() - t0) * 1e3
    if after == "sharded":
        t_after = synced_ms(torch, lambda: p.execute(x), 2)
    else:
        ph = plan(shape, "float32", TuckerConfig(**cfg))
        t_after = synced_ms(torch, lambda: ph.execute(x), 2)
        del ph
    row = dict(case=f"profile_{variant}", world=world, rank=rank,
               variant=variant, profiled=acts is not None,
               profiled_ms=t_prof, second_session_ms=again_ms,
               device_ms=dev_ms, after=after, after_ms=t_after,
               factors_digest=_digest(res.tucker.factors))
    del res, x
    clear_sweep_cache()
    torch.cuda.empty_cache()
    _barrier(world)
    return row


def sharded_cap_case(torch, mesh, world, rank) -> dict:
    """Boats with ``mode_order="opt"`` under a per-device cap of half the
    least cap the single-device hopper search admits: the single-device
    plan must refuse it (MemoryCapError) and the sharded plan admit it.
    Each rank makes only its slab on the card (the low-rank factors from
    seed 0 on every rank, the rows of the first step's shard mode cut to
    the rank's chunk, 1% noise from seed 100 + rank) and passes it as a
    DTensor.  Through the entry point, ``p.execute(dt)``, the slab plus
    what the execute allocates beyond it must stay within the cap and
    within the plan's largest modeled step peak; the kernels' launches are
    read from that execute.  Then step by step (the sweep's own loop,
    ``distributed._sweep_batches``, with a hook after each step) the same
    must hold for each step against its own modeled peak."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch import kernels
    from repro_torch.core import (MemoryCapError, TuckerConfig,
                                  clear_sweep_cache, plan)
    from repro_torch.core import distributed as D
    from repro_torch.core import tensor_ops as T
    shape, ranks = BOATS

    def single(c):
        return plan(shape, "float32", TuckerConfig(
            ranks=ranks, mode_order="opt", memory_cap_bytes=c, impl="auto"))
    least = least_cap(single)
    cap = least // 2
    try:
        single(cap)
        refused = None
    except MemoryCapError as e:
        refused = str(e)
    require(refused is not None, f"cap: the single-device plan admits "
            f"{cap} B, half its least cap {least} B")
    p = plan(shape, "float32", TuckerConfig(
        ranks=ranks, mode_order="opt", memory_cap_bytes=cap, impl="auto",
        mesh=mesh))
    require(p.backend == "sharded" and p.local_backend == "hopper",
            f"cap: the sharded plan resolved to {p.backend!r} on "
            f"{p.local_backend!r}")
    require(all(s.peak_bytes <= cap for s in p.schedule),
            "cap: a sharded step models more than the cap")
    s0 = p.schedule[0].shard_mode
    require(s0 is not None, "cap: the first step does not shard")
    gen = torch.Generator(device="cuda").manual_seed(0)
    core = torch.randn(ranks, generator=gen, device="cuda")
    us = [torch.linalg.qr(torch.randn((d, r), generator=gen,
                                      device="cuda"))[0]
          for d, r in zip(shape, ranks)]
    c = shape[s0] // world
    mine = list(us)
    mine[s0] = us[s0][rank * c:(rank + 1) * c]
    slab = T.reconstruct(core, mine)
    g2 = torch.Generator(device="cuda").manual_seed(100 + rank)
    noise = torch.randn(slab.shape, generator=g2, device="cuda")
    slab.add_(noise, alpha=0.01 * float(T.fro_norm(slab) / T.fro_norm(noise)))
    del noise, core, us, mine
    clear_sweep_cache()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    dt = DTensor.from_local(slab, mesh, [Shard(s0)])
    base = torch.cuda.memory_allocated()
    x_bytes = slab.numel() * slab.element_size()
    step_peak = max(s.peak_bytes for s in p.schedule)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res = p.execute(dt)
    torch.cuda.synchronize()
    launches = _kernel_counts(kernels)
    execute_peak = x_bytes + torch.cuda.max_memory_allocated() - base
    # per step, on the sweep's own loop (the factors and the gathered core
    # stay referenced by res, so they sit in the base of no step)
    ax = D.ShardAxis.of(mesh, p.config.resolved_shard_axis)
    inside, boundary = [], []

    def on_batch(batch, y):
        torch.cuda.synchronize()
        inside.extend([torch.cuda.max_memory_allocated() - base2]
                      * len(batch))
        boundary.append(torch.cuda.memory_allocated() - base2)
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.synchronize()
    base2 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    D._sweep_batches(slab, p.schedule, ax, p.local_backend, s0,
                     p.config.als_iters, on_batch)
    torch.cuda.empty_cache()
    over_cap = [k for k, b in enumerate(inside) if x_bytes + b > cap]
    over_model = [k for k, (s, b) in enumerate(zip(p.schedule, inside))
                  if x_bytes + b > s.peak_bytes]
    # rel_error over the mesh: each rank's slab against its rows of X̂
    f = list(res.tucker.factors)
    f[s0] = f[s0][rank * c:(rank + 1) * c]
    resid = (slab - T.reconstruct(res.tucker.core, f)).double().square().sum()
    norm = slab.double().square().sum()
    sums = torch.stack([resid, norm])
    dist.all_reduce(sums)
    rel = float((sums[0] / sums[1]).sqrt())
    row = dict(case="cap", world=world, rank=rank, shape=list(shape),
               ranks=list(ranks), cap=cap, single_least_cap=least,
               single_refusal=refused,
               schedule=[dict(mode=s.mode, method=s.method,
                              shard_mode=s.shard_mode, n_shards=s.n_shards,
                              peak_bytes=s.peak_bytes) for s in p.schedule],
               slab_bytes=x_bytes, other_bytes_before=base - x_bytes,
               execute_peak_with_slab=execute_peak,
               max_modeled_step_peak=step_peak, plan_peak_bytes=p.peak_bytes,
               max_allocated_with_slab_inside_steps=[x_bytes + b
                                                     for b in inside],
               allocated_beyond_slab_at_boundaries=boundary,
               launches=launches, rel_error=rel,
               factors_digest=_digest(res.tucker.factors))
    require(execute_peak <= cap and execute_peak <= step_peak,
            f"cap (rank {rank}): p.execute held {execute_peak} B with its "
            f"slab, over the cap {cap} or the largest modeled step peak "
            f"{step_peak}")
    require(not over_cap, f"cap (rank {rank}): steps {over_cap} exceed the "
            f"cap {cap}: {row['max_allocated_with_slab_inside_steps']}")
    require(not over_model, f"cap (rank {rank}): steps {over_model} exceed "
            f"their modeled peaks {[s.peak_bytes for s in p.schedule]}: "
            f"{row['max_allocated_with_slab_inside_steps']}")
    require(math.isfinite(rel) and rel <= SHARD_REL,
            f"cap: rel_error {rel} > {SHARD_REL}")
    del res, slab, dt
    clear_sweep_cache()
    torch.cuda.empty_cache()
    _barrier(world)
    return row


def sharded_engine_case(torch, mesh, world, rank) -> dict:
    """``TuckerBatchEngine(mesh=...)`` on 6 requests of three shapes (ranks
    (4, 4, 4), ``methods="eig"``), against the single-device engine's
    results on rank 0 (projector gap and rel_error)."""
    from repro_torch import kernels
    from repro_torch.core import TuckerConfig, clear_sweep_cache
    from repro_torch.serve import TuckerBatchEngine, TuckerRequest
    gen = torch.Generator(device="cuda").manual_seed(3)
    cfg = TuckerConfig(ranks=(4, 4, 4), methods="eig")
    xs = [lowrank(torch, s, (4, 4, 4), gen) for s in ENGINE_SHAPES * 2]
    reqs = [TuckerRequest(x=x, config=cfg, rid=i) for i, x in enumerate(xs)]
    eng = TuckerBatchEngine(mesh=mesh)
    kernels.reset_launch_counts()
    eng.run(reqs)
    torch.cuda.synchronize()
    launches = _kernel_counts(kernels)
    st = eng.stats
    eng.close()
    row = dict(case="engine", world=world, rank=rank,
               shapes=[list(s) for s in ENGINE_SHAPES],
               backends=st["backends"], plans_built=st["plans_built"],
               batches=st["batches"], launches=launches,
               factors_digest=_digest([u for r in reqs
                                       for u in r.result.tucker.factors]))
    require(st["backends"] == {"sharded": len(reqs)},
            f"engine: backends {st['backends']}")
    if rank == 0:
        clear_sweep_cache()
        ref = [TuckerRequest(x=x, config=cfg, rid=i)
               for i, x in enumerate(xs)]
        TuckerBatchEngine().run(ref)
        gaps, drel = [], []
        for a, b, x in zip(reqs, ref, xs):
            gaps.append(max(projector_gap(torch, u, v) for u, v in
                            zip(a.result.tucker.factors,
                                b.result.tucker.factors)))
            drel.append(abs(float(a.result.tucker.rel_error(x))
                            - float(b.result.tucker.rel_error(x))))
        row.update(max_projector_gap=max(gaps), max_rel_error_diff=max(drel))
        require(max(gaps) <= SHARD_GAP and max(drel) <= SHARD_DREL,
                f"engine: against the single-device engine, projector gap "
                f"{max(gaps)}, |d rel_error| {max(drel)}")
        clear_sweep_cache()
    _barrier(world)
    return row


#: the service case: SERVICE_REQS requests cycling the engine's shapes,
#: of which rank 0 expires SERVICE_EXPIRE; the last rank's ``wave`` seam
#: raises at its SERVICE_FAULT_AT-th hit
SERVICE_REQS, SERVICE_EXPIRE, SERVICE_FAULT_AT = 24, (5, 11, 17, 23), 2


def sharded_service_case(torch, mesh, world, rank) -> dict:
    """The Tucker service on the mesh, worker started on every rank: the
    same SERVICE_REQS requests (ENGINE_SHAPES at ranks (4, 4, 4),
    ``methods="eig"``, waves of 4) with the same rids on every rank; rank 0
    gives SERVICE_EXPIRE a deadline of 1 µs and the others give them an
    hour, so only rank 0's clock can expire them; the last rank's ``wave``
    chaos seam raises once, before that wave's first collective.  Before
    it, the same requests through the synchronous mesh service
    (``drain()``).  Checks on this rank: exactly SERVICE_EXPIRE fail (with
    DeadlineError), every other result bitwise the synchronous service's,
    and every Tucker kernel launched; the outcomes (a digest or an error
    class by rid) go to the phase, which holds them equal across ranks."""
    from repro_torch import chaos, kernels
    from repro_torch.core import TuckerConfig, clear_sweep_cache
    from repro_torch.serve import BucketPolicy, TuckerService
    gen = torch.Generator(device="cuda").manual_seed(5)
    cfg = TuckerConfig(ranks=(4, 4, 4), methods="eig")
    xs = [lowrank(torch, ENGINE_SHAPES[i % 3], (4, 4, 4), gen)
          for i in range(SERVICE_REQS)]
    policy = BucketPolicy(grid=1, wave_slots=4)

    def outcomes(svc, ts):
        out, res = {}, []
        for t in ts:
            try:
                r = svc.poll(t)
            except Exception as e:  # noqa: BLE001 - an outcome to compare
                out[t.rid] = type(e).__name__
                continue
            out[t.rid] = _digest([r.tucker.core, *r.tucker.factors])
            res += list(r.tucker.factors)
        return out, res

    sync = TuckerService(mesh=mesh, policy=policy, max_queue=None)
    ts = [sync.submit(x, cfg, rid=i) for i, x in enumerate(xs)]
    sync.drain()
    want, _ = outcomes(sync, ts)
    sync.close()
    svc = TuckerService(mesh=mesh, policy=policy, max_queue=None)
    if rank == world - 1:
        chaos.install([chaos.Rule(seam="wave", action="raise",
                                  at=SERVICE_FAULT_AT)])
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    svc.start()
    ts = [svc.submit(x, cfg, rid=i, deadline_s=None if i not in SERVICE_EXPIRE
                     else 1e-6 if rank == 0 else 3600.0)
          for i, x in enumerate(xs)]
    for t in ts:
        try:
            svc.wait(t, timeout=RANK_TIMEOUT / 3)
        except Exception:  # noqa: BLE001 - its outcome is compared below
            pass
    svc.stop()
    wall = time.perf_counter() - t0
    fired = chaos.fired()
    chaos.reset()
    torch.cuda.synchronize()
    launches = _kernel_counts(kernels)
    got, factors = outcomes(svc, ts)
    st = svc.stats()
    row = dict(case="service", world=world, rank=rank,
               shapes=[list(s) for s in ENGINE_SHAPES], requests=len(xs),
               outcomes=got, fired=fired, resilience=st["resilience"],
               completed=st["requests"], failed=st["failed"],
               waves=st["batches"], wall_s=wall,
               requests_per_s=st["requests"] / wall, launches=launches,
               factors_digest=_digest(factors))
    svc.close()
    clear_sweep_cache()
    expired = {r for r, v in got.items() if v == "DeadlineError"}
    require(expired == set(SERVICE_EXPIRE) and
            all(v == want[r] for r, v in got.items() if r not in expired),
            f"service (world {world}, rank {rank}): outcomes {got} against "
            f"the synchronous service's {want}")
    require(fired == ({"wave:raise": 1} if rank == world - 1 else {}),
            f"service (world {world}, rank {rank}): chaos fired {fired}")
    _barrier(world)
    return row


#: the cases each spawn of ranks runs: (world, backend, seconds its ranks
#: may take in all, [case specs]); a rank that outlives them is killed and
#: fails the phase
SHARD_SPAWNS = (
    (1, "nccl", 180, [("main", "boats", "auto", "off"),
                 ("main", "boats_eig", "eig", "off"),
                 ("main", "hsi", "auto", "off")]),
    (4, "gloo", 360, [("main", "boats", "auto", "off"),
                 ("main", "boats_eig", "eig", "off"),
                 ("main", "hsi", "auto", "off"),
                 ("main", "hsi_mp2", "auto", 2),
                 ("main", "hsi_mp_auto", "auto", "auto"),
                 ("cap",), ("fault",), ("service",)]),
    (2, "gloo", 180, [("engine",), ("fault",), ("service",)]),
    (4, "gloo", 180, [("device",)]),
)
#: the profiler probe's spawns (``--only profiler``): one world-4 gloo
#: spawn a variant, each under its own limit; a spawn that outlives it is
#: recorded as hung, not failed
PROFILE_SPAWN_LIMIT = 120


def sharded_rank(world: int, backend: str, rank: int, store: str,
                 cases) -> list[dict]:
    """One rank of a spawn: join the process group (a FileStore, a timeout),
    build the 1-D mesh over axis ``"data"`` on the card and run ``cases``.
    Prints one JSON line per case."""
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
    rows = []
    try:
        mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("data",))
        for spec in cases:
            kind = spec[0]
            if kind == "main":
                _, name, methods, mp = spec
                shape, ranks = BOATS if name.startswith("boats") else HSI
                row = sharded_main_case(torch, mesh, world, rank, name,
                                        shape, ranks, methods, mp)
            elif kind == "cap":
                row = sharded_cap_case(torch, mesh, world, rank)
            elif kind == "fault":
                row = sharded_fault_case(torch, mesh, world, rank)
            elif kind == "device":
                row = sharded_device_case(torch, mesh, world, rank)
            elif kind == "profile":
                row = sharded_profile_case(torch, mesh, world, rank, spec[1])
            elif kind == "service":
                row = sharded_service_case(torch, mesh, world, rank)
            else:
                row = sharded_engine_case(torch, mesh, world, rank)
            row["backend"] = backend
            print(json.dumps(row), flush=True)
            rows.append(row)
    finally:
        dist.destroy_process_group()
    return rows


def spawn_ranks(world: int, backend: str, limit: float,
                cases, hang_ok: bool = False) -> list[list[dict]]:
    """Run ``cases`` in ``world`` child processes (one a rank, all on the
    card) over one FileStore; the children have ``limit`` seconds, a hang
    or a non-zero exit fails the phase (a failed rank's peers, which may
    wait on it in a collective, are killed at once) -- unless ``hang_ok``,
    when the ranks that outlived the limit are killed and their rows are
    what they printed before.  Returns each rank's rows."""
    import os
    import tempfile
    code = ("import json, sys\n"
            "import chip_smoke as C\n"
            "C.sharded_rank(int(sys.argv[1]), sys.argv[2], int(sys.argv[3]),"
            " sys.argv[4], json.loads(sys.argv[5]))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(SRC), str(ROOT)]))
    with tempfile.TemporaryDirectory() as d:
        store = str(Path(d) / "store")
        logs = [(open(Path(d) / f"out{r}", "w+"), open(Path(d) / f"err{r}",
                                                          "w+"))
                for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", code, str(world), backend, str(r), store,
             json.dumps(cases)], env=env, stdout=logs[r][0],
            stderr=logs[r][1], text=True) for r in range(world)]
        hung = []
        deadline = time.monotonic() + limit
        while True:
            codes = [p.poll() for p in procs]
            if None not in codes or any(c not in (None, 0) for c in codes):
                break   # all done, or one failed (the rest may wait on it)
            if time.monotonic() > deadline:
                hung = [r for r, c in enumerate(codes) if c is None]
                break
            time.sleep(0.2)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        outs = []
        for out, err in logs:
            out.seek(0)
            err.seek(0)
            outs.append((out.read(), err.read()))
            out.close()
            err.close()
    for r, (out, err) in enumerate(outs):
        if r in hung or procs[r].returncode != 0:
            print(f"--- rank {r} of world {world} ({backend}) ---\n"
                  f"{out[-2000:]}\n{err[-3000:]}", file=sys.stderr,
                  flush=True)
    require(hang_ok or not hung, f"sharded: ranks {hung} of world {world} "
            f"({backend}) timed out after {limit} s")
    bad = [r for r, p in enumerate(procs) if p.returncode != 0
           and r not in hung]
    require(not bad, f"sharded: ranks {bad} of world {world} ({backend}) "
            f"exited {[procs[r].returncode for r in bad]}")
    return [[json.loads(ln) for ln in out.splitlines()
             if ln.startswith("{")] for out, _ in outs]


def phase_sharded(torch) -> dict:
    """The sharded backend on the card (see the module docstring): world 1
    on NCCL, world 4 on gloo (four processes time-sharing the one card) with
    the per-device cap case, world 2 on gloo through the engine.  Checks
    every rank's factors bitwise equal to rank 0's and every Tucker kernel
    launched on every rank of the full-size cases; returns the kernels'
    launches summed over ranks and cases."""
    t_phase = time.perf_counter()
    launched = {k: 0 for k in ("ttt", "matmul", "ttm_interior")}
    service = dict(launched)
    ttt_routes = []
    for world, backend, limit, cases in SHARD_SPAWNS:
        t0 = time.perf_counter()
        per_rank = spawn_ranks(world, backend, limit, cases)
        for i, spec in enumerate(cases):
            rows = [rs[i] for rs in per_rank]
            digests = {r["factors_digest"] for r in rows}
            require(len(digests) == 1, f"sharded {rows[0]['case']} (world "
                    f"{world}): factors differ across ranks {digests}")
            if spec[0] == "service":
                outs = [r["outcomes"] for r in rows]
                require(all(o == outs[0] for o in outs),
                        f"sharded service (world {world}): outcomes differ "
                        f"across ranks {outs}")
            for r in rows:
                for k in launched:
                    launched[k] += r["launches"][k]
                    if spec[0] == "service":
                        service[k] += r["launches"][k]
                ttt_routes.append(r["launches"]["ttt_routes"])
                if spec[0] in ("main", "cap", "service"):
                    missing = [k for k in launched if r["launches"][k] == 0]
                    require(not missing, f"sharded {r['case']} (world "
                            f"{world}, rank {r['rank']}): {missing} never "
                            "launched")
            head = dict(rows[0])
            head["ranks_execute_ms"] = [r.get("execute_ms") for r in rows]
            head["ranks_device_ms"] = [r.get("device_ms") for r in rows]
            head["ranks_launches"] = [r["launches"] for r in rows]
            if "collectives" in head:
                head["ranks_collectives"] = [r["collectives"] for r in rows]
            if "execute_peak_with_slab" in head:
                head["ranks_execute_peak"] = [r["execute_peak_with_slab"]
                                              for r in rows]
            emit("sharded", **head)
        emit("sharded", part="spawn", world=world, backend=backend,
             seconds=time.perf_counter() - t0)
    launched["ttt_routes"] = add_routes(ttt_routes)
    launched["service"] = service
    emit("sharded", part="summary", launches=launched,
         phase_s=time.perf_counter() - t_phase)
    return launched


def phase_profiler_probe(torch) -> dict:
    """The profiler hang of the sharded phase, reproduced: one spawn a
    variant of PROFILE_VARIANTS, under PROFILE_SPAWN_LIMIT seconds.  A
    spawn whose ranks outlive the limit is killed and reported hung (with
    the rows its ranks printed first); nothing here fails the run but a
    rank that exits with an error."""
    out = {}
    for variant, (world, backend, _, _) in PROFILE_VARIANTS.items():
        t0 = time.perf_counter()
        per_rank = spawn_ranks(world, backend, PROFILE_SPAWN_LIMIT,
                               [("profile", variant)], hang_ok=True)
        rows = [rs[0] if rs else None for rs in per_rank]
        out[variant] = dict(
            hung=[r for r, row in enumerate(rows) if row is None],
            seconds=time.perf_counter() - t0,
            device_ms=[row and row["device_ms"] for row in rows],
            profiled_ms=[row and row["profiled_ms"] for row in rows],
            second_session_ms=[row and row["second_session_ms"]
                               for row in rows],
            after_ms=[row and row["after_ms"] for row in rows])
        emit("profiler_probe", variant=variant, **out[variant])
    return out


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
    ap.add_argument("--only", choices=("kernels", "tune", "tucker_serve",
                                       "sharded", "profiler", "train",
                                       "dense", "families"),
                    help="kernels: run env, build and the kernel phases "
                         "(small and full-size shapes) only: no large "
                         "operands, main path or serve run; tune: env, "
                         "build and the tune phase only; tucker_serve: env, "
                         "build and the Tucker service phase only; sharded: "
                         "env, build and the sharded phase only; profiler: "
                         "env, build and the profiler probe of the sharded "
                         "phase's hang; train: env, build, the S6 scan's "
                         "and its backward's small shapes and the "
                         "backward's timed row, then "
                         "train, ckpt_codec and train_resume; dense: env, "
                         "build, serve_dense, dense_cache and "
                         "ckpt_codec_dense; families: env, build, "
                         "serve_moe, serve_hybrid, serve_vlm, family_cache "
                         "and ckpt_codec_moe; none prints the kernels line")
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
        if args.only == "train":
            phase_s6_shapes(torch)
            phase_s6_bwd_shapes(torch)
            s6_bwd_full(torch, peaks)
            phase_training(torch)
            emit("run", seconds=time.perf_counter() - t_run)
            print(smi, flush=True)
            return 0
        if args.only in ("tune", "tucker_serve", "sharded", "profiler",
                         "dense", "families"):
            {"tune": lambda: phase_tune(torch, smi),
             "tucker_serve": lambda: phase_tucker_serve(torch),
             "sharded": lambda: phase_sharded(torch),
             "profiler": lambda: phase_profiler_probe(torch),
             "dense": lambda: phase_dense(torch),
             "families": lambda: phase_families(torch)}[args.only]()
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
        dense_codec = phase_dense(torch)
        moe_codec = phase_families(torch)
        tucker_serve = phase_tucker_serve(torch)
        sharded = phase_sharded(torch)
        training = phase_training(torch)
        launched["s6_scan_bwd"] = training["train"]["s6_scan_bwd"]
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
                   launches_tucker_serve=tucker_serve.get(name),
                   launches_sharded=sharded.get(name),
                   launches_train=training["train"].get(name),
                   launches_ckpt_codec=training["ckpt_codec"].get(name, 0),
                   launches_ckpt_codec_dense=dense_codec["launches"].get(
                       name, 0),
                   launches_ckpt_codec_moe=moe_codec["launches"].get(name, 0),
                   launches_service=sharded["service"].get(name),
                   max_abs_err=m["max_abs_err"], ms=m["ms"],
                   plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
                   bound_by=m["bound_by"], library_ms=m["library_ms"],
                   device_ms=m["device_ms"],
                   library_device_ms=m.get("library_device_ms"),
                   launch=m["launch"])
        if name == "s6_scan_bwd":
            row.update({k: m[k] for k in (
                "shapes", "max_rel_err", "bound_terms_ms", "checkpoint_stride",
                "chunk_len", "checkpoint_bytes", "peak_bytes", "forward_ms")})
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
            # rows 1d (Cavity's B = 1 TTT on wgmma_cols) and the Gram in bf16
            row["cavity"] = {k: full["ttt_cavity"][k] for k in (
                "shapes", "route", "max_abs_err", "max_entry_err", "ms",
                "device_ms", "plain_ms", "bound_ms", "bound_by",
                "bound_terms_ms", "library_ms", "library_device_ms", "launch")}
            row["cavity"]["launches"] = launched["ttt_routes"].get(
                "wgmma_cols/ttt", 0)
            row["gram_bf16"] = {k: full["gram_bf16"][k] for k in (
                "shapes", "route", "max_abs_err", "max_entry_err", "ms",
                "device_ms", "plain_ms", "bound_ms", "bound_by",
                "bound_terms_ms", "library_ms", "library_device_ms", "launch")}
            row["launches_by_route"] = launched["ttt_routes"]
            row["launches_adaptive_by_route"] = adaptive["ttt_routes"]
            row["launches_tucker_serve_by_route"] = tucker_serve["ttt_routes"]
            row["launches_sharded_by_route"] = sharded["ttt_routes"]
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
            # rows 2c (the last mode at R = 64) and 2d (Cavity's last mode
            # at R = 20) on the wide route; launches: the last mode's wide
            # GEMMs on the main path
            row["last_r64"] = {k: full["matmul_last_r64"][k] for k in (
                "shapes", "route", "side", "max_abs_err", "max_entry_err",
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "bound_terms_ms", "library_ms", "library_device_ms",
                "slab_ms", "slab_device_ms", "bytes_per_s", "launch")}
            row["cavity"] = {k: full["matmul_cavity"][k] for k in (
                "shapes", "route", "side", "max_abs_err", "max_entry_err",
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "bound_terms_ms", "library_ms", "library_device_ms", "launch")}
            row["last_r64"]["launches"] = row["cavity"]["launches"] = \
                launched["matmul_routes"].get("wide/last", 0)
        if name == "ttm_interior":
            # row 3b: the sketch's projection at ℓ = 64 on the wide route,
            # with the 16-row slabs it replaced; launches by route
            row["l64"] = {k: full["ttm_interior_l64"][k] for k in
                          ("shapes", "route", "max_abs_err", "max_entry_err",
                           "ms", "plain_ms", "bound_ms", "bound_by",
                           "bound_terms_ms", "library_ms", "device_ms",
                           "library_device_ms", "slab_ms", "slab_device_ms",
                           "tile_fill", "energy_bias", "launch")}
            # row 3c: MNIST's mode 1 at R = 142 (the SPLIT instantiation)
            row["r142"] = {k: full["ttm_interior_r142"][k] for k in
                           ("shapes", "route", "max_abs_err", "max_entry_err",
                            "ms", "plain_ms", "bound_ms", "bound_by",
                            "bound_terms_ms", "library_ms", "device_ms",
                            "library_device_ms", "launch")}
            row["launches_by_route"] = launched["ttm_routes"]
            row["launches_adaptive_by_route"] = adaptive["ttm_routes"]
        rows.append(row)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
