#!/usr/bin/env python3
"""Diagnostics of the PyTorch/CUDA port on the card, kept apart from
``chip_smoke.py`` (which they reuse).  Imports nothing of JAX.

``python3 chip_diag.py alog``
    Trains falcon-mamba-7b cut to 16 layers as ``chip_smoke.py``'s train
    phase does, then takes the stacked ``a_log`` (16, 8192, 16), the
    checkpoint codec's near-exact leaf, at the codec's ranks (16, 64, 4)
    and methods (eig, als, eig) and prints one JSON line per variant of its
    st-HOSVD (modes in order, ALS seed 0): rel_error and each mode's
    projector gap against ``matfree``'s factors.  The variants: ``hopper``
    and ``matfree`` with the port's ``solvers._spd_inverse`` and with the
    reference's jitter ladder (no resolution gate); under the reference's
    ladder also ``hopper`` with one piece at a time put back to
    ``matfree`` (the Gram, the TTT, the TTMs), and with the solver's QR,
    Cholesky and ``eigh`` run in float64.  The leaf is saved to
    ``chiprun_out/alog.pt`` for the CPU.

``python3 chip_diag.py alog-emulate LEAF`` (any machine)
    The same st-HOSVD of a leaf saved by ``alog`` on the CPU, under the
    reference's ladder and the port's: ``matfree`` in float64 and fp32,
    and the card's arithmetic emulated by ``kernels/ref.py`` (the TTT and
    Gram at R > 16 as ``csrc/ttt.cu`` sums them, the interior TTM at R >
    16 as ``csrc/wgmma.cuh`` does, the rest fp32), also with its TTT
    exact in fp32 and with its TTT on the wide GEMM's grid sums.

``python3 chip_diag.py grads TREE TAG``
    One training step's gradients of falcon-mamba-7b cut to 16 layers at
    (2, 2048), parameters and batch from seed 0, computed by the port in
    the source tree ``TREE`` (a checkout's root, e.g. a parent commit
    unpacked with ``git archive``): 16,384 sampled entries of every
    parameter's gradient (the same indices in every tree) and the loss,
    saved to ``chiprun_out/grads_TAG.pt``.

``python3 chip_diag.py grads-compare A B`` (any machine)
    Two such samples against each other: the loss, the share of entries
    that differ, the sign flips among nonzero entries, and the relative
    difference of each layer's gradients (median over its parameters).

``python3 chip_diag.py paths TREE TAG``
    Two of ``chip_smoke.py``'s paths as the source tree ``TREE`` runs
    them, to hold one tree against another in one call: the falcon-mamba-7b
    ``serve`` phase of that tree's ``chip_smoke.py`` (its lines carry the
    captured decode step's ms, ``decode_ms_median``, and the eager one's,
    ``graphs.decode_ms_eager``), then ``TuckerBatchEngine(mesh=...)`` on
    two gloo ranks with the ``sharded`` phase's engine requests (6 of
    ``ENGINE_SHAPES`` at ranks (4, 4, 4), ``eig``): one cold run, then
    ENGINE_REPS warm runs, each timed from a barrier to the card's
    synchronize on every rank.  Prints ``engine_time`` lines tagged TAG,
    with the wall ms and calls of the decision channel's collectives
    (``core/distributed.py`` ``Decisions``, where the tree has it).

``python3 chip_diag.py engine TREE TAG VARIANT``
    The engine part of ``paths`` alone; VARIANT ``serial`` holds the
    service to one wave in flight (``_max_inflight = 1``), ``default``
    leaves it.
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"


def alog() -> None:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from unittest import mock

    import torch

    import chip_smoke as cs
    from repro_torch.checkpoint.checkpointer import tree_flatten
    from repro_torch.core import solvers
    from repro_torch.core import tensor_ops as T
    from repro_torch.core.backend import backend_ops
    from repro_torch.models.convert import tree_from_params
    cs.phase_env(torch)
    cs.phase_build()
    params, _ = cs.phase_train(torch)
    x = next(v for v in tree_flatten(tree_from_params(params))
             if tuple(v.shape) == (16, 8192, 16)).float()
    del params
    OUT.mkdir(exist_ok=True)
    torch.save({"x": x.cpu()}, OUT / "alog.pt")
    ranks, methods = (16, 64, 4), ("eig", "als", "eig")
    hop, mf = backend_ops("hopper"), backend_ops("matfree")
    gated = solvers._spd_inverse

    def reference(a):
        return cs.reference_ladder(torch, a)

    def widen(fn):
        def call(a, *args):
            out = fn(a.double(), *(v.double() if torch.is_tensor(v)
                                   and v.is_floating_point() else v
                                   for v in args))
            if isinstance(out, tuple):
                return tuple(v.to(a.dtype) if v.is_floating_point() else v
                             for v in out)
            return out.to(a.dtype)
        return call

    def run(ops, inverse, wide=False):
        patches = [mock.patch.object(solvers, "_spd_inverse", inverse)]
        if wide:
            patches += [mock.patch.object(torch.linalg, "qr",
                                          widen(torch.linalg.qr)),
                        mock.patch.object(torch.linalg, "cholesky_ex",
                                          widen(torch.linalg.cholesky_ex)),
                        mock.patch.object(torch, "cholesky_solve",
                                          widen(torch.cholesky_solve)),
                        mock.patch.object(solvers.G, "eigh",
                                          widen(solvers.G.eigh))]
        for p in patches:
            p.start()
        try:
            y, us = x, []
            for m, meth in enumerate(methods):
                u, y = solvers.SOLVERS[meth](y, m, ranks[m], impl=ops)
                us.append(u)
            return us, float(T.rel_error(x, y, us))
        finally:
            for p in reversed(patches):
                p.stop()

    base = {}
    for ladder, inverse in (("port", gated), ("reference", reference)):
        base[ladder] = run(mf, inverse)
        variants = {"hopper": (hop, False)}
        if ladder == "reference":
            variants.update({
                "gram=matfree": ((hop[0], mf[1], hop[2]), False),
                "ttt=matfree": ((hop[0], hop[1], mf[2]), False),
                "ttm=matfree": ((mf[0], hop[1], hop[2]), False),
                "linalg=float64": (hop, True)})
        cs.emit("alog", ladder=ladder, variant="matfree",
                rel_error=base[ladder][1])
        for name, (ops, wide) in variants.items():
            us, err = run(ops, inverse, wide)
            gaps = [cs.projector_gap(torch, u.float(), v.float())
                    for u, v in zip(us, base[ladder][0])]
            cs.emit("alog", ladder=ladder, variant=name, rel_error=err,
                    gaps=gaps)


def alog_emulate(path: str) -> None:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import math
    from unittest import mock

    import torch

    import chip_smoke as cs
    from repro_torch.core import solvers
    from repro_torch.core import tensor_ops as T
    from repro_torch.kernels import ref
    x = torch.load(path)["x"].float()
    ranks, methods = (16, 64, 4), ("eig", "als", "eig")

    def as3(v, mode):
        return v.reshape(math.prod(v.shape[:mode]), v.shape[mode], -1)

    def card(ttt_kind):
        def ttm(v, u, mode):
            if u.shape[0] <= 16 or mode in (0, v.ndim - 1):
                return T.ttm(v, u, mode)
            shape = list(v.shape)
            shape[mode] = u.shape[0]
            return ref.ttm_tf32x3_ref(u, as3(v, mode)).reshape(shape)

        def tc(v, y, mode, scheme):
            if y.shape[mode] <= 16 or scheme is None:
                return T.ttt(v, y, mode)
            return ref.ttt_tf32x3_ref(as3(v, mode), as3(y, mode),
                                      truncate=True, scheme=scheme)
        return (ttm, lambda v, mode: tc(v, v, mode, "stage"),
                lambda v, y, mode: tc(v, y, mode, ttt_kind))

    variants = {"matfree_f64": ("matfree", True), "matfree": ("matfree", False),
                "card": (card("stage"), False),
                "card_ttt_fp32": (card(None), False),
                "card_ttt_grid": (card("grid"), False)}
    for ladder in ("reference", "port"):
        inverse = solvers._spd_inverse if ladder == "port" else \
            (lambda a: cs.reference_ladder(torch, a))
        row = {}
        with mock.patch.object(solvers, "_spd_inverse", inverse):
            for name, (ops, f64) in variants.items():
                v = x.double() if f64 else x
                y, us = v, []
                for m, meth in enumerate(methods):
                    u, y = solvers.SOLVERS[meth](y, m, ranks[m], impl=ops)
                    us.append(u)
                row[name] = float(T.rel_error(v.double(), y.double(),
                                              [u.double() for u in us]))
        print(json.dumps({"phase": "alog_emulate", "leaf": path,
                          "ladder": ladder, "rel_error": row}), flush=True)


def grads(tree: str, tag: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch

    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import build
    cfg = configs.get("falcon-mamba-7b").with_(n_layers=16)
    bundle = build(cfg)
    params = bundle.init(0, "cuda")
    params.requires_grad_(True)
    batch = SyntheticLM(DataConfig(seed=0), cfg, 2048, 2,
                        device="cuda").batch_at(0)
    loss, _ = bundle.loss(params, batch)
    loss.backward()
    out = {"loss": float(loss.detach())}
    for i, (name, p) in enumerate(params.named_parameters()):
        g = p.grad.float().flatten()
        idx = torch.randint(0, g.numel(), (min(g.numel(), 16384),),
                            generator=torch.Generator().manual_seed(1000 + i))
        out[name] = {"numel": g.numel(), "sample": g[idx.cuda()].cpu()}
    OUT.mkdir(exist_ok=True)
    torch.save(out, OUT / f"grads_{tag}.pt")
    print(json.dumps({"phase": "grads", "tag": tag, "loss": out["loss"],
                      "params": len(out) - 1}), flush=True)


def grads_compare(a_path: str, b_path: str) -> None:
    import re

    import torch
    a, b = torch.load(a_path), torch.load(b_path)
    flips = nonzero = differ = 0
    by_layer: dict[str, list[float]] = {}
    for name in a:
        if name == "loss":
            continue
        x, y = a[name]["sample"].double(), b[name]["sample"].double()
        nz = (x != 0) | (y != 0)
        flips += int((torch.sign(x) != torch.sign(y))[nz].sum())
        nonzero += int(nz.sum())
        differ += int((x != y).sum())
        rel = float((x - y).norm() / y.norm()) if y.norm() > 0 else 0.0
        m = re.match(r"layers\.(\d+)\.", name)
        by_layer.setdefault(m.group(1) if m else name, []).append(rel)
    print(json.dumps({
        "phase": "grads_compare", "loss": [a["loss"], b["loss"]],
        "entries_nonzero": nonzero, "entries_differing": differ,
        "share_differing": differ / nonzero, "sign_flips": flips,
        "share_sign_flips": flips / nonzero,
        "rel_diff_median_by_layer": {k: statistics.median(v)
                                     for k, v in by_layer.items()}}))


ENGINE_REPS = 10


def _tree(tree: str) -> Path:
    root = Path(tree).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    return root


def paths(tree: str, tag: str) -> None:
    import time
    root = _tree(tree)
    import torch

    import chip_smoke as cs
    cs.phase_env(torch)
    cs.phase_build()
    t = time.perf_counter()
    cs.phase_serve(torch)
    print(json.dumps({"phase": "paths", "tag": tag, "serve_s":
                      time.perf_counter() - t}), flush=True)
    torch.cuda.empty_cache()
    _engine(root, tag, "default")


def engine(tree: str, tag: str, variant: str) -> None:
    root = _tree(tree)
    import torch

    import chip_smoke as cs
    cs.phase_env(torch)
    cs.phase_build()
    _engine(root, tag, variant)


def _engine(root: Path, tag: str, variant: str) -> None:
    import os
    import subprocess
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        store = str(Path(d) / "store")
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "engine-rank",
             str(root), tag, variant, str(r), store],
            env=dict(os.environ), stdout=subprocess.PIPE, text=True)
            for r in range(2)]
        try:
            outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    print("".join(outs), end="", flush=True)
    codes = [p.returncode for p in procs]
    if codes != [0, 0]:
        raise SystemExit(f"engine ranks exited {codes}")


def _timed_decisions(dist_mod) -> dict:
    """Wrap the decision channel's collectives (where the tree has one)
    to add up their wall ms and calls, by method."""
    spent: dict = {}
    cls = getattr(dist_mod, "Decisions", None)
    for name in ("send", "recv", "agree", "agree_lanes") if cls else ():
        real = getattr(cls, name)

        def timed(self, *a, _real=real, _name=name):
            import time
            t = time.perf_counter()
            try:
                return _real(self, *a)
            finally:
                ms, n = spent.get(_name, (0.0, 0))
                spent[_name] = (ms + (time.perf_counter() - t) * 1e3, n + 1)
        setattr(cls, name, timed)
    return spent


def engine_rank(tree: str, tag: str, variant: str, rank: int,
                store: str) -> None:
    import datetime
    import time
    _tree(tree)
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import chip_smoke as cs
    from repro_torch.core import TuckerConfig
    from repro_torch.core import distributed as rdist
    from repro_torch.serve import TuckerBatchEngine, TuckerRequest
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=240))
    mesh = init_device_mesh("cuda", (2,), mesh_dim_names=("data",))
    gen = torch.Generator(device="cuda").manual_seed(3)
    cfg = TuckerConfig(ranks=(4, 4, 4), methods="eig")
    xs = [cs.lowrank(torch, s, (4, 4, 4), gen) for s in cs.ENGINE_SHAPES * 2]
    spent = _timed_decisions(rdist)
    eng = TuckerBatchEngine(mesh=mesh)
    if variant == "serial":
        eng.service._max_inflight = 1
    ms, dec = [], []
    for k in range(ENGINE_REPS + 1):
        reqs = [TuckerRequest(x=x, config=cfg, rid=100 * k + i)
                for i, x in enumerate(xs)]
        dist.barrier()
        torch.cuda.synchronize()
        spent.clear()
        t = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        dec.append(dict(spent))
    st = eng.stats
    getattr(eng, "close", lambda: None)()
    dist.destroy_process_group()
    warm = dec[1:]
    print(json.dumps({
        "phase": "engine_time", "tag": tag, "variant": variant, "rank": rank,
        "requests": len(xs), "backends": st["backends"],
        "batches": st["batches"], "cold_ms": ms[0], "warm_ms": ms[1:],
        "warm_ms_median": statistics.median(ms[1:]),
        "decision_ms_median": statistics.median(
            sum(v[0] for v in d.values()) for d in warm),
        "decision_calls": {k: v[1] for k, v in warm[-1].items()},
        "decision_ms_by_call": {k: v[0] for k, v in warm[-1].items()}}),
        flush=True)


def main(argv: list[str]) -> int:
    if argv[:1] == ["alog"] and len(argv) == 1:
        alog()
    elif argv[:1] == ["alog-emulate"] and len(argv) == 2:
        alog_emulate(argv[1])
    elif argv[:1] == ["grads"] and len(argv) == 3:
        grads(argv[1], argv[2])
    elif argv[:1] == ["grads-compare"] and len(argv) == 3:
        grads_compare(argv[1], argv[2])
    elif argv[:1] == ["paths"] and len(argv) == 3:
        paths(argv[1], argv[2])
    elif argv[:1] == ["engine"] and len(argv) == 4:
        engine(argv[1], argv[2], argv[3])
    elif argv[:1] == ["engine-rank"] and len(argv) == 6:
        engine_rank(argv[1], argv[2], argv[3], int(argv[4]), argv[5])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
