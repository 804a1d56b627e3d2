"""Shared helpers for the PyTorch port's parity tests against the JAX reference.

Inputs are made with numpy from a seed and the same arrays go to both
packages; results come back to numpy (float64) for comparison.  Factors are
compared by projector U·Uᵀ (eigenvector signs and the order within a
degenerate subspace are free) and decompositions by ``rel_error``.
"""

from __future__ import annotations

import numpy as np
import torch


def to_np(a) -> np.ndarray:
    """float64 numpy copy of a torch tensor or a jax/numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().double().numpy()
    return np.asarray(a).astype(np.float64)


def projector(u) -> np.ndarray:
    u = to_np(u)
    return u @ u.T


def max_projector_gap(us, vs) -> float:
    """max over modes of max|U Uᵀ − V Vᵀ|."""
    return max(float(np.abs(projector(a) - projector(b)).max())
               for a, b in zip(us, vs))


def reconstruct_np(core, factors) -> np.ndarray:
    """X̂ = G ×_1 U^(1) ··· ×_N U^(N) in float64 numpy."""
    y = to_np(core)
    for mode, u in enumerate(factors):
        y = np.moveaxis(np.tensordot(to_np(u), y, axes=(1, mode)), 0, mode)
    return y


def rel_error_np(x, core, factors) -> float:
    x = to_np(x)
    return float(np.linalg.norm(x - reconstruct_np(core, factors))
                 / np.linalg.norm(x))


def lowrank(dims, ranks, seed: int = 0, noise: float = 0.0) -> np.ndarray:
    """float32 low-rank tensor at ``ranks`` (orthonormal factors, Gaussian
    core) plus Gaussian noise at ``noise`` × its RMS."""
    rng = np.random.default_rng(seed)
    core = rng.standard_normal(ranks)
    us = [np.linalg.qr(rng.standard_normal((d, r)))[0]
          for d, r in zip(dims, ranks)]
    x = reconstruct_np(core, us)
    if noise:
        x = x + noise * np.sqrt(np.mean(x ** 2)) * rng.standard_normal(dims)
    return x.astype(np.float32)


def assert_tucker_close(x, got, want, *, proj_atol: float,
                        rel_atol: float, recon_atol: float | None = None):
    """Hold two decompositions of ``x`` to each other: per-mode projectors
    within ``proj_atol``, ``rel_error`` within ``rel_atol`` and, when given,
    the reconstructions within ``recon_atol`` × max|x|."""
    gap = max_projector_gap(got.factors, want.factors)
    assert gap <= proj_atol, f"projector gap {gap} > {proj_atol}"
    e_got = rel_error_np(x, got.core, got.factors)
    e_want = rel_error_np(x, want.core, want.factors)
    assert abs(e_got - e_want) <= rel_atol, (e_got, e_want)
    if recon_atol is not None:
        diff = np.abs(reconstruct_np(got.core, got.factors)
                      - reconstruct_np(want.core, want.factors)).max()
        bound = recon_atol * np.abs(to_np(x)).max()
        assert diff <= bound, f"reconstructions differ by {diff} > {bound}"


# ---------------------------------------------------------------------------
# Multi-process gloo ranks on the CPU (the sharded path's tests)
# ---------------------------------------------------------------------------

_RANK_PREAMBLE = '''
import datetime, pickle, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
rank, world, _dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
with open(f"{_dir}/data.pkl", "rb") as _f:
    data = pickle.load(_f)
dist.init_process_group(
    "gloo", store=dist.FileStore(f"{_dir}/store", world), rank=rank,
    world_size=world, timeout=datetime.timedelta(seconds=%(timeout)d))
mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
out = {}
'''

_RANK_POSTAMBLE = '''
dist.barrier()
with open(f"{_dir}/out{rank}.pkl", "wb") as _f:
    pickle.dump(out, _f)
dist.destroy_process_group()
'''


def run_ranks(tmp_dir, world: int, body: str, *, timeout: float = 120.0,
              **data) -> list[dict]:
    """Run ``body`` as ``world`` gloo ranks on the CPU, each in its own
    Python process, and return every rank's ``out`` dict (rank order).

    Each rank joins a process group over a ``dist.FileStore`` under
    ``tmp_dir`` (no TCP port, so parallel test workers cannot collide) and
    finds ``rank``, ``world``, a 1-D ``DeviceMesh`` ``mesh`` over the axis
    ``"data"`` and ``data`` (the keyword arguments, pickled) in its
    namespace (names starting with ``_`` are the runner's own); ``body`` fills the dict ``out`` with picklable values (numpy
    arrays, not tensors).  Every rank and the process group time out after
    ``timeout`` seconds: a deadlock fails the test instead of hanging the
    suite, and a rank that exits non-zero fails it with its output."""
    import os
    import pickle
    import subprocess
    import sys
    import textwrap
    import time
    from pathlib import Path

    d = Path(tmp_dir)
    d.mkdir(parents=True, exist_ok=True)
    with open(d / "data.pkl", "wb") as f:
        pickle.dump(data, f)
    script = d / "rank.py"
    script.write_text(_RANK_PREAMBLE % {"timeout": int(timeout)}
                      + textwrap.dedent(body) + _RANK_POSTAMBLE)
    here = Path(__file__).resolve().parent
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(here.parent / "src"),
                                           str(here)]))
    logs = [open(d / f"log{r}.txt", "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(world), str(d)],
                              stdout=logs[r], stderr=subprocess.STDOUT,
                              env=env) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            p.kill()
            p.wait(timeout=30)
    text = []
    for r, log in enumerate(logs):
        log.seek(0)
        text.append(f"--- rank {r} (rc {procs[r].returncode}) ---\n"
                    + log.read()[-4000:])
        log.close()
    report = "\n".join(text)
    assert not hung, f"{len(hung)} rank(s) timed out after {timeout}s\n{report}"
    assert all(p.returncode == 0 for p in procs), report
    outs = []
    for r in range(world):
        with open(d / f"out{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs
