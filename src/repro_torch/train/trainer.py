"""Fault-tolerant training loop: the port of ``repro/train/trainer.py``.

* auto-restore from the newest committed checkpoint (atomic-rename commits:
  a half-written checkpoint is invisible),
* two checkpoint tiers: full every ``ckpt_every`` steps, and Tucker-
  compressed "safety" checkpoints every ``compressed_ckpt_every`` (the
  paper's codec on the eligible ≥ 3-D leaves),
* deterministic (seed, step)-pure data and deterministic kernels: a
  resumed run is bitwise equal to an uninterrupted one,
* a straggler watchdog: a step slower than ``straggler_factor`` × the
  EWMA of the step times is logged,
* a metrics log (jsonl).

A checkpoint holds the train state as the reference's tree:
``TrainState(params, opt_state, step, compressor)`` with the parameters
stacked per layer (:func:`repro_torch.models.convert.tree_from_params`).
Step times are host clock around a step that ends in
``torch.cuda.synchronize`` (the reference's ``block_until_ready``).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from ..checkpoint.checkpointer import Checkpointer, tree_flatten
from ..models.convert import load_tree, tree_from_params
from ..optim import grad_compress as gc
from .train_step import TrainState


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    compressed_ckpt_every: int = 0       # 0 = off
    log_every: int = 10
    ckpt_dir: str = "build/repro_torch/ckpt"
    keep: int = 3
    straggler_factor: float = 3.0
    refresh_every: int = 20              # compressed-grad factor refresh


def state_tree(state: TrainState, device=None) -> TrainState:
    """The train state as the reference's tree: parameters stacked per
    layer (copies on ``device``, default theirs), the step as an int32
    tensor; the optimizer's and compressor's tensors as they are."""
    return TrainState(tree_from_params(state.params, device),
                      state.opt_state, torch.tensor(state.step, dtype=torch.int32),
                      state.compressor)


@torch.no_grad()
def load_state(state: TrainState, tree: TrainState) -> TrainState:
    """Copy a restored state tree into ``state`` in place; returns the state
    at the restored step."""
    load_tree(state.params, tree.params)
    rest = (state.opt_state, state.compressor)
    for dst, src in zip(tree_flatten(rest),
                        tree_flatten((tree.opt_state, tree.compressor)),
                        strict=True):
        dst.copy_(src)
    return state._replace(step=int(tree.step))


class Trainer:
    def __init__(self, tc: TrainerConfig, step_fn, state: TrainState, source,
                 *, compressed_ckpt_cfg: gc.CompressionConfig | None = None,
                 log_path: str | None = None):
        """step_fn: callable(state, batch) → (state, metrics), or a
        {True/False: fn} dict for refresh-cadenced compressed training."""
        self.tc = tc
        self.step_fn = step_fn
        self.state = state
        self.source = source
        self.ckpt = Checkpointer(tc.ckpt_dir, keep=tc.keep)
        self.compressed_ckpt_cfg = compressed_ckpt_cfg
        self.log_path = Path(log_path) if log_path else None
        self.history: list[dict] = []
        self._ewma = None

    # -- fault tolerance ------------------------------------------------------
    def restore_if_available(self) -> int:
        restored = self.ckpt.restore(state_tree(self.state, "cpu"))
        if restored is None:
            return 0
        tree, step = restored
        self.state = load_state(self.state, tree)
        print(f"[trainer] restored checkpoint at step {step}")
        return int(step)

    def _save(self, step: int, *, compress: bool = False, blocking=False):
        # the codec runs on the parameters' device; a full save stacks on
        # the host
        tree = state_tree(self.state, None if compress else "cpu")
        self.ckpt.save(step, tree, blocking=blocking,
                       compress_cfg=self.compressed_ckpt_cfg if compress else None)

    # -- main loop ---------------------------------------------------------
    def run(self, start_step: int | None = None) -> list[dict]:
        step = self.restore_if_available() if start_step is None else start_step
        tc = self.tc
        dev = next(self.state.params.parameters()).device
        while step < tc.total_steps:
            batch = self.source.batch_at(step)
            t0 = time.perf_counter()
            fn = self.step_fn
            if isinstance(fn, dict):           # compressed variant pair
                fn = self.step_fn[step % tc.refresh_every == 0]
            self.state, metrics = fn(self.state, batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0

            self._watchdog(step, dt)
            step += 1

            if step % tc.log_every == 0 or step == tc.total_steps:
                rec = {"step": step, "dt_s": dt,
                       **{k: float(v) for k, v in metrics.items()}}
                self.history.append(rec)
                print(f"[trainer] step {step}: loss={rec['loss']:.4f} "
                      f"({dt * 1e3:.0f} ms)")
                if self.log_path:
                    with self.log_path.open("a") as f:
                        f.write(json.dumps(rec) + "\n")

            if tc.ckpt_every and step % tc.ckpt_every == 0:
                self._save(step)
            elif (tc.compressed_ckpt_every
                  and step % tc.compressed_ckpt_every == 0):
                self._save(step, compress=True)
        self._save(tc.total_steps, blocking=True)
        return self.history

    def _watchdog(self, step: int, dt: float):
        if self._ewma is None:
            self._ewma = dt
        if dt > self.tc.straggler_factor * self._ewma and step > 3:
            print(f"[trainer] WARNING straggler: step {step} took {dt:.2f}s "
                  f"(ewma {self._ewma:.2f}s) — flagged for eviction")
        self._ewma = 0.9 * self._ewma + 0.1 * dt
