"""Train-step factory: microbatched gradient accumulation, optional
Tucker-compressed gradient reduction, optimizer update.  The port of
``repro/train/train_step.py``.

Steps run eagerly and update the model and the optimizer state in place
(PyTorch has no ``jit`` to donate buffers to).  The parameters live in the
port's :class:`~repro_torch.models.lm.LM`; the optimizer, the compressor
and the checkpoints see them as the reference's tree
(:func:`repro_torch.models.convert.param_tree`).

* :func:`make_train_step` — the plain step.
* :func:`make_compressed_train_step` — ``{True: refresh, False: plain}``
  steps whose gradients go through :func:`repro_torch.optim.grad_compress.
  compress_psum`: across the processes of a ``torch.distributed`` group
  (one process per pod, each on its slice of the global batch), or with no
  group on one process, the reference's ``n_pods = 1``.  The trainer picks
  the refresh step by its cadence.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..models import shardings
from ..models.convert import map_leaves, param_tree
from ..models.lm import LM
from ..models.registry import ModelBundle
from ..optim import grad_compress as gc
from ..optim.adamw import AdamW, AdamWState


class TrainState(NamedTuple):
    params: LM
    opt_state: AdamWState
    step: int
    compressor: Any = None          # grad-compression state (or None)


def init_state(bundle: ModelBundle, optimizer: AdamW, seed: int = 0,
               compression: gc.CompressionConfig | None = None,
               device=None) -> TrainState:
    """Random parameters from ``seed`` on ``device`` (default ``cuda:0``),
    made trainable, with zero optimizer (and compressor) state."""
    params = bundle.init(seed, device)
    params.requires_grad_(True)
    tree = param_tree(params)
    comp = None
    if compression is not None and compression.enabled:
        comp = gc.init_state(compression, tree)
    return TrainState(params, optimizer.init(tree), 0, comp)


def _grads(params: LM, fp32: bool) -> dict:
    """The parameters' ``.grad`` in the tree's layout (fp32 copies when
    asked)."""
    def grad(p):
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        return g.float() if fp32 else g
    return map_leaves(lambda leaf: [grad(p) for p in leaf]
                      if isinstance(leaf, list) else grad(leaf),
                      param_tree(params))


def _accumulate_grads(loss_fn, params: LM, batch: dict, n_micro: int):
    """Mean gradients (in the tree's layout) and mean metrics over
    ``n_micro`` slices of the batch.  One slice leaves the gradients in the
    parameters' dtype; more sum them in fp32 and scale by 1/n_micro, as the
    reference's fp32 ``zero_g`` accumulator does."""
    params.zero_grad(set_to_none=True)
    if n_micro <= 1:
        loss, metrics = loss_fn(params, batch)
        loss.backward()
        return _grads(params, False), {**{k: v.detach() for k, v in
                                          metrics.items()},
                                       "loss": loss.detach()}
    b = next(iter(batch.values())).shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
    acc, macc = None, None
    for i in range(n_micro):
        # each slice re-pinned to the data axes on a mesh, as the
        # reference's scan re-pins its microbatches
        mb = {k: shardings.constrain_batch(
            shardings.micro_batch(v, i, n_micro)) for k, v in batch.items()}
        loss, metrics = loss_fn(params, mb)
        loss.backward()
        g = _grads(params, True)
        params.zero_grad(set_to_none=True)
        m = {**{k: v.detach() for k, v in metrics.items()}, "loss": loss.detach()}
        if acc is None:
            acc, macc = g, m
        else:
            acc = map_leaves(lambda x, y: [p.add_(q) for p, q in zip(x, y)]
                             if isinstance(x, list) else x.add_(y), acc, g)
            macc = {k: macc[k] + m[k] for k in macc}
    scale = 1.0 / n_micro
    grads = map_leaves(lambda x: [p.mul_(scale) for p in x]
                       if isinstance(x, list) else x.mul_(scale), acc)
    return grads, {k: v * scale for k, v in macc.items()}


def make_train_step(bundle: ModelBundle, optimizer: AdamW, *, n_micro: int = 1):
    """The plain step: (state, batch) → (state, metrics)."""

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        grads, metrics = _accumulate_grads(bundle.loss, state.params, batch,
                                           n_micro)
        _, opt_state, om = optimizer.update(grads, state.opt_state,
                                            param_tree(state.params))
        del grads
        state.params.zero_grad(set_to_none=True)
        return (TrainState(state.params, opt_state, state.step + 1,
                           state.compressor), {**metrics, **om})

    return step


def make_compressed_train_step(bundle: ModelBundle, optimizer: AdamW,
                               compression: gc.CompressionConfig, *,
                               group=None, n_micro: int = 1):
    """Returns {True: refresh_step, False: plain_step}.  With a ``group``,
    each process takes its rank's slice of the global batch's first axis,
    and the loss in the metrics is the group's mean."""

    def make(refresh: bool):
        def step(state: TrainState, batch) -> tuple[TrainState, dict]:
            if group is not None:
                world = torch.distributed.get_world_size(group)
                rank = torch.distributed.get_rank(group)
                batch = {k: v.chunk(world)[rank] for k, v in batch.items()}
            grads, metrics = _accumulate_grads(bundle.loss, state.params,
                                               batch, n_micro)
            red, new_comp, stats = gc.compress_psum(
                compression, grads, state.compressor, refresh=refresh,
                group=group)
            del grads
            loss = metrics["loss"]
            if group is not None:
                loss = loss.clone()
                torch.distributed.all_reduce(loss, group=group)
                loss = loss / torch.distributed.get_world_size(group)
            metrics = {**metrics, "loss": loss,
                       "comp_ratio": torch.tensor(stats["ratio"]),
                       "bytes_dense": stats["bytes_dense"],
                       "bytes_compressed": stats["bytes_compressed"]}
            _, opt_state, om = optimizer.update(red, state.opt_state,
                                                param_tree(state.params))
            del red
            state.params.zero_grad(set_to_none=True)
            return (TrainState(state.params, opt_state, state.step + 1,
                               new_comp), {**metrics, **om})

        return step

    return {True: make(True), False: make(False)}
