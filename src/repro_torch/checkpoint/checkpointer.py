"""Atomic, asynchronous checkpointing with an optional Tucker-compressed
tier (a-Tucker as the checkpoint codec): the port of
``repro/checkpoint/checkpointer.py``, with its layout on disk.

  <dir>/step_000000123.tmp/ … → <dir>/step_000000123/
      meta.json            {step, time, treedef, leaves: [{kind, file, dtype, shape}]}
      arr_<i>.npy          one file per leaf (np.save; bf16 stored as a uint16 view)
      tucker_<i>.npz       compressed leaves: core, n_factors, factor_<n>

A tree is nested dicts (keys sorted), lists and tuples (named tuples
included) whose leaves are tensors or arrays; None holds no leaf.  Its
leaves are numbered in the order ``jax.tree_util`` flattens the same
structure, so a parameter tree written by either package restores in the
other.  ``meta.json``'s ``treedef`` is this package's own description of
the structure (the reference writes JAX's ``PyTreeDef``); neither package
reads it back.

``save`` snapshots every leaf to host memory at once (running the Tucker
codec first, on the leaf's device) and writes the files on a thread;
``wait`` joins it.  ``restore`` loads the newest committed step: a
directory whose rename never happened is ignored, which is the
crash-recovery path.  ``keep`` committed steps are kept.
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..core import tensor_ops as T

#: numpy has no bf16: such leaves are stored as a same-width uint view
_UINT_VIEW = {1: np.uint8, 2: np.uint16, 4: np.uint32}


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def tree_flatten(tree: Any) -> list:
    """The leaves of ``tree`` in ``jax.tree_util``'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_flatten(v)]
    return [tree]


def tree_unflatten(like: Any, leaves: list) -> Any:
    """``like``'s structure with ``leaves`` in place of its own."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the structure holds")
    return out


def treedef(tree: Any) -> str:
    """A description of ``tree``'s structure, leaves as ``*``."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        body = ", ".join(treedef(v) for v in tree)
        name = type(tree).__name__ if hasattr(tree, "_fields") else ""
        return f"{name}({body})" if isinstance(tree, tuple) else f"[{body}]"
    return "*"


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def _to_host(leaf) -> np.ndarray:
    """A host copy of a leaf (bf16 as its uint16 view)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    a = np.array(leaf)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.view(_UINT_VIEW[a.dtype.itemsize])
    return a


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A tensor of ``dtype`` (the name meta.json records) from a stored
    array, re-viewing a uint-stored bf16 leaf."""
    if dtype == "bfloat16":
        if arr.dtype == np.uint16:
            return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(np.asarray(arr, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(getattr(torch, dtype))


# ---------------------------------------------------------------------------
# the checkpointer
# ---------------------------------------------------------------------------

class Checkpointer:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        #: one record per leaf sent to the Tucker tier: index, shape, ranks,
        #: methods, backend, ms, rel_error, bytes before and after
        self.tucker_log: list[dict] = []

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, *, compress_cfg=None,
             blocking: bool = False):
        """Snapshot now, write in the background.  ``compress_cfg`` (a
        :class:`repro_torch.optim.grad_compress.CompressionConfig`) sends
        the eligible ≥ 3-D floating leaves through the Tucker codec, which
        runs here, on each leaf's device."""
        flat = tree_flatten(tree)
        items = []
        for i, leaf in enumerate(flat):
            meta = {"dtype": _dtype_name(leaf), "shape": list(leaf.shape)}
            if compress_cfg is not None and _tucker_eligible(compress_cfg, leaf):
                payload, rec = _tucker_encode(leaf, compress_cfg)
                self.tucker_log.append({"index": i, **rec})
                items.append(("tucker", f"tucker_{i}.npz", payload, meta))
            else:
                items.append(("raw", f"arr_{i}.npy", _to_host(leaf), meta))
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(step, items, treedef(tree)), daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _write(self, step: int, items: list, tdef: str):
        try:
            tmp = self.dir / f"step_{step:09d}.tmp"
            final = self.dir / f"step_{step:09d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            index = []
            for kind, name, data, meta in items:
                if kind == "tucker":
                    _save_tucker(tmp / name, data)
                else:
                    np.save(tmp / name, data)
                index.append({"kind": kind, "file": name, **meta})
            (tmp / "meta.json").write_text(json.dumps(
                {"step": step, "time": time.time(), "treedef": tdef,
                 "leaves": index}))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)             # atomic commit
            self._gc()
        except BaseException as e:        # re-raised by wait()
            self._error = e

    def wait(self):
        """Join the writer; re-raise what it failed with."""
        if self._thread is not None:
            self._thread.join()
        self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "meta.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: Any, step: int | None = None
                ) -> tuple[Any, int] | None:
        """Restore into the structure of ``tree_like``: CPU tensors of the
        dtypes the checkpoint records.  None → nothing committed."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        d = self.dir / f"step_{step:09d}"
        meta = json.loads((d / "meta.json").read_text())
        n = len(tree_flatten(tree_like))
        if n != len(meta["leaves"]):
            raise ValueError(f"checkpoint has {len(meta['leaves'])} leaves, "
                             f"the tree {n}")
        out = []
        for info in meta["leaves"]:
            if info["kind"] == "tucker":
                arr = _load_tucker(d / info["file"])
            else:
                arr = np.load(d / info["file"])
            out.append(_from_host(arr, info["dtype"]))
        return tree_unflatten(tree_like, out), step


# ---------------------------------------------------------------------------
# Tucker codec
# ---------------------------------------------------------------------------

def _tucker_eligible(cfg, leaf) -> bool:
    floating = (leaf.is_floating_point() if isinstance(leaf, torch.Tensor)
                else np.issubdtype(np.asarray(leaf).dtype, np.floating)
                or _dtype_name(leaf) == "bfloat16")
    return floating and cfg.ranks_for(tuple(leaf.shape)) is not None


def _tucker_encode(leaf, cfg) -> tuple[dict, dict]:
    """st-HOSVD of the leaf in fp32 at ``cfg.ranks_for`` its shape, with
    ``methods="auto"`` and ``impl="auto"`` on the leaf's device
    (``hopper`` on the card), run eagerly step by step.
    Returns the npz payload (host arrays) and the record for
    :attr:`Checkpointer.tucker_log`."""
    from ..core.api import _as_tensor
    from ..core.sthosvd import sthosvd
    raw = _as_tensor(leaf).detach()
    x = raw.float()
    ranks = cfg.ranks_for(tuple(x.shape))
    sync = x.device.type == "cuda"
    if sync:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    # the per-step runner: a captured sweep would stay cached with a copy
    # of the leaf (tens of GB for a 7B model's stacked leaves)
    res = sthosvd(x, ranks, methods="auto", impl="auto", device=x.device,
                  block_until_ready=True)
    if sync:
        torch.cuda.synchronize(x.device)
    ms = (time.perf_counter() - t0) * 1e3
    tt = res.tucker
    payload = {"core": tt.core.cpu().numpy(), "n_factors": len(tt.factors),
               **{f"factor_{i}": u.cpu().numpy()
                  for i, u in enumerate(tt.factors)}}
    rec = {"shape": list(x.shape), "ranks": list(ranks),
           "methods": list(res.methods),
           "mode_ms": [t.seconds * 1e3 for t in sorted(res.trace,
                                                       key=lambda t: t.mode)],
           "backend": res.trace[0].backend if res.trace else None,
           "ms": ms, "rel_error": float(tt.rel_error(x)),
           "bytes_raw": raw.numel() * raw.element_size(),
           "bytes_tucker": 4 * (tt.core.numel()
                                + sum(u.numel() for u in tt.factors))}
    return payload, rec


def _save_tucker(path: Path, payload: dict) -> None:
    np.savez(path, **payload)


def _load_tucker(path: Path) -> np.ndarray:
    z = np.load(path)
    factors = [torch.from_numpy(z[f"factor_{i}"])
               for i in range(int(z["n_factors"]))]
    return T.reconstruct(torch.from_numpy(z["core"]), factors).numpy()
