"""Per-device FLOP, byte and collective counts of a PyTorch program, op by
op.

The counterpart of ``repro/roofline/hlo_walk.py``, which walks compiled
XLA HLO; PyTorch has no HLO, so :class:`OpWalk` is a
``TorchDispatchMode`` that sees every aten op as it runs and counts **per
device**, on local shards:

* ``flops``: 2 · |out| · K for the dots (mm, bmm, addmm, baddbmm) with K
  the contraction size, and for a convolution with K = the weight's
  elements per output channel, as ``hlo_walk._dot_flops``/``_conv_flops``
  take 2 · |result| · K; split by the dot's dtype under ``flops_by_dtype``;
* ``traffic``: the upper bound on bytes, the operand and result bytes of
  every op that moves data (views, allocations and waits excluded);
* ``traffic_ess``: the essential bytes, ``hlo_walk.py``'s rules carried
  over to aten ops: a dot's or convolution's operands and result; a
  gather's result (index, gather, embedding, index_select); a scatter's
  update (index_put, scatter, a copy into a view: the cache writes); a
  sort's and a concatenation's operands and result; a collective's bytes;
* per kind of collective (the five of ``hlo_walk.COLLECTIVES``), the
  operand bytes of every ``_c10d_functional`` op (an all-gather's operand
  is its result over the group, a reduce-scatter's its result times the
  group), ``coll_count`` and ``coll_total``; and ``coll_nvlink`` /
  ``coll_network``, the same bytes split by the slowest link each group
  crosses (``launch.mesh.link_bw``).

On a DTensor the mode defers (``NotImplemented``) until DTensor has
desugared the op into local ops and collectives, which it then counts; the
ops DTensor runs on fake tensors to propagate shardings are not counted.
The port's layer stacks are Python loops, so every trip runs and is
counted: no trip count is rebuilt.  The walker works on ``meta`` tensors
(the dry run: nothing is allocated) and on CUDA tensors alike.  With
``track_live`` it also follows the bytes of the tensors the ops make until
each is freed, and keeps their peak (``peak_live``, beside the
``live_base`` bytes the caller says are already held).
"""

from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_ZERO = {"flops": 0.0, "traffic": 0.0, "traffic_ess": 0.0,
         "coll_count": 0.0, "coll_nvlink": 0.0, "coll_network": 0.0,
         **{k: 0.0 for k in COLLECTIVES}}

_DOTS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1, "addbmm": 1}
_CONVS = ("convolution", "_convolution", "cudnn_convolution", "conv1d",
          "conv2d", "_conv_depthwise2d")
_GATHERS = ("index", "gather", "embedding", "index_select", "take",
            "_unsafe_index")
_SCATTERS = ("index_put", "index_put_", "_index_put_impl_", "scatter",
             "scatter_", "scatter_add", "scatter_add_", "index_add",
             "index_add_", "index_copy", "index_copy_", "slice_scatter",
             "select_scatter", "copy_", "masked_scatter_")
_SORTS = ("sort", "topk", "argsort")
_CATS = ("cat", "stack")
# functional collectives: op name -> kind
_COLL = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
         "all_reduce_coalesced": "all-reduce",
         "all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all",
         # a one-to-all send of the operand
         "broadcast": "collective-permute", "broadcast_": "collective-permute"}
_FREE = ("empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "wait_tensor", "_wrap_tensor_autograd",
         "detach", "lift_fresh", "_local_scalar_dense", "set_",
         "resize_", "record_stream")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def _group_ranks(group_name) -> list[int] | None:
    try:
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group
        return dist.get_process_group_ranks(_resolve_process_group(
            group_name))
    except Exception:           # a group the walker cannot resolve
        return None


class OpWalk(TorchDispatchMode):
    """``with OpWalk() as w: step()`` then ``w.result()``: one device's
    counts under ``hlo_walk.analyze``'s keys."""

    def __init__(self, *, track_live: bool = False, live_base: int = 0):
        super().__init__()
        self.acc = dict(_ZERO)
        self.flops_by_dtype: dict[str, float] = {}
        self.track_live = track_live
        self.live = int(live_base)
        self.peak_live = int(live_base)
        self.n_ops = 0

    # -- counting ---------------------------------------------------------

    def _dot(self, name: str, args, out) -> None:
        a = args[_DOTS[name]]
        k = a.shape[-1]
        f = 2.0 * out.numel() * k
        self.acc["flops"] += f
        key = str(a.dtype).replace("torch.", "")
        self.flops_by_dtype[key] = self.flops_by_dtype.get(key, 0.0) + f

    def _conv(self, args, out) -> None:
        w = args[1]
        k = 1
        for d in w.shape[1:]:
            k *= d
        f = 2.0 * out.numel() * k
        self.acc["flops"] += f
        key = str(w.dtype).replace("torch.", "")
        self.flops_by_dtype[key] = self.flops_by_dtype.get(key, 0.0) + f

    def _collective(self, name: str, args, kwargs) -> float:
        kind = _COLL[name]
        ins = [a for a in tree_flatten(args[:1])[0]
               if isinstance(a, torch.Tensor)]
        b = float(sum(_nbytes(t) for t in ins))
        self.acc[kind] += b
        self.acc["coll_count"] += 1
        group = args[-1] if isinstance(args[-1], str) else \
            kwargs.get("group_name")
        ranks = _group_ranks(group) if group is not None else None
        from ..launch.mesh import NETWORK_BW, link_bw
        net = ranks is None or link_bw(ranks) == NETWORK_BW
        self.acc["coll_network" if net else "coll_nvlink"] += b
        return b

    def _track(self, out, args) -> None:
        ins = {id(a) for a in args if isinstance(a, torch.Tensor)}
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor) or id(t) in ins:
                continue
            n = _nbytes(t)
            self.live += n
            self.peak_live = max(self.peak_live, self.live)
            weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # count the local ops DTensor makes
        out = func(*args, **kwargs)
        flat_in = [a for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, torch.Tensor)]
        flat_out = [t for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor)]
        if any(_is_fake(t) for t in flat_in + flat_out):
            return out                  # sharding propagation, not the program
        name = func._overloadpacket.__name__
        self.n_ops += 1
        coll_b = None
        if name in _COLL:
            coll_b = self._collective(name, args, kwargs)
        elif name in _DOTS:
            self._dot(name, args, flat_out[0])
        elif name in _CONVS:
            self._conv(args, flat_out[0])

        view = getattr(func, "is_view", False)
        if name in _FREE or view:
            return out
        io = float(sum(_nbytes(t) for t in flat_in + flat_out))
        self.acc["traffic"] += io
        if coll_b is not None:
            self.acc["traffic_ess"] += coll_b
        elif name in _DOTS or name in _CONVS or name in _SORTS \
                or name in _CATS:
            self.acc["traffic_ess"] += io
        elif name in _GATHERS:
            self.acc["traffic_ess"] += float(sum(_nbytes(t)
                                                 for t in flat_out))
        elif name in _SCATTERS:
            # the update (the last tensor operand): the result aliases
            # the buffer it is written into
            upd = [a for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, torch.Tensor)][-1:]
            self.acc["traffic_ess"] += float(sum(_nbytes(t) for t in upd))
        if self.track_live:
            self._track(out, args)
        return out

    def result(self) -> dict[str, float]:
        """``hlo_walk.analyze``'s keys (``flops``, ``traffic``,
        ``traffic_ess``, the five collective kinds, ``coll_count``,
        ``coll_total``) plus ``coll_nvlink``/``coll_network``, ``ops`` and,
        with ``track_live``, ``peak_live``; ``flops_by_dtype`` rides
        beside as :attr:`flops_by_dtype`."""
        out = dict(self.acc)
        out["coll_total"] = sum(out[k] for k in COLLECTIVES)
        out["ops"] = float(self.n_ops)
        if self.track_live:
            out["peak_live"] = float(self.peak_live)
        return out

