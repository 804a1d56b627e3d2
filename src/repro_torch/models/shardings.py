"""Parameter, batch and cache sharding rules, and the activation context.

The port of ``repro/models/shardings.py``.  The resolver is the
reference's, MaxText-style logical rules resolved against a mesh's axis
sizes:

* tensor-parallel (``model`` axis): the vocab dim of embeddings, the d_ff /
  heads output dim of up-projections, the contraction dim of
  down-projections, picked by the leaf's name;
* FSDP (``data``, and ``pod`` too) on the largest remaining dim for configs
  flagged ``fsdp``;
* an assignment is dropped where the dim does not divide the axes' size.

It is a pure function of leaf paths, shapes and axis sizes: a "mesh" here
is anything :func:`axis_sizes` reads (a ``DeviceMesh`` with dim names, or
a mapping of axis name to size), so the rules resolve a full-size model's
abstract parameters without a process group.  A spec is a tuple with one
entry a dim: None, an axis name, or a tuple of axis names (the entries of
the reference's ``PartitionSpec``).  :func:`to_placements` turns one into
DTensor placements on a ``DeviceMesh``; a dim taking two axes is
``Shard(dim)`` on both mesh dims, major axis first, as jax splits it.

The activation context (:func:`set_activation_mesh`,
:func:`constrain_batch`, :func:`constrain`) and the cache writes
(:func:`put_rows`, :func:`put_prefix`, :func:`put_slots`) are what the model
code calls where the reference calls ``with_sharding_constraint`` or writes
its cache.  On a plain tensor, or with no mesh set, each is the plain
operation (the identity for the constraints), so a single-device run is
unchanged by a bit.  On a DTensor a constraint redistributes (its
collectives show in a count), and a cache write moves the value to the
cache's placements and writes each device's own part, where DTensor has no
rule for an in-place write that changes a placement.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

# leaf names → role (first match wins per dim); dims are counted from the
# END so stacked (leading L / E) axes do not shift the rule
_TP_LAST = ("wq", "wk", "wv", "wi_gate", "wi_up", "wi", "in_proj", "bc_proj",
            "dt_proj", "w_gate", "w_up", "conv_w", "d_skip", "dt_bias")
_TP_SECOND = ("wo", "out_proj", "w_down", "x_proj", "a_log")
_EMBED = ("embed", "lm_head")

Spec = tuple


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (its dim names) or of a
    mapping of axis name to size."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh without mesh_dim_names has no axes "
                         "to resolve against")
    return dict(zip(names, tuple(mesh.mesh.shape)))


def _axes_size(sizes: dict[str, int], axis) -> int:
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return sizes[axis]


def _leaf_spec(path: str, shape: tuple[int, ...], sizes: dict[str, int], *,
               model_axis: str, fsdp_axes: tuple[str, ...] | None) -> Spec:
    parts: list[Any] = [None] * len(shape)
    name = path.rsplit("/", 1)[-1]

    def try_assign(dim_from_end: int, axis):
        i = len(shape) - dim_from_end
        if i < 0 or parts[i] is not None:
            return False
        size = _axes_size(sizes, axis)
        if shape[i] % size == 0 and shape[i] >= size:
            parts[i] = axis
            return True
        return False

    if name in _EMBED:
        # (V, d) or (d, V): shard the vocab dim
        vdim = 0 if shape[-2] >= shape[-1] else 1
        try_assign(2 - vdim, model_axis)
    elif name in _TP_LAST:
        try_assign(1, model_axis)
    elif name in _TP_SECOND:
        try_assign(2, model_axis)
    # norms / scalars / router: replicated for TP

    if fsdp_axes:
        # largest remaining dim takes the data axes (zero-redundancy style)
        size = _axes_size(sizes, fsdp_axes)
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if parts[i] is None and shape[i] % size == 0 and shape[i] >= size:
                parts[i] = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
                break
    return tuple(parts)


def _paths(tree, prefix: str = ""):
    """(path, leaf) of a nested dict, keys sorted (the reference's leaf
    order); a leaf is anything but a dict."""
    for k in sorted(tree):
        v = tree[k]
        p = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _paths(v, p)
        else:
            yield p, v


def _shape(leaf) -> tuple[int, ...]:
    """A leaf's shape: a tensor's, a stacked layered leaf's (a list of the
    layers' tensors, ``convert.param_tree``), or a shape tuple."""
    if isinstance(leaf, list):
        return (len(leaf),) + tuple(leaf[0].shape)
    if isinstance(leaf, tuple):
        return leaf
    return tuple(leaf.shape)


def _unflatten(flat: dict[str, Any]) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def param_specs(params_abs: dict, mesh, *, model_axis: str = "model",
                fsdp_axes: tuple[str, ...] | None = None,
                replicate_names: tuple[str, ...] = ()) -> dict:
    """A spec per leaf of the reference-layout parameter tree
    ``params_abs`` (tensors, meta tensors, layered lists or shape tuples),
    in a tree of the same keys.  ``replicate_names``: leaf names exempted
    from TP (expert weights under capacity sharding)."""
    sizes = axis_sizes(mesh)
    flat = {}
    for path, leaf in _paths(params_abs):
        shape = _shape(leaf)
        if path.rsplit("/", 1)[-1] in replicate_names:
            flat[path] = (None,) * len(shape)
            continue
        flat[path] = _leaf_spec(path, shape, sizes, model_axis=model_axis,
                                fsdp_axes=fsdp_axes)
    return _unflatten(flat)


def _data_axes(sizes: dict[str, int], batch_axes) -> tuple[str, ...]:
    return tuple(a for a in batch_axes if a in sizes)


def batch_specs(batch_abs, mesh, *, batch_axes=("pod", "data")):
    """Shard the leading (batch) dim of every input over the data axes;
    fall back to sequence sharding when the batch does not divide
    (long-context B = 1).  ``batch_abs``: a tensor or a dict of them."""
    sizes = axis_sizes(mesh)
    axes = _data_axes(sizes, batch_axes)
    size = _axes_size(sizes, axes)

    def leaf(x):
        shape = _shape(x)
        if len(shape) == 0:
            return ()
        if shape[0] % size == 0 and shape[0] >= size:
            return (axes,)
        if len(shape) >= 2 and shape[1] % size == 0:
            return (None, axes)          # sequence sharding
        return ()

    if isinstance(batch_abs, dict):
        return _unflatten({p: leaf(x) for p, x in _paths(batch_abs)})
    return leaf(batch_abs)


def cache_specs_tree(cache_abs: dict, mesh, *, batch_axes=("pod", "data")):
    """KV/SSM caches are stacked (L, B, S, ...): shard the batch; for B = 1
    long context, the sequence dim (ring-attention style residency)."""
    sizes = axis_sizes(mesh)
    axes = _data_axes(sizes, batch_axes)
    size = _axes_size(sizes, axes)

    def leaf(x):
        shape = _shape(x)
        parts: list[Any] = [None] * len(shape)
        if len(shape) >= 2 and shape[1] % size == 0 and shape[1] >= size:
            parts[1] = axes
        elif len(shape) >= 3 and shape[2] % size == 0:
            parts[2] = axes               # sequence dim of (L, B, S, …)
        return tuple(parts)

    return _unflatten({p: leaf(x) for p, x in _paths(cache_abs)})


def to_placements(spec: Spec, mesh) -> list:
    """DTensor placements on ``mesh`` (a ``DeviceMesh`` with dim names) for
    a spec: a mesh dim named in the entry of tensor dim i is ``Shard(i)``,
    any other ``Replicate()``.  A mesh dim may stand for several axes, its
    name joining them with "+" (``launch.mesh.placement_mesh``'s
    "pod+data"): an entry then names all of them or none."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    members = [tuple(n.split("+")) for n in names]
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for i, m in enumerate(members):
            hit = [a in axes for a in m]
            if any(hit) and not all(hit):
                raise ValueError(f"spec entry {entry!r} splits the mesh dim "
                                 f"{names[i]!r}")
            if all(hit):
                out[i] = Shard(dim)
        if not all(any(a in m for m in members) for a in axes):
            raise ValueError(f"spec entry {entry!r} names an axis the mesh "
                             f"{names} lacks")
    return out


def to_shardings(spec_tree, mesh):
    """``to_placements`` at every spec of a tree (a spec is a tuple)."""
    if isinstance(spec_tree, dict):
        return {k: to_shardings(v, mesh) for k, v in spec_tree.items()}
    return to_placements(spec_tree, mesh)


# ---------------------------------------------------------------------------
# activation-sharding context: model code calls ``constrain_batch`` on its
# (B, T, d) activations; outside a mesh context, or on a plain tensor, it
# is the identity.  The dry run sets the mesh once per process.
# ---------------------------------------------------------------------------

_ACT_MESH = None
_ACT_BATCH_AXES: tuple[str, ...] = ("pod", "data")


def set_activation_mesh(mesh, axes: tuple[str, ...] = ("pod", "data")):
    """Register the mesh whose axis sizes the constraints resolve against
    (a DTensor is redistributed on its own ``device_mesh``)."""
    global _ACT_MESH, _ACT_BATCH_AXES
    _ACT_MESH = mesh
    _ACT_BATCH_AXES = tuple(axes)


def activation_mesh():
    return _ACT_MESH


def is_distributed(x) -> bool:
    """Whether ``x`` is a DTensor (placed on a mesh)."""
    if type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)



def _redistribute(x, spec: Spec):
    placements = to_placements(spec, x.device_mesh)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def constrain_batch(x):
    """Dim 0 of an activation sharded over the data axes and nothing else
    (where a mesh is registered, ``x`` is a DTensor and the dim divides);
    the identity otherwise."""
    if _ACT_MESH is None or not is_distributed(x):
        return x
    sizes = axis_sizes(_ACT_MESH)
    axes = _data_axes(sizes, _ACT_BATCH_AXES)
    if not axes:
        return x
    size = _axes_size(sizes, axes)
    if x.ndim == 0 or x.shape[0] % size or x.shape[0] < size:
        return x
    return _redistribute(x, (axes,))


def constrain(x, parts: tuple):
    """``x`` laid out as the spec ``parts`` on the registered mesh, each
    dim that does not divide its axes' size left unsharded (an entry may
    be a tuple of axes, e.g. ("pod", "data")); the identity without a mesh
    or on a plain tensor."""
    if _ACT_MESH is None or not is_distributed(x):
        return x
    sizes = axis_sizes(_ACT_MESH)
    resolved = []
    for dim, axis in enumerate(parts):
        if axis is None:
            resolved.append(None)
            continue
        axes = tuple(a for a in (axis if isinstance(axis, tuple) else (axis,))
                     if a in sizes)
        if not axes:
            resolved.append(None)
            continue
        size = _axes_size(sizes, axes)
        ok = dim < x.ndim and x.shape[dim] % size == 0 and x.shape[dim] >= size
        resolved.append(axes if ok else None)
    return _redistribute(x, tuple(resolved))


def _local_part(t, mesh, placements: list):
    """This device's part of ``t`` laid out as ``placements`` on ``mesh``
    (a plain tensor is taken as replicated)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not is_distributed(t):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if list(t.placements) != placements:
        t = t.redistribute(mesh, placements)
    return t.to_local()


def _replicated(t, like):
    """A plain tensor ``t`` as a DTensor replicated on ``like``'s mesh."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def split_heads(x, kv_heads: int):
    """A (B, T, H, D) activation on a mesh with the ``model`` axis on its
    heads where the ``kv_heads`` KV heads divide it (so that a query head
    group never straddles two devices), else replicated over it, its other
    axes as they are: a head dim split from a model-sharded fused
    projection is otherwise a strided shard inside a head, which DTensor
    plans slowly.  The identity on a plain tensor."""
    if not is_distributed(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    names = x.device_mesh.mesh_dim_names or ()
    if "model" not in names:
        return x
    i = names.index("model")
    size = x.device_mesh.size(i)
    want = list(x.placements)
    want[i] = Shard(2) if kv_heads % size == 0 else Replicate()
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def local_heads(fn, q, kv: tuple, rows: tuple, kv_heads: int, *,
                out_dim: int = 2):
    """``fn(q, *kv, *rows)`` for an attention core: q (B, T, Hq, D), ``kv``
    (B, S, Hkv, D) each, ``rows`` (B, ...) per-row extras (a decode mask),
    independent across rows and KV-head groups.  On DTensors it runs on
    each device's shards, with no DTensor op inside: rows keep q's batch
    shards, heads take the ``model`` axis where the ``kv_heads`` divide it
    (:func:`split_heads`' rule), anything else is replicated (a sequence
    shard is gathered); the result comes back with the rows' shards and
    the heads' on dim ``out_dim``.  On plain tensors it is ``fn``."""
    if not is_distributed(q):
        return fn(q, *kv, *rows)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh
    names = mesh.mesh_dim_names or ()
    lay, row_l, out_l = [], [], []
    for i, p in enumerate(q.placements):
        if names[i] == "model":
            heads = kv_heads % mesh.size(i) == 0
            lay.append(Shard(2) if heads else Replicate())
            row_l.append(Replicate())
            out_l.append(Shard(out_dim) if heads else Replicate())
        else:
            keep = isinstance(p, Shard) and p.dim == 0
            for pl in (lay, row_l, out_l):
                pl.append(Shard(0) if keep else Replicate())

    loc = lambda t, pl: _local_part(t, mesh, pl)

    out = fn(loc(q, lay), *(loc(t, lay) for t in kv),
             *(loc(t, row_l) for t in rows))
    return DTensor.from_local(out, mesh, out_l, run_check=False)


def local_channels(fn, x, state, w, b):
    """``fn(x, w, b, state) -> (y, new_state)`` for a depthwise op, each
    channel (the last dim) on its own: x (B, T, C), state (B, K−1, C) or
    None, w (K, C), b (C,).  On DTensors it runs on each device's shards:
    the channels keep w's shards, x's rows its batch shards, anything
    else is replicated; y and new_state come back with x's layout.  On
    plain tensors it is ``fn``."""
    if not is_distributed(x):
        return fn(x, w, b, state)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = x.device_mesh
    px, pw, pb = [], [], []
    for pwi, pxi in zip(w.placements, x.placements):
        if isinstance(pwi, Shard) and pwi.dim == 1:
            px.append(Shard(2)), pw.append(Shard(1)), pb.append(Shard(0))
        else:
            keep = isinstance(pxi, Shard) and pxi.dim == 0
            px.append(Shard(0) if keep else Replicate())
            pw.append(Replicate()), pb.append(Replicate())

    loc = lambda t, pl: _local_part(t, mesh, pl)

    y, st = fn(loc(x, px), loc(w, pw), loc(b, pb),
               None if state is None else loc(state, px))
    wrap = lambda t: None if t is None else \
        DTensor.from_local(t, mesh, px, run_check=False)
    return wrap(y), wrap(st)


def whole(x):
    """``x`` with every partial sum of a DTensor made whole (replicated
    over those mesh dims: one all-reduce), e.g. after a contraction over a
    sharded dim whose result is split next.  The identity on a plain
    tensor."""
    if not is_distributed(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def chunk_last(x, n: int):
    """``x.chunk(n, dim=-1)``.  On a DTensor whose last dim is sharded the
    dim is gathered first (each chunk is a contiguous run of the global
    dim, which a device's shard is not), and partial sums made whole."""
    if is_distributed(x):
        from torch.distributed.tensor import Replicate, Shard
        last = x.ndim - 1
        want = [Replicate() if p.is_partial() or (
            isinstance(p, Shard) and p.dim == last) else p
            for p in x.placements]
        if want != list(x.placements):
            x = x.redistribute(x.device_mesh, want)
    return x.chunk(n, dim=-1)


def micro_batch(x, i: int, n: int):
    """Microbatch ``i`` of ``n`` along dim 0: ``x[i·B/n:(i+1)·B/n]``.  On a
    DTensor sharded along dim 0 whose rows on a device split into ``n``,
    each device takes slice ``i`` of its own rows (the same count of rows,
    another partition of the batch: the mean gradient over the
    microbatches is the same), where slicing the global dim would gather
    the batch."""
    from torch.distributed.tensor import Shard
    if is_distributed(x) and any(isinstance(p, Shard) and p.dim == 0
                              for p in x.placements) \
            and x.to_local().shape[0] % n == 0 \
            and x.to_local().shape[0] >= n:
        from torch.distributed.tensor import DTensor
        local = x.to_local()
        m = local.shape[0] // n
        return DTensor.from_local(local[i * m:(i + 1) * m], x.device_mesh,
                                  x.placements, run_check=False)
    if is_distributed(x):
        # rows fewer than the devices: the batch is gathered, as the
        # reference's microbatch of too few rows is replicated
        from torch.distributed.tensor import Replicate
        want = [Replicate() if isinstance(p, Shard) and p.dim == 0 else p
                for p in x.placements]
        if want != list(x.placements):
            x = x.redistribute(x.device_mesh, want)
    m = x.shape[0] // n
    return x[i * m:(i + 1) * m]


def take_rows(table, index):
    """``table[index]`` (an embedding lookup).  On a DTensor table each
    device looks up the rows it holds (the table keeps its vocab shards,
    any other shard is gathered, as FSDP gathers a weight; the index is
    replicated over the vocab's mesh dims), zeroes the others, and the
    partial sums are made whole by one all-reduce of the (B, T, d)
    result."""
    if not is_distributed(table):
        return table[index]
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    vocab = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
    want_t = [Shard(0) if v else Replicate() for v in vocab]
    if list(table.placements) != want_t:
        table = table.redistribute(mesh, want_t)
    if not is_distributed(index):
        index = DTensor.from_local(index, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    want_i = [Replicate() if v else p for v, p in zip(vocab, index.placements)]
    if list(index.placements) != want_i:
        index = index.redistribute(mesh, want_i)
    local, li = table.to_local(), index.to_local().long()
    li = li - _local_offset(table, 0)
    mine = (li >= 0) & (li < local.shape[0])
    rows = F.embedding(torch.where(mine, li, 0), local) * \
        mine[..., None].to(local.dtype)
    out = DTensor.from_local(rows, mesh,
                             [Partial() if v else p for v, p in
                              zip(vocab, want_i)], run_check=False)
    return out.redistribute(mesh, [Replicate() if v else p for v, p in
                                   zip(vocab, want_i)])


def local_rows(fn, rows: tuple, shared: tuple = ()):
    """``fn(*rows, *shared)`` for a computation independent across batch
    rows: ``rows`` (tensors whose dim 0 is the batch) and ``shared`` (the
    same on every row).  On DTensors it runs on each device's rows: the
    rows keep their batch shards (anything else is replicated), ``shared``
    is replicated, and every tensor ``fn`` returns (in nested tuples) is
    taken as batch-leading, with the rows' shards.  On plain tensors it is
    ``fn`` itself."""
    if not is_distributed(rows[0]):
        return fn(*rows, *shared)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = rows[0].device_mesh
    keep = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in rows[0].placements]
    rep = [Replicate()] * mesh.ndim
    out = fn(*(_local_part(t, mesh, keep) for t in rows),
             *(_local_part(t, mesh, rep) for t in shared))

    def wrap(o):
        if isinstance(o, tuple):
            return tuple(wrap(v) for v in o)
        return DTensor.from_local(o, mesh, keep, run_check=False)
    return wrap(out)


def value_counts(index, n: int) -> torch.Tensor:
    """fp32 counts of each value < ``n`` in ``index`` (any shape):
    ``zeros(n).scatter_add_(0, index.reshape(-1), ones)``.  On a DTensor
    the same sums as a one-hot reduction (exact in fp32 up to 2**24)."""
    if not is_distributed(index):
        return torch.zeros((n,), dtype=torch.float32, device=index.device) \
            .scatter_add_(0, index.reshape(-1),
                          torch.ones((index.numel(),), dtype=torch.float32,
                                     device=index.device))
    ids = _replicated(torch.arange(n, device=index.device), index)
    return (index.reshape(-1)[:, None] == ids).to(torch.float32).sum(0)


def pick_last(x, index):
    """``x.gather(-1, index[..., None])[..., 0]`` (each row's label logit).
    On a DTensor, whose gather from a sharded last dim DTensor cannot
    finish, the reference's one-hot contraction: a local product and a
    partial sum over the sharded dim, one all-reduce of the picked
    values."""
    if not is_distributed(x):
        return x.gather(-1, index[..., None].long())[..., 0]
    ids = _replicated(torch.arange(x.shape[-1], device=x.device), x)
    return (x * (index[..., None].long() == ids).to(x.dtype)).sum(-1)


def local_scan(fn, x, dt, bmat, cmat, a, h0=None):
    """``fn(x, dt, bmat, cmat, a, h0) -> (y, h_final)``, a selective scan
    over x, dt (B, T, Di) with bmat, cmat (B, T, N), a (Di, N) and h0 (B,
    Di, N).  On DTensors it runs on each device's shards, the scan being
    independent across rows and channels: x's shards of B and Di are kept
    (any other placement is replicated), the other operands laid out to
    match, and y and h_final come back with those shards.  On plain
    tensors it is ``fn`` itself."""
    if not is_distributed(x):
        return fn(x, dt, bmat, cmat, a, h0)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = x.device_mesh
    rows = [isinstance(p, Shard) and p.dim == 0 for p in x.placements]
    chans = [isinstance(p, Shard) and p.dim == 2 for p in x.placements]
    lay = lambda m: [Shard(m[0]) if r else Shard(m[1]) if c else Replicate()
                     for r, c in zip(rows, chans)]
    px, pb = lay((0, 2)), [Shard(0) if r else Replicate() for r in rows]
    pa = [Shard(0) if c else Replicate() for c in chans]
    ph = lay((0, 1))

    loc = lambda t, pl: _local_part(t, mesh, pl)

    y, hf = fn(loc(x, px), loc(dt, px), loc(bmat, pb), loc(cmat, pb),
               loc(a, pa), None if h0 is None else loc(h0, ph))
    return (DTensor.from_local(y, mesh, px, run_check=False),
            DTensor.from_local(hf, mesh, ph, run_check=False))


# ---------------------------------------------------------------------------
# cache writes: plain in-place writes on a tensor; on a DTensor cache the
# value moves to the cache's placements and each device writes its part
# ---------------------------------------------------------------------------

def _value_to(cache, val, dims: dict[int, int | None]):
    """``val`` (a DTensor or a plain tensor, implicitly replicated)
    redistributed so that cache dim d's sharding lands on value dim
    ``dims[d]`` (None: the value is replicated over that mesh dim); the
    local tensor."""
    from torch.distributed.tensor import Replicate, Shard
    want = []
    for p in cache.placements:
        d = dims.get(p.dim) if isinstance(p, Shard) else None
        want.append(Shard(d) if d is not None else Replicate())
    return _local_part(val, cache.device_mesh, want)


def _local_offset(cache, dim: int) -> int:
    """The global index of this device's first entry of cache dim ``dim``
    (evenly sharded)."""
    from torch.distributed.tensor import Shard
    coord = cache.device_mesh.get_coordinate()
    off, n = 0, cache.shape[dim]
    for mdim, p in enumerate(cache.placements):
        if isinstance(p, Shard) and p.dim == dim:
            n //= cache.device_mesh.size(mdim)
            off += coord[mdim] * n
    return off


def put_rows(cache, index: tuple, val) -> None:
    """``cache.index_put_((rows, slot), val)``: row i's entry at ``slot[i]``
    (decode's one token a row).  On a DTensor cache (B, S, ...) each device
    writes its rows, and of those the slots it holds."""
    if not is_distributed(cache):
        cache.index_put_(index, val)
        return
    slot = index[1]
    local = cache.to_local()
    v = _value_to(cache, val, {0: 0, 2: 1, 3: 2})
    b0, s0 = _local_offset(cache, 0), _local_offset(cache, 1)
    nb, ns = local.shape[0], local.shape[1]
    rows_l = torch.arange(nb, device=local.device)
    slot_g = _local_of(slot)[b0:b0 + nb] if _local_of(slot).dim() else \
        _local_of(slot).expand(nb)
    mine = (slot_g >= s0) & (slot_g < s0 + ns)
    slot_l = torch.where(mine, slot_g - s0, 0)
    keep = local[rows_l, slot_l]
    mine = mine.view(-1, *([1] * (v.dim() - 1)))
    local.index_put_((rows_l, slot_l), torch.where(mine, v, keep))


def _local_of(t):
    """A plain tensor, or a replicated DTensor's full value."""
    if is_distributed(t):
        from torch.distributed.tensor import Replicate
        if not all(isinstance(p, Replicate) for p in t.placements):
            t = t.redistribute(t.device_mesh,
                               [Replicate()] * t.device_mesh.ndim)
        return t.to_local()
    return t


def put_prefix(cache, val) -> None:
    """``cache[:, :T] = val`` (prefill's slots 0 … T − 1).  On a DTensor
    cache the value moves to the cache's placements first; a prefix shorter
    than a sequence-sharded cache is refused."""
    t = val.shape[1]
    if not is_distributed(cache):
        cache[:, :t] = val
        return
    if t != cache.shape[1]:
        from torch.distributed.tensor import Shard
        if any(isinstance(p, Shard) and p.dim == 1 for p in cache.placements):
            raise NotImplementedError(
                "put_prefix: a prefix shorter than a sequence-sharded cache")
        cache.to_local()[:, :t] = _value_to(cache, val, {0: 0, 2: 2, 3: 3})
        return
    cache.to_local().copy_(_value_to(cache, val, {0: 0, 1: 1, 2: 2, 3: 3}))


def put_slots(cache, slots, val) -> None:
    """``cache[:, slots] = val`` (a ring's prefill keeps the last S_c
    tokens at their ring slots).  On a DTensor cache the value is
    replicated over the sequence's mesh dims and each device writes the
    slots it holds."""
    if not is_distributed(cache):
        cache[:, slots] = val
        return
    local = cache.to_local()
    v = _value_to(cache, val, {0: 0, 2: 2, 3: 3})
    s0, ns = _local_offset(cache, 1), local.shape[1]
    sl = _local_of(slots)
    mine = (sl >= s0) & (sl < s0 + ns)
    slot_l = torch.where(mine, sl - s0, 0)
    shape = (1, -1) + (1,) * (v.dim() - 2)
    local[:, slot_l] = torch.where(mine.view(shape), v, local[:, slot_l])
