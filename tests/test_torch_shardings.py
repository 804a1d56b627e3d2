"""Port parity for the sharding rules (``repro_torch/models/shardings.py``)
and the dry run's abstract stand-ins (``registry.input_specs`` /
``cache_specs``, ``ModelBundle.abstract_params``).

The reference's resolver reads only the mesh's axis sizes, so both sides
resolve against abstract meshes, in process: ``jax.sharding.AbstractMesh``
for ``repro.models.shardings`` and a mapping of axis name to size for the
port.  Every architecture at full size, every ``SHAPES`` entry, on the
production meshes (16, 16) and (2, 16, 16) and the test mesh (2, 2, 2),
with ``fsdp_axes`` and ``replicate_names`` set as each dry run sets them.
Specs are compared entry by entry (an axis name, a tuple of them, or
None; a one-axis tuple and its name are the same entry).
"""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro import configs as R_configs
from repro.models import registry as R_registry
from repro.models import shardings as R_sh
from repro.models.config import SHAPES as R_SHAPES
from repro_torch import configs
from repro_torch.launch.mesh import data_axes
from repro_torch.models import build, input_specs, shardings
from repro_torch.models.config import SHAPES
from repro_torch.models.convert import leaves, param_tree
from repro_torch.models.registry import cache_specs

MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pods2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "test2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def meshes(name):
    shape, names = MESHES[name]
    return AbstractMesh(shape, names), dict(zip(names, shape))


def norm(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def norm_spec(spec):
    return tuple(norm(e) for e in spec)


def ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            norm_spec(v) for p, v in flat}


def port_flat(tree) -> dict:
    if not isinstance(tree, dict):
        return {(): norm_spec(tree)}
    return {p: norm_spec(v) for p, v in leaves(tree)}


@functools.lru_cache(maxsize=None)
def ref_abstract(arch):
    return R_registry.build(R_configs.get(arch)).abstract_params()


@functools.lru_cache(maxsize=None)
def port_abstract(arch):
    return param_tree(build(configs.get(arch)).abstract_params())


def rules(cfg, names):
    daxes = tuple(a for a in ("pod", "data") if a in names)
    return dict(fsdp_axes=daxes if cfg.fsdp else None,
                replicate_names=(("w_gate", "w_up", "w_down")
                                 if cfg.moe_capacity_sharding else ()))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", R_configs.ARCHS)
def test_param_specs_equal_the_reference(arch, mesh_name):
    rmesh, sizes = meshes(mesh_name)
    cfg = configs.get(arch)
    kw = rules(cfg, sizes)
    want = ref_flat(R_sh.param_specs(ref_abstract(arch), rmesh, **kw))
    got = port_flat(shardings.param_specs(port_abstract(arch), sizes, **kw))
    assert got == want


@pytest.mark.parametrize("arch", R_configs.ARCHS)
def test_abstract_params_match_the_reference_tree(arch):
    """Meta tensors with the tree's shapes and dtypes, drawn nowhere."""
    want = {p: (tuple(v.shape), str(v.dtype))
            for p, v in leaves(jax.tree.map(lambda x: x, ref_abstract(arch)))}
    got = {}
    for p, leaf in leaves(port_abstract(arch)):
        first = leaf[0] if isinstance(leaf, list) else leaf
        assert first.device.type == "meta"
        shape = (len(leaf),) + tuple(first.shape) if isinstance(leaf, list) \
            else tuple(first.shape)
        got[p] = (shape, str(first.dtype).replace("torch.", ""))
    assert got == want


def _specs_pair(arch, shape_name):
    rcfg, cfg = R_configs.get(arch), configs.get(arch)
    return (R_registry.input_specs(rcfg, R_SHAPES[shape_name]),
            input_specs(cfg, SHAPES[shape_name]))


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", R_configs.ARCHS)
def test_input_and_cache_specs_equal_the_reference(arch, shape_name):
    """Shapes and dtypes of every input and cache stand-in; the port's
    are meta tensors."""
    ref, mine = _specs_pair(arch, shape_name)

    def sd(tree):
        if not isinstance(tree, dict):
            return {(): (tuple(tree.shape),
                         str(tree.dtype).replace("torch.", ""))}
        return {p: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for p, v in leaves(tree)}
    assert set(ref) == set(mine)
    for k in ref:
        assert sd(mine[k]) == sd(ref[k]), k
        for _, v in (leaves(mine[k]) if isinstance(mine[k], dict)
                     else [((), mine[k])]):
            assert v.device.type == "meta"
    if "cache" in mine:
        cfg = configs.get(arch)
        b, t = SHAPES[shape_name].global_batch, SHAPES[shape_name].seq_len
        assert sd(cache_specs(cfg, b, t)) == sd(mine["cache"])


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", R_configs.ARCHS)
def test_batch_and_cache_specs_equal_the_reference(arch, shape_name,
                                                   mesh_name):
    rmesh, sizes = meshes(mesh_name)
    ref, mine = _specs_pair(arch, shape_name)
    for key in ("batch", "token"):
        if key in ref:
            assert port_flat(shardings.batch_specs(mine[key], sizes)) == \
                ref_flat(R_sh.batch_specs(ref[key], rmesh)), key
    if "cache" in ref:
        assert port_flat(shardings.cache_specs_tree(mine["cache"], sizes)) \
            == ref_flat(R_sh.cache_specs_tree(ref["cache"], rmesh))


def test_constrain_is_the_identity_without_a_mesh():
    x = torch.randn(4, 6, 8)
    assert shardings.activation_mesh() is None
    assert shardings.constrain_batch(x) is x
    assert shardings.constrain(x, (("pod", "data"), "model", None)) is x
    y = x.reshape(4, 6, 2, 4)
    assert shardings.split_heads(y, 2) is y


def test_constrain_is_the_identity_on_a_plain_tensor_with_a_mesh():
    x = torch.randn(4, 6, 8)
    shardings.set_activation_mesh({"data": 2, "model": 2})
    try:
        assert shardings.constrain_batch(x) is x
        assert shardings.constrain(x, (("pod", "data"), "model", None)) is x
    finally:
        shardings.set_activation_mesh(None)


def test_cache_writes_on_plain_tensors_are_the_plain_writes():
    """put_rows / put_prefix / put_slots / take_rows / pick_last on plain
    tensors equal the indexing they stand for, bitwise."""
    g = torch.Generator().manual_seed(0)
    cache = torch.randn(3, 10, 2, 4, generator=g)
    ref = cache.clone()
    val = torch.randn(3, 2, 4, generator=g)
    rows, slot = torch.arange(3), torch.tensor([1, 9, 4])
    shardings.put_rows(cache, (rows, slot), val)
    ref.index_put_((rows, slot), val)
    assert torch.equal(cache, ref)
    pre = torch.randn(3, 6, 2, 4, generator=g)
    shardings.put_prefix(cache, pre)
    ref[:, :6] = pre
    assert torch.equal(cache, ref)
    slots = torch.tensor([7, 8, 2])
    sv = torch.randn(3, 3, 2, 4, generator=g)
    shardings.put_slots(cache, slots, sv)
    ref[:, slots] = sv
    assert torch.equal(cache, ref)
    table = torch.randn(11, 5, generator=g)
    idx = torch.tensor([[0, 3, 10], [2, 2, 7]])
    assert torch.equal(shardings.take_rows(table, idx), table[idx])
    logits = torch.randn(2, 3, 11, generator=g)
    assert torch.equal(shardings.pick_last(logits, idx),
                       logits.gather(-1, idx[..., None])[..., 0])
    assert torch.equal(shardings.value_counts(idx, 11), torch.zeros(
        11).scatter_add_(0, idx.reshape(-1), torch.ones(6)))


def test_spec_entries_map_to_placements():
    """A spec entry naming two axes shards its dim on both mesh dims (or
    on the one "pod+data" dim that stands for them); one that splits such
    a dim is refused."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        def __init__(self, names):
            self.mesh_dim_names = names
    assert shardings.to_placements((("pod", "data"), None, "model"),
                                   Mesh(("pod", "data", "model"))) == \
        [Shard(0), Shard(0), Shard(2)]
    assert shardings.to_placements((None, ("pod", "data")),
                                   Mesh(("pod+data", "model"))) == \
        [Shard(1), Replicate()]
    with pytest.raises(ValueError, match="splits"):
        shardings.to_placements(("data",), Mesh(("pod+data", "model")))
    assert data_axes(Mesh(("pod", "data", "model"))) == ("pod", "data")


def test_to_placements_of_a_tree():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("data", "model")
    tree = {"a": ("data", None), "b": {"c": (None, "model")}}
    assert shardings.to_shardings(tree, Mesh()) == {
        "a": [Shard(0), Replicate()], "b": {"c": [Replicate(), Shard(1)]}}


def test_local_maps_on_plain_tensors_are_the_function():
    """local_scan / local_rows / local_heads / local_channels call their
    function on plain tensors as they are; whole and chunk_last are the
    identity and ``chunk``."""
    x = torch.randn(2, 5, 6)
    seen = []

    def fn(*a):
        seen.append(a)
        return a[0], a[1]
    assert shardings.local_scan(fn, x, x, x, x, x, None) == (x, x)
    assert shardings.local_rows(lambda a, b: (a, b), (x,), (x,)) == (x, x)
    assert shardings.local_heads(lambda q, k, v: q, x, (x, x), (), 2) is x
    assert shardings.local_channels(lambda a, w, b, s: (a, s), x, None, x,
                                    x) == (x, None)
    assert shardings.whole(x) is x
    assert all(torch.equal(a, b) for a, b in zip(shardings.chunk_last(x, 2),
                                                 x.chunk(2, dim=-1)))
    assert torch.equal(shardings.micro_batch(x, 1, 2), x[1:2])


DTENSOR_BODY = """
import torch.nn.functional as F
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from repro_torch.models import shardings as sm
from repro_torch.models.layers import blockwise_attention
from repro_torch.models.ssm import _causal_conv
from repro_torch.kernels.ref import s6_scan_ref
from torch.distributed.tensor.experimental import implicit_replication
m2 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
sm.set_activation_mesh({"data": 2, "model": 2})
_implicit = implicit_replication()     # as the dry run runs the model
_implicit.__enter__()
g = torch.Generator().manual_seed(0)
R = lambda *s: torch.randn(*s, generator=g)
D = lambda t, *pl: distribute_tensor(t, m2, list(pl))
full = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
err = lambda a, b: float((full(a) - b).abs().max())
S0, S1, S2, Rp = Shard(0), Shard(1), Shard(2), Replicate()

table, idx = R(12, 6), torch.randint(0, 12, (4, 5), generator=g)
out["take_rows"] = err(sm.take_rows(D(table, Rp, S0), D(idx, S0, Rp)),
                       table[idx])
logits, lab = R(4, 5, 12), torch.randint(0, 12, (4, 5), generator=g)
out["pick_last"] = err(sm.pick_last(D(logits, S0, S2), D(lab, S0, Rp)),
                       logits.gather(-1, lab[..., None])[..., 0])
out["value_counts"] = err(sm.value_counts(D(lab, S0, Rp), 12),
                          sm.value_counts(lab, 12))
for name, pl in (("rows", (S0, S2)), ("seq", (S1, S2))):
    cache, val = R(4, 8, 2, 3), R(4, 2, 3)
    rows, slot = torch.arange(4), torch.tensor([0, 7, 3, 4])
    want = cache.clone()
    want.index_put_((rows, slot), val)
    dc = D(cache, *pl)
    sm.put_rows(dc, (rows, slot), D(val, S0, Rp))
    out["put_rows_" + name] = err(dc, want)
    slots, sv = torch.tensor([6, 1, 5]), R(4, 3, 2, 3)
    want[:, slots] = sv
    sm.put_slots(dc, slots, sv)
    out["put_slots_" + name] = err(dc, want)
    pre = R(4, 8, 2, 3)
    sm.put_prefix(dc, D(pre, S0, Rp))
    out["put_prefix_" + name] = err(dc, pre)
q, k, v = R(4, 6, 4, 8), R(4, 6, 2, 8), R(4, 6, 2, 8)
att = lambda a, b, c: blockwise_attention(
    a, b, c, mask_fn=lambda ti, si: si[None, :] <= ti[:, None], block_kv=4)
out["local_heads"] = err(sm.local_heads(att, D(q, S0, S2), (D(k, S0, S2),
                                        D(v, S0, S2)), (), 2), att(q, k, v))
x, dt = R(4, 7, 6), R(4, 7, 6).abs()
b_, c_, a, h0 = R(4, 7, 3), R(4, 7, 3), -R(6, 3).abs(), R(4, 6, 3)
y, hf = s6_scan_ref(x, dt, b_, c_, a, h0)
gy, ghf = sm.local_scan(s6_scan_ref, D(x, S0, S2), D(dt, S0, S2),
                        D(b_, S0, Rp), D(c_, S0, Rp), D(a, Rp, S0),
                        D(h0, S0, S1))
out["local_scan"] = max(err(gy, y), err(ghf, hf))
w, bias, st = R(4, 6), R(6), R(4, 3, 6)
cy, cs = _causal_conv(x, w, bias, st)
gy, gs = sm.local_channels(_causal_conv, D(x, S0, Rp), D(st, S0, Rp),
                           D(w, Rp, S1), D(bias, Rp, S0))
out["local_channels"] = max(err(gy, cy), err(gs, cs))
gr = sm.local_rows(lambda a_, r_: (a_ @ r_, a_.cumsum(1)), (D(x, S0, S2),),
                   (D(w.T.contiguous(), Rp, Rp),))
out["local_rows"] = max(err(gr[0], x @ w.T), err(gr[1], x.cumsum(1)))
xz = R(4, 7, 12)
ch = sm.chunk_last(D(xz, S0, S2), 2)
out["chunk_last"] = max(err(c, p) for c, p in zip(ch, xz.chunk(2, -1)))
hp = D(R(4, 7, 6), S0, S2) @ D(R(6, 5), S0, Rp)
out["whole"] = float(any(p.is_partial() for p in sm.whole(hp).placements))
ids = torch.arange(8).float()[:, None].expand(8, 3).contiguous()
parts = [full(sm.micro_batch(D(ids, S0, Rp), i, 2))[:, 0] for i in range(2)]
out["micro_rows"] = sorted(torch.cat(parts).tolist())
cb = sm.constrain_batch(D(R(4, 7, 6), Rp, S2))
out["constrain_batch"] = [str(p) for p in cb.placements]
"""


@pytest.fixture(scope="module")
def dtensor_checks(tmp_path_factory):
    from torch_parity import run_ranks
    outs = run_ranks(tmp_path_factory.mktemp("dt"), 4, DTENSOR_BODY,
                     timeout=120)
    return outs[0]


@pytest.mark.parametrize("name", [
    "take_rows", "pick_last", "value_counts", "put_rows_rows",
    "put_rows_seq", "put_slots_rows", "put_slots_seq", "put_prefix_rows",
    "put_prefix_seq", "local_heads", "local_scan", "local_channels",
    "local_rows", "chunk_last"])
def test_dtensor_hooks_equal_the_plain_operation(dtensor_checks, name):
    """Each hook on DTensors over 4 gloo ranks ((2, 2) mesh "data" ×
    "model"; a cache sharded by rows and by sequence) gives the plain
    operation's values on the whole tensors, within 1e-5."""
    assert dtensor_checks[name] <= 1e-5, dtensor_checks[name]


def test_dtensor_layout_hooks(dtensor_checks):
    """whole() leaves no partial sum; micro_batch's slices cover every row
    once; constrain_batch shards dim 0 over "data" and replicates the
    rest."""
    assert dtensor_checks["whole"] == 0.0
    assert dtensor_checks["micro_rows"] == [float(i) for i in range(8)]
    assert dtensor_checks["constrain_batch"] == ["S(0)", "R"]
