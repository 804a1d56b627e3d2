"""Production mesh construction and the H100 figures of the roofline.

The port of ``repro/launch/mesh.py``.  Functions, not module constants, so
importing touches no process group.  The production mesh keeps the
reference's shapes and names, so every dry-run cell's specs compare one to
one with the reference's: one pod is (16, 16) over ("data", "model"), two
pods (2, 16, 16) over ("pod", "data", "model"); ``pod`` and ``data`` are
batch-parallel axes, ``model`` carries TP/EP/SP.  The mesh spans the
default process group: a fake world of 256 or 512 ranks for the dry run
(``repro_torch.launch.dryrun``), or a real one under ``torchrun``.

Hardware figures (NVIDIA H100 Tensor Core GPU datasheet, the SXM, NVL and
PCIe columns; dense rates are half the sheet's "with sparsity" figures):

=========  ==========  ========  =======  ==========  ===============
variant    bf16 dense  TF32      fp32     HBM         NVLink a
           (tensor)    dense     (FFMA)               direction
=========  ==========  ========  =======  ==========  ===============
SXM        989 TF/s    495 TF/s  67 TF/s  3.35 TB/s   450 GB/s (900
                                                      GB/s both ways)
NVL        835 TF/s    417.5     60 TF/s  3.9 TB/s    300 GB/s (600
                                                      GB/s bridge)
PCIe       756 TF/s    378 TF/s  51 TF/s  2.0 TB/s    64 GB/s (PCIe
                                                      Gen5 x16; the
                                                      600 GB/s bridge
                                                      joins pairs only)
=========  ==========  ========  =======  ==========  ===============

Between nodes each GPU has one NDR InfiniBand port, 400 Gb/s = 50 GB/s a
direction.  A node holds :data:`GPUS_PER_NODE` = 8 GPUs (an HGX board),
ranks numbered node by node, and a mesh's last axis varies fastest.  The
collective term prices each collective at the slowest link its group
crosses: a group whose ranks lie in one node moves at the NVLink rate, any
other at the network rate.  So on the production mesh every axis of 16
(the ``model`` axis: ranks r … r + 15, two nodes; ``data`` and ``pod``:
strides of 16 and 256) is priced at 50 GB/s, and on a mesh of at most 8
ranks every axis at NVLink's.
"""

from __future__ import annotations

#: per variant: bf16 and TF32 dense tensor-core FLOP/s, fp32 FFMA FLOP/s,
#: HBM bytes/s, and NVLink bytes/s a direction within a node
H100 = {
    "sxm": dict(bf16=989e12, tf32=495e12, fp32=67e12, hbm=3.35e12,
                nvlink=450e9),
    "nvl": dict(bf16=835e12, tf32=417.5e12, fp32=60e12, hbm=3.9e12,
                nvlink=300e9),
    "pcie": dict(bf16=756e12, tf32=378e12, fp32=51e12, hbm=2.0e12,
                 nvlink=64e9),
}
#: one NDR InfiniBand port a GPU: 400 Gb/s a direction
NETWORK_BW = 50e9
GPUS_PER_NODE = 8

# the production nodes' (SXM) figures: the roofline's denominators
PEAK_FLOPS_BF16 = H100["sxm"]["bf16"]
HBM_BW = H100["sxm"]["hbm"]
NVLINK_BW = H100["sxm"]["nvlink"]


def variant_of(device_name: str) -> str:
    """The H100 variant a device name (``torch.cuda.get_device_name``)
    denotes: ``pcie``, ``nvl`` or ``sxm`` (the default: "H100 80GB HBM3")."""
    low = device_name.lower()
    return "pcie" if "pcie" in low else "nvl" if "nvl" in low else "sxm"


def link_bw(ranks) -> float:
    """Bytes/s a direction of the slowest link a group of global ``ranks``
    crosses on the production (SXM) nodes: NVLink within one node, the
    network across nodes."""
    nodes = {r // GPUS_PER_NODE for r in ranks}
    return NVLINK_BW if len(nodes) <= 1 else NETWORK_BW


def _mesh(shape, names):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make the mesh inside a process group: the dry "
                           "run's fake world (launch.dryrun.fake_world) or "
                           "torchrun's")
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the process group "
                         f"has {dist.get_world_size()}")
    backend = dist.get_backend()
    device = "cuda" if backend == "nccl" else "cpu"
    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_test_mesh(n_devices: int | None = None, *, multi_pod: bool = False):
    """A small mesh over the default group's (fake) ranks."""
    import torch.distributed as dist
    n = n_devices or dist.get_world_size()
    if multi_pod:
        assert n % 2 == 0
        return _mesh((2, n // 4, 2), ("pod", "data", "model"))
    return _mesh((n // 2, 2), ("data", "model"))


def placement_mesh(mesh):
    """The mesh DTensors are placed on for ``mesh``: itself, or where it
    has both batch axes, a 2-D mesh over the same ranks whose first dim,
    "pod+data", stands for both (every rule shards over both or neither),
    so that DTensor weighs its strategies over two mesh dims, not three."""
    names = mesh.mesh_dim_names
    if not ("pod" in names and "data" in names):
        return mesh
    from torch.distributed.device_mesh import init_device_mesh
    shape = dict(zip(names, tuple(mesh.mesh.shape)))
    rest = [n for n in names if n not in ("pod", "data")]
    if names[:2] != ("pod", "data"):
        raise ValueError(f"the batch axes lead the mesh: {names}")
    return init_device_mesh(mesh.device_type,
                            (shape["pod"] * shape["data"],
                             *(shape[n] for n in rest)),
                            mesh_dim_names=("pod+data", *rest))


def data_axes(mesh) -> tuple[str, ...]:
    names = mesh.mesh_dim_names if hasattr(mesh, "mesh_dim_names") else mesh
    return tuple(a for a in ("pod", "data") if a in names)
