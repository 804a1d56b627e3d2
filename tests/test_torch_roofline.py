"""The port's roofline: ``repro_torch/roofline/analysis.py`` against
``repro/roofline/analysis.py``, and the per-device op walker
(``roofline/op_walk.py``, the counterpart of ``hlo_walk.py``).

``model_flops_for`` keeps the reference's arithmetic (its
``param_count`` included) and must equal it for every architecture and
shape.  The walker is held to counts worked out by hand: on plain CPU
tensors in process, and on the reference's known program
(``tests/test_multidevice.py``'s) in a subprocess on 8 fake ranks.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro import configs as R_configs
from repro.models.config import SHAPES as R_SHAPES
from repro.roofline import analysis as R_analysis
from repro_torch import configs
from repro_torch.launch import mesh as M
from repro_torch.models.config import SHAPES
from repro_torch.roofline import analysis, op_walk

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", R_configs.ARCHS)
def test_model_flops_equal_the_reference(arch, shape_name):
    assert analysis.model_flops_for(configs.get(arch), SHAPES[shape_name]) \
        == R_analysis.model_flops_for(R_configs.get(arch),
                                      R_SHAPES[shape_name])


def test_param_count_keeps_the_reference_gap():
    """seamless-m4t-medium: the reference's count takes a gated-gelu MLP
    as two matrices; its tree holds three (715,517,952 parameters)."""
    cfg = configs.get("seamless-m4t-medium")
    assert cfg.param_count() == 665_008_128
    from repro_torch.models import build
    ab = build(cfg).abstract_params()
    assert sum(p.numel() for p in ab.parameters()) == 715_517_952


def test_roofline_from_cell_arithmetic():
    coll = {"total": 3e9, "nvlink": 1e9, "network": 2e9}
    r = analysis.Roofline.from_cell(
        arch="a", shape="s", mesh_name="m", chips=256,
        cost={"flops": 989e12, "bytes accessed": 6.7e12}, collectives=coll,
        model_flops=989e12 * 128, peak_bytes=5.0)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(2.0)
    assert r.collective_s == pytest.approx(1e9 / 450e9 + 2e9 / 50e9)
    assert r.bottleneck == "memory"
    assert r.useful_ratio == pytest.approx(0.5)
    assert r.peak_bytes_per_device == 5.0
    # without the link split every byte crosses the slowest link
    r2 = analysis.Roofline.from_cell(
        arch="a", shape="s", mesh_name="m", chips=1, cost={"flops": 0.0},
        collectives={"total": 5e9}, model_flops=0.0)
    assert r2.collective_s == pytest.approx(0.1)
    assert r2.bottleneck == "collective"


def test_markdown_and_seconds_equal_the_reference():
    kw = dict(arch="a", shape="s", mesh="m", chips=4, hlo_flops=1.0,
              hlo_bytes=2.0, collective_bytes=3.0, model_flops=4.0,
              compute_s=2e-4, memory_s=0.5, collective_s=3.0,
              bottleneck="collective", useful_ratio=0.25)
    assert analysis.to_markdown_table([analysis.Roofline(**kw)]) == \
        R_analysis.to_markdown_table([R_analysis.Roofline(**kw)])
    for s in (3e-7, 2e-3, 4.5):
        assert analysis.fmt_seconds(s) == R_analysis.fmt_seconds(s)


def test_h100_figures():
    assert M.variant_of("NVIDIA H100 80GB HBM3") == "sxm"
    assert M.variant_of("NVIDIA H100 PCIe") == "pcie"
    assert M.variant_of("NVIDIA H100 NVL") == "nvl"
    assert M.H100["sxm"]["bf16"] == 989e12 and M.HBM_BW == 3.35e12
    assert M.link_bw(range(8)) == 450e9
    assert M.link_bw(range(16)) == M.NETWORK_BW == 50e9
    assert M.link_bw([0, 16, 32]) == 50e9


class TestWalkerOnPlainTensors:
    def test_dots(self):
        a, b = torch.randn(8, 32), torch.randn(32, 16)
        x, y = torch.randn(3, 8, 32), torch.randn(3, 32, 16)
        with op_walk.OpWalk() as w:
            a @ b
            torch.bmm(x, y)
            torch.addmm(torch.zeros(16), a, b)
        r = w.result()
        assert r["flops"] == 2 * 8 * 16 * 32 * (1 + 3 + 1)
        assert w.flops_by_dtype == {"float32": r["flops"]}
        # a dot's operands and result are essential bytes
        assert r["traffic_ess"] >= 4 * (8 * 32 + 32 * 16 + 8 * 16)

    def test_gather_scatter_and_views(self):
        table = torch.randn(100, 8)
        idx = torch.tensor([1, 5, 7])
        cache = torch.zeros(4, 10, 8)
        with op_walk.OpWalk() as w:
            table[idx]
            cache.index_put_((torch.arange(4), torch.tensor([0, 1, 2, 3])),
                             torch.ones(4, 8))
            cache.view(40, 8).t()
        r = w.result()
        # the gathered rows, and the update of the scatter: not the table
        # or the cache
        assert r["traffic_ess"] == 4 * 3 * 8 + 4 * 4 * 8
        assert r["flops"] == 0 and r["coll_total"] == 0

    def test_live_bytes(self):
        with op_walk.OpWalk(track_live=True, live_base=100) as w:
            a = torch.ones(1000)
            b = a * 2
            del a, b
            c = torch.ones(10)
        assert w.result()["peak_live"] == 100 + 8000
        del c

    def test_a_loop_counts_every_trip(self):
        a, b = torch.randn(4, 4), torch.randn(4, 4)
        with op_walk.OpWalk() as w:
            for _ in range(5):
                a @ b
        assert w.result()["flops"] == 5 * 2 * 4 * 4 * 4


def run_py(code: str, timeout: int = 120) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=timeout,
                       env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout


def test_walker_on_the_known_program():
    """x (64, 32) sharded over 8 fake ranks, w (32, 16) replicated,
    x @ w all-reduced, in a loop of 5: per device 2·8·32·16 FLOPs and an
    all-reduce of 8·16·4 bytes a trip; the all-reduce's group lies in one
    node, so its bytes are NVLink's."""
    out = run_py("""
        import warnings; warnings.filterwarnings("ignore")
        import torch
        import torch.distributed._functional_collectives as funcol
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import _mesh
        from repro_torch.roofline.op_walk import OpWalk
        dryrun.fake_world(8)
        mesh = _mesh((8,), ("data",))
        x = DTensor.from_local(torch.empty(8, 32, device="meta"), mesh,
                               [Shard(0)], run_check=False)
        w = DTensor.from_local(torch.empty(32, 16, device="meta"), mesh,
                               [Replicate()], run_check=False)
        assert x.shape == (64, 32)
        for trips in (1, 5):
            with OpWalk() as ow:
                for _ in range(trips):
                    y = funcol.all_reduce(x.to_local() @ w.to_local(),
                                          "sum", mesh)
            r = ow.result()
            print(trips, r["flops"], r["all-reduce"], r["coll_count"],
                  r["coll_nvlink"], r["coll_network"])
        with OpWalk() as ow:     # the DTensor program: local work only
            z = (x @ w).redistribute(mesh, [Replicate()])
        r = ow.result()
        print("dt", r["flops"], r["all-gather"], z.shape[0])
    """)
    lines = dict((ln.split()[0], ln.split()[1:]) for ln in out.splitlines())
    one = 2 * 8 * 32 * 16
    assert [float(v) for v in lines["1"]] == [one, 8 * 16 * 4, 1,
                                              8 * 16 * 4, 0]
    assert [float(v) for v in lines["5"]] == [5 * one, 5 * 8 * 16 * 4, 5,
                                              5 * 8 * 16 * 4, 0]
    flops, gathered, rows = (float(v) for v in lines["dt"])
    assert flops == one and gathered == 8 * 16 * 4 and rows == 64
