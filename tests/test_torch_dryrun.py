"""The port's dry run (``repro_torch/launch/dryrun.py``) on the CPU: the
reference's dry-run-lite matrix (``tests/test_multidevice.py``'s
``test_dryrun_lite_all_families``), one architecture of each family ×
train / prefill / decode at SMOKE size on a (2, 2, 2) mesh of fake ranks,
every cell traced on meta DTensors under the op walker with nothing
allocated; then ``run_cell``'s artifact, its skip of a cached cell and
``force``.

Each case runs in a subprocess of its own (the fake process group is
per process), under its own timeout.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
LITE = ("gemma3_1b", "mixtral_8x22b", "falcon_mamba_7b", "zamba2_1p2b",
        "seamless_m4t_medium", "internvl2_2b")
KEYS = {"arch", "shape", "mesh", "chips", "walked", "collectives",
        "model_flops", "roofline", "memory", "param_count",
        "param_count_tree", "trace_s", "build_s"}

PRELUDE = """
    import json, sys, warnings
    warnings.filterwarnings("ignore")
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import _mesh
    from repro_torch.models import shardings as sm
    from repro_torch.models.config import ShapeConfig
    dryrun.fake_world(8)
    mesh = _mesh((2, 2, 2), ("pod", "data", "model"))
    SHAPES = {"train": ShapeConfig("t", 32, 8, "train"),
              "prefill": ShapeConfig("p", 64, 4, "prefill"),
              "decode": ShapeConfig("d", 64, 4, "decode")}
"""


def _cmd(code: str) -> list[str]:
    return [sys.executable, "-c",
            textwrap.dedent(PRELUDE) + textwrap.dedent(code)]


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def run_py(code: str, timeout: int) -> str:
    p = subprocess.run(_cmd(code), capture_output=True, text=True,
                       timeout=timeout, env=_env())
    assert p.returncode == 0, p.stderr[-4000:]
    return p.stdout


LITE_CODE = """
    arch = sys.argv[1]
    for kind, sh in SHAPES.items():
        sm.set_activation_mesh(mesh)
        step, args, cfg, shape = dryrun.build_cell(
            arch, "train_4k", mesh, smoke=True, shape_override=sh)
        for p in args["params"].parameters():
            assert p.device.type == "meta", p.device
            assert type(p.data).__name__ == "DTensor"
        walked, secs = dryrun.walk_cell(step, args["arg_bytes"])
        sm.set_activation_mesh(None)
        print(json.dumps(dict(kind=kind, walked=walked,
                              arg_bytes=args["arg_bytes"])))
"""


@pytest.fixture(scope="module")
def lite_runs():
    """The six architectures' subprocesses, started together (each 240 s
    at most); {arch: (returncode, stdout, stderr)}."""
    procs = {a: subprocess.Popen(_cmd(LITE_CODE) + [a], env=_env(),
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for a in LITE}
    out = {}
    try:
        for a, p in procs.items():
            try:
                o, e = p.communicate(timeout=240)
            except subprocess.TimeoutExpired:
                p.kill()
                o, e = p.communicate(timeout=30)
                e = "timed out after 240 s\n" + e
            out[a] = (p.returncode, o, e)
    finally:   # a failed wait leaves no process behind
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return out


@pytest.mark.parametrize("arch", LITE)
def test_dryrun_lite(arch, lite_runs):
    """Every kind of step of one architecture builds on meta DTensors and
    walks: FLOPs > 0, the walker's keys, collectives on the mesh (the
    parameters are tensor-parallel over 'model'), nothing on a device."""
    rc, out, err = lite_runs[arch]
    assert rc == 0, err[-4000:]
    rows = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert [r["kind"] for r in rows] == ["train", "prefill", "decode"]
    for r in rows:
        w = r["walked"]
        assert w["flops"] > 0, (arch, r["kind"])
        assert w["traffic_ess"] > 0 and w["traffic"] >= w["traffic_ess"]
        assert w["coll_count"] > 0 and w["coll_total"] > 0
        assert w["coll_network"] == 0      # 8 ranks: one node
        assert w["peak_live"] >= r["arg_bytes"] > 0
        assert set(w) >= {"flops", "traffic", "traffic_ess", "all-reduce",
                          "all-gather", "reduce-scatter", "all-to-all",
                          "collective-permute", "coll_count", "coll_total"}
    # a train step does a forward and a backward of 8 microbatches: more
    # work than the prefill of half as many tokens
    assert rows[0]["walked"]["flops"] > rows[1]["walked"]["flops"]


def test_run_cell_writes_skips_and_forces(tmp_path):
    out = run_py(f"""
        from pathlib import Path
        art = Path({str(tmp_path)!r})
        kw = dict(smoke=True, shape_override=SHAPES["decode"])
        rec = dryrun.run_cell("seamless-m4t-medium", "decode_32k", mesh,
                              "test2x2x2", art, verbose=False, **kw)
        path = art / "test2x2x2" / "seamless_m4t_medium__decode_32k.json"
        first = path.stat().st_mtime_ns
        again = dryrun.run_cell("seamless-m4t-medium", "decode_32k", mesh,
                                "test2x2x2", art, verbose=True, **kw)
        assert path.stat().st_mtime_ns == first and again == rec
        forced = dryrun.run_cell("seamless-m4t-medium", "decode_32k", mesh,
                                 "test2x2x2", art, force=True,
                                 verbose=False, **kw)
        print("FORCED", path.stat().st_mtime_ns != first or
              forced["trace_s"] != rec["trace_s"])
        print(json.dumps(rec))
    """, timeout=180)
    assert "skip (cached)" in out
    assert "FORCED True" in out
    rec = json.loads(out.splitlines()[-1])
    assert set(rec) == KEYS
    assert rec["arch"] == "seamless_m4t_medium" and rec["chips"] == 8
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s",
                                    "bottleneck", "useful_ratio"}
    assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")
    assert rec["walked"]["flops"] > 0 and rec["model_flops"] > 0
    assert rec["memory"]["peak_live_bytes"] >= \
        rec["memory"]["argument_bytes"] > 0
    assert rec["param_count_tree"] > rec["param_count"]


def test_fake_world_is_required_for_a_mesh():
    out = run_py("""
        import torch.distributed as dist
        dist.destroy_process_group()
        from repro_torch.launch.mesh import make_production_mesh
        try:
            make_production_mesh()
        except RuntimeError as e:
            print("REFUSED", e)
        dryrun.fake_world(8)
        try:
            make_production_mesh()
        except ValueError as e:
            print("SIZE", e)
    """, timeout=120)
    assert "REFUSED" in out and "SIZE" in out
