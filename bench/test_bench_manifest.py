"""``BENCHMARK.json`` against the benchmark's contract, and the files it
names found by name (CPU only)."""

import ast
import json
import math
import re
import shutil
from pathlib import Path

import pytest

from bench.manifest import ROOT, Manifest

BM = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, set()),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
    "end_to_end": ({"name", "unit", "better", "bound", "source"},
                   {"workloads"}),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves",
                   "workloads"}, set()),
}
WORKLOADS = [w["name"] for w in BM["workloads"]]
PER_LAYER = [m["name"] for m in BM["per_layer"]]


def test_top_level_keys_and_size():
    assert set(BM) == TOP_KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("key", sorted(KEYS))
def test_entries_have_just_the_contract_keys(key):
    need, may = KEYS[key]
    assert BM[key], key
    for e in BM[key]:
        assert need <= set(e) <= need | may, (key, e["name"])


@pytest.mark.parametrize("key", sorted(KEYS))
def test_names_are_unique_and_well_formed(key):
    names = [e["name"] for e in BM[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_units_better_sources_and_texts():
    for m in BM["end_to_end"] + BM["per_layer"]:
        assert UNIT.match(m["unit"]), m["name"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BM["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
    for e in BM["configs"] + BM["workloads"]:
        assert TEXT.match(e["why"]), e["name"]
    for c in BM["configs"]:
        assert TEXT.match(c["source"]) and c["source"].startswith("https://")
    for m in BM["per_layer"]:
        assert TEXT.match(m["layer"])
    for w in BM["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_paths_and_command_stay_inside_the_benchmark():
    assert 1 <= len(BM["paths"]) <= 16
    for p in BM["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    cmd = BM["command"]
    assert 1 <= len(cmd) <= 32
    for word in cmd:
        assert TEXT.match(word) and not word.startswith("/")
        assert ".." not in word.split("/")
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BM["paths"]), word


def test_bounds_and_run_seconds():
    for m in BM["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
    rs = BM["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24      # later PRs may add cells up to the limit, never rs
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


def test_setup_s_is_an_end_to_end_metric_of_every_cell():
    setup = [m for m in BM["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]
    assert setup[0]["bound"] <= 0.25


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_reports_enough(workload):
    m = Manifest()
    e2e = {e["name"] for e in m.end_to_end(workload)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert m.per_layer(workload)
    w = m.workload(workload)
    assert w["chips"] in (1, 4)


@pytest.mark.parametrize("metric", PER_LAYER)
def test_each_per_layer_metric_moves_what_its_cells_report(metric):
    m = Manifest()
    entry = next(e for e in BM["per_layer"] if e["name"] == metric)
    assert entry["moves"] in {e["name"] for e in BM["end_to_end"]}
    for w in entry["workloads"]:
        assert w in WORKLOADS
        assert entry["moves"] in {e["name"] for e in m.end_to_end(w)}, w
    assert callable(m.reader(metric))


def test_layers_are_named_alike():
    layers = {m["layer"] for m in BM["per_layer"]}
    assert layers == {"front door", "kernels and device libraries", "device",
                      "sweep cache and graphs"}


def test_four_chip_cells_within_the_share():
    four = sum(w["chips"] == 4 for w in BM["workloads"])
    assert four <= max(1, len(BM["workloads"]) // 4)


@pytest.mark.parametrize("config", [c["name"] for c in BM["configs"]])
def test_config_files_hold_what_is_run(config):
    m = Manifest()
    entry = next(c for c in BM["configs"] if c["name"] == config)
    assert entry["file"].startswith(tuple(p + "/" for p in BM["paths"]))
    data = m.config(config)
    assert data["reduced"] == entry["reduced"] == []
    assert len(data["shape"]) == len(data["ranks"])
    assert all(1 <= r <= i for i, r in zip(data["shape"], data["ranks"]))
    assert data["dtype"] == "float32" and data["noise"] > 0
    assert "data" in data["assumed"]
    assert sum(c["file"] == entry["file"] for c in BM["configs"]) == 1
    assert any(w["config"] == config for w in BM["workloads"])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_cell_finds_its_traffic_driver_and_limits(workload):
    m = Manifest()
    w = m.workload(workload)
    tr = m.traffic(w["traffic"])
    drv = m.driver(tr["driver"])
    assert callable(drv.run) and callable(drv.judged_inputs)
    limits = m.cell(workload)["limits"]
    assert set(limits) == {"subspace", "recon", "failed"}
    assert limits["failed"] == 0
    # each limit lies between the readings it was set from, with more room
    # above the program's largest than below the control's smallest
    for k in ("subspace", "recon"):
        r = m.cell(workload)["readings"][k]
        assert 3 * r["lower"] <= r["upper"]
        assert r["lower"] < limits[k] < r["upper"]
        assert limits[k] / r["lower"] > r["upper"] / limits[k]


def test_pairs_of_config_and_traffic_appear_once():
    pairs = [(w["config"], w["traffic"]) for w in BM["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_files_under_paths_are_named_from_name_characters():
    for p in BM["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts or not f.is_file():
                continue
            rel = f.relative_to(ROOT).as_posix()
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def _digest(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in (root / "bench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_config_and_metric_are_found_by_name(tmp_path):
    """New files and new entries only: every file already there stays
    byte for byte as it was."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path)
    bm = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = tmp_path / "bench"
    (bench / "configs" / "cavity.json").write_text(json.dumps(dict(
        name="cavity", shape=[100, 100, 10000], ranks=[20, 20, 20],
        dtype="float32", noise=0.01, reduced=[], assumed={"data": "seed"})))
    (bench / "traffic" / "solve-als.json").write_text(json.dumps(dict(
        json.loads((bench / "traffic" / "solve-auto.json").read_text()),
        methods="als")))
    (bench / "cells" / "cavity-als.json").write_text(json.dumps(
        {"limits": {"subspace": 1e-5, "recon": 1e-5, "failed": 0}}))
    (bench / "metrics" / "solves_per_s.py").write_text(
        "def read(ctx):\n    return 1e3 / ctx['solve_ms']\n")
    bm["configs"].append(dict(name="cavity", source="https://x.org/a",
                              file="bench/configs/cavity.json", reduced=[],
                              why="a test"))
    bm["workloads"].append(dict(name="cavity-als", config="cavity",
                                traffic="solve-als", chips=1, why="a test"))
    next(e for e in bm["end_to_end"] if e["name"] == "solve_ms")[
        "workloads"].append("cavity-als")
    bm["per_layer"].append(dict(name="solves_per_s", unit="1/s",
                                better="higher", source="host_clock",
                                layer="front door", moves="solve_ms",
                                workloads=["cavity-als", "boats-auto"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bm))
    m = Manifest(tmp_path)
    assert m.config(m.workload("cavity-als")["config"])["ranks"] == [20] * 3
    tr = m.traffic(m.workload("cavity-als")["traffic"])
    assert tr["methods"] == "als" and tr["driver"] == "solve_loop"
    assert callable(m.driver(tr["driver"]).run)
    assert m.cell("cavity-als")["limits"]["subspace"] == 1e-5
    assert "solve_ms" in {e["name"] for e in m.end_to_end("cavity-als")}
    names = {e["name"] for e in m.per_layer("cavity-als")}
    assert "solves_per_s" in names
    assert "solves_per_s" in {e["name"] for e in m.per_layer("boats-auto")}
    assert "solves_per_s" not in {e["name"]
                                  for e in m.per_layer("hsi-eig")}
    assert m.reader("solves_per_s")({"solve_ms": 4.0}) == 250.0
    after = _digest(tmp_path)
    assert {k: after[k] for k in before} == before


# modules of the yardstick that must not import the program, JAX or the JAX
# package (the drivers and the harness drive the program; these judge it)
YARDSTICK = ["gen.py", "reference.py", "count.py", "devtrace.py",
             "isolation.py", "manifest.py"]


@pytest.mark.parametrize("module", YARDSTICK)
def test_the_yardstick_imports_nothing_of_the_program(module):
    tree = ast.parse((ROOT / "bench" / module).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            names.add(node.module.split(".")[0])
    assert not names & {"repro_torch", "repro", "jax", "jaxlib", "flax",
                        "benchmarks", "chip_smoke"}, names


def test_no_bench_file_reads_the_jax_benchmarks_or_chip_smoke():
    for f in (ROOT / "bench").rglob("*.py"):
        if f.name.startswith("test_") or f.name == "isolation.py":
            continue
        text = f.read_text()
        assert "chip_smoke" not in text, f
        assert not re.search(r"\bbenchmarks[/.]", text), f


def test_limits_are_finite_numbers():
    m = Manifest()
    for w in WORKLOADS:
        for v in m.cell(w)["limits"].values():
            assert math.isfinite(v)
