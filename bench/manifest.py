"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is ``bench/configs/<config>.json`` (the path its entry
gives), a traffic mix ``bench/traffic/<traffic>.json``, a cell's limits
``bench/cells/<workload>.json``, a driver ``bench/drivers/<driver>.py`` and
a per-layer metric's reader ``bench/metrics/<metric>.py``.  A new cell,
configuration or metric is new files and new entries; no file here needs
an edit.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    def __init__(self, root: Path | str = ROOT):
        self.root = Path(root)
        self.bench = self.root / "bench"
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def _entry(self, key: str, name: str) -> dict:
        for e in self.data[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"BENCHMARK.json has no {key} entry named {name!r}")

    def workload(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        return json.loads((self.root / self._entry("configs", name)["file"])
                          .read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench / "traffic" / f"{name}.json")
                          .read_text())

    def cell(self, workload: str) -> dict:
        return json.loads((self.bench / "cells" / f"{workload}.json")
                          .read_text())

    def end_to_end(self, workload: str) -> list[dict]:
        """The end-to-end metrics the cell reports."""
        return [m for m in self.data["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list[dict]:
        """The per-layer metrics that list the cell under ``workloads``."""
        return [m for m in self.data["per_layer"]
                if workload in m["workloads"]]

    def driver(self, name: str):
        return _load_module(self.bench / "drivers" / f"{name}.py",
                            f"bench_driver_{name}")

    def reader(self, metric: str):
        """The ``read(ctx) -> float | None`` of a per-layer metric."""
        mod = _load_module(self.bench / "metrics" / f"{metric}.py",
                           "bench_metric_" + metric.replace(".", "_"))
        return mod.read
