"""The harness driven end to end on the CPU at small sizes, past its look
for a card, with the timed path broken underneath: each fault a cell can
have must turn ``correct`` false, and a run with none must leave it true.

The faults: a solve that returns its state unchanged (the first result
served again), half of the input left out (its second half replaced by
the first), and an answer altered where it is produced.  One chip, so no
exchange between chips to leave out.
"""

import pytest
import torch

from bench import run as harness
from bench.manifest import Manifest
from repro_torch.core.api import TuckerPlan

FAULTS = ("none", "stale", "half", "altered")
SMALL = {  # the cells' configurations at sizes a test holds
    "boats-auto": dict(shape=[12, 10, 40], ranks=[3, 3, 3]),
    "hsi-eig": dict(shape=[14, 12, 5, 4], ranks=[3, 3, 2, 2]),
    "hsi-auto": dict(shape=[14, 12, 5, 4], ranks=[3, 3, 2, 2]),
}


@pytest.fixture(scope="module")
def manifest():
    return Manifest()


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _half(x):
    x = x.clone()
    h = x.shape[-1] // 2
    x[..., h:2 * h] = x[..., :h]
    return x


def _alter(res):
    core = res.tucker.core
    core.view(-1)[0] += 1e-3 * float(core.norm())
    return res


def _plant(monkeypatch, fault: str) -> None:
    if fault == "none":
        return
    execute = TuckerPlan.execute
    first = []

    def stale(res):
        first.append(res)
        return first[0]

    if fault == "stale":
        monkeypatch.setattr(TuckerPlan, "execute",
                            lambda self, x, **kw: stale(execute(self, x, **kw)))
    elif fault == "half":
        monkeypatch.setattr(TuckerPlan, "execute",
                            lambda self, x, **kw: execute(self, _half(x), **kw))
    elif fault == "altered":
        monkeypatch.setattr(TuckerPlan, "execute",
                            lambda self, x, **kw: _alter(execute(self, x, **kw)))


def _run(m: Manifest, workload: str, seed: int, trace: bool = False) -> dict:
    w = m.workload(workload)
    cfg = dict(m.config(w["config"]), **SMALL[workload])
    return harness.run_cell(m, workload, seed, 0.3, trace, "cpu", t0=0.0,
                            config=cfg)


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_broken_timed_path_reads_not_correct(monkeypatch, manifest,
                                               workload, fault):
    _plant(monkeypatch, fault)
    res = _run(manifest, workload, 2**31 + 17)
    assert res["correct"] is (fault == "none"), res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    if fault != "none":
        assert max(res["checks"][k]["value"] / res["checks"][k]["limit"]
                   for k in ("subspace", "recon")) > 1


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_sound_run_prints_its_cells_metrics(manifest, workload):
    m = manifest
    e2e = _run(m, workload, 5)
    assert e2e["correct"] is True
    assert set(e2e["metrics"]) == {e["name"] for e in m.end_to_end(workload)}
    for v in e2e["metrics"].values():
        assert v["value"] == v["value"] and v["unit"]
    traced = _run(m, workload, 6, trace=True)
    assert traced["correct"] is True
    # on the CPU the device's readers find nothing to read and stay silent
    allowed = {e["name"] for e in m.per_layer(workload)}
    assert set(traced["metrics"]) <= allowed
    assert traced["device"]["platform"] == "cpu"


def test_a_failed_solve_reads_not_correct(monkeypatch, manifest):
    execute, calls = TuckerPlan.execute, []

    def boom(self, x, **kw):       # set-up's 8 warm solves pass
        calls.append(1)
        if len(calls) > 8:
            raise RuntimeError("planted failure")
        return execute(self, x, **kw)
    monkeypatch.setattr(TuckerPlan, "execute", boom)
    res = _run(manifest, "boats-auto", 9)
    assert res["correct"] is False and res["failed"] == 1
