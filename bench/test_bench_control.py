"""The control on the card: the plain reference computed with TF32 products,
put in the program's place, must fail the cell's comparison.  Needs a CUDA
device (TF32 exists only there); it skips on the CPU.  The control's
readings at every cell's own sizes on three seeds are ``bench/control.py``'s;
this keeps the check at one seed and fewer inputs."""

import pytest

from bench.manifest import Manifest

WORKLOADS = [w["name"] for w in Manifest().data["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 products exist only there")
    return "cuda"


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_tf32_control_fails_the_cells_comparison(card, workload):
    from bench.control import control_readings
    m = Manifest()
    w = m.workload(workload)
    tr = dict(m.traffic(w["traffic"]))
    tr.update(inputs=1, sample=2)
    got = control_readings(m, workload, 2**31 + 29, card, traffic=tr)
    limits = m.cell(workload)["limits"]
    assert any(got[k] > limits[k] for k in ("subspace", "recon")), got
