"""The yardstick's own pieces on the CPU: the frozen bound, the seeds and
inputs, the reference and its judgement, the sample, the trace arithmetic
and the import check."""

import math
import random
from types import SimpleNamespace

import pytest
import torch

from bench import count, devtrace, gen, isolation, reference
from bench.drivers import common


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# bytes worked out by hand: the input once, the factors and the core once
@pytest.mark.parametrize("shape,ranks,nbytes,bound_ms", [
    # 320·240·7000 = 537,600,000; (320 + 240 + 7000)·10 = 75,600; 10³
    ((320, 240, 7000), (10, 10, 10), 4 * 537_676_600, 0.64200),
    # 1021·1340·33·8 = 361,188,960; (1021 + 1340 + 33)·10 + 8·5 = 23,980;
    # 10·10·10·5 = 5,000
    ((1021, 1340, 33, 8), (10, 10, 10, 5), 4 * 361_217_940, 0.43130),
])
def test_the_bound_reads_the_bytes_worked_out(shape, ranks, nbytes, bound_ms):
    assert count.solve_bytes(shape, ranks) == nbytes
    t, by = count.solve_bound(shape, ranks)
    assert by == "bytes"
    assert t * 1e3 == pytest.approx(bound_ms, rel=1e-4)
    # the operations' term is far below: 2·min(R)·|X| at the TF32 peak
    ops = 2 * min(ranks) * math.prod(shape)
    assert count.solve_flops(shape, ranks) == ops
    assert ops / 495e12 < t / 20


def test_operations_bind_only_at_large_ranks():
    assert count.solve_bound((2048, 2048, 512),
                             (512, 512, 512))[1] == "operations"
    assert count.solve_bound((320, 240, 7000), (10, 10, 10))[1] == "bytes"


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3, -5])
def test_stream_seeds_take_any_whole_number(seed):
    a = gen.stream_seed(seed, 0, 1)
    assert 0 <= a < 2**63
    assert a == gen.stream_seed(seed, 0, 1)
    assert a != gen.stream_seed(seed, 0, 2)
    assert a != gen.stream_seed(seed + 1, 0, 1)


def test_lowrank_is_the_same_for_a_seed_and_has_its_noise():
    shape, ranks = (9, 8, 7), (2, 3, 2)
    x = gen.lowrank(shape, ranks, gen.generator("cpu", 2**31 + 1, 0, 0))
    y = gen.lowrank(shape, ranks, gen.generator("cpu", 2**31 + 1, 0, 0))
    z = gen.lowrank(shape, ranks, gen.generator("cpu", 2**31 + 2, 0, 0))
    assert x.shape == shape and x.dtype == torch.float32
    assert torch.equal(x, y) and not torch.equal(x, z)
    clean = gen.lowrank(shape, ranks, gen.generator("cpu", 1, 0, 0), 0.0)
    core, factors = reference.sthosvd(clean, ranks, [0, 1, 2])
    assert reference.gaps(core, factors, core, factors)["recon"] == 0.0
    back = core
    for n, u in enumerate(factors):
        back = gen.mode_product(back, u, n)
    assert float((back - clean.double()).norm() / clean.norm()) < 1e-6


@pytest.mark.parametrize("rule,want", [(None, [0, 1, 2, 3]),
                                       ("shrink", [1, 0, 2, 3]),
                                       ([3, 2, 1, 0], [3, 2, 1, 0])])
def test_mode_order_as_the_configuration_states(rule, want):
    assert reference.mode_order((1021, 1340, 33, 8), (10, 10, 10, 5),
                                rule) == want


def test_subspace_iteration_agrees_with_eigh(monkeypatch):
    x = gen.lowrank((30, 1500, 6), (4, 5, 3), gen.generator("cpu", 3, 0))
    a = reference.sthosvd(x, (4, 5, 3), [1, 0, 2])
    monkeypatch.setattr(reference, "EXPLICIT_MAX", 10**9)
    b = reference.sthosvd(x, (4, 5, 3), [1, 0, 2])
    g = reference.gaps(*a, *b)
    assert g["subspace"] < 1e-10 and g["recon"] < 1e-10


def test_the_judgement_ignores_bases_and_sees_faults():
    x = gen.lowrank((12, 10, 9), (3, 3, 2), gen.generator("cpu", 4, 0))
    core, fac = reference.sthosvd(x, (3, 3, 2), [0, 1, 2])
    # another basis of the same spans, the core turned to match: no gap
    q = torch.linalg.qr(torch.randn(3, 3, dtype=torch.float64))[0]
    fac2 = [fac[0] @ q, fac[1], fac[2]]
    core2 = reference.ttm_t(core, q, 0)
    g = reference.gaps(core2, fac2, core, fac)
    assert g["subspace"] < 1e-12 and g["recon"] < 1e-12
    # an altered core, a factor out of its span, a wrong shape, a NaN
    bumped = core.clone()
    bumped[0, 0, 0] += 1e-3 * float(core.norm())
    assert reference.gaps(bumped, fac, core, fac)["recon"] > 5e-4
    bent = [fac[0], fac[1].clone(), fac[2]]
    bent[1][:, 0] = torch.linalg.qr(torch.randn(10, 3, dtype=torch.float64)
                                    )[0][:, 0]
    assert reference.gaps(core, bent, core, fac)["subspace"] > 1e-2
    wide = [torch.cat([fac[0], torch.zeros(2, 3, dtype=torch.float64)])] \
        + fac[1:]
    assert reference.gaps(core, wide, core, fac)["recon"] == math.inf
    nan = core.clone()
    nan[0, 0, 0] = math.nan
    assert reference.gaps(nan, fac, core, fac)["subspace"] == math.inf


def test_the_control_runs_in_tf32_and_restores_the_flags():
    before = torch.backends.cuda.matmul.allow_tf32
    with reference.precision(True):
        assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32 == before


def test_the_reservoir_is_uniform_and_drawn_from_the_seed():
    def draw(seed):
        r = common.Reservoir(8, random.Random(seed))
        for i in range(1000):
            r.offer(i)
        return r.items
    assert draw(1) == draw(1) and draw(1) != draw(2)
    hits = [0] * 10
    for s in range(400):
        for i in draw(s):
            hits[i // 100] += 1
    assert min(hits) > 0.6 * max(hits)


def _ev(name, a, b, cuda):
    from torch.autograd import DeviceType
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=a, end=b),
        device_type=DeviceType.CUDA if cuda else DeviceType.CPU)


def test_trace_arithmetic_on_a_made_timeline():
    events = [
        _ev("gemm", 0, 400, True), _ev("ttt", 300, 600, True),
        _ev("Memcpy DtoD (Device -> Device)", 800, 900, True),
        _ev("aten::linalg_eigh", 590, 820, False),
        _ev("cudaLaunchKernel", 10, 12, False),
        _ev("cudaGraphLaunch", 20, 25, False),
        _ev("cudaMemcpyAsync", 650, 655, False),
    ]
    s = devtrace.summarize(events, window_s=1e-3)
    assert s["busy_s"] == pytest.approx(700e-6)        # [0,600] + [800,900]
    assert s["idle_share"] == pytest.approx(0.3)
    assert s["launches"] == 3 and s["d2d_s"] == pytest.approx(100e-6)
    assert s["device_ops"][0] == ["gemm", pytest.approx(400e-6)]
    assert s["idle_gaps"] == [["aten::linalg_eigh", pytest.approx(200e-6)]]
    assert devtrace.summarize([], 1.0)["idle_share"] is None


def test_the_stretch_is_the_units_the_device_trace_covers():
    # six solves of 100 us, each 60 us on the device; the device's events
    # before 150 us are lost.  Counted: the solves that start after the
    # device's first event and end before its last, [300, 500]
    events = [_ev(devtrace.UNIT, 100 * i, 100 * i + 100, False)
              for i in range(6)]
    events += [_ev("cudaGraphLaunch", 100 * i + 5, 100 * i + 8, False)
               for i in range(6)]
    events += [_ev("ttt", 100 * i + 20, 100 * i + 80, True)
               for i in range(6) if 100 * i + 20 >= 150]
    # the profiler mirrors each mark on the device, over its work and gaps
    events += [_ev(devtrace.UNIT, 100 * i + 20, 100 * i + 80, True)
               for i in range(6)]
    s = devtrace.summarize(events, window_s=1.0)
    assert s["units"] == 2
    assert s["window_s"] == pytest.approx(200e-6)
    assert s["busy_s"] == pytest.approx(120e-6)
    assert s["launches"] == 2
    assert s["idle_share"] == pytest.approx(0.4)
    assert s["idle_gaps"][0][0] != devtrace.UNIT
    assert devtrace.summarize(events[:6] + events[-6:], 1.0)["units"] == 0


@pytest.mark.parametrize("names,bad", [
    (["repro_torch", "repro_torch.core.api", "torch"], []),
    (["repro", "repro_torch"], ["repro"]),
    (["repro.core.api"], ["repro"]),
    (["jax.numpy", "jaxtyping", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["flax.linen", "reprox"], ["flax"]),
    (["benchmarks.run", "chip_smoke"], ["benchmarks", "chip_smoke"]),
])
def test_the_import_check_compares_whole_top_level_names(names, bad):
    assert isolation.forbidden(names) == bad
