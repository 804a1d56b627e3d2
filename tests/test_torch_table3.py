"""Port parity on the paper's Table III Cavity and MNIST tensors, cut to
size: repro_torch ``plan → execute`` against repro's st-HOSVD.

The full tensors run on the card in ``chip_smoke.py``'s main phase: Cavity
(100, 100, 10000) at ranks (20, 20, 20), whose last mode runs its ALS GEMM
on the boundary GEMM's last-mode wide route and its TTT (B = 1) on the wide
GEMM, and MNIST (784, 5000, 10) at ranks (65, 142, 10), whose mode 1 runs
the interior TTM at R = 142 and the TTT on 128-column tiles.  Here the same
plans run at (24, 24, 600) and (96, 300, 10) on the CPU, where each kernel
wrapper runs its plain version, on both backends, against the reference on
the same numpy input (low rank + 1% noise).  ``methods="auto"``,
``mode_order="shrink"`` (the reference runs the port's picks, which on
``hopper`` come from the port's own cuda model).  The reference draws
ALS's start from
``jax.random.normal(PRNGKey(0), (I_n, R_n))``; the port's draw is replaced
by that same array, so the two sweeps start alike.  Limits: projectors
within 1e-3 and rel_error within 1e-4, ``chip_smoke.py``'s gates.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro_torch.core import TuckerConfig, plan
from repro_torch.kernels.matmul import route as gemm_route
from repro_torch.kernels.matmul import side
from repro_torch.kernels.ttt import route as ttt_route
from torch_parity import assert_tucker_close, lowrank

#: the graphs module, whose ``seeded_randn`` draws ALS's start
G = importlib.import_module("repro_torch.core.graphs")

CAVITY = ((24, 24, 600), (20, 20, 20))
MNIST = ((96, 300, 10), (65, 142, 10))


def reference_draw(shape, *, seed, dtype, device):
    """The reference's ALS start for the same (I_n, R_n) and seed."""
    a = np.array(jax.random.normal(jax.random.PRNGKey(seed), tuple(shape),
                                   dtype=jnp.float32))
    return torch.from_numpy(a).to(dtype=dtype, device=device)


@pytest.mark.parametrize("impl", ["hopper", "matfree"])
@pytest.mark.parametrize("name,case", [("cavity", CAVITY), ("mnist", MNIST)])
def test_sthosvd_matches_the_reference(monkeypatch, name, case, impl):
    shape, ranks = case
    monkeypatch.setattr(G, "seeded_randn", reference_draw)
    x = lowrank(shape, ranks, seed=7, noise=0.01)
    cfg = dict(ranks=ranks, mode_order="shrink")
    p = plan(shape, "float32", TuckerConfig(impl=impl, methods="auto", **cfg),
             device="cpu")
    if impl == "matfree":   # the reference's selector, copied as data
        assert p.methods == R.plan(shape, jnp.float32, R.TuckerConfig(
            methods="auto", **cfg)).methods
    # hopper picks by the port's own cuda model: the reference runs its picks
    ref = R.plan(shape, jnp.float32, R.TuckerConfig(methods=p.methods, **cfg))
    assert [s.mode for s in p.schedule] == [s.mode for s in ref.schedule]
    got = p.execute(x)
    want = ref.execute(jnp.asarray(x))
    assert got.tucker.ranks == want.tucker.ranks
    assert_tucker_close(x, got.tucker, want.tucker, proj_atol=1e-3,
                        rel_atol=1e-4)
    assert float(got.tucker.rel_error(x)) <= 0.02


def test_the_cut_cases_take_the_routes_of_the_full_ones():
    """The cut shapes keep what the full ones run on the card: Cavity's
    last mode at R = 20 on the last-mode wide GEMM and wgmma_cols, MNIST's
    mode 1 TTT at R = 142 with B = 10 on wgmma_plain."""
    shape, ranks = CAVITY
    j = shape[0] * shape[1]
    assert gemm_route(j, ranks[2]) == "wide" and side(j, ranks[2]) == "last"
    assert ttt_route(ranks[2], 1) == "wgmma_cols"
    shape, ranks = MNIST
    assert ttt_route(ranks[1], shape[2]) == "wgmma_plain"
