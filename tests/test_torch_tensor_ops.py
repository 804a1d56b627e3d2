"""Port parity: repro_torch.core.tensor_ops against repro.core.tensor_ops.

Every primitive, on modes first / interior / last of order-2..5 tensors, in
fp32 and fp64 (jax's 64-bit mode switched on only around the fp64 cases),
on the same numpy inputs.  Tolerances: fp32 2e-5 relative to the largest
entry (both sides sum the same fp32 products, in different orders, over at
most a few hundred terms), fp64 1e-12; bf16 4e-2 as in
tests/test_kernels.py.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tensor_ops as RT
from repro_torch.core import tensor_ops as PT
from torch_parity import to_np

CASES = [((9, 7), 0), ((9, 7), 1),
         ((5, 6, 7), 0), ((5, 6, 7), 1), ((5, 6, 7), 2),
         ((3, 4, 5, 6), 0), ((3, 4, 5, 6), 2), ((3, 4, 5, 6), 3),
         ((2, 3, 4, 3, 2), 0), ((2, 3, 4, 3, 2), 2), ((2, 3, 4, 3, 2), 4)]
DTYPES = {"float32": 2e-5, "float64": 1e-12}
OPS = ("ttm", "gram", "ttt", "ttm_explicit", "gram_explicit",
       "ttt_explicit", "unfold_fold")


def _x64(dtype):
    return jax.enable_x64(True) if dtype == "float64" \
        else contextlib.nullcontext()


def _inputs(shape, mode, dtype, seed=0):
    rng = np.random.default_rng(seed)
    r = max(1, shape[mode] - 2)
    x = rng.standard_normal(shape).astype(dtype)
    u = rng.standard_normal((r, shape[mode])).astype(dtype)
    y = rng.standard_normal(shape[:mode] + (r,) + shape[mode + 1:]).astype(dtype)
    return x, u, y


def _close(got, want, tol):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,mode", CASES)
@pytest.mark.parametrize("op", OPS)
def test_primitive_matches_reference(op, shape, mode, dtype):
    tol = DTYPES[dtype]
    x, u, y = _inputs(shape, mode, dtype)
    xt, ut, yt = (torch.from_numpy(a) for a in (x, u, y))
    with _x64(dtype):
        xj, uj, yj = (jnp.asarray(a) for a in (x, u, y))
        if op == "unfold_fold":
            got, want = PT.unfold(xt, mode), RT.unfold(xj, mode)
            _close(got, want, 0.0)
            _close(PT.fold(got, mode, shape), x, 0.0)
            return
        fn_t, fn_j = getattr(PT, op), getattr(RT, op)
        if op.startswith("ttm"):
            got, want = fn_t(xt, ut, mode), fn_j(xj, uj, mode)
        elif op.startswith("gram"):
            got, want = fn_t(xt, mode), fn_j(xj, mode)
        else:
            got, want = fn_t(xt, yt, mode), fn_j(xj, yj, mode)
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
        _close(got, want, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(9, 7), (5, 6, 7), (3, 4, 5, 6)])
def test_reconstruct_rel_error_fro_norm(shape, dtype):
    tol = DTYPES[dtype]
    rng = np.random.default_rng(3)
    ranks = tuple(max(1, d - 2) for d in shape)
    core = rng.standard_normal(ranks).astype(dtype)
    us = [rng.standard_normal((d, r)).astype(dtype)
          for d, r in zip(shape, ranks)]
    x = rng.standard_normal(shape).astype(dtype)
    ct, ust, xt = (torch.from_numpy(core), [torch.from_numpy(a) for a in us],
                   torch.from_numpy(x))
    with _x64(dtype):
        cj, usj, xj = jnp.asarray(core), [jnp.asarray(a) for a in us], \
            jnp.asarray(x)
        _close(PT.reconstruct(ct, ust), RT.reconstruct(cj, usj), tol)
        _close(PT.rel_error(xt, ct, ust), RT.rel_error(xj, cj, usj), tol)
        _close(PT.fro_norm(xt), RT.fro_norm(xj), tol)


@pytest.mark.parametrize("op", ["ttm", "gram", "ttt"])
def test_bfloat16_matches_reference(op):
    """bf16 keeps the input dtype for TTM and accumulates Gram/TTT in fp32,
    as the reference does (4e-2: bf16 rounds at other places)."""
    x, u, y = _inputs((6, 20, 8), 1, "float32", seed=5)
    xt, ut, yt = (torch.from_numpy(a).bfloat16() for a in (x, u, y))
    xj, uj, yj = (jnp.asarray(a, jnp.bfloat16) for a in (x, u, y))
    if op == "ttm":
        got, want = PT.ttm(xt, ut, 1), RT.ttm(xj, uj, 1)
    elif op == "gram":
        got, want = PT.gram(xt, 1), RT.gram(xj, 1)
    else:
        got, want = PT.ttt(xt, yt, 1), RT.ttt(xj, yj, 1)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    _close(got, want, 4e-2)


@pytest.mark.parametrize("shape,mode", CASES)
def test_split_dims_matches_reference(shape, mode):
    assert PT.split_dims(shape, mode) == RT.split_dims(shape, mode)


def test_ttm_rejects_mismatched_factor():
    with pytest.raises(ValueError):
        PT.ttm(torch.zeros(3, 4, 5), torch.zeros(2, 5), 1)
    with pytest.raises(ValueError):
        PT.ttt(torch.zeros(3, 4, 5), torch.zeros(3, 2, 6), 1)


@pytest.mark.parametrize("name,want", [
    ("float32", torch.float32), (torch.bfloat16, torch.bfloat16),
    (np.float64, torch.float64), (np.dtype("float32"), torch.float32)])
def test_dtype_names_round_trip(name, want):
    assert PT.torch_dtype(name) is want
    assert PT.dtype_name(want) == str(want).replace("torch.", "")
