"""Port parity for the Tucker gradient compressor
(``repro_torch.optim.grad_compress`` against ``repro.optim.grad_compress``).

* ``CompressionConfig.ranks_for`` and ``compressed_bytes`` equal the
  reference's on a grid of shapes and configs.
* ``compress_psum`` with no process group against the reference's
  ``axis_name=None`` on the same gradients: a refresh step, then a plain
  step on the factors it made, on a tree of plain leaves and on the SMOKE
  model's parameter tree (per-layer leaves as lists, reckoned on their
  stacks).  The gradients are low rank plus 1% noise, so the top subspaces
  are well separated and the factors are compared by projector; the
  reduced gradients and the error feedback within 1e-5 of max|g| (fp32
  Grams, eigh and TTMs in two orders of summation).
* Two gloo ranks (``torch_parity.run_ranks``): the factors are bitwise
  equal on both, and the reduced gradient is the mean of the ranks'
  feedback-corrected gradients projected on them, within 1e-5.
* Compressed SMOKE training tracks dense training within 0.25 in loss
  after 10 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as R_configs
from repro.models import lm as R_lm
from repro.optim import grad_compress as R_gc
from repro_torch import configs
from repro_torch.models.convert import (leaves, map_leaves, param_tree,
                                        params_from_jax)
from repro_torch.optim import grad_compress as gc
from test_torch_train import trainer
from torch_parity import max_projector_gap, run_ranks, to_np

TOL = 1e-5
SMOKE = configs.get_smoke("falcon-mamba-7b")
R_SMOKE = R_configs.get_smoke("falcon-mamba-7b")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPES = [(16, 4096, 16384), (16, 8192, 4096), (16, 4, 8192), (16, 8192, 16),
          (2, 64, 256), (64, 64), (3, 5, 7), (8, 1, 1, 9000), (1, 300, 300),
          (4, 2, 2, 2, 2048)]
CONFIGS = [{}, {"rank_fraction": 0.5, "max_rank": 8}, {"min_size": 10},
           {"skip_first_mode": False, "refresh_every": 5}, {"enabled": False},
           {"min_ndim": 2, "min_size": 1}]


@pytest.mark.parametrize("kw", CONFIGS)
@pytest.mark.parametrize("shape", SHAPES)
def test_ranks_and_bytes(shape, kw):
    ours, theirs = gc.CompressionConfig(**kw), R_gc.CompressionConfig(**kw)
    assert ours.ranks_for(shape) == theirs.ranks_for(shape)
    assert gc.compressed_bytes(ours, shape) == R_gc.compressed_bytes(theirs, shape)


def lowrank_grad(r, shape, ranks, noise=0.01):
    core = r.standard_normal(ranks)
    g = core
    for mode, (d, k) in enumerate(zip(shape, ranks)):
        u = np.linalg.qr(r.standard_normal((d, k)))[0]
        g = np.moveaxis(np.tensordot(u, g, axes=(1, mode)), 0, mode)
    g = g / np.abs(g).max()
    return (g + noise * r.standard_normal(shape)).astype(np.float32)


def tree_grads(seed, cfg, shapes: dict) -> dict:
    r = np.random.default_rng(seed)
    out = {}
    for k, shape in shapes.items():
        ranks = cfg.ranks_for(shape) or shape
        out[k] = lowrank_grad(r, shape, ranks)
    return out


PLAIN = {"a": (4, 64, 48), "b": (3, 40, 40, 8), "c": (10, 10), "d": (2, 8, 8)}
CFG = dict(rank_fraction=0.25, max_rank=64, min_size=1000)


def ref_steps(cfg, grads_seq):
    st = R_gc.init_state(cfg, grads_seq[0])
    out = []
    for i, g in enumerate(grads_seq):
        red, st, stats = R_gc.compress_psum(
            cfg, jax.tree.map(jnp.asarray, g), st, refresh=(i == 0),
            axis_name=None)
        out.append((red, st, stats))
    return out


def check_against_reference(ours, theirs, factors=True):
    """ours: (reduced tree, state, stats) with stacked numpy leaves; the
    factors are compared by projector when ``factors``."""
    (red, st, stats), (rred, rst, rstats) = ours, theirs
    states = dict(state_leaves(rst))
    for path, want in leaves(rred):
        want = np.asarray(want)
        rs = states[path]
        # the scale of g_fb = g_hat + error
        scale = max(np.abs(want).max(),
                    0.0 if rs is None else np.abs(np.asarray(rs["error"])).max())
        assert np.abs(red[path] - want).max() <= TOL * scale, path
        s = st[path]
        if rs is None:
            assert s is None, path
            continue
        if factors:
            assert max_projector_gap(
                [u for u in s["factors"] if u is not None],
                [u for u in rs["factors"] if u is not None]) <= 1e-4, path
        err, rerr = to_np(s["error"]), np.asarray(rs["error"])
        assert np.abs(err - rerr).max() <= TOL * scale, path
    assert stats == rstats


def state_leaves(tree, prefix=()):
    """(path, leaf state) of a compressor state, either package's (the
    reference's EMPTY as None)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict) and "error" not in v:
            out += state_leaves(v, prefix + (k,))
        else:
            out.append((prefix + (k,), None if isinstance(v, R_gc._Empty) else v))
    return out


def nest(flat: dict) -> dict:
    """A nested dict from {path: leaf}."""
    out = {}
    for path, v in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


class TestAgainstReference:
    def test_plain_leaves(self):
        cfg_r, cfg = R_gc.CompressionConfig(**CFG), gc.CompressionConfig(**CFG)
        seq = [tree_grads(s, cfg, PLAIN) for s in (0, 1)]
        theirs = ref_steps(cfg_r, seq)
        st = gc.init_state(cfg, {k: torch.from_numpy(v) for k, v in seq[0].items()})
        for i, g in enumerate(seq):
            red, st, stats = gc.compress_psum(
                cfg, {k: torch.from_numpy(v.copy()) for k, v in g.items()}, st,
                refresh=(i == 0))
            flat = {(k,): to_np(v) for k, v in red.items()}
            sflat = {(k,): v for k, v in st.items()}
            check_against_reference((flat, sflat, stats), theirs[i])

    def test_layered_tree_of_the_smoke_model(self):
        cfg_r = R_gc.CompressionConfig(min_size=1024)
        cfg = gc.CompressionConfig(min_size=1024)
        rp = jax.tree.map(np.asarray,
                          R_lm.init_params(jax.random.PRNGKey(0), R_SMOKE))
        tree = param_tree(params_from_jax(rp, SMOKE, device="cpu"))
        shapes = {path: np.asarray(v).shape for path, v in leaves(rp)}
        seq = [nest(tree_grads(seed, cfg, shapes)) for seed in (2, 3, 4)]

        def ours(g):
            return map_leaves(lambda leaf, a: list(torch.from_numpy(a.copy()).unbind(0))
                              if isinstance(leaf, list) else torch.from_numpy(a.copy()),
                              tree, g)
        # refresh on the port; the SMOKE leaves' small modes leave some top
        # subspaces undetermined (a rank above the other modes' product),
        # so both packages then run plain steps on the port's factors
        st = gc.init_state(cfg, tree)
        _, st, _ = gc.compress_psum(cfg, ours(seq[0]), st, refresh=True)
        rst = R_gc.init_state(cfg_r, seq[0])
        n = 0
        for path, s in state_leaves(st):
            rs = dict(state_leaves(rst))[path]
            assert (s is None) == (rs is None), path
            if s is not None:
                rs["factors"] = [None if u is None else jnp.asarray(u.numpy())
                                 for u in s["factors"]]
                rs["error"] = jnp.asarray(s["error"].numpy())
                n += 1
        assert n > 0
        for g in seq[1:]:
            theirs = R_gc.compress_psum(cfg_r, jax.tree.map(jnp.asarray, g),
                                        rst, refresh=False, axis_name=None)
            rst = theirs[1]
            red, st, stats = gc.compress_psum(cfg, ours(g), st, refresh=False)
            flat = {path: (np.stack([to_np(x) for x in v]) if isinstance(v, list)
                           else to_np(v)) for path, v in leaves(red)}
            for path, v in leaves(red):
                if isinstance(v, list):
                    assert len(v) == SMOKE.n_layers
            check_against_reference((flat, dict(state_leaves(st)), stats),
                                    theirs, factors=False)


def test_error_feedback_identity():
    """g_hat + error == g + old error (g_fb) on every compressed leaf."""
    cfg = gc.CompressionConfig(**CFG)
    g = {k: torch.from_numpy(v) for k, v in tree_grads(4, cfg, PLAIN).items()}
    st = gc.init_state(cfg, g)
    st["a"]["error"] += 0.01
    g_fb = g["a"].double() + 0.01
    red, st, _ = gc.compress_psum(cfg, g, st, refresh=True)
    diff = (red["a"].double() + st["a"]["error"].double() - g_fb).abs().max()
    assert float(diff) <= TOL * float(g_fb.abs().max())


RANK_BODY = '''
import torch
from repro_torch.optim import grad_compress as gc
cfg = gc.CompressionConfig(rank_fraction=0.25, min_size=1000)
st = None
for i, g in enumerate(data["grads"][rank]):
    g = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
    if st is None:
        st = gc.init_state(cfg, g)
    old = {k: (None if s is None else s["error"].clone()) for k, s in st.items()}
    red, st, stats = gc.compress_psum(cfg, g, st, refresh=(i == 0),
                                      group=dist.group.WORLD)
    # copies: the next step reuses the error buffers in place
    out[i] = {k: dict(red=red[k].numpy().copy(),
                      g_fb=(g[k] + (0 if old[k] is None else old[k])).numpy(),
                      factors=None if st[k] is None else
                      [None if u is None else u.numpy().copy()
                       for u in st[k]["factors"]],
                      error=None if st[k] is None else st[k]["error"].numpy().copy())
              for k in g}
'''


def test_two_gloo_ranks(tmp_path):
    cfg = gc.CompressionConfig(rank_fraction=0.25, min_size=1000)
    shapes = {"a": (4, 64, 48), "b": (3, 40, 40, 8), "c": (10, 10)}
    grads = [[tree_grads(10 * r + s, cfg, shapes) for s in range(2)]
             for r in range(2)]
    outs = run_ranks(tmp_path, 2, RANK_BODY, grads=grads)
    for step in (0, 1):
        for k in shapes:
            a, b = outs[0][step][k], outs[1][step][k]
            if a["factors"] is None:        # dense: the plain mean
                want = (a["g_fb"] + b["g_fb"]) / 2
                assert np.abs(a["red"] - want).max() <= 1e-6 * np.abs(want).max()
                continue
            for u, v in zip(a["factors"], b["factors"]):
                assert (u is None and v is None) or np.array_equal(u, v)
            np.testing.assert_array_equal(a["red"], b["red"])
            us = a["factors"]
            mean = (a["g_fb"].astype(np.float64) + b["g_fb"]) / 2

            def proj(x):
                for mode, u in enumerate(us):
                    if u is not None:
                        p = u.astype(np.float64) @ u.T.astype(np.float64)
                        x = np.moveaxis(np.tensordot(p, x, axes=(1, mode)), 0, mode)
                return x
            want = proj(mean)
            assert np.abs(a["red"] - want).max() <= TOL * np.abs(want).max(), k
            for o in (a, b):
                e = o["g_fb"] - proj(o["g_fb"].astype(np.float64))
                assert np.abs(o["error"] - e).max() <= \
                    TOL * np.abs(o["g_fb"]).max(), k


def test_compressed_training_tracks_dense(tmp_path):
    dense = trainer(tmp_path / "d", 10, ckpt_every=0).run()
    comp = trainer(tmp_path / "c", 10, compress=True, ckpt_every=0).run()
    assert abs(comp[-1]["loss"] - dense[-1]["loss"]) <= 0.25
    assert comp[-1]["bytes_compressed"] < comp[-1]["bytes_dense"]
