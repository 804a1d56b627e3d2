"""Port parity for the checkpointer (``repro_torch.checkpoint``) and the
serve CLI's ``--ckpt``.

* Round trip (fp32, bf16, int32 leaves, bitwise), ``keep`` garbage
  collection, and a half-written ``.tmp`` directory ignored.
* The Tucker tier: an exactly low-rank ≥ 3-D leaf comes back within 1e-4
  of its max (a Tucker decomposition at its own ranks is exact up to fp32
  rounding), also where a configured rank exceeds what a core can use
  (the core is stored at the configured ranks, as the reference stores
  it); the plans resolve to ``matfree`` on the CPU, and the codec's log
  records the leaf.
* The layout on disk is the reference's: a parameter tree written by
  either package restores in the other, raw leaves bitwise (bf16 stored as
  a uint16 view), Tucker leaves within one bf16 unit (2**-7 of max|.|) of
  the writer's own restore (both round one fp32 reconstruction to bf16).
* ``python -m repro_torch.launch.serve --ckpt`` restores the saved weights
  on the CPU and serves from them.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as R_configs
from repro.checkpoint.checkpointer import Checkpointer as R_Checkpointer
from repro.models import lm as R_lm
from repro.optim.grad_compress import CompressionConfig as R_CompressionConfig
from repro_torch import configs
from repro_torch.checkpoint.checkpointer import (Checkpointer, tree_flatten,
                                                 tree_unflatten)
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build
from repro_torch.models.convert import (leaves, load_tree, params_from_jax,
                                        tree_from_params)
from repro_torch.optim.grad_compress import CompressionConfig
from repro_torch.serve.engine import Request, ServeEngine
from torch_parity import to_np

SMOKE = configs.get_smoke("falcon-mamba-7b")
R_SMOKE = R_configs.get_smoke("falcon-mamba-7b")
#: a codec config under which the SMOKE model's big stacked leaves compress
SMALL = dict(min_size=4096)


def sample_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((3, 4, 5), generator=g),
            "b": torch.randn((7,), generator=g).to(torch.bfloat16),
            "nested": {"count": torch.tensor(5, dtype=torch.int32),
                       "list": [None, torch.randn((2, 2), generator=g)]}}


def assert_same(a, b):
    fa, fb = tree_flatten(a), tree_flatten(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())


class TestCheckpointer:
    def test_round_trip_is_bitwise(self, tmp_path):
        ck = Checkpointer(tmp_path)
        tree = sample_tree()
        ck.save(3, tree, blocking=True)
        out, step = ck.restore(sample_tree(1))
        assert step == 3
        assert_same(out, tree)
        assert out["nested"]["list"][0] is None

    def test_async_save_and_gc(self, tmp_path):
        ck = Checkpointer(tmp_path, keep=2)
        for s in range(1, 5):
            ck.save(s, sample_tree(s))
        ck.wait()
        assert ck.all_steps() == [3, 4]
        assert_same(ck.restore(sample_tree())[0], sample_tree(4))
        assert_same(ck.restore(sample_tree(), step=3)[0], sample_tree(3))

    def test_uncommitted_tmp_is_ignored(self, tmp_path):
        ck = Checkpointer(tmp_path)
        ck.save(2, sample_tree(2), blocking=True)
        bad = tmp_path / "step_000000009.tmp"
        bad.mkdir()
        (bad / "meta.json").write_text("{not json")
        (tmp_path / "step_000000010").mkdir()      # no meta.json: not committed
        assert ck.latest_step() == 2
        assert_same(ck.restore(sample_tree())[0], sample_tree(2))

    def test_empty_directory_restores_nothing(self, tmp_path):
        assert Checkpointer(tmp_path).restore(sample_tree()) is None

    def test_leaf_count_mismatch_raises(self, tmp_path):
        ck = Checkpointer(tmp_path)
        ck.save(1, sample_tree(), blocking=True)
        with pytest.raises(ValueError, match="leaves"):
            ck.restore({"only": torch.zeros(1)})

    def test_unflatten_keeps_named_tuples(self):
        from repro_torch.optim.adamw import AdamWState
        st = AdamWState(torch.tensor(1), {"a": torch.zeros(2)}, {"a": torch.ones(2)})
        out = tree_unflatten(st, [torch.tensor(2), torch.ones(2), torch.zeros(2)])
        assert isinstance(out, AdamWState) and int(out.count) == 2


def lowrank(shape, ranks, seed=0):
    r = np.random.default_rng(seed)
    x = r.standard_normal(ranks)
    for mode, (d, k) in enumerate(zip(shape, ranks)):
        u = r.standard_normal((d, k))
        x = np.moveaxis(np.tensordot(u, x, axes=(1, mode)), 0, mode)
    return torch.from_numpy(x.astype(np.float32))


class TestTuckerTier:
    def test_exactly_low_rank_leaf_is_lossless(self, tmp_path):
        cfg = CompressionConfig(min_size=1000)
        shape = (4, 32, 24)
        ranks = cfg.ranks_for(shape)
        x = lowrank(shape, ranks)
        ck = Checkpointer(tmp_path)
        ck.save(1, {"w": x, "small": torch.ones(3)}, compress_cfg=cfg,
                blocking=True)
        assert (tmp_path / "step_000000001" / "tucker_1.npz").exists()
        assert (tmp_path / "step_000000001" / "arr_0.npy").exists()
        out, _ = ck.restore({"w": x, "small": torch.ones(3)})
        err = float((out["w"] - x).abs().max())
        assert err <= 1e-4 * float(x.abs().max())
        (rec,) = ck.tucker_log
        assert rec["shape"] == list(shape) and rec["ranks"] == list(ranks)
        assert rec["backend"] == "matfree" and rec["rel_error"] <= 1e-4
        assert rec["bytes_tucker"] < rec["bytes_raw"]

    @pytest.mark.parametrize("shape,inner,method", [
        ((4, 3, 256), (4, 1, 4), "als"), ((4, 3, 256), (4, 1, 4), "eig"),
        ((3, 8, 100), (3, 2, 6), "als"), ((3, 8, 100), (3, 2, 6), "eig")])
    def test_improper_ranks_are_cut_losslessly(self, tmp_path, shape, inner,
                                               method):
        """(4, 3, 256) asks (4, 1, 64) and (3, 8, 100) asks (3, 2, 25): the
        last mode holds only as many directions as the other ranks' product,
        4 and 6, so the surplus core slices are cut to zero.  An exactly
        ``inner``-rank leaf comes back through the codec and through either
        solver pinned on the last mode, its core at the configured ranks
        and its factor orthonormal."""
        from repro_torch.core.sthosvd import sthosvd
        cfg = CompressionConfig(min_size=500)
        ranks = cfg.ranks_for(shape)
        assert ranks[-1] > math.prod(ranks[:-1]) == inner[-1]
        x = lowrank(shape, inner, seed=2)
        ck = Checkpointer(tmp_path)
        ck.save(1, [x], compress_cfg=cfg, blocking=True)
        (out,), _ = ck.restore([x])
        assert float((out - x).abs().max()) <= 1e-4 * float(x.abs().max())
        (rec,) = ck.tucker_log
        assert rec["ranks"] == list(ranks)
        res = sthosvd(x, ranks, methods=("eig",) * (len(shape) - 1) + (method,),
                      impl="matfree", device="cpu")
        tt = res.tucker
        assert tuple(tt.core.shape) == ranks
        assert float(tt.rel_error(x)) <= 1e-5
        u = tt.factors[-1]
        eye = torch.eye(u.shape[1])
        assert float((u.T @ u - eye).abs().max()) <= 1e-5

    def test_bf16_leaf_comes_back_in_bf16(self, tmp_path):
        cfg = CompressionConfig(min_size=1000)
        x = lowrank((4, 32, 24), cfg.ranks_for((4, 32, 24))).to(torch.bfloat16)
        ck = Checkpointer(tmp_path)
        ck.save(1, [x], compress_cfg=cfg, blocking=True)
        (out,), _ = ck.restore([x])
        assert out.dtype == torch.bfloat16
        assert float((out.float() - x.float()).abs().max()) <= \
            2 ** -7 * float(x.float().abs().max())


@pytest.fixture(scope="module")
def ref_bf16():
    """The reference's SMOKE parameters in bf16 (numpy leaves)."""
    cfg = R_SMOKE.with_(dtype="bfloat16")
    return jax.tree.map(np.asarray, R_lm.init_params(jax.random.PRNGKey(0), cfg))


class TestAcrossPackages:
    def test_port_restores_the_reference(self, tmp_path, ref_bf16):
        R_Checkpointer(tmp_path).save(7, ref_bf16, blocking=True)
        like = tree_from_params(params_from_jax(ref_bf16, SMOKE.with_(
            dtype="bfloat16"), device="cpu"))
        out, step = Checkpointer(tmp_path).restore(like)
        assert step == 7
        for (path, a), (_, b) in zip(leaves(out), leaves(ref_bf16)):
            assert str(a.dtype).endswith(str(b.dtype)), path
            np.testing.assert_array_equal(to_np(a), np.asarray(b, np.float64))

    def test_reference_restores_the_port(self, tmp_path, ref_bf16):
        params = params_from_jax(ref_bf16, SMOKE.with_(dtype="bfloat16"),
                                 device="cpu")
        Checkpointer(tmp_path).save(5, tree_from_params(params), blocking=True)
        out, step = R_Checkpointer(tmp_path).restore(
            jax.tree.map(jnp.asarray, ref_bf16))
        assert int(step) == 5
        for (path, a), (_, b) in zip(leaves(out), leaves(ref_bf16)):
            assert a.dtype == b.dtype, path
            np.testing.assert_array_equal(np.asarray(a), b)

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_tucker_tier_across_packages(self, tmp_path, ref_bf16, writer):
        cfg_kw = SMALL
        params = params_from_jax(ref_bf16, SMOKE.with_(dtype="bfloat16"),
                                 device="cpu")
        like = tree_from_params(params)
        if writer == "port":
            ck = Checkpointer(tmp_path)
            ck.save(1, like, compress_cfg=CompressionConfig(**cfg_kw),
                    blocking=True)
            assert ck.tucker_log
            own, _ = ck.restore(like)
            out, _ = R_Checkpointer(tmp_path).restore(
                jax.tree.map(jnp.asarray, ref_bf16))
        else:
            R_Checkpointer(tmp_path).save(1, ref_bf16, blocking=True,
                                          compress_cfg=R_CompressionConfig(**cfg_kw))
            own, _ = R_Checkpointer(tmp_path).restore(
                jax.tree.map(jnp.asarray, ref_bf16))
            out, _ = Checkpointer(tmp_path).restore(like)
        files = sorted(p.name for p in (tmp_path / "step_000000001").iterdir())
        assert any(f.startswith("tucker_") for f in files)
        for (path, a), (_, b) in zip(leaves(out), leaves(own)):
            a, b = to_np(a), to_np(b)
            assert np.abs(a - b).max() <= 2 ** -7 * max(np.abs(b).max(), 1e-30), path


def test_serve_cli_restores_a_checkpoint(tmp_path, capsys):
    bundle = build(SMOKE)
    params = bundle.init(7, "cpu")
    Checkpointer(tmp_path).save(11, tree_from_params(params), blocking=True)
    outs = serve_cli.main(["--arch", "falcon-mamba-7b", "--smoke",
                           "--requests", "2", "--max-new", "4",
                           "--device", "cpu", "--ckpt", str(tmp_path)])
    assert "restored params at step 11" in capsys.readouterr().out
    # the same requests on the saved weights, loaded by hand
    fresh = load_tree(bundle.init(0, "cpu"), tree_from_params(params))
    eng = ServeEngine(bundle, fresh, batch_slots=4, max_len=256)
    want = eng.run([Request(prompt=[1 + i, 2, 3, 4 + i], max_new_tokens=4,
                            rid=i) for i in range(2)])
    assert [r.output for r in outs] == [r.output for r in want]
