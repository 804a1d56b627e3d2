"""Port parity for the training path at falcon-mamba SMOKE size: the loss
and its gradients, AdamW and its schedule, microbatching, the trainer's
resume and the training CLI.

The SMOKE model (2 layers, d_model 64, d_inner 128, N = 16, fp32) gets the
reference's weights through ``params_from_jax``, so both packages compute
with the same parameters on the same numpy tokens.  Tolerances: the loss
within 1e-5 and every parameter's gradient within 1e-4 of its max|.| of
``jax.value_and_grad`` of the reference's ``lm_loss`` (the two differ in
the order of fp32 sums: the reference scans in chunks of 16, the port by
the step recurrence and its reverse); AdamW within 1e-6 of the reference's
update on the stacked tree after two steps (fp32 element-wise arithmetic
in the same order); microbatching 1 vs 4 within 1e-4 of each gradient's
max; a resumed run bitwise equal to an uninterrupted one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as R_configs
from repro.models import lm as R_lm
from repro.optim import adamw as R_adamw
from repro_torch import configs
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.models import build, lm
from repro_torch.models.convert import (leaves, map_leaves, param_tree,
                                        params_from_jax, tree_from_params)
from repro_torch.optim import adamw
from repro_torch.optim.grad_compress import CompressionConfig
from repro_torch.train.train_step import (_accumulate_grads, init_state,
                                          make_compressed_train_step,
                                          make_train_step)
from repro_torch.train.trainer import Trainer, TrainerConfig, state_tree
from repro_torch.checkpoint.checkpointer import tree_flatten
from torch_parity import to_np

SMOKE = configs.get_smoke("falcon-mamba-7b")
R_SMOKE = R_configs.get_smoke("falcon-mamba-7b")


@pytest.fixture(scope="module")
def ref_params():
    return jax.tree.map(np.asarray,
                        R_lm.init_params(jax.random.PRNGKey(0), R_SMOKE))


def port_model(ref_params):
    p = params_from_jax(ref_params, SMOKE, device="cpu")
    return p.requires_grad_(True)


def tokens(b, t, seed=0):
    return np.random.default_rng(seed).integers(0, SMOKE.vocab, (b, t))


def grads_of(params) -> dict:
    """The parameters' gradients in the reference's stacked layout."""
    return {path: (np.stack([to_np(p.grad) for p in leaf])
                   if isinstance(leaf, list) else to_np(leaf.grad))
            for path, leaf in leaves(param_tree(params))}


class TestLoss:
    @pytest.fixture(scope="class")
    def both(self, ref_params):
        toks = tokens(2, 33)
        (loss, met), g = jax.value_and_grad(
            lambda p: R_lm.lm_loss(p, R_SMOKE, {"tokens": jnp.asarray(toks)}),
            has_aux=True)(ref_params)
        params = port_model(ref_params)
        ploss, pmet = lm.lm_loss(params, SMOKE, {"tokens": torch.from_numpy(toks)})
        ploss.backward()
        return (float(loss), jax.tree.map(float, met), dict(leaves(g)),
                float(ploss.detach()), {k: float(v) for k, v in pmet.items()},
                grads_of(params))

    def test_loss_and_metrics(self, both):
        loss, met, _, ploss, pmet, _ = both
        assert abs(ploss - loss) <= 1e-5
        assert abs(pmet["nll"] - met["nll"]) <= 1e-5
        assert pmet["aux"] == met["aux"] == 0.0

    @pytest.mark.parametrize("path", [
        ("embed",), ("final_norm", "scale"), ("layers", "norm_ssm", "scale"),
        *[("layers", "ssm", k) for k in ("a_log", "conv_b", "conv_w",
                                         "d_skip", "dt_bias", "dt_proj",
                                         "in_proj", "out_proj", "x_proj")],
        ("lm_head",)])
    def test_every_parameter_gradient(self, both, path):
        _, _, g, _, _, pg = both
        want = np.asarray(g[path])
        assert pg[path].shape == want.shape
        assert np.abs(pg[path] - want).max() <= 1e-4 * np.abs(want).max()

    def test_remat_matches_the_plain_stack(self, ref_params):
        toks = {"tokens": torch.from_numpy(tokens(2, 17, seed=3))}
        out = []
        for remat in (True, False):
            p = port_model(ref_params)
            loss, _ = lm.lm_loss(p, SMOKE.with_(remat=remat), toks)
            loss.backward()
            out.append((float(loss.detach()), grads_of(p)))
        assert out[0][0] == out[1][0]
        for k in out[0][1]:
            np.testing.assert_array_equal(out[0][1][k], out[1][1][k])

    def test_bundle_loss_is_lm_loss(self, ref_params):
        toks = {"tokens": torch.from_numpy(tokens(1, 9))}
        p = port_model(ref_params)
        with torch.no_grad():
            a = build(SMOKE).loss(p, toks)[0]
            b = lm.lm_loss(p, SMOKE, toks)[0]
        assert float(a) == float(b)


class TestAdamW:
    """The port's AdamW on the layered tree against the reference's on the
    stacked tree: two steps from the same weights and gradients."""

    @staticmethod
    def run_both(ref_params, opt_kw, steps=2):
        r = np.random.default_rng(1)
        grads = [jax.tree.map(lambda p: r.standard_normal(p.shape).astype(
            np.float32), ref_params) for _ in range(steps)]
        lr = R_adamw.cosine_schedule(1e-2, 1, 10)
        ropt = R_adamw.AdamW(lr=lr, **opt_kw)
        rp, rs = jax.tree.map(jnp.asarray, ref_params), None
        rs = ropt.init(rp)
        for g in grads:
            rp, rs, rm = ropt.update(jax.tree.map(jnp.asarray, g), rs, rp)
        popt = adamw.AdamW(lr=adamw.cosine_schedule(1e-2, 1, 10), **opt_kw)
        params = params_from_jax(ref_params, SMOKE, device="cpu")
        tree = param_tree(params)
        ps = popt.init(tree)
        for g in grads:
            gt = map_leaves(lambda leaf, a: list(torch.from_numpy(a).unbind(0))
                            if isinstance(leaf, list) else torch.from_numpy(a),
                            tree, g)
            _, ps, pm = popt.update(gt, ps, tree)
        return (dict(leaves(rp)), rs, rm, dict(leaves(tree_from_params(params))),
                ps, pm)

    @pytest.mark.parametrize("opt_kw", [{}, {"weight_decay": 0.5},
                                        {"clip_norm": None},
                                        {"clip_norm": 1e3, "weight_decay": 0.0}])
    def test_matches_the_reference_update(self, ref_params, opt_kw):
        rp, rs, rm, pp, ps, pm = self.run_both(ref_params, opt_kw)
        for path in rp:
            want = np.asarray(rp[path])
            assert np.abs(to_np(pp[path]) - want).max() <= \
                1e-6 * max(np.abs(want).max(), 1.0), path
        for ours, theirs in ((ps.m, rs.m), (ps.v, rs.v)):
            for (path, a), (_, b) in zip(leaves(ours), leaves(theirs)):
                b = np.asarray(b)
                assert np.abs(to_np(a) - b).max() <= 1e-6 * np.abs(b).max(), path
        assert int(ps.count) == int(rs.count) == 2
        assert abs(float(pm["grad_norm"]) - float(rm["grad_norm"])) <= \
            1e-5 * float(rm["grad_norm"])
        assert abs(float(pm["lr"]) - float(rm["lr"])) <= 1e-9

    def test_decay_rule_is_the_stacked_layout(self, ref_params):
        """Every per-layer leaf decays (stacking makes the norm scales and
        dt_bias 2-D); of the top-level leaves final_norm does not."""
        params = params_from_jax(ref_params, SMOKE, device="cpu")
        ours = {path: adamw.decays(leaf)
                for path, leaf in leaves(param_tree(params))}
        theirs = {path: np.asarray(v).ndim >= 2
                  for path, v in leaves(ref_params)}
        assert ours == theirs
        assert ours[("layers", "ssm", "dt_bias")] and \
            ours[("layers", "norm_ssm", "scale")]
        assert not ours[("final_norm", "scale")]

    @pytest.mark.parametrize("count", [0, 1, 5, 10, 37, 100, 150])
    def test_cosine_schedule(self, count):
        want = float(R_adamw.cosine_schedule(3e-4, 10, 100)(jnp.int32(count)))
        got = float(adamw.cosine_schedule(3e-4, 10, 100)(torch.tensor(count)))
        assert abs(got - want) <= 1e-12 + 1e-6 * want


class TestSteps:
    def test_microbatch_1_vs_4(self, ref_params):
        batch = {"tokens": torch.from_numpy(tokens(4, 17, seed=5))}
        out = []
        for n_micro in (1, 4):
            p = port_model(ref_params)
            g, m = _accumulate_grads(build(SMOKE).loss, p, batch, n_micro)
            out.append((g, m))
        (g1, m1), (g4, m4) = out
        assert abs(float(m1["loss"]) - float(m4["loss"])) <= 1e-5
        for (path, a), (_, b) in zip(leaves(g1), leaves(g4)):
            a = np.stack([to_np(x) for x in a]) if isinstance(a, list) else to_np(a)
            b = np.stack([to_np(x) for x in b]) if isinstance(b, list) else to_np(b)
            assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max(), path

    def test_token_file_windows_are_the_reference_s(self, tmp_path):
        from repro.data.pipeline import DataConfig as R_DataConfig
        from repro.data.pipeline import TokenFileSource as R_TokenFileSource
        from repro_torch.data.pipeline import TokenFileSource
        path = tmp_path / "tokens.bin"
        np.random.default_rng(0).integers(0, 1000, 5000, dtype=np.int32) \
            .tofile(path)
        ours = TokenFileSource(DataConfig(seed=4, source="file", path=str(path)),
                               SMOKE, 32, 3, device="cpu")
        theirs = R_TokenFileSource(R_DataConfig(seed=4, source="file",
                                                path=str(path)), R_SMOKE, 32, 3)
        for step in (0, 1, 17):
            np.testing.assert_array_equal(
                ours.batch_at(step)["tokens"].numpy(),
                np.asarray(theirs.batch_at(step)["tokens"]))

    def test_synthetic_batches_are_step_pure(self):
        src = SyntheticLM(DataConfig(seed=3), SMOKE, 16, 4, device="cpu")
        a, b = src.batch_at(7)["tokens"], src.batch_at(7)["tokens"]
        assert torch.equal(a, b) and a.shape == (4, 17)
        assert not torch.equal(a, src.batch_at(8)["tokens"])
        assert int(a.min()) >= 0 and int(a.max()) < SMOKE.vocab


def trainer(tmp_path, total, *, compress=False, lr=1e-2, log_every=1,
            ckpt_every=3):
    bundle = build(SMOKE)
    opt = adamw.AdamW(lr=adamw.cosine_schedule(lr, 2, 20))
    comp = CompressionConfig(min_size=1024, refresh_every=4) if compress else None
    state = init_state(bundle, opt, 0, compression=comp, device="cpu")
    step = (make_compressed_train_step(bundle, opt, comp) if compress
            else make_train_step(bundle, opt))
    src = SyntheticLM(DataConfig(seed=0), SMOKE, 32, 4, device="cpu")
    tc = TrainerConfig(total_steps=total, ckpt_every=ckpt_every,
                       log_every=log_every, ckpt_dir=str(tmp_path),
                       refresh_every=4)
    return Trainer(tc, step, state, src)


class TestTrainer:
    def test_loss_decreases_over_20_steps(self, tmp_path):
        hist = trainer(tmp_path, 20).run()
        losses = [h["loss"] for h in hist]
        assert len(losses) == 20 and all(np.isfinite(losses))
        assert np.mean(losses[-3:]) < np.mean(losses[:3]) - 0.1

    @pytest.mark.parametrize("compress", [False, True])
    def test_resume_is_bitwise(self, tmp_path, compress):
        whole = trainer(tmp_path / "whole", 8, compress=compress)
        whole.run()
        first = trainer(tmp_path / "split", 6, compress=compress)
        first.run()
        second = trainer(tmp_path / "split", 8, compress=compress)
        assert second.restore_if_available() == 6
        second.run()
        a = tree_flatten(state_tree(whole.state, "cpu"))
        b = tree_flatten(state_tree(second.state, "cpu"))
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert torch.equal(x.cpu(), y.cpu())
        assert whole.state.step == second.state.step == 8

    def test_cli_runs_to_the_end(self, tmp_path, capsys):
        hist = train_cli.main(["--arch", "falcon_mamba_7b", "--smoke",
                               "--steps", "4", "--compress", "--device", "cpu",
                               "--ckpt-dir", str(tmp_path)])
        assert hist and np.isfinite(hist[-1]["loss"])
        assert "done: loss" in capsys.readouterr().out
        assert (tmp_path / "step_000000004" / "meta.json").exists()
