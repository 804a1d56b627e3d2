"""Port parity for the vlm family: the vision prefix (``vis_proj`` over
the patches, placed before the text), positions over both, prefill with
patches then decode, the text-only loss, the serve engine (text only, as
the reference's) and the checkpoint across packages.

The vlm branch of ``repro_torch/models/lm.py`` is held against
``repro.models`` at internvl2-2b's SMOKE preset (2 layers, d_model 64, 16
patches), fp32, with the reference's parameters passed through
``params_from_jax`` and the same numpy tokens and patches for both.

Tolerances (fp32; the two sum in different orders): logits, hidden states
and embeddings max |Δ| <= 1e-4 × max |reference|; the KV cache 1e-5 ×
max |reference|; the loss 1e-5 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as R_configs
from repro.checkpoint.checkpointer import Checkpointer as R_Checkpointer
from repro.models import lm as R_lm
from repro.models import registry as R_registry
from repro.serve.engine import Request as R_Request
from repro.serve.engine import ServeEngine as R_ServeEngine
from repro_torch import configs
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build, lm
from repro_torch.models.convert import (leaves, load_tree, params_from_jax,
                                        tree_from_params)
from repro_torch.serve.engine import Request, ServeEngine
from torch_parity import to_np

ARCH = "internvl2-2b"
LOGIT_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg, rcfg = configs.get_smoke(ARCH), R_configs.get_smoke(ARCH)
    rp = jax.tree.map(np.asarray,
                      R_lm.init_params(jax.random.PRNGKey(0), rcfg))
    return cfg, rcfg, rp, params_from_jax(rp, cfg, device="cpu")


def tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, t))


def patches(cfg, b, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.n_patches, cfg.d_model)).astype(np.float32)


def scaled_close(got, want, tol=LOGIT_TOL):
    got, want = to_np(got), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale, \
        (np.abs(got - want).max(), scale)


class TestConfigs:
    @pytest.mark.parametrize("get", ["get", "get_smoke"])
    def test_configs_match_reference(self, get):
        mine = getattr(configs, get)(ARCH)
        assert dataclasses.asdict(mine) == \
            dataclasses.asdict(getattr(R_configs, get)(ARCH))
        assert configs.canonical(ARCH) in configs.PORTED


class TestModel:
    def test_init_shapes_match_reference(self, model):
        cfg, _, rp, _ = model
        mine = lm.init_params(torch.Generator().manual_seed(0), cfg)
        got = {p: tuple(v.shape) for p, v in leaves(tree_from_params(mine))}
        assert got == {p: v.shape for p, v in leaves(rp)}
        assert tuple(mine.vis_proj.shape) == (cfg.d_model, cfg.d_model)

    def test_params_from_jax_keeps_vis_proj(self, model):
        cfg, _, rp, pp = model
        for path, v in leaves(tree_from_params(pp)):
            np.testing.assert_array_equal(to_np(v), dict(leaves(rp))[path])
        bad = {k: v for k, v in rp.items() if k != "vis_proj"}
        with pytest.raises(ValueError, match="vis_proj"):
            params_from_jax(bad, cfg, device="cpu")

    @pytest.mark.parametrize("with_patches", [True, False])
    def test_embed_tokens(self, model, with_patches):
        """Patches ``@ vis_proj`` before the text; text alone without."""
        cfg, rcfg, rp, pp = model
        tok = tokens(cfg, 2, 7)
        pat = patches(cfg, 2) if with_patches else None
        want = R_lm.embed_tokens(rp, rcfg, jnp.asarray(tok),
                                 None if pat is None else jnp.asarray(pat))
        got = lm.embed_tokens(pp, cfg, torch.from_numpy(tok),
                              None if pat is None else torch.from_numpy(pat))
        n = cfg.n_patches if with_patches else 0
        assert got.shape == (2, n + 7, cfg.d_model)
        scaled_close(got, want)
        if with_patches:
            scaled_close(got[:, :n], pat @ to_np(pp.vis_proj))

    def test_forward_hidden_with_patches(self, model):
        cfg, rcfg, rp, pp = model
        tok, pat = tokens(cfg, 2, 13), patches(cfg, 2)
        rh, _, _ = R_lm.forward_hidden(rp, rcfg, jnp.asarray(tok),
                                       patches=jnp.asarray(pat))
        with torch.no_grad():
            h, _, _ = lm.forward_hidden(pp, cfg, torch.from_numpy(tok),
                                        patches=torch.from_numpy(pat))
        assert h.shape[1] == cfg.n_patches + 13
        scaled_close(h, rh)

    def test_lm_loss_on_text_positions_only(self, model):
        """The loss with patches against the reference's; it is the loss
        of the text positions' logits (the patches' positions dropped)."""
        cfg, rcfg, rp, pp = model
        tok, pat = tokens(cfg, 2, 17, seed=3), patches(cfg, 2, seed=4)
        want, wm = R_lm.lm_loss(rp, rcfg, {"tokens": jnp.asarray(tok),
                                           "patches": jnp.asarray(pat)})
        with torch.no_grad():
            got, m = build(cfg).loss(pp, {"tokens": torch.from_numpy(tok),
                                          "patches": torch.from_numpy(pat)})
            h, _, _ = lm.forward_hidden(pp, cfg, torch.from_numpy(tok[:, :-1]),
                                        patches=torch.from_numpy(pat))
            logits = lm.logits_from_hidden(pp, cfg, h[:, cfg.n_patches:])
            nll = torch.logsumexp(logits, -1) - logits.gather(
                -1, torch.from_numpy(tok[:, 1:, None]))[..., 0]
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
        assert abs(float(m["nll"]) - float(nll.mean())) <= \
            1e-6 * abs(float(nll.mean()))
        assert float(m["aux"]) == 0.0

    def test_lm_loss_gradient_reaches_vis_proj(self, model):
        cfg, _, _, _ = model
        pp = lm.init_params(torch.Generator().manual_seed(1), cfg)
        for p in pp.parameters():
            p.requires_grad_(True)
        loss, _ = lm.lm_loss(pp, cfg, {
            "tokens": torch.from_numpy(tokens(cfg, 1, 9)),
            "patches": torch.from_numpy(patches(cfg, 1))})
        loss.backward()
        assert pp.vis_proj.grad is not None and pp.vis_proj.grad.abs().sum() > 0
        assert all(torch.isfinite(p.grad).all() for p in pp.parameters())

    def test_prefill_with_patches_then_decode(self, model):
        """The registry's prefill with patches (16 + 11 positions), then 8
        decode steps at per-row positions n_patches + len(prompt) + i
        (row 1 one step behind): logits against the reference's and the
        port's no-cache forward; the KV caches against the reference's."""
        cfg, rcfg, rp, pp = model
        b, rb = build(cfg), R_registry.build(rcfg)
        n, t0 = cfg.n_patches, 11
        total = n + 24
        tok, pat = tokens(cfg, 2, 20, seed=5), patches(cfg, 2, seed=6)
        rcache = rb.init_cache(2, total)
        pcache = b.init_cache(2, total, device="cpu")
        rl, rcache = rb.prefill(rp, {"tokens": jnp.asarray(tok[:, :t0]),
                                     "patches": jnp.asarray(pat)}, rcache)
        with torch.no_grad():
            pl, pcache = b.prefill(pp, {"tokens": torch.from_numpy(
                tok[:, :t0]), "patches": torch.from_numpy(pat)}, pcache)
            full = lm.logits_from_hidden(pp, cfg, lm.forward_hidden(
                pp, cfg, torch.from_numpy(tok),
                patches=torch.from_numpy(pat))[0])
        scaled_close(pl, rl)
        scaled_close(pl[:, 0], full[:, n + t0 - 1])
        for s in range(t0, 19):
            pos = np.array([n + s, n + s])
            rl, rcache = rb.decode(rp, jnp.asarray(tok[:, s:s + 1]), rcache,
                                   jnp.asarray(pos, jnp.int32), total)
            with torch.no_grad():
                pl, pcache = b.decode(pp, torch.from_numpy(tok[:, s:s + 1]),
                                      pcache, torch.from_numpy(pos), total)
            scaled_close(pl, rl)
            scaled_close(pl[:, 0], full[:, n + s])
        scaled_close(pcache["k"], rcache["k"], 1e-5)
        scaled_close(pcache["v"], rcache["v"], 1e-5)


class TestServe:
    def test_text_requests_match_reference_engine(self, model):
        """The engine admits text only, as the reference's: greedy tokens
        of 3 requests on 2 slots equal the reference engine's."""
        cfg, rcfg, rp, pp = model
        prompts = [list(tokens(cfg, 1, k, seed=k)[0]) for k in (3, 12, 6)]
        ref = R_ServeEngine(R_registry.build(rcfg), rp, batch_slots=2,
                            max_len=32).run(
            [R_Request(prompt=p, max_new_tokens=6, rid=i)
             for i, p in enumerate(prompts)])
        got = ServeEngine(build(cfg), pp, batch_slots=2, max_len=32).run(
            [Request(prompt=p, max_new_tokens=6, rid=i)
             for i, p in enumerate(prompts)])
        assert [r.output for r in got] == [r.output for r in ref]

    def test_launcher_on_cpu(self, capsys):
        outs = serve_cli.main(["--arch", ARCH, "--smoke", "--requests", "3",
                               "--max-new", "4", "--max-len", "32",
                               "--device", "cpu"])
        assert len(outs) == 3 and all(len(r.output) == 4 for r in outs)
        assert "tokens in" in capsys.readouterr().out


class TestCheckpoint:
    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_restored_across_packages_equal_logits(self, model, tmp_path,
                                                   writer):
        cfg, rcfg, rp, pp = model
        if writer == "port":
            Checkpointer(tmp_path).save(3, tree_from_params(pp),
                                        blocking=True)
            out, step = R_Checkpointer(tmp_path).restore(
                jax.tree.map(jnp.asarray, rp))
            restored = params_from_jax(jax.tree.map(np.asarray, out), cfg,
                                       device="cpu")
        else:
            R_Checkpointer(tmp_path).save(3, rp, blocking=True)
            fresh = build(cfg).init(9, "cpu")
            out, step = Checkpointer(tmp_path).restore(
                tree_from_params(fresh))
            restored = load_tree(fresh, out)
        assert int(step) == 3
        tok = torch.from_numpy(tokens(cfg, 1, 9))
        pat = torch.from_numpy(patches(cfg, 1))
        with torch.no_grad():
            want = lm.forward_hidden(pp, cfg, tok, patches=pat)[0]
            got = lm.forward_hidden(restored, cfg, tok, patches=pat)[0]
        assert torch.equal(got, want)
