"""Port parity for the dense LM family's model against ``repro.models`` at
the SMOKE presets of gemma2-9b, gemma3-1b, phi3-mini-3.8b and minitron-4b:
initialisation, the layer split of the reference's tree, the forward pass,
the loss and its gradient, and the serve engine (greedy tokens, in-place
admission, the launcher).  Tolerances as in ``test_torch_dense.py``;
prefill and decode on the cache are in ``test_torch_dense_decode.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from lm_parity import model_fixture, ref_tree, scaled_close, smoke, tokens

from repro.models import lm as R_lm
from repro.models import registry as R_registry
from repro.serve.engine import Request as R_Request
from repro.serve.engine import ServeEngine as R_ServeEngine
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build, lm
from repro_torch.models.convert import (leaves, params_from_jax,
                                        tree_from_params)
from repro_torch.serve.engine import Request, ServeEngine
from torch_parity import to_np

ARCHS = ("gemma2-9b", "gemma3-1b", "phi3-mini-3.8b", "minitron-4b")

model = model_fixture(ARCHS)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class TestModel:
    def test_init_shapes_match_reference(self, model):
        arch, cfg, rcfg, rp, _ = model
        mine = lm.init_params(torch.Generator().manual_seed(0), cfg)
        theirs = dict(leaves(rp))
        got = {p: tuple(v.shape) for p, v in leaves(tree_from_params(mine))}
        assert got == {p: v.shape for p, v in theirs.items()}
        assert not any(p.requires_grad for p in mine.parameters())

    def test_params_from_jax_splits_the_layer_axis(self, model):
        _, cfg, _, rp, pp = model
        for path, v in leaves(tree_from_params(pp)):
            np.testing.assert_array_equal(to_np(v), dict(leaves(rp))[path])

    def test_params_from_jax_refuses_other_keys(self, model):
        _, cfg, _, rp, _ = model
        bad = jax.tree.map(lambda v: v, rp)
        bad["layers"]["attn"]["extra"] = bad["layers"]["attn"]["wq"]
        with pytest.raises(ValueError, match="layer keys"):
            params_from_jax(bad, cfg, device="cpu")

    def test_forward_hidden_and_logits(self, model):
        _, cfg, rcfg, rp, pp = model
        tok = tokens(cfg, 2, 19)
        rh, _, _ = R_lm.forward_hidden(rp, rcfg, jnp.asarray(tok))
        with torch.no_grad():
            h, _, aux = lm.forward_hidden(pp, cfg, torch.from_numpy(tok))
            logits = lm.logits_from_hidden(pp, cfg, h)
        scaled_close(h, rh)
        scaled_close(logits, R_lm.logits_from_hidden(rp, rcfg, rh))
        assert float(aux) == 0.0

    def test_lm_loss_value(self, model):
        _, cfg, rcfg, rp, pp = model
        tok = tokens(cfg, 2, 17, seed=3)
        (want, wm) = R_lm.lm_loss(rp, rcfg, {"tokens": jnp.asarray(tok)})
        with torch.no_grad():
            got, m = build(cfg).loss(pp, {"tokens": torch.from_numpy(tok)})
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
        assert abs(float(m["nll"]) - float(wm["nll"])) <= \
            1e-5 * abs(float(wm["nll"]))

    def test_lm_loss_gradient_reaches_every_parameter(self, model):
        _, cfg, _, _, pp = model
        pp = lm.init_params(torch.Generator().manual_seed(1), cfg)
        for p in pp.parameters():
            p.requires_grad_(True)
        loss, _ = lm.lm_loss(pp, cfg, {"tokens": torch.from_numpy(
            tokens(cfg, 1, 9))})
        loss.backward()
        assert all(p.grad is not None and torch.isfinite(p.grad).all()
                   for p in pp.parameters())


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

class TestServe:
    @pytest.mark.parametrize("ring", [False, True], ids=["linear", "ring"])
    def test_greedy_tokens_match_reference_engine(self, ring):
        """gemma2's SMOKE (window 8; ``ring``: all-local, a ring cache of
        8) on 2 slots, 3 requests, prompts past the window: the refilled
        slot's stale tail is masked alike."""
        kw = {"local_global_pattern": (1, 0)} if ring else {}
        cfg, rcfg = smoke("gemma2-9b", **kw)
        rp = ref_tree(rcfg, seed=2)
        pp = params_from_jax(rp, cfg, device="cpu")
        prompts = [list(tokens(cfg, 1, n, seed=n)[0]) for n in (3, 11, 6)]
        ref = R_ServeEngine(R_registry.build(rcfg), rp, batch_slots=2,
                            max_len=24).run(
            [R_Request(prompt=p, max_new_tokens=6, rid=i)
             for i, p in enumerate(prompts)])
        eng = ServeEngine(build(cfg), pp, batch_slots=2, max_len=24)
        got = eng.run([Request(prompt=p, max_new_tokens=6, rid=i)
                       for i, p in enumerate(prompts)])
        assert [r.output for r in got] == [r.output for r in ref]

    def test_admission_writes_the_cache_in_place(self):
        cfg, _ = smoke("gemma3-1b")
        b = build(cfg)
        pp = b.init(0, "cpu")
        eng = ServeEngine(b, pp, batch_slots=3, max_len=20)
        ptrs = {k: v.data_ptr() for k, v in eng.cache.items()}
        prompt = list(tokens(cfg, 1, 7)[0])
        eng._admit(Request(prompt=prompt, max_new_tokens=2), slot=1)
        fresh = b.init_cache(1, 20, device="cpu")
        with torch.no_grad():
            b.prefill(pp, {"tokens": torch.tensor([prompt])}, fresh)
        assert {k: v.data_ptr() for k, v in eng.cache.items()} == ptrs
        for k in ("k", "v"):
            assert torch.equal(eng.cache[k][:, 1:2, :7], fresh[k][:, :, :7])
            assert not eng.cache[k][:, 0].any() and not eng.cache[k][:, 2].any()

    @pytest.mark.parametrize("arch", ARCHS)
    def test_launcher_on_cpu(self, arch, capsys):
        outs = serve_cli.main(["--arch", arch, "--smoke", "--requests", "3",
                               "--max-new", "4", "--max-len", "32",
                               "--device", "cpu"])
        assert len(outs) == 3 and all(len(r.output) == 4 for r in outs)
        assert "tokens in" in capsys.readouterr().out


    def test_launcher_serves_a_restored_checkpoint(self, tmp_path, capsys):
        """``--ckpt``: the saved weights, not the seed's, serve."""
        cfg, _ = smoke("gemma3-1b")
        b = build(cfg)
        saved = b.init(7, "cpu")
        Checkpointer(tmp_path).save(4, tree_from_params(saved),
                                    blocking=True)
        outs = serve_cli.main(["--arch", "gemma3-1b", "--smoke",
                               "--requests", "2", "--max-new", "4",
                               "--max-len", "32", "--device", "cpu",
                               "--ckpt", str(tmp_path)])
        assert "restored params at step 4" in capsys.readouterr().out
        want = ServeEngine(b, saved, batch_slots=4, max_len=32).run(
            [Request(prompt=[1 + i, 2, 3, 4 + i], max_new_tokens=4, rid=i)
             for i in range(2)])
        assert [r.output for r in outs] == [r.output for r in want]
