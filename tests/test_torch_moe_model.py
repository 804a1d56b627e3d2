"""Port parity for the MoE family's model against ``repro.models`` at the
SMOKE presets of granite-moe-3b-a800m and mixtral-8x22b: initialisation,
the forward pass, the loss with its aux term, the gradient, and the serve
engine's greedy tokens.  Tolerances as in ``test_torch_moe.py``; prefill
and decode on the cache are in ``test_torch_moe_decode.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from lm_parity import (ACT_TOL, model_fixture, ref_tree, scaled_close, smoke,
                       tokens)

from repro.models import lm as R_lm
from repro.models import registry as R_registry
from repro.serve.engine import Request as R_Request
from repro.serve.engine import ServeEngine as R_ServeEngine
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build, lm
from repro_torch.models.convert import (layer_keys, leaves, params_from_jax,
                                        tree_from_params)
from repro_torch.serve.engine import Request, ServeEngine
from torch_parity import to_np

ARCHS = ("granite-moe-3b-a800m", "mixtral-8x22b")

model = model_fixture(ARCHS)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class TestModel:
    def test_init_shapes_match_reference(self, model):
        _, cfg, _, rp, _ = model
        mine = lm.init_params(torch.Generator().manual_seed(0), cfg)
        got = {p: tuple(v.shape) for p, v in leaves(tree_from_params(mine))}
        assert got == {p: v.shape for p, v in leaves(rp)}
        assert mine.layers[0].moe["router"].dtype == torch.float32
        assert "mlp" not in mine.layers[0].parts

    def test_params_from_jax_splits_the_layer_axis(self, model):
        _, cfg, _, rp, pp = model
        assert set(layer_keys(cfg)["moe"]) == set(rp["layers"]["moe"])
        for path, v in leaves(tree_from_params(pp)):
            np.testing.assert_array_equal(to_np(v), dict(leaves(rp))[path])

    def test_params_from_jax_refuses_a_dense_tree(self, model):
        _, cfg, _, rp, _ = model
        bad = jax.tree.map(lambda v: v, rp)
        bad["layers"]["mlp"] = bad["layers"].pop("moe")
        with pytest.raises(ValueError, match="layer keys"):
            params_from_jax(bad, cfg, device="cpu")

    def test_forward_hidden_logits_and_aux(self, model):
        _, cfg, rcfg, rp, pp = model
        tok = tokens(cfg, 2, 29)
        rh, _, raux = R_lm.forward_hidden(rp, rcfg, jnp.asarray(tok))
        with torch.no_grad():
            h, _, aux = lm.forward_hidden(pp, cfg, torch.from_numpy(tok))
            logits = lm.logits_from_hidden(pp, cfg, h)
        scaled_close(h, rh)
        scaled_close(logits, R_lm.logits_from_hidden(rp, rcfg, rh))
        assert float(aux) > 0
        assert abs(float(aux) - float(raux)) <= ACT_TOL

    @pytest.mark.parametrize("cf", [None, 0.5], ids=["smoke_cf", "dropping"])
    def test_lm_loss_with_aux(self, model, cf):
        _, cfg, rcfg, rp, pp = model
        if cf is not None:
            cfg, rcfg = cfg.with_(capacity_factor=cf), rcfg.with_(
                capacity_factor=cf)
        tok = tokens(cfg, 2, 17, seed=3)
        want, wm = R_lm.lm_loss(rp, rcfg, {"tokens": jnp.asarray(tok)})
        with torch.no_grad():
            got, m = build(cfg).loss(pp, {"tokens": torch.from_numpy(tok)})
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
        assert abs(float(m["aux"]) - float(wm["aux"])) <= ACT_TOL
        assert float(m["aux"]) > 0
        assert abs(float(got) - float(m["nll"]) - float(m["aux"])) <= 1e-6

    def test_lm_loss_gradient_reaches_every_parameter(self, model):
        _, cfg, _, _, _ = model
        pp = lm.init_params(torch.Generator().manual_seed(1), cfg)
        for p in pp.parameters():
            p.requires_grad_(True)
        loss, _ = lm.lm_loss(pp, cfg, {"tokens": torch.from_numpy(
            tokens(cfg, 1, 9))})
        loss.backward()
        assert all(p.grad is not None and torch.isfinite(p.grad).all()
                   for p in pp.parameters())
        assert pp.layers[0].moe["router"].grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

class TestServe:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_greedy_tokens_match_reference_engine(self, arch):
        """2 slots, 3 requests (a refilled slot), prompts past mixtral's
        window of 16 on its ring cache."""
        cfg, rcfg = smoke(arch)
        rp = ref_tree(rcfg, seed=2)
        pp = params_from_jax(rp, cfg, device="cpu")
        prompts = [list(tokens(cfg, 1, n, seed=n)[0]) for n in (3, 19, 6)]
        ref = R_ServeEngine(R_registry.build(rcfg), rp, batch_slots=2,
                            max_len=40).run(
            [R_Request(prompt=p, max_new_tokens=6, rid=i)
             for i, p in enumerate(prompts)])
        eng = ServeEngine(build(cfg), pp, batch_slots=2, max_len=40)
        assert eng.state_keys == ()
        got = eng.run([Request(prompt=p, max_new_tokens=6, rid=i)
                       for i, p in enumerate(prompts)])
        assert [r.output for r in got] == [r.output for r in ref]

    @pytest.mark.parametrize("arch", ARCHS)
    def test_launcher_on_cpu(self, arch, capsys):
        outs = serve_cli.main(["--arch", arch, "--smoke", "--requests", "3",
                               "--max-new", "4", "--max-len", "32",
                               "--device", "cpu"])
        assert len(outs) == 3 and all(len(r.output) == 4 for r in outs)
        assert "tokens in" in capsys.readouterr().out
