"""Port parity for the MoE family: routing, dispatch, the expert combine,
the aux loss, the KV cache (linear and ring), the serve engine and the
checkpoint across packages.

``repro_torch/models/moe.py`` and the moe branch of ``models/lm.py`` are
held against ``repro.models`` at the SMOKE presets of granite-moe-3b-a800m
(8 experts, top-2) and mixtral-8x22b (4 experts, top-2, a sliding window
of 16, so a longer context runs on a ring cache), fp32.  The reference's
parameters come from its own ``init_params`` and reach the port through
``params_from_jax``; both packages take the same numpy inputs.

Tolerances (fp32; the two sum in different orders):
  * logits and hidden states: max |Δ| <= 1e-4 × max |reference|;
  * an MoE layer's output: max |Δ| <= 1e-5 × max |reference| (expert
    weights drawn at 1/sqrt(E), as the reference draws them, make outputs
    of order 100);
  * the routing probabilities and the aux loss: 1e-5 absolute (values of
    order 1);
  * integer routing (the top-k experts, the sorted order, each entry's
    destination and whether it is kept): equal;
  * the dispatch buffer: equal (it holds copies of the inputs).

This file holds the configs, routing and dispatch, and the checkpoint;
``test_torch_moe_model.py`` the model and the serve engine,
``test_torch_moe_decode.py`` prefill and per-slot decode on the cache.  The
helpers are ``lm_parity.py``'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from lm_parity import (ACT_TOL, close, model_fixture, rng_normal,
                       scaled_close, smoke, tokens)

from repro import configs as R_configs
from repro.checkpoint.checkpointer import Checkpointer as R_Checkpointer
from repro.models import lm as R_lm
from repro.models import moe as R_moe
from repro_torch import configs
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.models import build, lm, moe
from repro_torch.models.convert import (leaves, load_tree, params_from_jax,
                                        tree_from_params)
from repro_torch.optim.grad_compress import CompressionConfig

ARCHS = ("granite-moe-3b-a800m", "mixtral-8x22b")

model = model_fixture(ARCHS)


def layer0_moe(rp, pp):
    """Layer 0's experts: the reference's (jnp) and the port's."""
    return (jax.tree.map(lambda v: jnp.asarray(v[0]), rp["layers"]["moe"]),
            pp.layers[0].moe)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

class TestConfigs:
    @pytest.mark.parametrize("get", ["get", "get_smoke"])
    @pytest.mark.parametrize("arch", ARCHS)
    def test_configs_match_reference(self, arch, get):
        mine = getattr(configs, get)(arch)
        assert dataclasses.asdict(mine) == \
            dataclasses.asdict(getattr(R_configs, get)(arch))
        assert configs.canonical(arch) in configs.PORTED

    @pytest.mark.parametrize("arch", ARCHS)
    def test_tuned_presets_match_reference(self, arch):
        from importlib import import_module
        name = configs.canonical(arch)
        mine = import_module(f"repro_torch.configs.{name}").TUNED
        theirs = import_module(f"repro.configs.{name}").TUNED
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)

    @pytest.mark.parametrize("arch,seq,want", [
        ("granite-moe-3b-a800m", 8224, 8224), ("mixtral-8x22b", 8224, 4096),
        ("mixtral-8x22b", 100, 100)])
    def test_cache_len_and_ring_rule(self, arch, seq, want):
        cfg, rcfg = configs.get(arch), R_configs.get(arch)
        assert lm.cache_len(cfg, seq) == R_lm.cache_len(rcfg, seq) == want

    @pytest.mark.parametrize("t", [1, 37, 5000, 5016, 8191])
    @pytest.mark.parametrize("arch", ARCHS)
    def test_capacity_is_the_reference_s(self, arch, t):
        """max(4, ⌈t·k/E·cf⌉), the reference's formula (moe.py:85)."""
        cfg = configs.get(arch)
        want = max(4, int(np.ceil(t * cfg.top_k / cfg.n_experts
                                  * cfg.capacity_factor)))
        assert moe.capacity(t, cfg) == want
        if t == 1:
            assert want == 4     # a decode slot drops nothing


# ---------------------------------------------------------------------------
# routing, dispatch and combine
# ---------------------------------------------------------------------------

class TestDispatch:
    @pytest.mark.parametrize("cap", [3, 6, 40])
    def test_dispatch_group_matches_reference(self, model, cap):
        """One group at a capacity that drops entries (3, 6 slots for 19
        tokens × 2) and one that keeps all (40): the sorted tokens,
        probabilities, destinations, the kept mask and the buffer."""
        _, cfg, rcfg, rp, pp = model
        rw, pw = layer0_moe(rp, pp)
        x = rng_normal((19, cfg.d_model), 1)
        rbuf, (rdest, rstok, rsp, rkeep), (rprobs, rtop) = \
            R_moe._dispatch_group(jnp.asarray(x), rw["router"],
                                  cfg.n_experts, cfg.top_k, cap)
        buf, (dest, stok, sp, keep), (probs, top) = moe._dispatch_group(
            torch.from_numpy(x)[None], pw["router"], cfg.n_experts,
            cfg.top_k, cap)
        assert np.array_equal(top[0].numpy(), np.asarray(rtop))
        assert np.array_equal(stok[0].numpy(), np.asarray(rstok))
        assert np.array_equal(dest[0].numpy(), np.asarray(rdest))
        assert np.array_equal(keep[0].numpy(), np.asarray(rkeep))
        close(probs[0], rprobs)
        close(sp[0], rsp)
        assert np.array_equal(buf[0].numpy(), np.asarray(rbuf))
        if cap < 19:
            assert not keep.all()

    def test_rows_are_separate_groups(self, model):
        """A batch of 3 rows dispatches as 3 groups: each row's buffer,
        destinations and output are what it gets alone, and the reference's
        vmapped dispatch agrees.  Capacity is the group's (8 tokens), so
        row 1, whose tokens all crowd the same experts, drops only its
        own."""
        _, cfg, rcfg, rp, pp = model
        rw, pw = layer0_moe(rp, pp)
        x = rng_normal((3, 8, cfg.d_model), 2)
        x[1] = x[1, :1]              # row 1: eight copies of one token
        cap = moe.capacity(8, cfg.with_(capacity_factor=0.5))
        buf, (dest, _, _, keep), _ = moe._dispatch_group(
            torch.from_numpy(x), pw["router"], cfg.n_experts, cfg.top_k, cap)
        for i in range(3):
            b1, (d1, _, _, k1), _ = moe._dispatch_group(
                torch.from_numpy(x[i:i + 1]), pw["router"], cfg.n_experts,
                cfg.top_k, cap)
            assert torch.equal(buf[i], b1[0]) and torch.equal(dest[i], d1[0])
            assert torch.equal(keep[i], k1[0])
        assert not keep[1].all()
        rc = cfg.with_(capacity_factor=0.5)
        rrc = rcfg.with_(capacity_factor=0.5)
        got, _ = moe.moe_apply(pw, torch.from_numpy(x), rc)
        want, _ = R_moe.moe_apply(rw, jnp.asarray(x), rrc)
        scaled_close(got, want, ACT_TOL)
        for i in range(3):
            alone, _ = moe.moe_apply(pw, torch.from_numpy(x[i:i + 1]), rc)
            assert torch.equal(got[i], alone[0])

    @pytest.mark.parametrize("cf", [None, 0.5], ids=["smoke_cf", "dropping"])
    def test_moe_apply_output_and_aux(self, model, cf):
        _, cfg, rcfg, rp, pp = model
        if cf is not None:
            cfg, rcfg = cfg.with_(capacity_factor=cf), rcfg.with_(
                capacity_factor=cf)
        rw, pw = layer0_moe(rp, pp)
        x = rng_normal((2, 23, cfg.d_model), 3)
        want, raux = R_moe.moe_apply(rw, jnp.asarray(x), rcfg)
        with moe.count_drops() as drops:
            got, aux = moe.moe_apply(pw, torch.from_numpy(x), cfg)
        scaled_close(got, want, ACT_TOL)
        assert abs(float(aux) - float(raux)) <= ACT_TOL
        assert aux.dtype == torch.float32
        assert len(drops) == 1
        assert (int(drops[0]) > 0) == (cf is not None)

    def test_count_drops_is_off_outside_its_context(self, model):
        _, cfg, _, _, pp = model
        x = torch.from_numpy(rng_normal((1, 5, cfg.d_model), 4))
        moe.moe_apply(pp.layers[0].moe, x, cfg)
        assert moe._DROPS is None
        with moe.count_drops() as outer:
            with moe.count_drops() as inner:
                moe.moe_apply(pp.layers[0].moe, x, cfg)
            moe.moe_apply(pp.layers[0].moe, x, cfg)
        assert len(inner) == 1 and len(outer) == 1
        assert moe._DROPS is None

    def test_combine_is_bitwise_repeatable(self, model):
        """The combine gathers each token's k outputs and adds them one
        by one in ascending expert id: two calls are bitwise equal, and
        so is a hand sum in that order of the same expert outputs."""
        _, cfg, _, _, pp = model
        p = pp.layers[0].moe
        x = torch.from_numpy(rng_normal((2, 17, cfg.d_model), 5))
        cap = moe.capacity(17, cfg)
        a, _ = moe.moe_apply(p, x, cfg)
        b, _ = moe.moe_apply(p, x, cfg)
        assert torch.equal(a, b)
        buf, (dest, stok, sp, keep), (_, top_e) = moe._dispatch_group(
            x, p["router"], cfg.n_experts, cfg.top_k, cap)
        gate = torch.einsum("becd,edf->becf", buf, p["w_gate"])
        up = torch.einsum("becd,edf->becf", buf, p["w_up"])
        out = torch.einsum("becf,efd->becd", torch.nn.functional.silu(gate)
                           * up, p["w_down"]).reshape(2, -1, cfg.d_model)
        hand = torch.zeros_like(a)
        for row in range(2):
            for tok in range(17):
                acc = torch.zeros(cfg.d_model)
                for j in sorted(range(stok.shape[1]),
                                key=lambda j: int(dest[row, j])):
                    if int(stok[row, j]) != tok:
                        continue
                    w = float(keep[row, j]) * sp[row, j]
                    d = min(int(dest[row, j]), out.shape[1] - 1)
                    acc = acc + out[row, d] * w
                hand[row, tok] = acc
        assert torch.equal(a, hand)

    def test_dispatch_has_no_host_sync_ops(self):
        """The decode step must capture: the dispatch keeps to stable
        ``argsort``, ``scatter_add_`` and ``cumsum`` (no ``bincount``,
        ``unique``, ``nonzero``, mask indexing or ``.item()``)."""
        import inspect
        src = inspect.getsource(moe._dispatch_group) + \
            inspect.getsource(moe._ffn_combine) + \
            inspect.getsource(moe.moe_apply)
        for op in ("bincount", "unique", "nonzero", ".item(", "index_add",
                   "masked_select"):
            assert op not in src, op
        assert "stable=True" in inspect.getsource(moe._dispatch_group)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

class TestCheckpoint:
    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_restored_across_packages_serves_equal_logits(self, model,
                                                          tmp_path, writer):
        arch, cfg, rcfg, rp, pp = model
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
        with torch.no_grad():
            want = lm.logits_from_hidden(pp, cfg,
                                         lm.forward_hidden(pp, cfg, tok)[0])
            got = lm.logits_from_hidden(restored, cfg, lm.forward_hidden(
                restored, cfg, tok)[0])
        assert torch.equal(got, want)

    def test_codec_takes_the_4way_expert_leaves(self, tmp_path):
        """granite's SMOKE at min_size 1024: the stacked expert leaves
        (L, E, d, ff) go through the codec as 4-way tensors at ranks (L,
        ⌈E/4⌉, ...) and the router (L, d, E) as a 3-way one; the restore
        reconstructs each at its shape."""
        cfg, _ = smoke("granite-moe-3b-a800m")
        pp = build(cfg).init(0, "cpu")
        tree = tree_from_params(pp)
        cc = CompressionConfig(min_size=1024)
        ck = Checkpointer(tmp_path)
        ck.save(1, tree, compress_cfg=cc, blocking=True)
        paths = [p for p, _ in leaves(tree)]
        by_path = {tuple(paths[r["index"]]): r for r in ck.tucker_log}
        for name in ("w_gate", "w_up", "w_down"):
            r = by_path[("layers", "moe", name)]
            assert len(r["shape"]) == 4
            assert r["ranks"][:2] == [cfg.n_layers, 2]
        assert by_path[("layers", "moe", "router")]["ranks"][0] == \
            cfg.n_layers
        out, _ = ck.restore(tree)
        for p, v in leaves(out):
            assert tuple(v.shape) == tuple(dict(leaves(tree))[p].shape)
            if p not in by_path:
                assert torch.equal(v, dict(leaves(tree))[p])
