"""Port parity for the dense LM family: attention, RoPE, MLPs, the KV
cache, the serve engine and the checkpoint across packages.

The port's ``models/layers.py``, ``models/lm.py``, ``registry``,
``convert``, ``ServeEngine`` and ``launch/serve.py`` are held against
``repro.models`` at the SMOKE presets of the four dense configs
(gemma2-9b, gemma3-1b, phi3-mini-3.8b, minitron-4b: 2 to 6 layers, d_model
48 or 64, fp32).  The reference's parameters come from its own
``init_params`` and reach the port through ``params_from_jax``, so both
compute with the same weights on the same numpy tokens.

Tolerances (fp32; the two sum in different orders):
  * logits and hidden states: max |Δ| <= 1e-4 × max |reference|;
  * layer outputs (attention, MLP, RoPE at small positions): 1e-5 absolute
    (activations of order 1);
  * RoPE at positions up to 8191: the port's frequencies are within one
    ulp of the reference's, and the outputs within what one ulp of a
    frequency and the rounding of the angle allow, (|x1| + |x2|) · p · 2^-22
    per entry at position p;
  * the KV cache: 1e-5 absolute (k and v of order 1).

This file holds the configs, attention, RoPE, the MLPs and the checkpoint;
``test_torch_dense_model.py`` the model and the serve engine,
``test_torch_dense_decode.py`` prefill and decode on the cache.  The helpers
are ``lm_parity.py``'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from lm_parity import (ACT_TOL, close, model_fixture, ref_tree, rng_normal,
                       smoke, tokens)

from repro import configs as R_configs
from repro.checkpoint.checkpointer import Checkpointer as R_Checkpointer
from repro.models import layers as R_layers
from repro.models import lm as R_lm
from repro_torch import configs
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.models import build, layers, lm
from repro_torch.models.convert import (leaves, load_tree, params_from_jax,
                                        tree_from_params)
from repro_torch.optim.grad_compress import CompressionConfig
from torch_parity import to_np

ARCHS = ("gemma2-9b", "gemma3-1b", "phi3-mini-3.8b", "minitron-4b")

model = model_fixture(ARCHS)
# a windowed SMOKE made all-local (local_global_pattern (1, 0)), whose cache
# is its window: a ring buffer written at pos % S_c
ring_model = model_fixture(("gemma2-9b", "gemma3-1b"), name="ring_model",
                           local_global_pattern=(1, 0))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

class TestConfigs:
    @pytest.mark.parametrize("get", ["get", "get_smoke"])
    @pytest.mark.parametrize("arch", ARCHS)
    def test_dense_configs_match_reference(self, arch, get):
        mine = getattr(configs, get)(arch)
        assert dataclasses.asdict(mine) == \
            dataclasses.asdict(getattr(R_configs, get)(arch))
        assert configs.canonical(arch) in configs.PORTED

    @pytest.mark.parametrize("arch", ARCHS)
    def test_layer_schedule_is_the_reference_s(self, arch):
        cfg, rcfg = configs.get(arch), R_configs.get(arch)
        want = R_lm.layer_schedule(rcfg)
        got = lm.layer_schedule(cfg)
        assert [w for w, _ in got] == np.asarray(want["window"]).tolist()
        assert np.array_equal(np.array([t for _, t in got], np.float32),
                              np.asarray(want["theta"]))

    @pytest.mark.parametrize("arch,seq", [("gemma2-9b", 8224),
                                          ("gemma3-1b", 100)])
    def test_cache_len_and_ring_rule(self, arch, seq):
        cfg, rcfg = configs.get(arch), R_configs.get(arch)
        assert lm.cache_len(cfg, seq) == R_lm.cache_len(rcfg, seq) == seq
        local = cfg.with_(local_global_pattern=(1, 0))
        rlocal = rcfg.with_(local_global_pattern=(1, 0))
        assert lm.cache_len(local, seq) == R_lm.cache_len(rlocal, seq) == \
            min(seq, cfg.sliding_window)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class TestBlockwiseAttention:
    @pytest.mark.parametrize("block_kv", [4, 8, 1024])
    @pytest.mark.parametrize("window", [None, 5])
    @pytest.mark.parametrize("softcap", [None, 50.0])
    def test_matches_reference(self, block_kv, window, softcap):
        """GQA 4 query heads over 2 KV heads, T = S = 13 (not a multiple of
        the block), causal with and without a window."""
        q = rng_normal((2, 13, 4, 16), 1) * 3
        k = rng_normal((2, 13, 2, 16), 2) * 3
        v = rng_normal((2, 13, 2, 16), 3)

        def mask(ti, si):
            m = si[None, :] <= ti[:, None]
            return m if window is None else m & ((ti[:, None] - si[None, :])
                                                 < window)
        want = R_layers.blockwise_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask_fn=mask,
            block_kv=block_kv, softcap=softcap)
        got = layers.blockwise_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            mask_fn=mask, block_kv=block_kv, softcap=softcap)
        close(got, want)

    def test_block_size_does_not_change_the_result(self):
        q, k, v = (torch.from_numpy(rng_normal(s, i)) for i, s in enumerate(
            ((1, 11, 2, 8), (1, 11, 1, 8), (1, 11, 1, 8))))
        mask = lambda ti, si: si[None, :] <= ti[:, None]
        outs = [layers.blockwise_attention(q, k, v, mask_fn=mask, block_kv=n)
                for n in (1, 3, 11, 1024)]
        for o in outs[1:]:
            close(o, to_np(outs[0]))


class TestRope:
    @pytest.mark.parametrize("theta", [10_000.0, 1e6])
    @pytest.mark.parametrize("d", [16, 24, 256])
    def test_frequencies_within_one_ulp(self, theta, d):
        half = d // 2
        want = np.asarray(jnp.exp(-jnp.arange(half, dtype=jnp.float32)
                                  * (jnp.log(jnp.float32(theta)) / half)))
        got = layers.rope_freqs(theta, half, "cpu").numpy()
        assert np.abs(got.view(np.int32) - want.view(np.int32)).max() <= 1

    @pytest.mark.parametrize("theta", [10_000.0, 1e6])
    @pytest.mark.parametrize("d", [16, 256])
    def test_matches_reference_up_to_position_8191(self, theta, d):
        x = rng_normal((2, 6, 3, d), 4)
        pos = np.array([[0, 1, 7, 63, 4095, 4096],
                        [8186, 8187, 8188, 8189, 8190, 8191]], np.int32)
        want = np.asarray(R_layers.rope(jnp.asarray(x), jnp.asarray(pos),
                                        theta))
        got = layers.rope(torch.from_numpy(x), torch.from_numpy(pos).long(),
                          theta).numpy()
        half = d // 2
        mag = np.abs(x[..., :half]) + np.abs(x[..., half:])
        bound = mag * pos[:, :, None, None] * 2.0 ** -22 + ACT_TOL
        err = np.abs(got - want)
        assert (err[..., :half] <= bound).all()
        assert (err[..., half:] <= bound).all()

    def test_rotates_halves_not_pairs(self):
        x = torch.zeros((1, 1, 1, 4))
        x[..., 0] = 1.0
        out = layers.rope(x, torch.tensor([[1]]), 10_000.0)
        # the first half's entry 0 pairs with the second half's entry 0
        assert out[0, 0, 0, 1] == 0 and out[0, 0, 0, 3] == 0
        assert torch.isclose(out[0, 0, 0, 2], torch.sin(torch.tensor(1.0)))


def layer0(rp, part):
    return jax.tree.map(lambda v: jnp.asarray(v[0]), rp["layers"][part])


class TestAttention:
    def test_prefill_without_cache(self, model):
        arch, cfg, rcfg, rp, pp = model
        h = rng_normal((2, 11, cfg.d_model), 5)
        pos = np.broadcast_to(np.arange(11), (2, 11))
        want, _ = R_layers.attn_apply(
            layer0(rp, "attn"), jnp.asarray(h), rcfg,
            positions=jnp.asarray(pos), window=jnp.int32(cfg.sliding_window
                                                         or lm.BIG_WINDOW))
        got, _ = layers.attn_apply(
            pp.layers[0].attn, torch.from_numpy(h), cfg,
            positions=torch.from_numpy(pos.copy()),
            window=cfg.sliding_window or lm.BIG_WINDOW)
        close(got, want)

    def test_prefill_then_decode_per_slot(self, model):
        """Prefill 10 tokens into a cache, then decode rows at their own
        positions (a per-slot (B,) vector): outputs and the cache contents
        against the reference; the window mask (gemma's SMOKE window 8) is
        exercised past position 8."""
        self.prefill_then_decode(model, ring=False)

    def test_ring_prefill_then_decode_per_slot(self, ring_model):
        """The same through a ring cache of the window's 8 slots."""
        self.prefill_then_decode(ring_model, ring=True)

    @staticmethod
    def prefill_then_decode(model, ring):
        arch, cfg, rcfg, rp, pp = model
        total = 24
        s_c = lm.cache_len(cfg, total)
        window = cfg.sliding_window if cfg.sliding_window else None
        p_ref, p_port = layer0(rp, "attn"), pp.layers[0].attn
        h = rng_normal((2, 10, cfg.d_model), 6)
        pos = np.broadcast_to(np.arange(10), (2, 10)).copy()
        zeros = np.zeros((2, s_c, cfg.n_kv_heads, cfg.hd), np.float32)
        rcache = {"k": jnp.asarray(zeros), "v": jnp.asarray(zeros)}
        pcache = {"k": torch.zeros(zeros.shape), "v": torch.zeros(zeros.shape)}
        rw = None if window is None else jnp.int32(window)
        want, rcache = R_layers.attn_apply(
            p_ref, jnp.asarray(h), rcfg, positions=jnp.asarray(pos),
            cache=rcache, window=rw)
        got, out_cache = layers.attn_apply(
            p_port, torch.from_numpy(h), cfg,
            positions=torch.from_numpy(pos), cache=pcache, window=window)
        assert out_cache is pcache        # written in place
        close(got, want)
        # decode: row 0 at 10, 11, ... and row 1 two positions behind
        for step in range(12):
            cp = np.array([10 + step, 8 + step])
            x = rng_normal((2, 1, cfg.d_model), 100 + step)
            want, rcache = R_layers.attn_apply(
                p_ref, jnp.asarray(x), rcfg,
                positions=jnp.asarray(cp[:, None]), cache=rcache,
                cache_pos=jnp.asarray(cp, jnp.int32), ring=ring, window=rw)
            got, _ = layers.attn_apply(
                p_port, torch.from_numpy(x), cfg,
                positions=torch.from_numpy(cp[:, None]), cache=pcache,
                cache_pos=torch.from_numpy(cp), ring=ring, window=window)
            close(got, want)
        close(pcache["k"], rcache["k"])
        close(pcache["v"], rcache["v"])


class TestMLP:
    @pytest.mark.parametrize("arch,act", [("gemma2-9b", "gelu"),
                                          ("phi3-mini-3.8b", "silu"),
                                          ("minitron-4b", "relu2")])
    def test_matches_reference(self, arch, act):
        cfg, rcfg = smoke(arch)
        assert cfg.act == act
        rp = ref_tree(rcfg)
        pp = params_from_jax(rp, cfg, device="cpu")
        x = rng_normal((2, 7, cfg.d_model), 8)
        want = R_layers.mlp_apply(layer0(rp, "mlp"), jnp.asarray(x), rcfg)
        got = layers.mlp_apply(pp.layers[0].mlp, torch.from_numpy(x), cfg)
        close(got, want)


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

    def test_codec_compresses_the_stacked_leaves_only(self, tmp_path):
        """With CompressionConfig(), every stacked 3-D leaf of a dense
        model goes through the Tucker codec at ranks (L, 64, 64) (here
        ``min_size`` admits SMOKE's small leaves and ranks are capped by
        the fraction); the 2-D embedding and norms stay dense."""
        cfg, _ = smoke("gemma2-9b")
        pp = build(cfg).init(0, "cpu")
        tree = tree_from_params(pp)
        cc = CompressionConfig(min_size=4096)
        ck = Checkpointer(tmp_path)
        ck.save(1, tree, compress_cfg=cc, blocking=True)
        paths = [p for p, _ in leaves(tree)]
        coded = {tuple(paths[r["index"]]) for r in ck.tucker_log}
        want = {p for p, v in leaves(tree)
                if cc.ranks_for(tuple(v.shape)) is not None}
        assert coded == want and all(len(dict(leaves(tree))[p].shape) == 3
                                     for p in coded)
        assert ("embed",) not in coded
        for r in ck.tucker_log:
            assert r["ranks"][0] == cfg.n_layers
        out, _ = ck.restore(tree)
        for p, v in leaves(out):
            if p not in coded:
                assert torch.equal(v, dict(leaves(tree))[p])


def test_unported_families_still_raise():
    """No family is left unported: every family builds, initialises and
    lays out its cache (the encdec family through the registry's own
    branch); only an unknown architecture raises (ValueError)."""
    for arch in R_configs.ARCHS:
        cfg = configs.get_smoke(arch)
        bundle = build(cfg)
        params = bundle.init(0, "cpu")
        cache = bundle.init_cache(2, 8, device="cpu")
        assert params.embed.shape == (cfg.vocab_padded, cfg.d_model)
        want = {"encdec": {"k", "v", "ck", "cv"}, "ssm": {"conv", "ssm"},
                "hybrid": {"conv", "ssm", "k", "v"}}.get(cfg.family,
                                                         {"k", "v"})
        assert set(cache) == want, (arch, set(cache))
    with pytest.raises(ValueError, match="unknown"):
        configs.get("no-such-model")
