"""Port parity for the encdec family (seamless-m4t-medium): the encoder
(bidirectional attention), each decoder layer's cross K/V, the decoder
(causal self-attention over an in-place KV cache, then cross-attention),
the loss and its gradients, prefill then decode, and the checkpoint codec
on the stacked leaves.

``repro_torch/models/encdec.py`` and ``layers.attn_apply``'s ``bidir`` and
``cross`` kinds are held against ``repro.models`` at the SMOKE preset (2 +
2 layers, d_model 64), fp32, with the reference's parameters passed
through ``params_from_jax`` and the same numpy frames and tokens for both.

Tolerances (fp32; the two sum in different orders): logits, hidden states
and cross K/V max |Δ| <= 1e-4 × max |reference|; the KV cache 1e-5 ×
max |reference|; the loss 1e-5 relative; each gradient 1e-4 × its max
|reference|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as R_configs
from repro.models import encdec as R_encdec
from repro.models import layers as R_layers
from repro.models import registry as R_registry
from repro_torch import configs
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.models import build, encdec, layers
from repro_torch.models.convert import (leaves, load_tree, param_tree,
                                        params_from_jax, stack_keys,
                                        tree_from_params)
from repro_torch.optim.grad_compress import CompressionConfig
from torch_parity import to_np

ARCH = "seamless-m4t-medium"
LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5


@pytest.fixture(scope="module")
def model():
    cfg, rcfg = configs.get_smoke(ARCH), R_configs.get_smoke(ARCH)
    rp = jax.tree.map(np.asarray,
                      R_encdec.init_params(jax.random.PRNGKey(0), rcfg))
    return cfg, rcfg, rp, params_from_jax(rp, cfg, device="cpu")


def frames(cfg, b, t, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, t, cfg.d_model)).astype(np.float32)


def tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, t))


def scaled_close(got, want, tol=LOGIT_TOL):
    got, want = to_np(got), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale, \
        (np.abs(got - want).max(), scale)


def ref_tree(rp):
    return jax.tree.map(jnp.asarray, rp)


class TestConfigs:
    @pytest.mark.parametrize("get", ["get", "get_smoke"])
    def test_configs_match_reference(self, get):
        mine = getattr(configs, get)(ARCH)
        assert dataclasses.asdict(mine) == \
            dataclasses.asdict(getattr(R_configs, get)(ARCH))
        assert mine.family == "encdec" and mine.is_encdec
        assert configs.canonical(ARCH) in configs.PORTED

    def test_full_size(self):
        cfg = configs.get(ARCH)
        assert (cfg.enc_layers, cfg.n_layers, cfg.d_model, cfg.d_ff,
                cfg.vocab_padded) == (12, 12, 1024, 4096, 256256)


class TestModel:
    def test_init_shapes_match_reference(self, model):
        cfg, _, rp, _ = model
        mine = encdec.init_params(torch.Generator().manual_seed(0), cfg)
        got = {p: tuple(v.shape) for p, v in leaves(tree_from_params(mine))}
        assert got == {p: v.shape for p, v in leaves(rp)}
        dt = {p: v.dtype for p, v in leaves(tree_from_params(mine))}
        assert all(d == torch.float32 for d in dt.values())

    def test_abstract_params_are_meta_with_the_tree_shapes(self, model):
        cfg, _, rp, _ = model
        ab = build(cfg).abstract_params()
        got = dict(leaves(tree_from_params(ab)))
        assert {p: tuple(v.shape) for p, v in got.items()} == \
            {p: v.shape for p, v in leaves(rp)}
        assert all(v.device.type == "meta" for v in got.values())

    def test_params_from_jax_round_trip(self, model):
        cfg, _, rp, pp = model
        out = tree_from_params(pp)
        assert [p for p, _ in leaves(out)] == [p for p, _ in leaves(rp)]
        for path, v in leaves(out):
            np.testing.assert_array_equal(to_np(v), dict(leaves(rp))[path])
        assert set(stack_keys(cfg)) == {"enc_layers", "dec_layers"}
        fresh = build(cfg).init(5, "cpu")
        load_tree(fresh, out)
        for (p, a), (_, b) in zip(leaves(tree_from_params(fresh)),
                                  leaves(out)):
            assert torch.equal(a, b), p

    def test_params_from_jax_refuses_other_keys(self, model):
        cfg, _, rp, _ = model
        bad = dict(rp, dec_layers={k: v for k, v in rp["dec_layers"].items()
                                   if k != "cross_attn"})
        with pytest.raises(ValueError, match="dec_layers"):
            params_from_jax(bad, cfg, device="cpu")


class TestAttention:
    @pytest.mark.parametrize("kind", ["bidir", "cross", "win"])
    def test_attn_apply_kinds(self, model, kind):
        cfg, rcfg, rp, pp = model
        rng = np.random.default_rng(7)
        h = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
        lp = {k: v[0] for k, v in rp["dec_layers"]["cross_attn"].items()}
        pos = np.broadcast_to(np.arange(9), (2, 9))
        ckv = None
        if kind == "cross":
            ckv = tuple(rng.standard_normal((2, 13, cfg.n_kv_heads, cfg.hd))
                        .astype(np.float32) for _ in range(2))
        kw = dict(window=1 << 30) if kind == "win" else {}
        want, _ = R_layers.attn_apply(
            jax.tree.map(jnp.asarray, lp), jnp.asarray(h), rcfg,
            positions=jnp.asarray(pos), kind=kind,
            cross_kv=None if ckv is None else tuple(map(jnp.asarray, ckv)),
            **kw)
        got, cache = layers.attn_apply(
            pp.dec_layers[0].cross_attn, torch.from_numpy(h), cfg,
            positions=torch.from_numpy(pos.copy()), kind=kind,
            cross_kv=None if ckv is None else tuple(map(torch.from_numpy,
                                                        ckv)), **kw)
        assert cache is None
        scaled_close(got, want)

    def test_cross_writes_no_cache(self, model):
        cfg, _, _, pp = model
        h = torch.randn(1, 1, cfg.d_model)
        kv = torch.randn(1, 5, cfg.n_kv_heads, cfg.hd)
        cache = {"k": torch.zeros(1, 4, cfg.n_kv_heads, cfg.hd),
                 "v": torch.zeros(1, 4, cfg.n_kv_heads, cfg.hd)}
        _, c = layers.attn_apply(pp.dec_layers[0].cross_attn, h, cfg,
                                 positions=torch.zeros(1, 1, dtype=torch.long),
                                 kind="cross", cross_kv=(kv, kv), cache=cache,
                                 cache_pos=2)
        assert c is None and not cache["k"].any() and not cache["v"].any()


class TestForward:
    def test_encode(self, model):
        cfg, rcfg, rp, pp = model
        f = frames(cfg, 2, 11)
        want = R_encdec.encode(ref_tree(rp), rcfg, jnp.asarray(f))
        with torch.no_grad():
            got = encdec.encode(pp, cfg, torch.from_numpy(f))
        scaled_close(got, want)

    def test_cross_kv(self, model):
        cfg, rcfg, rp, pp = model
        mem = frames(cfg, 2, 11, seed=2)
        wk, wv = R_encdec.cross_kv(ref_tree(rp), rcfg, jnp.asarray(mem))
        with torch.no_grad():
            k, v = encdec.cross_kv(pp, cfg, torch.from_numpy(mem))
        assert k.shape == (cfg.n_layers, 2, 11, cfg.n_kv_heads, cfg.hd)
        scaled_close(k, wk)
        scaled_close(v, wv)

    def test_decode_hidden(self, model):
        cfg, rcfg, rp, pp = model
        f, tok = frames(cfg, 2, 11), tokens(cfg, 2, 7)
        rt = ref_tree(rp)
        rckv = R_encdec.cross_kv(rt, rcfg,
                                 R_encdec.encode(rt, rcfg, jnp.asarray(f)))
        want, _ = R_encdec.decode_hidden(rt, rcfg, jnp.asarray(tok), rckv)
        with torch.no_grad():
            ckv = encdec.cross_kv(pp, cfg, encdec.encode(
                pp, cfg, torch.from_numpy(f)))
            got, _ = encdec.decode_hidden(pp, cfg, torch.from_numpy(tok), ckv)
        scaled_close(got, want)


class TestLoss:
    def batch(self, cfg):
        return frames(cfg, 2, 10, seed=5), tokens(cfg, 2, 9, seed=6)

    def test_loss_value(self, model):
        cfg, rcfg, rp, pp = model
        f, tok = self.batch(cfg)
        want, wm = R_encdec.encdec_loss(ref_tree(rp), rcfg, {
            "frames": jnp.asarray(f), "tokens": jnp.asarray(tok)})
        with torch.no_grad():
            got, m = build(cfg).loss(pp, {"frames": torch.from_numpy(f),
                                          "tokens": torch.from_numpy(tok)})
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
        assert float(m["aux"]) == 0.0 and float(m["nll"]) == float(got)

    def test_gradients(self, model):
        cfg, rcfg, rp, _ = model
        f, tok = self.batch(cfg)
        grads = jax.grad(lambda p: R_encdec.encdec_loss(p, rcfg, {
            "frames": jnp.asarray(f), "tokens": jnp.asarray(tok)})[0])(
                ref_tree(rp))
        pp = params_from_jax(rp, cfg, device="cpu")
        pp.requires_grad_(True)
        loss, _ = build(cfg).loss(pp, {"frames": torch.from_numpy(f),
                                       "tokens": torch.from_numpy(tok)})
        loss.backward()
        from repro_torch.models.convert import map_leaves
        got = dict(leaves(map_leaves(
            lambda leaf: torch.stack([p.grad for p in leaf])
            if isinstance(leaf, list) else leaf.grad, param_tree(pp))))
        want = dict(leaves(jax.tree.map(np.asarray, grads)))
        assert set(got) == set(want)
        for path, g in want.items():
            scaled_close(got[path], g)


class TestServe:
    def test_prefill_then_decode(self, model):
        """Prefill 6 tokens over 11 frames, then 8 decode steps: logits
        within 1e-4 of max|logits|, the self-attention KV and the cross K/V
        within 1e-5 of theirs."""
        cfg, rcfg, rp, pp = model
        f, tok = frames(cfg, 2, 11), tokens(cfg, 2, 6)
        rb, b = R_registry.build(rcfg), build(cfg)
        rcache = R_encdec.init_cache(rcfg, 2, 16, 11)
        cache = b.init_cache(2, 16, device="cpu")
        rl, rcache = rb.prefill(ref_tree(rp), {"frames": jnp.asarray(f),
                                               "tokens": jnp.asarray(tok)},
                                rcache)
        with torch.no_grad():
            lg, cache = b.prefill(pp, {"frames": torch.from_numpy(f),
                                       "tokens": torch.from_numpy(tok)},
                                  cache)
        scaled_close(lg, rl)
        for k in ("ck", "cv"):
            assert cache[k].shape == (cfg.n_layers, 2, 11, cfg.n_kv_heads,
                                      cfg.hd)
        nxt = np.argmax(np.asarray(rl)[:, -1], -1)[:, None]
        for i in range(8):
            pos = 6 + i
            rl, rcache = rb.decode(ref_tree(rp), jnp.asarray(nxt), rcache,
                                   jnp.int32(pos))
            with torch.no_grad():
                lg, cache = b.decode(pp, torch.from_numpy(nxt), cache,
                                     torch.tensor(pos))
            scaled_close(lg, rl)
            nxt = np.argmax(np.asarray(rl)[:, -1], -1)[:, None]
        for k in ("k", "v", "ck", "cv"):
            scaled_close(cache[k], rcache[k], CACHE_TOL)

    def test_decode_matches_teacher_forced_pass(self, model):
        """The cached decode's logits at each step equal (within 1e-4 of
        max|logits|) the no-cache decoder over the whole prefix."""
        cfg, _, _, pp = model
        f, tok = torch.from_numpy(frames(cfg, 1, 9)), \
            torch.from_numpy(tokens(cfg, 1, 12, seed=8))
        b = build(cfg)
        with torch.no_grad():
            cache = b.init_cache(1, 16, device="cpu")
            _, cache = b.prefill(pp, {"frames": f, "tokens": tok[:, :4]},
                                 cache)
            steps = []
            for i in range(4, 12):
                lg, cache = b.decode(pp, tok[:, i:i + 1], cache, i)
                steps.append(lg[:, 0])
            ckv = encdec.cross_kv(pp, cfg, encdec.encode(pp, cfg, f))
            h, _ = encdec.decode_hidden(pp, cfg, tok, ckv)
            full = encdec.logits_from_hidden(pp, cfg, h)[:, 4:12]
        got = torch.stack(steps, 1)
        scale = full.abs().max()
        assert (got - full).abs().max() <= LOGIT_TOL * scale

    def test_per_row_positions(self, model):
        """A decode with one position a row (the serve engine's) equals
        each row decoded alone at its own position."""
        cfg, _, _, pp = model
        b = build(cfg)
        f = torch.from_numpy(frames(cfg, 2, 7))
        tok = torch.from_numpy(tokens(cfg, 2, 5, seed=9))
        with torch.no_grad():
            cache = b.init_cache(2, 12, device="cpu")
            _, cache = b.prefill(pp, {"frames": f, "tokens": tok}, cache)
            pos = torch.tensor([5, 3])
            lg, _ = b.decode(pp, tok[:, :1], cache, pos)
            for r in range(2):
                c1 = b.init_cache(1, 12, device="cpu")
                _, c1 = b.prefill(pp, {"frames": f[r:r + 1],
                                       "tokens": tok[r:r + 1]}, c1)
                l1, _ = b.decode(pp, tok[r:r + 1, :1], c1, int(pos[r]))
                assert (l1[0] - lg[r]).abs().max() <= \
                    LOGIT_TOL * l1.abs().max()


class TestCodec:
    def test_codec_round_trip_on_the_stacked_leaves(self, model, tmp_path):
        """CompressionConfig(min_size=4096): every stacked 3-D leaf of the
        encdec tree goes through the Tucker codec at ranks (L, ·, ·); the
        embedding and the norms stay dense and come back bitwise; the
        restored model decodes."""
        cfg, _, _, pp = model
        tree = tree_from_params(pp)
        cc = CompressionConfig(min_size=4096)
        ck = Checkpointer(tmp_path)
        ck.save(1, tree, compress_cfg=cc, blocking=True)
        paths = [p for p, _ in leaves(tree)]
        coded = {tuple(paths[r["index"]]) for r in ck.tucker_log}
        want = {p for p, v in leaves(tree)
                if cc.ranks_for(tuple(v.shape)) is not None}
        assert coded == want and coded
        assert {p[0] for p in coded} == {"enc_layers", "dec_layers"}
        for r in ck.tucker_log:
            assert r["ranks"][0] == cfg.n_layers
        out, step = ck.restore(tree)
        assert int(step) == 1
        for p, v in leaves(out):
            if p not in coded:
                assert torch.equal(v, dict(leaves(tree))[p])
        restored = load_tree(build(cfg).init(3, "cpu"), out)
        with torch.no_grad():
            cache = build(cfg).init_cache(1, 8, device="cpu")
            lg, _ = build(cfg).prefill(restored, {
                "frames": torch.from_numpy(frames(cfg, 1, 5)),
                "tokens": torch.from_numpy(tokens(cfg, 1, 4))}, cache)
        assert torch.isfinite(lg).all()
