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
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as R_configs
from repro.checkpoint.checkpointer import Checkpointer as R_Checkpointer
from repro.models import layers as R_layers
from repro.models import lm as R_lm
from repro.models import registry as R_registry
from repro.serve.engine import Request as R_Request
from repro.serve.engine import ServeEngine as R_ServeEngine
from repro_torch import configs
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build, layers, lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import (leaves, load_tree, params_from_jax,
                                        tree_from_params)
from repro_torch.optim.grad_compress import CompressionConfig
from repro_torch.serve.engine import Request, ServeEngine
from torch_parity import to_np

ARCHS = ("gemma2-9b", "gemma3-1b", "phi3-mini-3.8b", "minitron-4b")
LOGIT_TOL = 1e-4
ACT_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke(arch, **kw):
    """The port's SMOKE config of ``arch`` and the reference's, with
    ``kw`` replaced in both."""
    return (configs.get_smoke(arch).with_(**kw),
            R_configs.get_smoke(arch).with_(**kw))


def ref_tree(rcfg, seed=0):
    return jax.tree.map(np.asarray,
                        R_lm.init_params(jax.random.PRNGKey(seed), rcfg))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, port cfg, reference cfg, reference numpy tree, port LM)."""
    cfg, rcfg = smoke(request.param)
    rp = ref_tree(rcfg)
    return request.param, cfg, rcfg, rp, params_from_jax(rp, cfg,
                                                         device="cpu")


@pytest.fixture(scope="module", params=("gemma2-9b", "gemma3-1b"))
def ring_model(request):
    """A windowed SMOKE made all-local (local_global_pattern (1, 0)), whose
    cache is its window: a ring buffer written at pos % S_c."""
    cfg, rcfg = smoke(request.param, local_global_pattern=(1, 0))
    rp = ref_tree(rcfg)
    return request.param, cfg, rcfg, rp, params_from_jax(rp, cfg,
                                                         device="cpu")


def tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, t))


def scaled_close(got, want, tol=LOGIT_TOL):
    got, want = to_np(got), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale, \
        (np.abs(got - want).max(), scale)


def close(got, want, atol=ACT_TOL):
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float64),
                               rtol=0, atol=atol)


def rng_normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


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

    def test_prefill_then_decode_against_both(self, model):
        """The registry's prefill (13 tokens) and 8 decode steps at
        per-slot positions: logits against the reference's prefill and
        decode_step, and against the port's own no-cache forward over the
        whole sequence; the caches against each other."""
        self.against_both(model)

    def test_ring_prefill_then_decode_against_both(self, ring_model):
        """The same with a ring cache (the registry's ring rule: the cache
        of 8 is shorter than the 24 the decode is told)."""
        assert lm.cache_len(ring_model[1], 24) == 8
        self.against_both(ring_model)

    @staticmethod
    def against_both(model):
        arch, cfg, rcfg, rp, pp = model
        b, rb = build(cfg), R_registry.build(rcfg)
        total, t0 = 24, 13
        tok = tokens(cfg, 2, 21, seed=5)
        rcache = rb.init_cache(2, total)
        pcache = b.init_cache(2, total, device="cpu")
        rl, rcache = rb.prefill(rp, {"tokens": jnp.asarray(tok[:, :t0])},
                                rcache)
        with torch.no_grad():
            pl, pcache = b.prefill(pp, {"tokens": torch.from_numpy(
                tok[:, :t0])}, pcache)
            full = lm.logits_from_hidden(pp, cfg, lm.forward_hidden(
                pp, cfg, torch.from_numpy(tok))[0])
        scaled_close(pl, rl)
        scaled_close(pl[:, 0], full[:, t0 - 1])
        for s in range(t0, 21):
            pos = np.array([s, s])
            rl, rcache = rb.decode(rp, jnp.asarray(tok[:, s:s + 1]), rcache,
                                   jnp.asarray(pos, jnp.int32), total)
            with torch.no_grad():
                pl, pcache = b.decode(pp, torch.from_numpy(tok[:, s:s + 1]),
                                      pcache, torch.from_numpy(pos), total)
            scaled_close(pl, rl)
            scaled_close(pl[:, 0], full[:, s])
        close(pcache["k"], rcache["k"])
        close(pcache["v"], rcache["v"])


# ---------------------------------------------------------------------------
# serving and checkpoints
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
    cfg = ModelConfig(**dataclasses.asdict(R_configs.get_smoke(
        "seamless-m4t-medium")))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        lm.require_ported(cfg)
    lm.require_ported(configs.get_smoke("gemma2-9b"))
    lm.require_ported(configs.get_smoke("falcon-mamba-7b"))
