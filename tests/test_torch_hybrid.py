"""Port parity for Mamba-2 (SSD) and the hybrid family: the chunked scan,
the one-token recurrence, zamba2's shared attention block, the mixed
cache (a state returned anew, a KV cache written in place), the serve
engine and the checkpoint across packages.

``repro_torch/models/ssm.py``'s Mamba-2 half and the hybrid branch of
``models/lm.py`` are held against ``repro.models`` at zamba2-1.2b's SMOKE
preset (4 layers, shared attention at layers 1 and 3, 4 heads of P = 16,
N = 8, chunk 16), fp32, with the reference's parameters passed through
``params_from_jax`` and the same numpy inputs for both.

Tolerances (fp32; the two sum in different orders):
  * logits and hidden states: max |Δ| <= 1e-4 × max |reference|;
  * the scan's outputs and states: max |Δ| <= 1e-5 × max |reference|;
  * the cache contents (conv, ssm, k, v): 1e-5 × max |reference| of each.
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
from repro.models import ssm as R_ssm
from repro_torch import configs
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build, lm, ssm
from repro_torch.models.convert import (layer_keys, leaves, load_tree,
                                        params_from_jax, shared_keys,
                                        tree_from_params)
from repro_torch.serve.engine import Request, ServeEngine
from torch_parity import to_np

ARCH = "zamba2-1.2b"
LOGIT_TOL = 1e-4
SCAN_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_tree(rcfg, seed=0):
    return jax.tree.map(np.asarray,
                        R_lm.init_params(jax.random.PRNGKey(seed), rcfg))


@pytest.fixture(scope="module")
def model():
    """(port cfg, reference cfg, reference numpy tree, port LM)."""
    cfg, rcfg = configs.get_smoke(ARCH), R_configs.get_smoke(ARCH)
    rp = ref_tree(rcfg)
    return cfg, rcfg, rp, params_from_jax(rp, cfg, device="cpu")


def tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, t))


def rng_normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def scaled_close(got, want, tol=LOGIT_TOL):
    got, want = to_np(got), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale, \
        (np.abs(got - want).max(), scale)


def scan_inputs(b, t, h, p, n, seed, dt_scale=0.1):
    x = rng_normal((b, t, h, p), seed)
    dt = np.abs(rng_normal((b, t, h), seed + 1, dt_scale))
    bmat = rng_normal((b, t, n), seed + 2)
    cmat = rng_normal((b, t, n), seed + 3)
    a = -np.exp(rng_normal((h,), seed + 4, 0.5))
    return x, dt, bmat, cmat, a


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

class TestConfigs:
    @pytest.mark.parametrize("get", ["get", "get_smoke"])
    def test_configs_match_reference(self, get):
        mine = getattr(configs, get)(ARCH)
        assert dataclasses.asdict(mine) == \
            dataclasses.asdict(getattr(R_configs, get)(ARCH))
        assert configs.canonical(ARCH) in configs.PORTED

    def test_sites_and_cache_len(self):
        cfg = configs.get(ARCH)
        sites = [i for i, s in enumerate(cfg.shared_attn_sites()) if s]
        assert sites == [5, 11, 17, 23, 29, 35]
        assert lm.cache_len(cfg, 8224) == 8224     # never a ring
        assert lm.state_keys(cfg) == ("conv", "ssm")

    def test_cache_layout_is_the_reference_s(self, model):
        cfg, rcfg, _, _ = model
        want = R_lm.init_cache(rcfg, 3, 20)
        got = lm.init_cache(cfg, 3, 20, device="cpu")
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: v.shape for k, v in want.items()}
        assert {k: str(v.dtype).replace("torch.", "")
                for k, v in got.items()} == \
            {k: str(v.dtype) for k, v in want.items()}


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------

class TestSSDScan:
    @pytest.mark.parametrize("t,chunk", [(37, 16), (16, 16), (5, 16),
                                         (50, 8)])
    @pytest.mark.parametrize("with_h0", [False, True])
    def test_matches_reference(self, t, chunk, with_h0):
        """T a multiple of the chunk or not (a ragged last chunk), from a
        zero state or an h0: y and the final state."""
        x, dt, bm, cm, a = scan_inputs(2, t, 3, 4, 5, seed=t)
        h0 = rng_normal((2, 3, 4, 5), 99) if with_h0 else None
        wy, wh = R_ssm._ssd_scan(*map(jnp.asarray, (x, dt, bm, cm, a)),
                                 chunk, h0=None if h0 is None
                                 else jnp.asarray(h0))
        gy, gh = ssm._ssd_scan(*map(torch.from_numpy, (x, dt, bm, cm, a)),
                               chunk, h0=None if h0 is None
                               else torch.from_numpy(h0))
        assert gy.shape == (2, t, 3, 4) and gh.shape == (2, 3, 4, 5)
        scaled_close(gy, wy, SCAN_TOL)
        scaled_close(gh, wh, SCAN_TOL)

    def test_chunk_does_not_change_the_result(self):
        x, dt, bm, cm, a = map(torch.from_numpy,
                               scan_inputs(1, 45, 2, 3, 4, seed=7))
        y1, h1 = ssm._ssd_scan(x, dt, bm, cm, a, 8)
        y2, h2 = ssm._ssd_scan(x, dt, bm, cm, a, 64)
        scaled_close(y1, to_np(y2), SCAN_TOL)
        scaled_close(h1, to_np(h2), SCAN_TOL)

    def test_large_decay_stays_finite(self):
        """|a·dt| of 30 a step: over a chunk of 16 the reference's
        intermediate exp(cum_t − cum_s) for s > t reaches exp(450), inf in
        fp32 (its ``where`` then drops it, so its forward is still
        finite, but its gradient is not).  The port masks the exponent,
        so every decay is exp(<= 0): the same y, and a finite gradient."""
        x, dt, bm, cm, a = scan_inputs(1, 32, 2, 3, 4, seed=3)
        dt = np.full_like(dt, 3.0)
        a = np.full_like(a, -10.0)
        cum = np.cumsum(dt[0, :16, 0] * a[0])
        with np.errstate(over="ignore"):
            assert not np.isfinite(np.exp(np.float32(cum[:, None]
                                                     - cum[None, :]))).all()
        wy, _ = R_ssm._ssd_scan(*map(jnp.asarray, (x, dt, bm, cm, a)), 16)
        ref_grad = jax.grad(lambda d: R_ssm._ssd_scan(
            jnp.asarray(x), d, jnp.asarray(bm), jnp.asarray(cm),
            jnp.asarray(a), 16)[0].sum())(jnp.asarray(dt))
        assert not np.isfinite(np.asarray(ref_grad)).all()
        tdt = torch.from_numpy(dt).requires_grad_(True)
        gy, gh = ssm._ssd_scan(torch.from_numpy(x), tdt,
                               torch.from_numpy(bm), torch.from_numpy(cm),
                               torch.from_numpy(a), 16)
        assert torch.isfinite(gy).all() and torch.isfinite(gh).all()
        scaled_close(gy.detach(), wy, SCAN_TOL)
        gy.sum().backward()
        assert torch.isfinite(tdt.grad).all()


# ---------------------------------------------------------------------------
# the Mamba-2 layer
# ---------------------------------------------------------------------------

def layer0(rp, part):
    return jax.tree.map(lambda v: jnp.asarray(v[0]), rp["layers"][part])


class TestMamba2:
    def test_init_keys_and_values(self):
        cfg = configs.get_smoke(ARCH)
        p = ssm.mamba2_init(torch.Generator().manual_seed(0), cfg,
                            torch.float32)
        assert set(p) == set(layer_keys(cfg)["ssm"])
        assert torch.equal(p["dt_bias"], torch.full((cfg.ssm_heads,), -4.0))
        assert torch.equal(p["a_log"], torch.zeros(cfg.ssm_heads))
        assert torch.equal(p["d_skip"], torch.ones(cfg.ssm_heads))

    def test_apply_without_cache(self, model):
        cfg, rcfg, rp, pp = model
        h = rng_normal((2, 21, cfg.d_model), 1)
        want, _ = R_ssm.mamba2_apply(layer0(rp, "ssm"), jnp.asarray(h), rcfg)
        got, c = ssm.mamba2_apply(pp.layers[0].ssm, torch.from_numpy(h), cfg)
        assert c is None
        scaled_close(got, want)

    def test_recurrence_continues_the_scan(self, model):
        """A prefill of 19 tokens through the scan (a ragged chunk), then 9
        one-token recurrence steps from its cache: each step's output
        against the scan over the whole sequence, and the final states
        against the reference's."""
        cfg, rcfg, rp, pp = model
        p, rpar = pp.layers[0].ssm, layer0(rp, "ssm")
        h = rng_normal((2, 28, cfg.d_model), 2)
        full, _ = ssm.mamba2_apply(p, torch.from_numpy(h), cfg)
        zeros = {"conv": torch.zeros((2, cfg.ssm_conv - 1, cfg.d_inner)),
                 "ssm": torch.zeros((2, cfg.ssm_heads, cfg.ssm_head_dim,
                                     cfg.ssm_state))}
        rcache = jax.tree.map(lambda v: jnp.asarray(v.numpy()), zeros)
        got, cache = ssm.mamba2_apply(p, torch.from_numpy(h[:, :19]), cfg,
                                      cache=zeros)
        want, rcache = R_ssm.mamba2_apply(rpar, jnp.asarray(h[:, :19]), rcfg,
                                          cache=rcache)
        scaled_close(got, to_np(full[:, :19]))
        scaled_close(got, want)
        for s in range(19, 28):
            got, cache = ssm.mamba2_apply(p, torch.from_numpy(h[:, s:s + 1]),
                                          cfg, cache=cache)
            want, rcache = R_ssm.mamba2_apply(
                rpar, jnp.asarray(h[:, s:s + 1]), rcfg, cache=rcache)
            scaled_close(got, to_np(full[:, s:s + 1]))
            scaled_close(got, want)
        scaled_close(cache["ssm"], rcache["ssm"], SCAN_TOL)
        scaled_close(cache["conv"], rcache["conv"], SCAN_TOL)


# ---------------------------------------------------------------------------
# the hybrid model
# ---------------------------------------------------------------------------

class TestModel:
    def test_init_shapes_match_reference(self, model):
        cfg, _, rp, _ = model
        mine = lm.init_params(torch.Generator().manual_seed(0), cfg)
        got = {p: tuple(v.shape) for p, v in leaves(tree_from_params(mine))}
        assert got == {p: v.shape for p, v in leaves(rp)}
        assert mine.shared is not None and len(mine.layers) == cfg.n_layers
        assert set(mine.shared.parts) == set(shared_keys(cfg))

    def test_params_from_jax_keeps_the_shared_block(self, model):
        cfg, _, rp, pp = model
        for path, v in leaves(tree_from_params(pp)):
            np.testing.assert_array_equal(to_np(v), dict(leaves(rp))[path])
        assert any(p[0] == "shared" for p, _ in leaves(tree_from_params(pp)))

    def test_params_from_jax_refuses_a_missing_shared_block(self, model):
        cfg, _, rp, _ = model
        bad = {k: v for k, v in rp.items() if k != "shared"}
        with pytest.raises(ValueError, match="shared keys"):
            params_from_jax(bad, cfg, device="cpu")

    def test_forward_hidden_and_logits(self, model):
        cfg, rcfg, rp, pp = model
        tok = tokens(cfg, 2, 37)
        rh, _, _ = R_lm.forward_hidden(rp, rcfg, jnp.asarray(tok))
        with torch.no_grad():
            h, _, aux = lm.forward_hidden(pp, cfg, torch.from_numpy(tok))
            logits = lm.logits_from_hidden(pp, cfg, h)
        scaled_close(h, rh)
        scaled_close(logits, R_lm.logits_from_hidden(rp, rcfg, rh))
        assert float(aux) == 0.0

    def test_shared_block_runs_at_its_sites_only(self, model):
        cfg, _, _, pp = model
        calls = []
        orig = lm._shared_attn_block

        def spy(*a, **kw):
            calls.append(1)
            return orig(*a, **kw)
        lm._shared_attn_block = spy
        try:
            with torch.no_grad():
                lm.forward_hidden(pp, cfg, torch.from_numpy(tokens(cfg, 1,
                                                                   5)))
        finally:
            lm._shared_attn_block = orig
        assert len(calls) == sum(cfg.shared_attn_sites()) == 2

    def test_lm_loss_value_and_gradient(self, model):
        cfg, rcfg, rp, pp = model
        tok = tokens(cfg, 2, 21, seed=3)
        want, wm = R_lm.lm_loss(rp, rcfg, {"tokens": jnp.asarray(tok)})
        with torch.no_grad():
            got, m = build(cfg).loss(pp, {"tokens": torch.from_numpy(tok)})
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
        fresh = lm.init_params(torch.Generator().manual_seed(1), cfg)
        for p in fresh.parameters():
            p.requires_grad_(True)
        loss, _ = lm.lm_loss(fresh, cfg, {"tokens": torch.from_numpy(tok)})
        loss.backward()
        assert all(p.grad is not None and torch.isfinite(p.grad).all()
                   for p in fresh.parameters())

    def test_prefill_then_decode_caches_equal_the_reference_s(self, model):
        """The registry's prefill (rows of 21 tokens: one whole chunk and
        a ragged one) and 8 decode steps at per-row positions: logits
        against the reference's and the port's no-cache forward; every
        cache key (conv, ssm, and k/v of every layer, the sites' written,
        the others zero) against the reference's."""
        cfg, rcfg, rp, pp = model
        b, rb = build(cfg), R_registry.build(rcfg)
        total, t0 = 32, 21
        tok = tokens(cfg, 2, 29, seed=5)
        rcache = rb.init_cache(2, total)
        pcache = b.init_cache(2, total, device="cpu")
        k_ptr = pcache["k"].data_ptr()
        rl, rcache = rb.prefill(rp, {"tokens": jnp.asarray(tok[:, :t0])},
                                rcache)
        with torch.no_grad():
            pl, pcache = b.prefill(pp, {"tokens": torch.from_numpy(
                tok[:, :t0])}, pcache)
            full = lm.logits_from_hidden(pp, cfg, lm.forward_hidden(
                pp, cfg, torch.from_numpy(tok))[0])
        assert pcache["k"].data_ptr() == k_ptr      # written in place
        scaled_close(pl, rl)
        scaled_close(pl[:, 0], full[:, t0 - 1])
        for s in range(t0, 29):
            pos = np.array([s, s])
            rl, rcache = rb.decode(rp, jnp.asarray(tok[:, s:s + 1]), rcache,
                                   jnp.asarray(pos, jnp.int32), total)
            with torch.no_grad():
                pl, pcache = b.decode(pp, torch.from_numpy(tok[:, s:s + 1]),
                                      pcache, torch.from_numpy(pos), total)
            scaled_close(pl, rl)
            scaled_close(pl[:, 0], full[:, s])
        for key in ("conv", "ssm", "k", "v"):
            scaled_close(pcache[key], rcache[key], SCAN_TOL)
        sites = cfg.shared_attn_sites()
        for i in range(cfg.n_layers):
            assert bool(pcache["k"][i].any()) == bool(sites[i])


# ---------------------------------------------------------------------------
# serving and checkpoints
# ---------------------------------------------------------------------------

class TestServe:
    def test_admission_mixes_in_place_and_returned_keys(self, model):
        """A refilled slot: the sites' k/v are written into the engine's
        own tensors (same storage; the other layers' are never written),
        conv/ssm come back from a zero state and are copied in; the other
        slots are untouched."""
        cfg, _, _, pp = model
        b = build(cfg)
        eng = ServeEngine(b, pp, batch_slots=3, max_len=24)
        ptrs = {k: v.data_ptr() for k, v in eng.cache.items()}
        for k in eng.cache:
            eng.cache[k][:, 1].fill_(7.0)    # a previous occupant's leftovers
        prompt = list(tokens(cfg, 1, 9)[0])
        eng._admit(Request(prompt=prompt, max_new_tokens=2), slot=1)
        fresh = b.init_cache(1, 24, device="cpu")
        with torch.no_grad():
            _, want = b.prefill(pp, {"tokens": torch.tensor([prompt])},
                                fresh)
        assert {k: v.data_ptr() for k, v in eng.cache.items()} == ptrs
        for k in ("conv", "ssm"):
            assert torch.equal(eng.cache[k][:, 1:2], want[k])
        sites = [i for i, s in enumerate(cfg.shared_attn_sites()) if s]
        for k in ("k", "v"):
            got = eng.cache[k][:, 1]
            assert torch.equal(got[sites, :9], want[k][sites, 0, :9])
            assert (got[sites, 9:] == 7.0).all()       # the stale tail kept
            others = [i for i in range(cfg.n_layers) if i not in sites]
            assert (got[others] == 7.0).all()          # no site: unwritten
        for k in eng.cache:
            assert not eng.cache[k][:, 0].any() and not eng.cache[k][:, 2].any()

    def test_engine_tokens_equal_each_request_alone(self, model):
        """2 slots, 3 requests (the third refills a slot): each request's
        greedy tokens equal those it gets alone on a fresh engine (a
        refilled slot's state starts from zero; its stale KV tail is
        masked)."""
        cfg, _, _, pp = model
        b = build(cfg)
        prompts = [list(tokens(cfg, 1, n, seed=n)[0]) for n in (4, 19, 7)]
        got = ServeEngine(b, pp, batch_slots=2, max_len=40).run(
            [Request(prompt=p, max_new_tokens=6, rid=i)
             for i, p in enumerate(prompts)])
        for r, p in zip(got, prompts):
            alone = ServeEngine(b, pp, batch_slots=1, max_len=40).run(
                [Request(prompt=p, max_new_tokens=6)])[0]
            assert r.output == alone.output

    def test_launcher_on_cpu(self, capsys):
        outs = serve_cli.main(["--arch", ARCH, "--smoke", "--requests", "3",
                               "--max-new", "4", "--max-len", "32",
                               "--device", "cpu"])
        assert len(outs) == 3 and all(len(r.output) == 4 for r in outs)
        assert "tokens in" in capsys.readouterr().out


    def test_launcher_serves_a_restored_checkpoint(self, tmp_path, capsys):
        """``--ckpt``: the saved weights (the shared block's included),
        not the seed's, serve."""
        cfg = configs.get_smoke(ARCH)
        b = build(cfg)
        saved = b.init(7, "cpu")
        Checkpointer(tmp_path).save(4, tree_from_params(saved),
                                    blocking=True)
        outs = serve_cli.main(["--arch", ARCH, "--smoke", "--requests", "2",
                               "--max-new", "4", "--max-len", "32",
                               "--device", "cpu", "--ckpt", str(tmp_path)])
        assert "restored params at step 4" in capsys.readouterr().out
        want = ServeEngine(b, saved, batch_slots=4, max_len=32).run(
            [Request(prompt=[1 + i, 2, 3, 4 + i], max_new_tokens=4, rid=i)
             for i in range(2)])
        assert [r.output for r in outs] == [r.output for r in want]


class TestCheckpoint:
    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_restored_across_packages_serves_equal_logits(self, model,
                                                          tmp_path, writer):
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
        with torch.no_grad():
            want = lm.logits_from_hidden(pp, cfg,
                                         lm.forward_hidden(pp, cfg, tok)[0])
            got = lm.logits_from_hidden(restored, cfg, lm.forward_hidden(
                restored, cfg, tok)[0])
        assert torch.equal(got, want)
