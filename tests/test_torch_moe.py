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
from repro.models import moe as R_moe
from repro.models import registry as R_registry
from repro.serve.engine import Request as R_Request
from repro.serve.engine import ServeEngine as R_ServeEngine
from repro_torch import configs
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build, lm, moe
from repro_torch.models.convert import (layer_keys, leaves, load_tree,
                                        params_from_jax, tree_from_params)
from repro_torch.optim.grad_compress import CompressionConfig
from repro_torch.serve.engine import Request, ServeEngine
from torch_parity import to_np

ARCHS = ("granite-moe-3b-a800m", "mixtral-8x22b")
LOGIT_TOL = 1e-4
ACT_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke(arch, **kw):
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


def tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, t))


def rng_normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def scaled_close(got, want, tol=LOGIT_TOL):
    got, want = to_np(got), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale, \
        (np.abs(got - want).max(), scale)


def close(got, want, atol=ACT_TOL):
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float64),
                               rtol=0, atol=atol)


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

    def test_prefill_then_per_slot_decode(self, model):
        """The registry's prefill (rows of 21 tokens; mixtral's SMOKE
        window is 16, so its cache of 16 is a ring the prompt wraps) and
        9 decode steps with the rows at their own positions: logits against
        the reference's prefill and decode_step and against the port's
        no-cache forward (no group drops: SMOKE's capacity factor is 8);
        the caches against the reference's."""
        arch, cfg, rcfg, rp, pp = model
        b, rb = build(cfg), R_registry.build(rcfg)
        total, t0 = 32, 21
        ring = lm.cache_len(cfg, total) < total
        assert ring == (arch == "mixtral-8x22b")
        tok = tokens(cfg, 2, 31, seed=5)
        rcache = rb.init_cache(2, total)
        pcache = b.init_cache(2, total, device="cpu")
        rl, rcache = rb.prefill(rp, {"tokens": jnp.asarray(tok[:, :t0])},
                                rcache)
        with torch.no_grad(), moe.count_drops() as drops:
            pl, pcache = b.prefill(pp, {"tokens": torch.from_numpy(
                tok[:, :t0])}, pcache)
            full = lm.logits_from_hidden(pp, cfg, lm.forward_hidden(
                pp, cfg, torch.from_numpy(tok))[0])
        assert sum(int(d) for d in drops) == 0
        scaled_close(pl, rl)
        scaled_close(pl[:, 0], full[:, t0 - 1])
        # row 1 is given its token one step late (a per-row position)
        for s in range(t0, 30):
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

    def test_decode_rows_at_different_positions(self, model):
        """Per-slot decode: rows at positions 5 and 21 of two different
        prompts, each against the reference at the same positions."""
        arch, cfg, rcfg, rp, pp = model
        b, rb = build(cfg), R_registry.build(rcfg)
        total = 28
        rcache = rb.init_cache(2, total)
        pcache = b.init_cache(2, total, device="cpu")
        lens = (5, 21)
        for row, n in enumerate(lens):
            tok = tokens(cfg, 1, n, seed=10 + row)
            sl = lambda c: jax.tree.map(lambda v: v[:, row:row + 1], c)
            _, rc = rb.prefill(rp, {"tokens": jnp.asarray(tok)}, sl(rcache))
            rcache = jax.tree.map(lambda f, s: f.at[:, row:row + 1].set(s),
                                  rcache, rc)
            with torch.no_grad():
                b.prefill(pp, {"tokens": torch.from_numpy(tok)},
                          {k: v[:, row:row + 1] for k, v in pcache.items()})
        nxt = tokens(cfg, 2, 4, seed=12)
        for i in range(4):
            pos = np.array([lens[0] + i, lens[1] + i])
            rl, rcache = rb.decode(rp, jnp.asarray(nxt[:, i:i + 1]), rcache,
                                   jnp.asarray(pos, jnp.int32), total)
            with torch.no_grad():
                pl, pcache = b.decode(pp, torch.from_numpy(nxt[:, i:i + 1]),
                                      pcache, torch.from_numpy(pos), total)
            scaled_close(pl, rl)
        close(pcache["k"], rcache["k"])


# ---------------------------------------------------------------------------
# serving and checkpoints
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
