"""Port parity for the model stack of the falcon-mamba serving path.

The port's configs, Mamba-1 layer and LM entry points are held against
``repro.models`` at SMOKE size (``falcon_mamba_7b.SMOKE``: 2 layers,
d_model 64, d_inner 128, N = 16, fp32).  The reference's parameters come
from its own ``init_params`` and reach the port through
``params_from_jax``, so both compute with the same weights on the same
numpy tokens.  Tolerance: 1e-4 absolute on activations and logits (|logits|
are of order 1-10).  The two differ only in the order of fp32 sums: the
reference scans in chunks of 16 (exp of cumulative sums), the port by the
step recurrence; XLA and PyTorch also sum the matmuls in different orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as R_configs
from repro.models import lm as R_lm
from repro.models import ssm as R_ssm
from repro.models.config import ModelConfig as R_ModelConfig
from repro_torch import configs
from repro_torch.models import build, lm, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax
from torch_parity import to_np

ATOL = 1e-4
SMOKE = configs.get_smoke("falcon-mamba-7b")
R_SMOKE = R_configs.get_smoke("falcon-mamba-7b")


@pytest.fixture(scope="module")
def ref_params():
    return jax.tree.map(np.asarray,
                        R_lm.init_params(jax.random.PRNGKey(0), R_SMOKE))


@pytest.fixture(scope="module")
def port_params(ref_params):
    return params_from_jax(ref_params, SMOKE, device="cpu")


def tokens(b, t, seed=0):
    return np.random.default_rng(seed).integers(0, SMOKE.vocab, (b, t))


def layer0(tree):
    return jax.tree.map(lambda v: jnp.asarray(v[0]), tree["layers"]["ssm"])


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=0, atol=atol)


class TestConfigs:
    @pytest.mark.parametrize("get", ["get", "get_smoke"])
    def test_falcon_mamba_matches_reference(self, get):
        mine = getattr(configs, get)("falcon-mamba-7b")
        ref = getattr(R_configs, get)("falcon-mamba-7b")
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert configs.get(configs.canonical("falcon-mamba-7b")) == \
            configs.get("falcon_mamba_7b")

    @pytest.mark.parametrize("arch", R_configs.ARCHS)
    def test_config_copy_derives_as_the_reference(self, arch):
        """The port's ModelConfig copy, given each reference config's
        fields, derives the same sizes, layer patterns and parameter count."""
        ref = R_configs.get(arch)
        mine = ModelConfig(**dataclasses.asdict(ref))
        assert [f.name for f in dataclasses.fields(ModelConfig)] == \
            [f.name for f in dataclasses.fields(R_ModelConfig)]
        for attr in ("hd", "vocab_padded", "d_inner", "ssm_heads",
                     "is_encdec"):
            assert getattr(mine, attr) == getattr(ref, attr), attr
        assert mine.layer_kinds() == ref.layer_kinds()
        assert mine.shared_attn_sites() == ref.shared_attn_sites()
        assert mine.param_count() == ref.param_count()

    def test_unported_architectures_raise(self):
        """The family still to port (encdec: seamless-m4t-medium) raises,
        naming ROADMAP.md, through the configs and the model entry points."""
        for arch in ("seamless-m4t-medium",):
            with pytest.raises(NotImplementedError, match="ROADMAP.md"):
                configs.get(arch)
            with pytest.raises(NotImplementedError, match="ROADMAP.md"):
                configs.get_smoke(arch)
        with pytest.raises(ValueError, match="unknown"):
            configs.get("no-such-model")
        for arch in ("seamless-m4t-medium",):
            cfg = ModelConfig(**dataclasses.asdict(R_configs.get_smoke(arch)))
            with pytest.raises(NotImplementedError, match="ROADMAP.md"):
                build(cfg)
            with pytest.raises(NotImplementedError, match="ROADMAP.md"):
                lm.init_cache(cfg, 1, 8)


class TestParams:
    def test_init_shapes_match_reference(self, ref_params):
        mine = lm.init_params(torch.Generator().manual_seed(0), SMOKE)
        assert tuple(mine.embed.shape) == ref_params["embed"].shape
        assert tuple(mine.lm_head.shape) == ref_params["lm_head"].shape
        assert len(mine.layers) == SMOKE.n_layers
        for k, v in ref_params["layers"]["ssm"].items():
            for block in mine.layers:
                assert tuple(block.ssm[k].shape) == v.shape[1:], k
                assert str(block.ssm[k].dtype) == f"torch.{v.dtype}", k
        total = sum(p.numel() for p in mine.parameters())
        assert total == sum(v.size for v in jax.tree.leaves(ref_params))
        assert not any(p.requires_grad for p in mine.parameters())

    def test_params_from_jax_splits_the_layer_axis(self, ref_params,
                                                   port_params):
        for i, block in enumerate(port_params.layers):
            for k, v in ref_params["layers"]["ssm"].items():
                np.testing.assert_array_equal(to_np(block.ssm[k]), v[i])
            np.testing.assert_array_equal(
                to_np(block.norm_ssm["scale"]),
                ref_params["layers"]["norm_ssm"]["scale"][i])
        np.testing.assert_array_equal(to_np(port_params.lm_head),
                                      ref_params["lm_head"])

    def test_params_from_jax_rejects_a_wrong_depth(self, ref_params):
        with pytest.raises(ValueError, match="layers"):
            params_from_jax(ref_params, SMOKE.with_(n_layers=3), device="cpu")


class TestDevices:
    """The model entry points default to the card, as ``plan()`` and
    ``bundle.init`` do, and never fall back to the CPU."""

    def test_default_device_raises_without_cuda(self, ref_params):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default device works")
        with pytest.raises(RuntimeError, match="CUDA"):
            params_from_jax(ref_params, SMOKE)
        with pytest.raises(RuntimeError, match="CUDA"):
            lm.init_cache(SMOKE, 2, 16)
        with pytest.raises(RuntimeError, match="CUDA"):
            build(SMOKE).init_cache(2, 16)

    def test_cpu_on_request(self, ref_params):
        built = params_from_jax(ref_params, SMOKE, device="cpu")
        assert {p.device.type for p in built.parameters()} == {"cpu"}
        for cache in (lm.init_cache(SMOKE, 2, 16, device="cpu"),
                      build(SMOKE).init_cache(2, 16, device="cpu")):
            assert {v.device.type for v in cache.values()} == {"cpu"}


class TestMamba1Layer:
    def test_without_cache(self, ref_params, port_params):
        h = np.random.default_rng(1).standard_normal((2, 19, 64)).astype(
            np.float32)
        out, c = ssm.mamba1_apply(port_params.layers[0].ssm,
                                  torch.from_numpy(h), SMOKE)
        ref, rc = R_ssm.mamba1_apply(layer0(ref_params), jnp.asarray(h),
                                     R_SMOKE)
        assert c is None and rc is None
        close(out, ref)

    @pytest.mark.parametrize("t", [1, 23])
    def test_with_cache(self, ref_params, port_params, t):
        """From a nonzero cached state: the decode branch at T = 1, the
        prefill branch above it."""
        r = np.random.default_rng(2)
        h = r.standard_normal((2, t, 64)).astype(np.float32)
        cache = {"conv": r.standard_normal((2, 3, 128)).astype(np.float32),
                 "ssm": r.standard_normal((2, 128, 16)).astype(np.float32)}
        out, c = ssm.mamba1_apply(
            port_params.layers[0].ssm, torch.from_numpy(h), SMOKE,
            cache={k: torch.from_numpy(v) for k, v in cache.items()})
        ref, rc = R_ssm.mamba1_apply(
            layer0(ref_params), jnp.asarray(h), R_SMOKE,
            cache={k: jnp.asarray(v) for k, v in cache.items()})
        close(out, ref)
        close(c["conv"], rc["conv"])
        close(c["ssm"], rc["ssm"])

    def test_causal_conv(self):
        r = np.random.default_rng(3)
        x, w, b, state = (r.standard_normal(s).astype(np.float32)
                          for s in ((2, 9, 5), (4, 5), (5,), (2, 3, 5)))
        for st in (None, state):
            got = ssm._causal_conv(*map(torch.from_numpy, (x, w, b)),
                                   None if st is None else
                                   torch.from_numpy(st))
            want = R_ssm._causal_conv(*map(jnp.asarray, (x, w, b)),
                                      None if st is None else jnp.asarray(st))
            close(got[0], want[0], 1e-6)
            close(got[1], want[1], 0)
            # the state owns its 3 rows only: a view would keep the whole
            # padded input alive in the cache (8.6 GB at an 8191-token prompt)
            st_nbytes = got[1].numel() * got[1].element_size()
            assert got[1].untyped_storage().nbytes() == st_nbytes


class TestLM:
    def test_forward_hidden(self, ref_params, port_params):
        tok = tokens(2, 21)
        h, c, aux = lm.forward_hidden(port_params, SMOKE, torch.from_numpy(tok))
        rh, rc, raux = R_lm.forward_hidden(ref_params, R_SMOKE,
                                           jnp.asarray(tok))
        assert c is None and rc is None and float(aux) == float(raux) == 0
        close(h, rh)
        close(lm.logits_from_hidden(port_params, SMOKE, h),
              R_lm.logits_from_hidden(ref_params, R_SMOKE, rh))

    def test_init_cache(self):
        mine = lm.init_cache(SMOKE, 3, 40, device="cpu")
        ref = R_lm.init_cache(R_SMOKE, 3, 40)
        assert set(mine) == set(ref)
        for k in ref:
            assert tuple(mine[k].shape) == ref[k].shape
            assert str(mine[k].dtype) == f"torch.{ref[k].dtype}"
            assert not mine[k].any()
        assert lm.cache_len(SMOKE, 40) == R_lm.cache_len(R_SMOKE, 40) == 0

    def test_prefill_then_decode(self, ref_params, port_params):
        """Prefill a batch of prompts, then three decode steps feeding the
        greedy token: logits and caches agree at every step."""
        tok = tokens(2, 13, seed=4)
        cache = lm.init_cache(SMOKE, 2, 32, device="cpu")
        rcache = R_lm.init_cache(R_SMOKE, 2, 32)
        logits, cache = lm.prefill(port_params, SMOKE, torch.from_numpy(tok),
                                   cache)
        rlogits, rcache = R_lm.prefill(ref_params, R_SMOKE, jnp.asarray(tok),
                                       rcache)
        assert tuple(logits.shape) == (2, 1, SMOKE.vocab_padded)
        assert logits.dtype == torch.float32
        close(logits, rlogits)
        for step in range(3):
            nxt = np.array(rlogits[:, -1].argmax(-1)).reshape(2, 1)
            assert (to_np(logits[:, -1].argmax(-1)) == nxt[:, 0]).all()
            pos = np.full(2, 13 + step, np.int64)
            logits, cache = lm.decode_step(port_params, SMOKE,
                                           torch.from_numpy(nxt), cache,
                                           torch.from_numpy(pos))
            rlogits, rcache = R_lm.decode_step(ref_params, R_SMOKE,
                                               jnp.asarray(nxt), rcache,
                                               jnp.asarray(pos))
            close(logits, rlogits)
            for k in ("conv", "ssm"):
                close(cache[k], rcache[k])

    def test_decode_continues_prefill(self, port_params):
        """The port's own state carry: prefill over a prompt plus k tokens
        gives the last logits that prefill + k decode steps give."""
        tok = torch.from_numpy(tokens(1, 17, seed=5))
        full, _ = lm.prefill(port_params, SMOKE, tok,
                             lm.init_cache(SMOKE, 1, 32, device="cpu"))
        logits, cache = lm.prefill(port_params, SMOKE, tok[:, :12],
                                   lm.init_cache(SMOKE, 1, 32, device="cpu"))
        for i in range(12, 17):
            logits, cache = lm.decode_step(port_params, SMOKE, tok[:, i:i + 1],
                                           cache, None)
        close(logits, full)

    def test_bfloat16_path(self):
        """At the full model's dtype the hidden states and the conv cache
        stay bf16 while dt, the scan, its state and the logits are fp32;
        the result stays within bf16 rounding (5% of max|logits|) of the
        reference, which rounds at other places."""
        cfg16, rcfg16 = SMOKE.with_(dtype="bfloat16"), R_SMOKE.with_(
            dtype="bfloat16")
        tree16 = jax.tree.map(np.asarray, R_lm.init_params(
            jax.random.PRNGKey(1), rcfg16))
        port16 = params_from_jax(tree16, cfg16, device="cpu")
        assert port16.layers[0].ssm["in_proj"].dtype == torch.bfloat16
        assert port16.layers[0].ssm["dt_bias"].dtype == torch.float32
        tok = tokens(2, 9, seed=6)
        cache = lm.init_cache(cfg16, 2, 16, device="cpu")
        logits, cache = lm.prefill(port16, cfg16, torch.from_numpy(tok), cache)
        rlogits, _ = R_lm.prefill(tree16, rcfg16, jnp.asarray(tok),
                                  R_lm.init_cache(rcfg16, 2, 16))
        assert logits.dtype == torch.float32
        assert cache["conv"].dtype == torch.bfloat16
        assert cache["ssm"].dtype == torch.float32
        scale = float(np.abs(np.asarray(rlogits)).max())
        close(logits, rlogits, 0.05 * scale)
