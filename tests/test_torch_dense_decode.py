"""Port parity for the dense LM family's KV cache against ``repro.models``
at the SMOKE presets of gemma2-9b, gemma3-1b, phi3-mini-3.8b and
minitron-4b: the registry's prefill and decode at per-slot positions, on a
linear cache and on a ring (gemma2's and gemma3's windowed SMOKE made
all-local).  Tolerances as in ``test_torch_dense.py``.
"""

import jax.numpy as jnp
import numpy as np
import torch
from lm_parity import close, model_fixture, scaled_close, tokens

from repro.models import registry as R_registry
from repro_torch.models import build, lm

ARCHS = ("gemma2-9b", "gemma3-1b", "phi3-mini-3.8b", "minitron-4b")

model = model_fixture(ARCHS)
# a windowed SMOKE made all-local (local_global_pattern (1, 0)), whose cache
# is its window: a ring buffer written at pos % S_c
ring_model = model_fixture(("gemma2-9b", "gemma3-1b"), name="ring_model",
                           local_global_pattern=(1, 0))


class TestModel:
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
