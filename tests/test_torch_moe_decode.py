"""Port parity for the MoE family's KV cache against ``repro.models`` at
the SMOKE presets of granite-moe-3b-a800m and mixtral-8x22b (whose window
of 16 makes a longer context run on a ring cache): the registry's prefill,
then decode with rows at their own positions.  Tolerances as in
``test_torch_moe.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from lm_parity import close, model_fixture, scaled_close, tokens

from repro.models import registry as R_registry
from repro_torch.models import build, lm, moe

ARCHS = ("granite-moe-3b-a800m", "mixtral-8x22b")

model = model_fixture(ARCHS)


class TestModel:
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
