"""Deterministic, resumable data pipeline: the port of
``repro/data/pipeline.py``.

Every batch is a pure function of ``(seed, step)``: a restart at step k
gets batch k again, bit for bit.  Two sources, as in the reference:

* :class:`SyntheticLM` draws from a ``torch.Generator`` seeded from
  ``(seed, step)``, with the reference's zipf-ish marginal (uniform³ toward
  low ids) and its period-7 copy motif on half the rows.  The reference
  draws with JAX's threefry, which torch cannot reproduce, so the stream
  is the reference's in law but not in value.
* :class:`TokenFileSource` draws its windows with
  ``np.random.default_rng((seed, step))``, as the reference does, so it
  gives the reference's windows exactly.

Batches are ``{"tokens": (B, T + 1) int64}`` on ``device`` (default
``cuda:0``; raises without CUDA).  The ssm family has no modality stubs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.api import resolve_device
from ..models.config import ModelConfig, ShapeConfig

#: the copy motif's period, as the reference's
PERIOD = 7


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    source: str = "synthetic"        # synthetic | file
    path: str | None = None          # token file (np.int32 binary)


class SyntheticLM:
    """Deterministic synthetic LM batches for a (cfg, shape) cell."""

    def __init__(self, dc: DataConfig, cfg: ModelConfig, seq_len: int,
                 global_batch: int, device=None):
        self.dc, self.cfg = dc, cfg
        self.seq_len, self.global_batch = seq_len, global_batch
        self.device = resolve_device(device)

    def batch_at(self, step: int) -> dict:
        seed = int(np.random.SeedSequence((self.dc.seed, step))
                   .generate_state(1, np.uint64)[0])
        gen = torch.Generator().manual_seed(seed)
        b, t, v = self.global_batch, self.seq_len, self.cfg.vocab
        u = torch.rand((b, t + 1), generator=gen)
        toks = (u ** 3 * (v - 1)).long()
        reps = toks[:, :PERIOD].repeat(1, (t + 1) // PERIOD + 1)[:, :t + 1]
        mix = torch.rand((b, 1), generator=gen) < 0.5
        toks = torch.where(mix, reps, toks)
        return {"tokens": toks.to(self.device)}


class TokenFileSource:
    """Memory-mapped token corpus; window sampling is (seed, step)-pure."""

    def __init__(self, dc: DataConfig, cfg: ModelConfig, seq_len: int,
                 global_batch: int, device=None):
        if not dc.path:
            raise ValueError("TokenFileSource needs DataConfig.path")
        self.tokens = np.memmap(dc.path, dtype=np.int32, mode="r")
        self.dc, self.cfg = dc, cfg
        self.seq_len, self.global_batch = seq_len, global_batch
        self.device = resolve_device(device)

    def batch_at(self, step: int) -> dict:
        n = len(self.tokens) - (self.seq_len + 1)
        rng = np.random.default_rng((self.dc.seed, step))
        starts = rng.integers(0, n, size=self.global_batch)
        toks = np.stack([self.tokens[s: s + self.seq_len + 1] for s in starts])
        return {"tokens": torch.from_numpy(
            (toks % self.cfg.vocab).astype(np.int64)).to(self.device)}


def make_source(dc: DataConfig, cfg: ModelConfig, shape: ShapeConfig,
                device=None):
    cls = TokenFileSource if dc.source == "file" else SyntheticLM
    return cls(dc, cfg, shape.seq_len, shape.global_batch, device=device)
