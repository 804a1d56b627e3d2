"""The benchmark's inputs, made on the device from the run's seed.

Plain ``torch``: nothing here imports the program.  Every stream of random
numbers comes from its own ``torch.Generator``, seeded from the run's seed
and the stream's tags, so the same seed gives the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch


def stream_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream of a run, hashed from any whole-number
    ``seed`` and the stream's non-negative ``tags``."""
    entropy = [abs(int(seed)), int(seed < 0), *(int(t) for t in tags)]
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)
    return int(state[0]) >> 1


def generator(device, seed: int, *tags: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, *tags))


def mode_product(x: torch.Tensor, u: torch.Tensor, n: int) -> torch.Tensor:
    """``x ×_n u``: mode ``n`` of ``x`` (size J) contracted with ``u`` (I, J)."""
    y = torch.tensordot(x, u, dims=([n], [1]))          # (..., I) at the end
    return y if n == x.ndim - 1 else y.movedim(-1, n).contiguous()


def lowrank(shape, ranks, gen: torch.Generator, noise: float = 0.01,
            device=None) -> torch.Tensor:
    """A tensor of multilinear rank ``ranks`` (a Gaussian core, orthonormal
    factors) plus Gaussian noise at ``noise`` times its norm, fp32, made on
    ``gen``'s device."""
    device = gen.device if device is None else device
    x = torch.randn(tuple(ranks), generator=gen, device=device)
    for n, (i, r) in enumerate(zip(shape, ranks)):
        u = torch.linalg.qr(torch.randn((i, r), generator=gen,
                                        device=device))[0]
        x = mode_product(x, u, n)
    e = torch.randn(tuple(shape), generator=gen, device=device)
    x.add_(e, alpha=noise * float(x.norm() / e.norm()))
    return x
