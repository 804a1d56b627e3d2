"""What the drivers share: the device's clock and memory, and a sample of
the window's results drawn from the seed."""

from __future__ import annotations

import random

import torch


def is_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def sync(device) -> None:
    if is_cuda(device):
        torch.cuda.synchronize(device)


def peak(device, reset: bool = False) -> int:
    """The device's peak of allocated bytes since the last reset (0 on the
    CPU); ``reset`` starts a new one after reading."""
    if not is_cuda(device):
        return 0
    torch.cuda.synchronize(device)
    got = torch.cuda.max_memory_allocated(device)
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
    return got


def empty_cache(device) -> None:
    if is_cuda(device):
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


class Reservoir:
    """A uniform sample of ``size`` items of a stream of unknown length,
    drawn by ``rng`` (Algorithm R)."""

    def __init__(self, size: int, rng: random.Random):
        self.size, self.rng = size, rng
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.items[j] = item
        self.seen += 1
