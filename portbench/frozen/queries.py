"""The noisy-query law of ``repro_torch/data/queries.py`` (the paper's
§4.1 Queries, after Zoumpatianos et al.), drawn batch by batch on the
collection's device.

Query j is a row of the collection, drawn uniformly, plus
N(0, (level * std)^2) noise per point, where std is the collection's
and level = levels[j % len(levels)]. A stream is a pure function of its
generator's seed and the batch size: the same seed gives the same
batches in the same order, however many are drawn.
"""

from __future__ import annotations

from typing import Sequence

import torch


class NoisyQueries:
    def __init__(self, collection: torch.Tensor, levels: Sequence[float],
                 gen: torch.Generator, scale: float):
        self.x = collection
        self.levels = torch.tensor(list(levels), dtype=torch.float32,
                                   device=collection.device)
        self.gen = gen
        self.scale = float(scale)
        self.count = 0

    def next(self, b: int) -> torch.Tensor:
        """The next [b, n] f32 batch."""
        x, dev = self.x, self.x.device
        rows = torch.randint(0, x.shape[0], (b,), generator=self.gen,
                             device=dev)
        j = self.count + torch.arange(b, device=dev)
        lvl = self.levels[j % self.levels.numel()] * self.scale
        noise = torch.randn((b, x.shape[1]), generator=self.gen,
                            device=dev, dtype=torch.float32)
        self.count += b
        return x[rows] + noise * lvl[:, None]


def collection_std(x: torch.Tensor, rows: int = 1 << 16) -> float:
    """The std of every value of the collection (numpy's ``data.std()``),
    summed in f64 block by block."""
    s = s2 = 0.0
    for i in range(0, x.shape[0], rows):
        blk = x[i:i + rows].double()
        s += float(blk.sum())
        s2 += float((blk * blk).sum())
    n = x.numel()
    mean = s / n
    return max(s2 / n - mean * mean, 0.0) ** 0.5
