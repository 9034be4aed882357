"""Synthetic token pipeline for LM training (stateless, skip-ahead).

The port's copy of ``src/repro/data/tokens.py``. A batch is a pure
function of (seed, step): restart-safe with no replay drift, and each row
a pure function of (seed, step, row), so that a data-parallel rank draws
only its rows and they equal the same rows of the global draw. Tokens
follow the
reference's law: each position is drawn from a Zipf-like unigram (logits
``-1.2 log(rank)``), then with probability 0.5 replaced by its left
neighbour's draw (a roll by one along the sequence, so position 0 takes
the last position's), which gives the LM loss learnable structure. The
reference draws from jax keys, which torch cannot reproduce: here each
row's draws come from a ``torch.Generator`` on the host seeded by
:func:`stream_seed` of (seed, step, row), the categorical by inversion of
the unigram's f64 CDF.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

__all__ = ["batch_at_step", "stream_seed", "zipf_logits"]


def stream_seed(*ints: int) -> int:
    """A 63-bit generator seed that is a pure, well-mixed function of the
    integers (numpy's SeedSequence)."""
    a, b = np.random.SeedSequence([int(i) for i in ints]).generate_state(2)
    return ((int(a) << 32) | int(b)) & ((1 << 63) - 1)


def zipf_logits(vocab: int, alpha: float = 1.2) -> torch.Tensor:
    ranks = torch.arange(1, vocab + 1, dtype=torch.float32)
    return -alpha * torch.log(ranks)


@functools.lru_cache(maxsize=8)
def _cdf(vocab: int) -> torch.Tensor:
    return torch.cumsum(torch.softmax(zipf_logits(vocab).double(), 0), 0)


def batch_at_step(seed: int, step: int, batch: int, seq: int, vocab: int,
                  *, row_start: int = 0, row_count: int = -1
                  ) -> Dict[str, torch.Tensor]:
    """The batch of ``step`` on the host: tokens and labels [rows, seq]
    int32, the labels the tokens shifted by one. ``rows`` is ``batch``,
    or the ``row_count`` rows from ``row_start`` on (equal to those rows
    of the whole batch)."""
    rows = batch if row_count < 0 else row_count
    cdf = _cdf(vocab)
    toks = torch.empty((rows, seq + 1), dtype=torch.int32)
    for r in range(rows):
        g = torch.Generator().manual_seed(
            stream_seed(seed, step, row_start + r))
        u = torch.rand(seq + 1, generator=g, dtype=torch.float64)
        row = torch.searchsorted(cdf, u, right=True).clamp_max_(vocab - 1)
        rep = torch.rand(seq + 1, generator=g) < 0.5
        toks[r] = torch.where(rep, torch.roll(row, 1), row)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
