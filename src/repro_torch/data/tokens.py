"""Synthetic token pipeline for LM training (stateless, skip-ahead).

The port's copy of ``src/repro/data/tokens.py``. A batch is a pure
function of (seed, step, row_start): restart-safe with no replay drift,
and a data-parallel group can draw only its rows. Tokens follow the
reference's law: each position is drawn from a Zipf-like unigram (logits
``-1.2 log(rank)``), then with probability 0.5 replaced by its left
neighbour's draw (a roll by one along the sequence, so position 0 takes
the last position's), which gives the LM loss learnable structure. The
reference draws from jax keys, which torch cannot reproduce: here the
draws come from a ``torch.Generator`` on the host seeded by
:func:`stream_seed` of (seed, step, row_start), the categorical by
inversion of the unigram's f64 CDF.
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
    or ``row_count`` rows drawn for ``row_start``."""
    rows = batch if row_count < 0 else row_count
    g = torch.Generator().manual_seed(stream_seed(seed, step, row_start))
    u = torch.rand((rows, seq + 1), generator=g, dtype=torch.float64)
    toks = torch.searchsorted(_cdf(vocab), u, right=True).clamp_max_(
        vocab - 1)
    rep = torch.rand((rows, seq + 1), generator=g) < 0.5
    toks = torch.where(rep, torch.roll(toks, 1, dims=1), toks).to(
        torch.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
