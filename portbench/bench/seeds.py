"""Every random stream of a run comes from ``--seed``: stream 0 draws the
collection, 1 the timed queries, 2 the warm-up queries. Each is a
``torch.Generator`` on the run's device, so a seed gives the same data
and queries on every run on that device."""

from __future__ import annotations

import torch

COLLECTION, QUERIES, WARMUP = 0, 1, 2


def stream(seed: int, which: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed * 4 + which)
