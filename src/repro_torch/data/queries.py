"""Query workloads (paper §4.1 Queries, after Zoumpatianos et al.).

Queries are series drawn from the collection with additive Gaussian
noise of growing size, cycling through difficulty levels (the same
numbers as the JAX package's ``repro.data.queries.noisy_queries``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def noisy_queries(data: np.ndarray, n_queries: int,
                  noise_levels: Sequence[float] = (0.0, 0.01, 0.05, 0.1,
                                                   0.25),
                  seed: int = 7) -> np.ndarray:
    """[n_queries, n] f32; query i takes noise level i % len(levels)."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(data.shape[0], n_queries, replace=False)
    q = data[idx].copy()
    scale = data.std()
    for i in range(n_queries):
        lvl = noise_levels[i % len(noise_levels)]
        q[i] += rng.normal(0, lvl * scale, data.shape[1]).astype(
            np.float32)
    return q.astype(np.float32)
