"""The paper's synthetic random-walk collections (§4.1 Datasets).

Series are cumulative sums of N(0,1) steps, z-normalized. Row i of a
dataset is a pure function of (seed, i): rows are drawn in fixed
BLOCK-aligned chunks, each seeded by (seed, block, series_len), so any
row range regenerates identically (the same numbers as the JAX
package's ``repro.data.randomwalk.generate``).
"""

from __future__ import annotations

import numpy as np

BLOCK = 1024  # fixed addressing granularity — never change


def generate(seed: int, n_series: int, series_len: int, *,
             znorm: bool = True, start: int = 0) -> np.ndarray:
    """Rows [start, start+n_series) of dataset ``seed``, f32 [N, n]."""
    if n_series == 0:
        return np.zeros((0, series_len), np.float32)
    b0 = start // BLOCK
    b1 = (start + n_series - 1) // BLOCK
    chunks = []
    for b in range(b0, b1 + 1):
        rng = np.random.default_rng((seed, b, series_len))
        chunks.append(rng.normal(size=(BLOCK, series_len))
                      .astype(np.float32))
    allb = np.concatenate(chunks, axis=0)
    ofs = start - b0 * BLOCK
    out = np.cumsum(allb[ofs:ofs + n_series], axis=1)
    if znorm:
        mu = out.mean(axis=1, keepdims=True)
        sd = out.std(axis=1, keepdims=True) + 1e-9
        out = (out - mu) / sd
    return out
