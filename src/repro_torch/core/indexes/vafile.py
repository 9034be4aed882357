"""VA+file (Ferhatosmanoglu et al.): DFT + adaptive scalar quantization.

DFT features (the paper's KLT -> DFT substitution) are computed on the
card; on the host, bits go to dimensions by variance (the "+") and each
dimension gets quantile cell edges. One cell per series is a box, so the
shared search applies with one series per leaf: the filter pass bounds
every cell and series are visited in lower-bound order. Search it with
visit_batch >> 1.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import device as device_mod

from ..histogram import DEFAULT_SEED, DistanceHistogram, build_histogram
from ..index import FrozenIndex, freeze_from_leaves
from ..summaries import dft as dft_mod

_BIG = np.float32(1e9)


def allocate_bits(variances: np.ndarray, total_bits: int,
                  min_bits: int = 1, max_bits: int = 12) -> np.ndarray:
    """Greedy water-filling: each extra bit goes to the dim with the
    largest remaining per-bit variance reduction (var / 4^bits)."""
    l = len(variances)
    bits = np.full(l, min_bits, np.int64)
    remaining = total_bits - min_bits * l
    if remaining < 0:
        raise ValueError("bit budget below minimum")
    gain = variances / (4.0 ** bits)
    for _ in range(remaining):
        j = int(np.argmax(gain))
        if bits[j] >= max_bits:
            gain[j] = -np.inf
            continue
        bits[j] += 1
        gain[j] = variances[j] / (4.0 ** bits[j])
    return bits


def build(
    data: np.ndarray,
    *,
    n_coeffs: int = 16,
    bits_per_dim: int = 8,
    hist: Optional[DistanceHistogram] = None,
    seed: int = DEFAULT_SEED,
    device=device_mod.DEFAULT,
) -> FrozenIndex:
    """Build over data [N, n] (host array); the index lives on
    ``device``. ``seed`` draws the distance histogram's sample pairs."""
    dev = device_mod.resolve(device)
    n, series_len = data.shape
    x = torch.as_tensor(np.ascontiguousarray(data, np.float32), device=dev)
    feats = dft_mod.transform(x, n_coeffs).cpu().numpy()
    variances = feats.var(axis=0) + 1e-12
    bits = allocate_bits(variances, bits_per_dim * n_coeffs)

    box_lo = np.zeros((n, n_coeffs), np.float32)
    box_hi = np.zeros((n, n_coeffs), np.float32)
    for d in range(n_coeffs):
        k = 1 << int(bits[d])
        qs = np.linspace(0.0, 1.0, k + 1)
        edges = np.quantile(feats[:, d], qs).astype(np.float32)
        edges = np.maximum.accumulate(edges)  # monotone under ties
        edges[0], edges[-1] = -_BIG, _BIG
        code = np.clip(np.searchsorted(edges, feats[:, d], side="right")
                       - 1, 0, k - 1)
        box_lo[:, d] = edges[code]
        box_hi[:, d] = edges[code + 1]

    if hist is None:
        sample = data[np.random.default_rng(0).choice(
            n, min(n, 100_000), replace=False)]
        hist = build_histogram(sample, seed, device=dev)
    leaves = [np.array([i]) for i in range(n)]
    return freeze_from_leaves(
        x, leaves, box_lo, box_hi, dft_mod.weights(n_coeffs), hist,
        kind="va+file", summary="dft",
        n_summary=n_coeffs)
