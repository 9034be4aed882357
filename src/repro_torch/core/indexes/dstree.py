"""DSTree (Wang et al.): EAPCA summaries on the card, tree on the host.

Every node summarizes its population per segment by (mean, std) ranges;
the lower bound is the weighted box distance over the 2l dims. As in the
JAX package, the segmentation stays fixed and a node splits on the
(segment, statistic) with the largest spread, at the population median.
Leaf boxes are the members' min/max ranges.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch import device as device_mod

from ..histogram import DEFAULT_SEED, DistanceHistogram, build_histogram
from ..index import FrozenIndex, freeze_from_leaves
from ..summaries import eapca as eapca_mod


def build(
    data: np.ndarray,
    *,
    n_segments: int = 8,
    leaf_cap: int = 512,
    hist: Optional[DistanceHistogram] = None,
    seed: int = DEFAULT_SEED,
    device=device_mod.DEFAULT,
) -> FrozenIndex:
    """Build over data [N, n] (host array); the index lives on
    ``device``. ``seed`` draws the distance histogram's sample pairs."""
    dev = device_mod.resolve(device)
    n, series_len = data.shape
    x = torch.as_tensor(np.ascontiguousarray(data, np.float32), device=dev)
    summ = eapca_mod.transform(x, n_segments).cpu().numpy()
    d2 = 2 * n_segments

    leaves: List[np.ndarray] = []
    stack = [np.arange(n)]
    while stack:
        members = stack.pop()
        if len(members) <= leaf_cap:
            leaves.append(members)
            continue
        s = summ[members]
        spread = s.max(axis=0) - s.min(axis=0)
        dim = int(np.argmax(spread))
        med = np.median(s[:, dim])
        left = s[:, dim] <= med
        # degenerate split (all equal): fall back to halving
        if left.all() or (~left).all():
            half = len(members) // 2
            stack.append(members[:half])
            stack.append(members[half:])
            continue
        stack.append(members[left])
        stack.append(members[~left])

    L = len(leaves)
    box_lo = np.zeros((L, d2), np.float32)
    box_hi = np.zeros((L, d2), np.float32)
    for li, mem in enumerate(leaves):
        s = summ[mem]
        box_lo[li] = s.min(axis=0)
        box_hi[li] = s.max(axis=0)
    if hist is None:
        sample = data[np.random.default_rng(0).choice(
            n, min(n, 100_000), replace=False)]
        hist = build_histogram(sample, seed, device=dev)
    return freeze_from_leaves(
        x, leaves, box_lo, box_hi, eapca_mod.weights(series_len, n_segments),
        hist, kind="dstree", summary="eapca",
        n_summary=n_segments)
