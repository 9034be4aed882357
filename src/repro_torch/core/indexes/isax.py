"""iSAX2+ index (Camerra et al.): summaries on the card, tree on the host.

The build computes PAA summaries of the whole collection with the paa
kernel and SAX codes at base cardinality 2^bits, then grows the tree on
the host: a node holding more than leaf_cap series deepens ONE segment
by one bit, the segment whose split is most balanced. Leaves become
summary-space boxes: segment i at prefix length p covers the PAA
interval between the breakpoints of its prefix (the MINDIST region).

``tighten=True`` shrinks boxes to the min/max PAA of their members:
still a valid bound, and tighter.
"""

from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np
import torch

from repro_torch import device as device_mod

from ..histogram import DEFAULT_SEED, DistanceHistogram, build_histogram
from ..index import FrozenIndex, freeze_from_leaves
from ..summaries import paa as paa_mod
from ..summaries import sax as sax_mod


def build(
    data: np.ndarray,
    *,
    n_segments: int = 16,
    bits: int = 8,
    leaf_cap: int = 512,
    tighten: bool = False,
    hist: Optional[DistanceHistogram] = None,
    seed: int = DEFAULT_SEED,
    device=device_mod.DEFAULT,
) -> FrozenIndex:
    """Build over data [N, n] (host array); the index lives on
    ``device``. ``seed`` draws the distance histogram's sample pairs."""
    dev = device_mod.resolve(device)
    n, series_len = data.shape
    x = torch.as_tensor(np.ascontiguousarray(data, np.float32), device=dev)
    paa_np = paa_mod.transform(x, n_segments).cpu().numpy()
    breaks = sax_mod.breakpoints(1 << bits)
    codes = np.searchsorted(breaks, paa_np).astype(np.int32)  # [N, l]

    leaves: List[np.ndarray] = []
    leaf_prefix: List[np.ndarray] = []
    leaf_codes: List[np.ndarray] = []

    def split(members: np.ndarray, prefix_bits: np.ndarray,
              word: np.ndarray):
        if len(members) <= leaf_cap or prefix_bits.min() >= bits:
            leaves.append(members)
            leaf_prefix.append(prefix_bits.copy())
            leaf_codes.append(word.copy())
            return
        # candidate segments: those not yet at full cardinality
        best_seg, best_imb = -1, None
        mcodes = codes[members]
        for seg in range(n_segments):
            p = prefix_bits[seg]
            if p >= bits:
                continue
            bit = (mcodes[:, seg] >> (bits - p - 1)) & 1
            left = int((bit == 0).sum())
            imb = abs(2 * left - len(members))
            if best_imb is None or imb < best_imb:
                best_seg, best_imb = seg, imb
        seg = best_seg
        p = prefix_bits[seg]
        bit = (mcodes[:, seg] >> (bits - p - 1)) & 1
        for side in (0, 1):
            sub = members[bit == side]
            if len(sub) == 0:
                continue
            nb = prefix_bits.copy()
            nb[seg] = p + 1
            nw = word.copy()
            nw[seg] = (word[seg] << 1) | side
            split(sub, nb, nw)

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        split(np.arange(n), np.zeros(n_segments, np.int64),
              np.zeros(n_segments, np.int64))
    finally:
        sys.setrecursionlimit(old_limit)

    L = len(leaves)
    box_lo = np.zeros((L, n_segments), np.float32)
    box_hi = np.zeros((L, n_segments), np.float32)
    pb = sax_mod.padded_breakpoints(1 << bits)
    for li in range(L):
        shift = bits - leaf_prefix[li]
        lo_sym = leaf_codes[li] << shift
        box_lo[li] = pb[lo_sym]
        box_hi[li] = pb[lo_sym + (1 << shift)]
        if tighten:
            mem = paa_np[leaves[li]]
            box_lo[li] = np.maximum(box_lo[li], mem.min(axis=0))
            box_hi[li] = np.minimum(box_hi[li], mem.max(axis=0))
    if hist is None:
        sample = data[np.random.default_rng(0).choice(
            n, min(n, 100_000), replace=False)]
        hist = build_histogram(sample, seed, device=dev)
    return freeze_from_leaves(
        x, leaves, box_lo, box_hi, paa_mod.weights(series_len, n_segments),
        hist, kind="isax2+", summary="paa",
        n_summary=n_segments)
