"""Piecewise Aggregate Approximation (Keogh et al.).

Lower-bounding contract: (n/l) * ||paa(Q) - paa(S)||^2 <= ||Q - S||^2.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops


def transform(x: torch.Tensor, n_segments: int) -> torch.Tensor:
    """[.., n] -> [.., l] segment means (f32), through the paa kernel."""
    if x.dim() == 1:
        return ops.paa(x[None].contiguous(), n_segments)[0]
    return ops.paa(x.contiguous(), n_segments)


def weights(series_len: int, n_segments: int) -> np.ndarray:
    """Per-dim weight of the box lower bound: segment width n/l."""
    return np.full(n_segments, series_len / n_segments, np.float32)
