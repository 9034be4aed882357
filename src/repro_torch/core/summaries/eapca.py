"""Extended APCA summaries for the DSTree (Wang et al.).

Each segment of width w is summarized by (mean, population std); the
DSTree's node bound is the weighted box distance over the 2l dims
[mean_1..mean_l, std_1..std_l] with weight w per dim.

The sums follow the JAX package's CPU arithmetic, so DSTree builds agree
bit for bit: a mean adds left to right and scales by the float32
reciprocal of the width; a variance accumulates each squared deviation
with one rounding (a fused multiply-add) and divides by the width; the
square root is rounded once from float64 (torch's vectorized float32
square root on the CPU is not correctly rounded).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ref import inv_width, seq_sum


def transform(x: torch.Tensor, n_segments: int) -> torch.Tensor:
    """[N, n] -> [N, 2l]: concat(segment means, segment stds), f32."""
    n = x.shape[-1]
    w = n // n_segments
    inv = inv_width(n, n_segments)
    seg = x.reshape(x.shape[:-1] + (n_segments, w)).float()
    mean = seq_sum(seg) * inv
    c = (seg - mean[..., None]).double()
    acc = torch.zeros_like(mean)
    for i in range(w):
        acc = (c[..., i] * c[..., i] + acc.double()).float()
    std = torch.sqrt((acc / w).double()).float()
    return torch.cat([mean, std], -1)


def weights(series_len: int, n_segments: int) -> np.ndarray:
    return np.full(2 * n_segments, series_len / n_segments, np.float32)
