"""DFT features for the VA+file (the paper's KLT -> DFT substitution).

With the orthonormal rFFT of a real series (n even), the layout
[c0, sqrt2*re_1, sqrt2*im_1, sqrt2*re_2, ..., c_{n/2}] is an isometry,
so its first l features lower-bound the distance (Parseval).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def transform(x: torch.Tensor, n_coeffs: int) -> torch.Tensor:
    """[N, n] -> [N, l] energy-preserving DFT features (f32)."""
    n = x.shape[-1]
    c = torch.fft.rfft(x.float(), dim=-1, norm="ortho")
    nyq = n // 2
    parts = [c[..., :1].real]
    re = c[..., 1:nyq].real * math.sqrt(2.0)
    im = c[..., 1:nyq].imag * math.sqrt(2.0)
    parts.append(torch.stack([re, im], -1).reshape(x.shape[:-1] + (-1,)))
    if n % 2 == 0:
        parts.append(c[..., nyq:nyq + 1].real)
    return torch.cat(parts, -1)[..., :n_coeffs].contiguous()


def weights(n_coeffs: int) -> np.ndarray:
    """DFT features are isometric: unit weights."""
    return np.ones(n_coeffs, np.float32)
