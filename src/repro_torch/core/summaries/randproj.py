"""Gaussian random projections (SRS, Sun et al.).

Counterpart of ``src/repro/core/summaries/randproj.py``. 2-stable
projections: for w_i ~ N(0, I_n), <u, w_i> ~ N(0, ||u||^2), so
||proj(u)||^2 / ||u||^2 ~ chi^2_m. SRS's early-termination test uses the
chi^2 CDF psi_m, the regularized lower incomplete gamma
(``torch.special.gammainc``). The reference draws the matrix from a jax
key; here it comes from a ``torch.Generator`` (or an integer seed for
one), or is given as a matrix, so a test that needs the reference's
projection passes it in.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from repro_torch import device as device_mod

# an integer seed, a generator, or the [n, m] matrix itself
Seed = Union[int, torch.Generator, np.ndarray, torch.Tensor]


def make_projection(seed: Seed, series_len: int, m: int,
                    device=device_mod.DEFAULT) -> torch.Tensor:
    """[n, m] Gaussian matrix (unscaled, 2-stable) on ``device`` (the
    card unless asked for the CPU): drawn on the host from an integer
    seed or a generator, or the given matrix."""
    dev = device_mod.resolve(device)
    if isinstance(seed, (np.ndarray, torch.Tensor)):
        w = seed.float() if isinstance(seed, torch.Tensor) \
            else torch.tensor(np.asarray(seed), dtype=torch.float32)
        if tuple(w.shape) != (series_len, m):
            raise ValueError(f"projection of shape {tuple(w.shape)}, "
                             f"expected {(series_len, m)}")
        return w.to(dev)
    g = seed if isinstance(seed, torch.Generator) \
        else torch.Generator().manual_seed(int(seed))
    w = torch.randn((series_len, m), generator=g, dtype=torch.float32,
                    device=g.device)
    return w.to(dev)


def transform(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.float() @ w


def psi(m: int, x: torch.Tensor) -> torch.Tensor:
    """chi^2_m CDF."""
    return torch.special.gammainc(
        torch.full_like(x, m / 2.0), torch.clamp_min(x, 0.0) / 2.0)
