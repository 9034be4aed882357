"""Distance distribution F(.) and the r_delta stopping radius.

After Ciaccia & Patella as the paper does (§3.2.3): estimate F from
random pairs of a sample, then

    r_delta = F^{-1}(1 - delta^(1/N))

under the independence approximation P[B(Q, r) empty] = (1 - F(r))^N.
The sample is drawn with numpy from an integer seed; the JAX package
draws that integer from a jax key, and :data:`DEFAULT_SEED` is the one
it draws from ``PRNGKey(0)``, its builders' default.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

DEFAULT_SEED = 31327077


class DistanceHistogram(NamedTuple):
    edges: torch.Tensor  # [n_bins+1] ascending distance values, f32
    cdf: torch.Tensor    # [n_bins+1] F(edges), cdf[0]=0, cdf[-1]=1


def build_histogram(data: np.ndarray, seed: int = DEFAULT_SEED,
                    n_pairs: int = 100_000, n_bins: int = 512, *,
                    device) -> DistanceHistogram:
    """Empirical F from random pairs of the sample (paper: 100K), as
    tensors on ``device`` (required: the builds pass their own)."""
    n = data.shape[0]
    rng = np.random.default_rng(int(seed))
    i = rng.integers(0, n, n_pairs)
    j = rng.integers(0, n, n_pairs)
    keep = i != j
    d = np.linalg.norm(data[i[keep]] - data[j[keep]], axis=1)
    qs = np.linspace(0.0, 1.0, n_bins + 1)
    edges = np.quantile(d, qs)
    edges[0] = 0.0
    return DistanceHistogram(
        edges=torch.as_tensor(edges, dtype=torch.float32, device=device),
        cdf=torch.as_tensor(qs, dtype=torch.float32, device=device))


def _fma(a, b, c):
    """f32 a*b + c rounded once (the product is exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor,
           left=None, right=None) -> torch.Tensor:
    """Piecewise-linear interpolation with the arithmetic of
    ``jnp.interp`` on its CPU backend, whose compiler fuses the final
    multiply-add into one rounding."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1,
                    xp.numel() - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = dx.abs() <= np.spacing(np.finfo(np.float32).eps)
    f = _fma(delta / torch.where(dx0, 1.0, dx), df, fp[i - 1])
    f = torch.where(dx0, fp[i - 1], f)
    f = torch.where(x < xp[0], fp[0] if left is None else left, f)
    return torch.where(x > xp[-1], fp[-1] if right is None else right, f)


def f_of(hist: DistanceHistogram, r: torch.Tensor) -> torch.Tensor:
    """F(r) by linear interpolation."""
    return interp(r, hist.edges, hist.cdf, left=0.0, right=1.0)


def f_inverse(hist: DistanceHistogram, p: torch.Tensor) -> torch.Tensor:
    """F^{-1}(p) by inverse interpolation."""
    return interp(p, hist.cdf, hist.edges)


def r_delta(hist: DistanceHistogram, delta: float, n_total: int
            ) -> torch.Tensor:
    """The paper's delta radius (f32 scalar). delta=1 -> 0: no early
    stop, Algorithm 2 degenerates to epsilon-approximate."""
    d = torch.tensor(delta, dtype=torch.float32, device=hist.edges.device)
    p = 1.0 - torch.pow(torch.clamp_min(d, 1e-30), 1.0 / float(n_total))
    r = f_inverse(hist, p.reshape(1))[0]
    return torch.where(d >= 1.0, 0.0, r)
