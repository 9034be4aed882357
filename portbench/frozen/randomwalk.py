"""The paper's random-walk collection (§4.1, "Rand"), drawn on a device.

Each series is the cumulative sum of N(0, 1) steps, z-normalized per
series (population std, plus 1e-9), the law of
``repro_torch/data/randomwalk.py``. The draw is one ``torch.randn`` from
the caller's generator, so the same seed on the same device gives the
same collection; the numbers differ from the numpy generator's.
"""

from __future__ import annotations

import torch


def generate(n_series: int, series_len: int,
             gen: torch.Generator) -> torch.Tensor:
    """[n_series, series_len] f32 on ``gen``'s device."""
    x = torch.randn((n_series, series_len), generator=gen,
                    device=gen.device, dtype=torch.float32)
    x.cumsum_(1)
    mu = x.mean(1, keepdim=True)
    sd = x.std(1, unbiased=False, keepdim=True) + 1e-9
    return x.sub_(mu).div_(sd)
