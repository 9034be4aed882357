"""The paper's accuracy measures (§4.1: Avg_Recall, MAP) over [B, k]
id lists, a frozen copy of ``repro_torch/core/metrics.py``'s arithmetic,
and the percentile the latency metric takes from raw samples.

  Recall(Q) = |returned ∩ true_kNN| / k
  AP(Q)     = (1/k) sum_r P(Q, r) rel(r)
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def membership(returned_ids: torch.Tensor,
               true_ids: torch.Tensor) -> torch.Tensor:
    """rel [B, k]: 1 where the returned id is one of the true k."""
    eq = returned_ids[:, :, None] == true_ids[:, None, :]
    return (eq.any(-1) & (returned_ids >= 0)).float()


def recall(returned_ids, true_ids) -> torch.Tensor:
    """Per-query recall [B]."""
    k = max(true_ids.shape[1], 1)
    return membership(returned_ids, true_ids).sum(1) / k


def average_precision(returned_ids, true_ids) -> torch.Tensor:
    """Per-query AP [B] (the paper's definition)."""
    k = max(true_ids.shape[1], 1)
    rel = membership(returned_ids, true_ids)
    ranks = torch.arange(1, rel.shape[1] + 1, dtype=torch.float32,
                         device=rel.device)[None, :]
    return (torch.cumsum(rel, 1) / ranks * rel).sum(1) / k


def percentile(samples: Sequence[float], p: float) -> float:
    """The nearest-rank p-th percentile of raw samples: the smallest
    sample with at least p% of all samples at or below it."""
    if not samples:
        raise ValueError("percentile of no samples")
    s = sorted(samples)
    return s[max(math.ceil(p / 100.0 * len(s)), 1) - 1]
