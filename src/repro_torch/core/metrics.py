"""Accuracy measures from the paper §4.1: Avg_Recall, MAP, MRE.

  Recall(Q) = |returned ∩ true_kNN| / k
  AP(Q)     = (1/k) sum_r P(Q, r) rel(r)
  RE(Q)     = (1/k) sum_r (d(Q, C_r) - d(Q, C*_r)) / d(Q, C*_r), over
              ranks with a nonzero exact distance and a filled answer.
Workload aggregates are plain means over queries.
"""

from __future__ import annotations

from typing import Dict

import torch


def _membership(returned_ids, true_ids) -> torch.Tensor:
    """rel [B, k]: 1 where the returned id is one of the true k."""
    eq = returned_ids[:, :, None] == true_ids[:, None, :]
    return (eq.any(-1) & (returned_ids >= 0)).float()


def recall(returned_ids, true_ids) -> torch.Tensor:
    """Per-query recall [B]; an empty truth set scores 0."""
    k = max(true_ids.shape[1], 1)
    return _membership(returned_ids, true_ids).sum(1) / k


def average_precision(returned_ids, true_ids) -> torch.Tensor:
    """Per-query AP [B] (the paper's definition)."""
    k = max(true_ids.shape[1], 1)
    rel = _membership(returned_ids, true_ids)
    ranks = torch.arange(1, rel.shape[1] + 1, dtype=torch.float32,
                         device=rel.device)[None, :]
    return (torch.cumsum(rel, 1) / ranks * rel).sum(1) / k


def relative_error(returned_d, true_d) -> torch.Tensor:
    """Per-query MRE [B], rank-paired; zero exact distances and unfilled
    (inf) answer slots are left out."""
    re = (returned_d - true_d) / torch.clamp_min(true_d, 1e-12)
    valid = (true_d > 1e-12) & torch.isfinite(returned_d)
    k_eff = torch.clamp_min(valid.sum(1), 1)
    return torch.where(valid, re, 0.0).sum(1) / k_eff


def workload_metrics(returned_ids, returned_d, true_ids, true_d
                     ) -> Dict[str, float]:
    return {
        "avg_recall": float(recall(returned_ids, true_ids).mean()),
        "map": float(average_precision(returned_ids, true_ids).mean()),
        "mre": float(relative_error(returned_d, true_d).mean()),
    }
