"""QALSH (Huang et al.): query-aware LSH, the delta-epsilon class.

Counterpart of ``src/repro/core/indexes/qalsh.py``. The original keeps
one B+-tree per hash line and walks buckets anchored at the query's own
projection. Here, as in the reference, the trees are per-line sorted
projection arrays (a stable sort per line): a query finds its rank on
each line (``torch.searchsorted``, left), widens a two-sided window of
``frontier`` positions per step, counts how many lines each point
collided on, and refines, each step, the ``frontier * m`` points with the
most collisions (at least ``l_threshold`` of the m lines) on their true
distances. The count scores are small integers, so ties are the rule:
the selection is ``ops.lex_select`` on the negated counts with the point
ids as the second key, which keeps the lower id first as ``lax.top_k``
does. The collision threshold is fixed at build time: an index targets
one (delta, epsilon) setting, as the paper notes.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.kernels import ops

from ..search import SearchResult
from ..summaries import randproj

ARRAY_FIELDS = ("proj", "sorted_vals", "sorted_ids", "data")
META_FIELDS = ("m", "l_threshold", "n_total")

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class QALSHIndex:
    proj: torch.Tensor         # [n, m] Gaussian lines
    sorted_vals: torch.Tensor  # [m, N] projections sorted per line
    sorted_ids: torch.Tensor   # [m, N] int32 point ids in that order
    data: torch.Tensor         # [N, n]
    m: int
    l_threshold: int
    n_total: int


def build(data: np.ndarray, *, m: int = 8,
          l_threshold: Optional[int] = None, seed: randproj.Seed = 3,
          device=device_mod.DEFAULT) -> QALSHIndex:
    """Project the collection [N, n] on m Gaussian lines drawn from
    ``seed`` and sort each line; ``l_threshold`` defaults to
    round(0.6 m)."""
    dev = device_mod.resolve(device)
    n_pts, n = data.shape
    proj = randproj.make_projection(seed, n, m, dev)
    x = torch.as_tensor(data, dtype=torch.float32, device=dev)
    vals, order = torch.sort(randproj.transform(x, proj), dim=0,
                             stable=True)  # [N, m]
    if l_threshold is None:
        l_threshold = max(1, int(round(0.6 * m)))
    return QALSHIndex(
        proj=proj, sorted_vals=vals.T.contiguous(),
        sorted_ids=order.T.to(torch.int32).contiguous(), data=x, m=m,
        l_threshold=l_threshold, n_total=n_pts)


def from_arrays(arrays: Mapping[str, np.ndarray], meta: Mapping,
                device=device_mod.DEFAULT) -> QALSHIndex:
    """The index held by host arrays (the reference's ``QALSHIndex``
    fields ``proj``, ``sorted_vals``, ``sorted_ids``, ``data``) and its
    static fields ``meta`` (``m``, ``l_threshold``, ``n_total``), placed
    on ``device``."""
    dev = device_mod.resolve(device)
    return QALSHIndex(
        **{f: torch.tensor(np.asarray(arrays[f]), device=dev,
                           dtype=torch.int32 if f == "sorted_ids"
                           else torch.float32) for f in ARRAY_FIELDS},
        **{f: int(meta[f]) for f in META_FIELDS})


def query(idx: QALSHIndex, queries, k: int, *, steps: int = 8,
          frontier: int = 64, device=device_mod.DEFAULT) -> SearchResult:
    """k-NN of queries [B, n] by frontier expansion: each step takes, per
    line, the ``frontier * (step + 1)`` positions around the query's
    rank, counts collisions, and refines the ``frontier * m`` best-hit
    points on true distances. ``steps`` is the budget (QALSH's beta)."""
    dev = device_mod.matching(idx.data.device, device)
    qf = torch.as_tensor(queries, device=dev).float()
    b = qf.shape[0]
    npts = idx.n_total
    qp = randproj.transform(qf, idx.proj)  # [B, m]
    # each query's rank on each line: [m, B] -> [B, m]
    center = torch.searchsorted(idx.sorted_vals, qp.T.contiguous()).T
    lanes = torch.arange(b, device=dev)[:, None]
    lines = torch.arange(idx.m, device=dev)[None, :, None]
    point_ids = torch.arange(npts, dtype=torch.int32, device=dev)
    top_d = torch.full((b, k), INF, device=dev)
    top_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    scanned = torch.zeros(b, dtype=torch.int32, device=dev)
    counts = torch.zeros((b, npts), dtype=torch.int8, device=dev)
    one = torch.ones((), dtype=torch.int8, device=dev)
    half = frontier // 2
    sel_w = frontier * idx.m
    for step in range(steps):
        w = frontier * (step + 1)
        span = torch.arange(w, device=dev)
        start = (center - half * (step + 1)).clamp(0, npts - w)  # [B, m]
        pos = (start[:, :, None] + span).clamp(0, npts - 1)  # [B, m, W]
        cand = idx.sorted_ids[lines, pos].reshape(b, -1)  # [B, m*W]
        cnt = torch.zeros((b, npts), dtype=torch.int8, device=dev)
        cnt.index_put_((lanes, cand.long()), one.expand(cand.shape),
                       accumulate=True)
        counts = torch.maximum(counts, cnt)  # collisions at this radius
        hit = counts >= idx.l_threshold  # [B, N]
        # the sel_w largest scores, lower id first among equal ones
        score = torch.where(hit, counts.float(), -1.0)
        _, sel = ops.lex_select(-score, point_ids, sel_w)  # [B, sel_w]
        diff = idx.data[sel] - qf[:, None, :]
        valid = hit.gather(1, sel.long())
        d = torch.where(valid, (diff * diff).sum(-1), INF)
        top_d, top_i = ops.topk_merge(d, torch.where(valid, sel, -1),
                                      top_d, top_i)
        scanned += valid.sum(1, dtype=torch.int32)
    return SearchResult(
        dists=torch.sqrt(top_d.clamp_min(0.0)),
        ids=top_i,
        leaves_visited=scanned,
        rows_scanned=scanned,
        lb_computed=idx.m * npts,
        iterations=steps,
    )
