"""SRS (Sun et al.): a tiny-index LSH through m Gaussian projections.

Counterpart of ``src/repro/core/indexes/srs.py``. Points are examined in
increasing *projected* distance (a stable sort of the projected
distances, the reference's ``argsort``, in place of SRS's incremental
R-tree walk). After each chunk of true-distance refinements the early
termination test fires: since proj_dist^2 / true_dist^2 ~ chi^2_m,

    psi_m( p_cur^2 * (1+eps)^2 / bsf^2 ) >= delta

means a point with true distance <= bsf/(1+eps) would have been seen
with probability >= delta, so bsf is a delta-epsilon answer. A max-scan
budget bounds the worst case. The projected distances go through
``ops.l2`` (K3 on the card); the loop runs on the host and reads one
flag from the device per chunk.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.kernels import ops

from ..guarantees import Guarantee
from ..search import SearchResult
from ..summaries import randproj

ARRAY_FIELDS = ("proj", "feats", "data")
META_FIELDS = ("m", "n_total")

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class SRSIndex:
    proj: torch.Tensor   # [n, m]
    feats: torch.Tensor  # [N, m] projected points
    data: torch.Tensor   # [N, n]
    m: int
    n_total: int


def build(data: np.ndarray, *, m: int = 16, seed: randproj.Seed = 0,
          device=device_mod.DEFAULT) -> SRSIndex:
    """Project the collection [N, n] on m Gaussian lines drawn from
    ``seed``."""
    dev = device_mod.resolve(device)
    w = randproj.make_projection(seed, data.shape[1], m, dev)
    xd = torch.as_tensor(data, dtype=torch.float32, device=dev)
    return SRSIndex(proj=w, feats=randproj.transform(xd, w), data=xd, m=m,
                    n_total=data.shape[0])


def from_arrays(arrays: Mapping[str, np.ndarray], meta: Mapping,
                device=device_mod.DEFAULT) -> SRSIndex:
    """The index held by host arrays (the reference's ``SRSIndex``
    fields ``proj``, ``feats``, ``data``) and its static fields ``meta``
    (``m``, ``n_total``), placed on ``device``."""
    dev = device_mod.resolve(device)
    return SRSIndex(**{f: torch.tensor(np.asarray(arrays[f]),
                                       dtype=torch.float32, device=dev)
                       for f in ARRAY_FIELDS},
                    **{f: int(meta[f]) for f in META_FIELDS})


def query(idx: SRSIndex, queries, k: int,
          g: Optional[Guarantee] = None, *, chunk: int = 256,
          max_scan: Optional[int] = None,
          device=device_mod.DEFAULT) -> SearchResult:
    """k-NN of queries [B, n] under a delta-epsilon guarantee ``g``
    (default delta = 0.95, the reference's). SRS has no nprobe-bounded
    (ng) mode, so ``g.nprobe`` raises. ``iterations`` counts the chunks
    the loop ran."""
    g = Guarantee(delta=0.95) if g is None else g.validate()
    if g.nprobe is not None:
        raise ValueError("srs is a delta-epsilon method: it has no "
                         "nprobe-bounded (ng) mode")
    dev = device_mod.matching(idx.data.device, device)
    qf = torch.as_tensor(queries, device=dev).float()
    b = qf.shape[0]
    nn = idx.n_total
    max_scan = min(max_scan or nn, nn)
    p_sq = ops.l2(randproj.transform(qf, idx.proj), idx.feats)  # [B, N]
    p_sorted, order = torch.sort(p_sq, dim=1, stable=True)
    eps_mult = torch.tensor((1.0 + g.epsilon) ** 2, dtype=torch.float32,
                            device=dev)
    delta = torch.tensor(g.delta, dtype=torch.float32, device=dev)
    lanes = torch.arange(b, device=dev)
    cols = torch.arange(chunk, device=dev)
    ptr = torch.zeros(b, dtype=torch.long, device=dev)
    top_d = torch.full((b, k), INF, device=dev)
    top_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    scanned = torch.zeros(b, dtype=torch.int32, device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    iterations = 0
    while bool(active.any()):
        iterations += 1
        pos = ptr[:, None] + cols[None, :]
        in_range = (pos < max_scan) & active[:, None]
        ids = order.gather(1, pos.clamp_max(nn - 1))  # [B, C]
        diff = idx.data[ids] - qf[:, None, :]
        d = torch.where(in_range, (diff * diff).sum(-1), INF)
        top_d, top_i = ops.topk_merge(
            d, torch.where(in_range, ids, -1).to(torch.int32), top_d, top_i)
        scanned += in_range.sum(1, dtype=torch.int32)
        ptr = (ptr + chunk).clamp_max(max_scan)
        p_cur = p_sorted[lanes, ptr.clamp_max(nn - 1)]
        arg = p_cur * eps_mult / top_d[:, k - 1].clamp_min(1e-30)
        early = randproj.psi(idx.m, arg) >= delta
        active &= ~((ptr >= max_scan) | early)
    return SearchResult(
        dists=torch.sqrt(top_d.clamp_min(0.0)),
        ids=top_i,
        leaves_visited=scanned,
        rows_scanned=scanned,
        lb_computed=nn,
        iterations=iterations,
    )
