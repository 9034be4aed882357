"""Inverted Multi-Index with (O)PQ codes (Babenko & Lempitsky, Ge et al.
OPQ): the paper's quantization-based competitor.

Counterpart of ``src/repro/core/indexes/imi.py``. Two coarse codebooks
over the vector halves define a Kc x Kc cell grid; members are stored
cell-contiguously with the PQ codes of their residuals. A query scores
the cells by du[u] + dv[v] (two ``ops.l2`` calls, K3 on the card), takes
its nprobe best cells and scans each with per-cell residual ADC tables
(``ops.pq_adc_batch`` per lane, K5). Faithful to the paper's finding C4,
IMI returns ADC distances without a re-rank on raw data; ``refine=True``
re-ranks, to measure that gap.

The build is training (k-means and PQ, drawn from a torch generator)
followed by :func:`layout`, which is deterministic given the trained
codebooks. Codes are uint8, the paper's 8-bit PQ, so ``k_pq`` <= 256;
the reference keeps them as int32.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.kernels import ops

from ..guarantees import EXACT, Guarantee
from ..search import SearchResult
from ..summaries import pq as pq_mod

ARRAY_FIELDS = ("u_cent", "v_cent", "pq_centroids", "pq_rotation")
META_FIELDS = ("kc", "m", "max_cell", "n_total")

INF = float("inf")
# rows after the last cell, so a cell's window never reads past the end
_PAD = 8
# elements of the [B, C, n] row block that a re-ranked step holds at once
_REFINE_CHUNK_ELEMS = 1 << 28


@dataclasses.dataclass(frozen=True)
class IMIIndex:
    u_cent: torch.Tensor        # [Kc, n/2]
    v_cent: torch.Tensor        # [Kc, n/2]
    cell_offsets: torch.Tensor  # [Kc*Kc + 1] int32
    codes: torch.Tensor         # [Npad, m] uint8, cell-contiguous
    ids: torch.Tensor           # [Npad] int32 (-1 pad)
    data: torch.Tensor          # [Npad, n] cell-contiguous (refine only)
    pq_centroids: torch.Tensor  # [m, K, dsub] residual codebooks
    pq_rotation: torch.Tensor   # [n, n]
    kc: int
    m: int
    max_cell: int
    n_total: int


def _coarse(x: torch.Tensor, u_cent: torch.Tensor, v_cent: torch.Tensor):
    """Each row's nearest u and v centroids (the first of equal ones)."""
    half = x.shape[1] // 2
    u = torch.argmin(ops.l2(x[:, :half], u_cent), dim=1)
    v = torch.argmin(ops.l2(x[:, half:], v_cent), dim=1)
    return u, v


def build(data: np.ndarray, *, kc: int = 32, m: int = 16, k_pq: int = 256,
          kmeans_iters: int = 20, opq_iters: int = 0,
          train_size: Optional[int] = None, seed: pq_mod.Seed = 0,
          device=device_mod.DEFAULT) -> IMIIndex:
    """Train the coarse codebooks and the residual PQ on ``data`` [N, n]
    (or its first ``train_size`` rows), then lay the index out."""
    n, d = data.shape
    if d % 2 or d % m:
        raise ValueError(f"imi needs an even series length divisible by "
                         f"m={m}, got {d}")
    if k_pq > 256:
        raise ValueError(f"imi stores 8-bit codes: k_pq={k_pq} > 256")
    dev = device_mod.resolve(device)
    g = torch.Generator().manual_seed(int(seed)) \
        if not isinstance(seed, torch.Generator) else seed
    xd = torch.as_tensor(data, dtype=torch.float32, device=dev)
    train = xd if train_size is None else xd[:train_size]
    half = d // 2
    u_cent = pq_mod.kmeans(g, train[:, :half], kc, kmeans_iters)
    v_cent = pq_mod.kmeans(g, train[:, half:], kc, kmeans_iters)
    u, v = _coarse(train, u_cent, v_cent)
    resid = train - torch.cat([u_cent[u], v_cent[v]], dim=1)
    cb = pq_mod.pq_train(g, resid, m, k_pq, kmeans_iters,
                         opq_iters=opq_iters)
    return layout(xd, u_cent, v_cent, cb.centroids, cb.rotation)


def layout(data, u_cent: torch.Tensor, v_cent: torch.Tensor,
           pq_centroids: torch.Tensor, pq_rotation: torch.Tensor
           ) -> IMIIndex:
    """The index given its trained codebooks, on their device: each row's
    cell, then rows, ids and the uint8 codes of the residuals stored
    cell by cell (a stable order, so rows keep their order in a cell),
    with ``_PAD`` empty rows after the last cell."""
    dev = u_cent.device
    x = torch.as_tensor(data, dtype=torch.float32, device=dev)
    n, d = x.shape
    kc = u_cent.shape[0]
    m, k_pq, _ = pq_centroids.shape
    if k_pq > 256:
        raise ValueError(f"imi stores 8-bit codes: k_pq={k_pq} > 256")
    u, v = _coarse(x, u_cent, v_cent)
    cell = u * kc + v
    resid = x - torch.cat([u_cent[u], v_cent[v]], dim=1)
    codes = pq_mod.pq_encode(pq_mod.PQCodebook(pq_centroids, pq_rotation),
                             resid)
    order = torch.sort(cell, stable=True).indices
    counts = torch.bincount(cell, minlength=kc * kc)
    offsets = torch.zeros(kc * kc + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(counts, 0)
    pcodes = torch.zeros((n + _PAD, m), dtype=torch.uint8, device=dev)
    pcodes[:n] = codes[order].to(torch.uint8)
    pids = torch.full((n + _PAD,), -1, dtype=torch.int32, device=dev)
    pids[:n] = order.to(torch.int32)
    pdata = torch.zeros((n + _PAD, d), dtype=torch.float32, device=dev)
    pdata[:n] = x[order]
    return IMIIndex(
        u_cent=u_cent, v_cent=v_cent,
        cell_offsets=offsets.to(torch.int32), codes=pcodes, ids=pids,
        data=pdata, pq_centroids=pq_centroids, pq_rotation=pq_rotation,
        kc=kc, m=m, max_cell=int(counts.max()), n_total=n)


def from_arrays(arrays: Mapping[str, np.ndarray], meta: Mapping,
                device=device_mod.DEFAULT) -> IMIIndex:
    """The index held by host arrays, the reference's ``IMIIndex`` fields
    (``u_cent``, ``v_cent``, ``cell_offsets``, ``codes``, ``ids``,
    ``data``, ``pq_centroids``, ``pq_rotation``), and its static fields
    ``meta`` (``kc``, ``m``, ``max_cell``, ``n_total``), placed on
    ``device``. Codes must fit in 8 bits."""
    dev = device_mod.resolve(device)
    codes = np.asarray(arrays["codes"])
    if codes.size and (codes.min() < 0 or codes.max() > 255):
        raise ValueError("imi stores 8-bit codes: a code lies outside "
                         "[0, 255]")

    def t(name, dtype):
        return torch.tensor(np.asarray(arrays[name]), dtype=dtype,
                            device=dev)

    return IMIIndex(
        **{f: t(f, torch.float32) for f in ARRAY_FIELDS},
        cell_offsets=t("cell_offsets", torch.int32),
        codes=torch.tensor(codes.astype(np.uint8), device=dev),
        ids=t("ids", torch.int32), data=t("data", torch.float32),
        **{f: int(meta[f]) for f in META_FIELDS})


def query(idx: IMIIndex, queries, k: int, g: Guarantee = EXACT, *,
          refine: bool = False, device=device_mod.DEFAULT) -> SearchResult:
    """k-NN of queries [B, n] scanning the ``g.nprobe`` best cells (ng;
    16 when ``g`` carries no nprobe). IMI is ng-only: a delta or epsilon
    guarantee raises. Distances are ADC distances unless ``refine``."""
    g = g.validate()
    if g.nprobe is None:
        if g.delta < 1.0 or g.epsilon > 0.0:
            raise ValueError("imi is ng-only: pass g=ng(nprobe), not "
                             "a delta/epsilon guarantee")
        nprobe = 16
    else:
        nprobe = g.nprobe
    dev = device_mod.matching(idx.data.device, device)
    qf = torch.as_tensor(queries, device=dev).float()
    b, d = qf.shape
    half, kc, c = d // 2, idx.kc, idx.max_cell
    du = ops.l2(qf[:, :half], idx.u_cent)  # [B, Kc]
    dv = ops.l2(qf[:, half:], idx.v_cent)
    scores = (du[:, :, None] + dv[:, None, :]).reshape(b, kc * kc)
    _, cells = ops.smallest_k(scores, nprobe)  # [B, nprobe] best cells
    npad = idx.codes.shape[0]
    cb = pq_mod.PQCodebook(idx.pq_centroids, idx.pq_rotation)
    span = torch.arange(c, device=dev)
    top_d = torch.full((b, k), INF, device=dev)
    top_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    scanned = torch.zeros(b, dtype=torch.int32, device=dev)
    for t in range(nprobe):
        cell = cells[:, t]
        start = idx.cell_offsets[cell].long()
        end = idx.cell_offsets[cell + 1].long()
        gidx = start[:, None] + span[None, :]
        valid = gidx < end[:, None]
        gidx = gidx.clamp_max(npad - 1)
        ids_g = torch.where(valid, idx.ids[gidx], -1)
        if refine:
            dist = _raw_sq_dists(idx.data, gidx, qf)
        else:
            rq = qf - torch.cat([idx.u_cent[cell // kc],
                                 idx.v_cent[cell % kc]], dim=1)
            lut = pq_mod.adc_lut_batch(cb, rq)  # [B, m, K]
            dist = ops.pq_adc_batch(idx.codes[gidx], lut)  # [B, C]
        dist = torch.where(valid, dist, INF)
        top_d, top_i = ops.topk_merge(dist, ids_g, top_d, top_i)
        scanned += valid.sum(1, dtype=torch.int32)
    return SearchResult(
        dists=torch.sqrt(top_d.clamp_min(0.0)),
        ids=top_i,
        leaves_visited=torch.full((b,), nprobe, dtype=torch.int32,
                                  device=dev),
        rows_scanned=scanned,
        lb_computed=kc * kc,
        iterations=nprobe,
    )


def _raw_sq_dists(data: torch.Tensor, gidx: torch.Tensor,
                  qf: torch.Tensor) -> torch.Tensor:
    """sum((data[gidx] - q)^2) over n: [B, C], in column blocks that keep
    the gathered rows within _REFINE_CHUNK_ELEMS."""
    b, c = gidx.shape
    step = max(1, _REFINE_CHUNK_ELEMS // max(b * qf.shape[1], 1))
    out = []
    for s in range(0, c, step):
        diff = data[gidx[:, s:s + step]] - qf[:, None, :]
        out.append((diff * diff).sum(-1))
    return torch.cat(out, dim=1)
