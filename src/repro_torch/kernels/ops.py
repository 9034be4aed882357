"""The operations the search core calls: the kernels and the plain
selection and merge ops around them.

Counterpart of ``src/repro/kernels/ops.py``. The kernel wrappers
(``paa``, ``box_mindist``, ``l2``, ``coop_score_select``,
``pq_adc_batch``, ``pq_adc_select`` and ``lex_select``) launch their
CUDA kernels for a CUDA tensor and take the plain version for a CPU
tensor. Everything else here is plain PyTorch on whatever device its
inputs are on.

Tie order is part of the contract: the reference's ``lax.top_k`` puts
the lower index first among equal values, and ``torch.topk`` promises
no order, so every selection goes through :func:`smallest_k`, which
reproduces ``lax.top_k`` exactly; ``lax.sort(num_keys=2)`` becomes
:func:`ref.lex_order`.
"""

from __future__ import annotations

import torch

from . import ref
from .box_mindist import box_mindist
from .l2_dist import l2
from .lex_select import lex_select
from .paa import paa
from .pq_adc import pq_adc_batch
from .pq_adc_select import pq_adc_select
from .topk import coop_score_select

__all__ = [
    "box_mindist", "l2", "paa", "coop_score_select", "lex_select",
    "pq_adc", "pq_adc_batch", "pq_adc_select", "smallest_k", "row_sq_norms",
    "sq_l2", "l2_topk", "bitonic_merge_sorted", "topk_merge",
    "dedup_merge_topk", "topk_merge_unique",
]

INF = float("inf")


def smallest_k(x: torch.Tensor, k: int) -> tuple:
    """Per row of x [B, W], the k smallest values ascending and their
    column positions (int64), equal values in column order: exactly
    ``-lax.top_k(-x, k)``.

    ``torch.topk`` finds the k-th smallest value; every value below it
    is kept, and of the values equal to it the leftmost ones fill the
    rest, so the kept set is the one a stable sort would keep; a stable
    sort of those k orders them."""
    b, w = x.shape
    thr = torch.topk(x, k, dim=1, largest=False, sorted=True).values
    thr = thr[:, k - 1:k]
    lt = x < thr
    eq = x == thr
    need = k - lt.sum(1, keepdim=True)
    keep = lt | (eq & (torch.cumsum(eq, 1) <= need))
    slot = torch.where(keep, torch.cumsum(keep, 1) - 1, k)
    cols = torch.arange(w, device=x.device).expand(b, w)
    pos = torch.empty((b, k + 1), dtype=torch.long, device=x.device)
    pos = pos.scatter_(1, slot, cols)[:, :k]
    v = x.gather(1, pos)
    o = torch.sort(v, dim=1, stable=True).indices
    return v.gather(1, o), pos.gather(1, o)


def pq_adc(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """ADC scan distances [M] of codes [M, m] under one query's table
    lut [m, K]: the pq_adc_batch kernel with one lane."""
    return pq_adc_batch(codes, lut[None])[0]


def l2_topk(q: torch.Tensor, x: torch.Tensor, k: int) -> tuple:
    """Distance (the l2 kernel) + the k nearest rows: (squared dists
    [B, k] ascending, row positions [B, k] int64)."""
    return smallest_k(l2(q, x), k)


def row_sq_norms(rows: torch.Tensor) -> torch.Tensor:
    """Per-row squared L2 norms [N, n] -> [N] f32."""
    rf = rows.float()
    return (rf * rf).sum(-1)


def sq_l2(q: torch.Tensor, rows: torch.Tensor,
          row_norms: torch.Tensor) -> torch.Tensor:
    """Squared L2 with precomputed row norms, f32: rows [R, n] -> [B, R]
    (every row against every lane) or rows [B, M, n] -> [B, M] (per
    lane, norms [B, M]).

    Per lane on the CPU, every cross term comes from one BLAS path:
    torch's CPU ``bmm`` sums a product of fewer than 400 multiply-adds in
    a plain loop and a larger one in BLAS, in another order, so a narrow
    pool is padded with zero rows up to that size. A row then scores
    alike in a leaf of any width and in the write tier's memtable, which
    keeps frozen+delta answers equal to a rebuild's."""
    qf = q.float()
    qn = (qf * qf).sum(-1)[:, None]
    rf = rows.float()
    rn = row_norms.float()
    if rows.dim() == 2:
        return torch.clamp_min(qn - 2.0 * (qf @ rf.T) + rn[None, :], 0.0)
    b, m, n = rf.shape
    if not rf.is_cuda and 0 < m * n < _CPU_BMM_BLAS_MIN:
        pad = -(-_CPU_BMM_BLAS_MIN // n) - m
        rf = torch.cat([rf, rf.new_zeros(b, pad, n)], 1)
    cross = torch.bmm(rf, qf[:, :, None])[:, :m, 0]
    return torch.clamp_min(qn - 2.0 * cross + rn, 0.0)


# the least multiply-adds of a CPU bmm product that torch hands to BLAS
_CPU_BMM_BLAS_MIN = 400


def _select_k_by_d(dists, ids, kk: int):
    """Per row the kk smallest candidates by distance, ties by column;
    sorted ascending."""
    d, pos = smallest_k(dists, kk)
    return d, ids.gather(1, pos)


def _select_k_by_d_id_shared(dists, ids, kk: int):
    """Per row the kk lexicographically smallest (d, id) pairs when the
    ids [R] are shared by every lane: permuting the columns into id
    order makes the column tie order the id order."""
    ids = ids.to(torch.int32)
    order = torch.sort(ids, stable=True).indices
    d, pos = smallest_k(dists[:, order], kk)
    return d, ids[order][pos]


def _select_k_by_d_id(dists, ids, kk: int):
    """Per row the kk lexicographically smallest (d, id) pairs, sorted,
    for per-row ids [B, M] — the reference's two passes: the kk-th
    distance is the threshold, and ties at it rank by id as an f32 key
    (exact below 2^24)."""
    ids = ids.to(torch.int32)
    thr = torch.topk(dists, kk, dim=1, largest=False).values.amax(
        1, keepdim=True)
    neg_key = torch.where(
        dists < thr, -INF,
        torch.where(dists == thr, ids.float(), INF))
    _, pos = smallest_k(neg_key, kk)
    sel_d, sel_i = dists.gather(1, pos), ids.gather(1, pos)
    o = ref.lex_order(sel_d, sel_i)
    return sel_d.gather(1, o), sel_i.gather(1, o)


def bitonic_merge_sorted(da, ia, db, ib):
    """Merge two per-row ascending lists [B, ka] + [B, kb] -> [B, ka+kb]
    stably: the a-list wins distance ties. The reference runs this as a
    bitonic network on (d, concat-position) keys; a stable sort of the
    concatenation gives the same order."""
    d = torch.cat([da, db], 1)
    i = torch.cat([ia, ib.to(ia.dtype)], 1)
    o = torch.sort(d, dim=1, stable=True).indices
    return d.gather(1, o), i.gather(1, o)


def topk_merge(dists, ids, top_d, top_i):
    """Merge a candidate batch [B, M] into running sorted top-k rows
    (equal to ref.ref_topk_merge, ties included): select the k best
    candidates, then merge two sorted lists."""
    k = top_d.shape[1]
    kk = min(k, dists.shape[1])
    sel_d, sel_i = _select_k_by_d(dists, ids, kk)
    md, mi = bitonic_merge_sorted(top_d, top_i, sel_d, sel_i)
    return md[:, :k], mi[:, :k]


def dedup_merge_topk(sel_d, sel_i, top_d, top_i):
    """Fold pre-selected candidates [B, kk] into the running top-k,
    keeping each id once (its best distance); (d, id)-lexicographic
    output, placeholders (inf, -1) last."""
    k = top_d.shape[1]
    all_d = torch.cat([top_d, sel_d], 1)
    all_i = torch.cat([top_i, sel_i.to(top_i.dtype)], 1)
    o = ref.lex_order(all_i, all_d)
    si, sd = all_i.gather(1, o), all_d.gather(1, o)
    dup = torch.zeros_like(si, dtype=torch.bool)
    dup[:, 1:] = si[:, 1:] == si[:, :-1]
    sd = torch.where(dup, INF, sd)
    si = torch.where(dup, -1, si)
    o2 = torch.sort(sd, dim=1, stable=True).indices[:, :k]
    return sd.gather(1, o2), si.gather(1, o2)


def topk_merge_unique(dists, ids, top_d, top_i):
    """topk_merge that keeps each id once (equal to
    ref.ref_topk_merge_unique). ``ids`` is [M] (one pool shared by every
    lane) or [B, M]. Precondition: each real id appears at most once
    among the candidate columns; only -1 repeats."""
    k = top_d.shape[1]
    kk = min(2 * k, dists.shape[1])
    if ids.dim() == 1:
        sel_d, sel_i = _select_k_by_d_id_shared(dists, ids, kk)
    else:
        sel_d, sel_i = _select_k_by_d_id(dists, ids, kk)
    return dedup_merge_topk(sel_d, sel_i, top_d, top_i)
