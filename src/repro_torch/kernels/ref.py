"""Plain PyTorch versions of the kernels and of the selection oracles.

Each ``ref_*`` function is the semantic definition that its CUDA kernel
is held against on the card, and the path its wrapper takes for a CPU
tensor. Short reductions (segment means, the box distance over summary
dims) run left to right through :func:`seq_sum`: that is the order
XLA's CPU backend uses for them, so the summaries agree bit for bit
with the JAX package, and the kernels use the same order.
"""

from __future__ import annotations

import numpy as np
import torch

INF = float("inf")


def seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis strictly left to right, in x's dtype."""
    acc = x[..., 0].clone()
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def lex_order(primary: torch.Tensor, secondary: torch.Tensor
              ) -> torch.Tensor:
    """Per-row permutation sorting (primary, secondary) pairs
    lexicographically along the last axis (``lax.sort(num_keys=2)``)."""
    o1 = torch.sort(secondary, dim=-1, stable=True).indices
    o2 = torch.sort(primary.gather(-1, o1), dim=-1, stable=True).indices
    return o1.gather(-1, o2)


def inv_width(n: int, n_segments: int) -> float:
    """1/w as a float32 value: a mean is its sum times this reciprocal,
    the arithmetic XLA's CPU backend uses for a mean."""
    if n_segments < 1 or n % n_segments:
        raise ValueError(f"series length {n} is not a multiple of "
                         f"{n_segments} segments")
    return float(np.float32(n_segments / n))


def ref_paa(x: torch.Tensor, n_segments: int) -> torch.Tensor:
    """Piecewise Aggregate Approximation [N, n] -> [N, l] f32 segment
    means; n % l == 0."""
    n = x.shape[-1]
    inv = inv_width(n, n_segments)
    seg = x.reshape(x.shape[:-1] + (n_segments, n // n_segments)).float()
    return seq_sum(seg) * inv


# rows of the [B, L_chunk, D] intermediate held at once
_BOX_CHUNK_ELEMS = 1 << 26


def ref_box_mindist(q: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """Squared weighted box distance [B, L]:
    sum_d w_d * max(lo_d - q_d, q_d - hi_d, 0)^2, summed left to right
    (the unified lower bound of iSAX, DSTree and VA+file)."""
    qf = q.float()[:, None, :]
    w = weights.float()
    b, d = q.shape
    step = max(1, _BOX_CHUNK_ELEMS // max(b * d, 1))
    out = []
    for s in range(0, lo.shape[0], step):
        lof = lo[s:s + step].float()[None]
        hif = hi[s:s + step].float()[None]
        t = torch.clamp_min(torch.maximum(lof - qf, qf - hif), 0.0)
        out.append(seq_sum(t * t * w))
    if not out:
        return torch.zeros((b, 0), dtype=torch.float32, device=q.device)
    return torch.cat(out, dim=1)


def ref_l2(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances [B, M] f32 in the matmul form
    |q|^2 - 2 q.x + |x|^2, clamped at 0, f32 accumulation."""
    qf = q.float()
    xf = x.float()
    qn = (qf * qf).sum(-1, keepdim=True)
    xn = (xf * xf).sum(-1)
    return torch.clamp_min(qn - 2.0 * (qf @ xf.T) + xn[None, :], 0.0)


def ref_topk_merge(dists, ids, top_d, top_i):
    """Full-sort merge of candidates into running sorted top-k rows;
    ties resolve by concatenation position (running entries first)."""
    k = top_d.shape[1]
    all_d = torch.cat([top_d, dists], 1)
    all_i = torch.cat([top_i, ids.to(top_i.dtype)], 1)
    o = torch.sort(all_d, dim=1, stable=True).indices[:, :k]
    return all_d.gather(1, o), all_i.gather(1, o)


def ref_topk_merge_unique(dists, ids, top_d, top_i):
    """Full-sort merge that keeps each id once (its best distance);
    the output is (d, id)-lexicographic, placeholders (inf, -1) last."""
    k = top_d.shape[1]
    all_d = torch.cat([top_d, dists], 1)
    all_i = torch.cat([top_i, ids.to(top_i.dtype)], 1)
    o = lex_order(all_i, all_d)
    si, sd = all_i.gather(1, o), all_d.gather(1, o)
    dup = torch.zeros_like(si, dtype=torch.bool)
    dup[:, 1:] = si[:, 1:] == si[:, :-1]
    sd = torch.where(dup, torch.full_like(sd, INF), sd)
    si = torch.where(dup, torch.full_like(si, -1), si)
    o2 = torch.sort(sd, dim=1, stable=True).indices[:, :k]
    return sd.gather(1, o2), si.gather(1, o2)


def ref_lex_select(d: torch.Tensor, ids: torch.Tensor, kk: int) -> tuple:
    """Per lane of the scores d [B, R] against the shared ids [R], the
    ``kk`` lexicographically smallest (d, id) pairs, sorted by (d, id):
    d [B, kk] f32, ids [B, kk] int32. A slot with a negative id counts
    as (inf, id), so the -1 slots come out as (inf, -1). Precondition:
    real ids are distinct; only the -1 placeholder repeats."""
    d = torch.where(ids[None, :] < 0, torch.full_like(d, INF), d)
    idm = ids.to(torch.int32)[None, :].expand(d.shape[0], -1)
    o = lex_order(d, idm)[:, :kk]
    return d.gather(1, o), idm.gather(1, o)


def ref_coop_score_select(q, rows, row_norms, ids, kk: int):
    """Score every pooled row against every lane (|q|^2 - 2 q.x + |x|^2
    with the norms passed in, clamped at 0) and return per lane the
    ``kk`` lexicographically smallest (d, id) pairs, masked slots (id -1)
    at +inf, sorted by (d, id) (:func:`ref_lex_select`). Precondition:
    real ids are distinct in the pool; only the -1 placeholder repeats."""
    qf = q.float()
    rf = rows.float()
    qn = (qf * qf).sum(-1)[:, None]
    d = torch.clamp_min(qn - 2.0 * (qf @ rf.T)
                        + row_norms.float()[None, :], 0.0)
    return ref_lex_select(d, ids, kk)


def ref_pq_adc(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """PQ asymmetric distance scan for one query: codes [M, m] in [0, K),
    lut [m, K] f32 -> [M], d[i] = sum_j lut[j, codes[i, j]] summed left
    to right from zero."""
    idx = codes.long()
    out = torch.zeros(codes.shape[0], dtype=torch.float32,
                      device=codes.device)
    for j in range(codes.shape[1]):
        out = out + lut[j].float()[idx[:, j]]
    return out


def ref_pq_adc_batch(codes: torch.Tensor, luts: torch.Tensor
                     ) -> torch.Tensor:
    """Batched ADC scan: luts [B, m, K]; codes [M, m] (one row set scored
    against every lane) or [B, M, m] (per-lane rows) -> [B, M], each sum
    left to right."""
    b, m, k = luts.shape
    idx = codes.long()
    if idx.dim() == 2:
        idx = idx[None].expand(b, -1, -1)
    # flat position of lut[b, j, code] in luts.reshape(b, m * k)
    flat = idx + torch.arange(m, device=idx.device) * k
    g = luts.float().reshape(b, 1, m * k).expand(-1, idx.shape[1], -1)
    g = g.gather(2, flat)
    out = torch.zeros(g.shape[:2], dtype=torch.float32, device=g.device)
    for j in range(m):
        out = out + g[..., j]
    return out


def ref_pq_adc_select(codes: torch.Tensor, luts: torch.Tensor,
                      ids: torch.Tensor, kk: int) -> tuple:
    """ADC-score every pooled code row [R, m] against every lane's table
    luts [B, m, K] (masked slots, id -1, at +inf) and return per lane the
    ``kk`` lexicographically smallest (d, id) pairs, sorted by (d, id).
    Precondition: real ids are distinct in the pool."""
    return ref_lex_select(ref_pq_adc_batch(codes, luts), ids, kk)
