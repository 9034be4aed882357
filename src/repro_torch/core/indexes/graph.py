"""Hierarchical proximity graph (HNSW, Malkov & Yashunin): ng-approximate
only, in memory only, as the paper's Table 1 files it.

Counterpart of ``src/repro/core/indexes/graph.py``. Levels are geometric
(mL = 1/ln M), drawn from ``np.random.default_rng(seed)``, the
reference's generator, so they are the same for the same seed. A level's
edges are its members' M nearest members ("HNSW with oracle neighbour
selection"), found in row blocks: ``ops.l2`` (K3) scores a block against
every member, the self-distance goes to inf, and ``ops.lex_select``
keeps the M smallest (d, member) pairs, the reference's ``lax.top_k``
order, ties included. A query descends the upper levels greedily, then
runs a beam of width efs at level 0 with a visited mask; both loops run
on the host and read one flag from the device per step.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.kernels import ops

from ..search import SearchResult

NEG = -1
INF = float("inf")
META_FIELDS = ("levels", "m_links", "n_total")
# elements of a [block, members] distance block (2 GiB of f32)
_BLOCK_ELEMS = 1 << 29
_MAX_BLOCK = 2048


@dataclasses.dataclass(frozen=True)
class GraphIndex:
    adj: torch.Tensor   # [levels, N, M] int32 neighbour ids, -1 padded
    data: torch.Tensor  # [N, n]
    entry: int          # entry node (the first top-level member)
    levels: int
    m_links: int
    n_total: int


def _knn_members(x: torch.Tensor, members: np.ndarray, m: int
                 ) -> torch.Tensor:
    """[len(members), m] nearest member ids (global, int64), -1 padded
    on levels of at most m members."""
    dev = x.device
    mem = torch.as_tensor(members, device=dev)
    sub = x[mem].contiguous()
    size = len(members)
    kk = min(m, size - 1)
    local = torch.arange(size, dtype=torch.int32, device=dev)
    block = max(1, min(_MAX_BLOCK, _BLOCK_ELEMS // size))
    out = []
    for s in range(0, size, block):
        d = ops.l2(sub[s:s + block], sub)
        rows = torch.arange(d.shape[0], device=dev)
        d[rows, rows + s] = INF  # no self-edges
        out.append(ops.lex_select(d, local, kk)[1])
        del d
    res = mem[torch.cat(out).long()]
    if kk < m:  # tiny levels: pad
        res = torch.cat([res, torch.full((size, m - kk), NEG,
                                         dtype=res.dtype, device=dev)], 1)
    return res


def build(data: np.ndarray, *, m_links: int = 16, seed: int = 0,
          max_levels: int = 5, device=device_mod.DEFAULT) -> GraphIndex:
    """Levels from ``np.random.default_rng(seed)``; every level's
    members linked to their ``m_links`` nearest members."""
    dev = device_mod.resolve(device)
    n = data.shape[0]
    rng = np.random.default_rng(seed)
    ml = 1.0 / np.log(max(m_links, 2))
    lvl = np.minimum(
        np.floor(-np.log(rng.uniform(1e-12, 1.0, n)) * ml).astype(np.int64),
        max_levels - 1)
    levels = int(lvl.max()) + 1
    x = torch.as_tensor(data, dtype=torch.float32, device=dev)
    adj = torch.full((levels, n, m_links), NEG, dtype=torch.int32,
                     device=dev)
    for level in range(levels):
        members = np.where(lvl >= level)[0]
        if len(members) <= 1:
            continue
        adj[level, torch.as_tensor(members, device=dev)] = _knn_members(
            x, members, m_links).to(torch.int32)
    top_members = np.where(lvl >= levels - 1)[0]
    entry = int(top_members[0]) if len(top_members) else 0
    return GraphIndex(adj=adj, data=x, entry=entry, levels=levels,
                      m_links=m_links, n_total=n)


def from_arrays(arrays: Mapping[str, np.ndarray], meta: Mapping,
                device=device_mod.DEFAULT) -> GraphIndex:
    """The index held by host arrays (the reference's ``GraphIndex``
    fields ``adj``, ``data``, ``entry``) and its static fields ``meta``
    (``levels``, ``m_links``, ``n_total``), placed on ``device``."""
    dev = device_mod.resolve(device)
    return GraphIndex(
        adj=torch.tensor(np.asarray(arrays["adj"]), dtype=torch.int32,
                         device=dev),
        data=torch.tensor(np.asarray(arrays["data"]), dtype=torch.float32,
                          device=dev),
        entry=int(arrays["entry"]),
        **{f: int(meta[f]) for f in META_FIELDS})


def _dist_to(qf: torch.Tensor, data: torch.Tensor, ids: torch.Tensor
             ) -> torch.Tensor:
    """Squared distances of each lane to its nodes: ids [B] -> [B],
    ids [B, M] -> [B, M] (a -1 id reads node 0)."""
    rows = data[ids.clamp_min(0)]
    diff = rows - (qf[:, None, :] if rows.dim() == 3 else qf)
    return (diff * diff).sum(-1)


def _greedy_level(idx: GraphIndex, level: int, qf: torch.Tensor,
                  start: torch.Tensor, max_hops: int = 64) -> tuple:
    """Greedy 1-NN walk at one level: start [B] -> (node [B], hops), the
    hops being the loop's steps, the same for every lane."""
    cur, cur_d = start, _dist_to(qf, idx.data, start)
    hops = 0
    improved = torch.ones_like(start, dtype=torch.bool)
    while hops < max_hops and bool(improved.any()):
        neigh = idx.adj[level, cur]  # [B, M]
        d = torch.where(neigh >= 0, _dist_to(qf, idx.data, neigh), INF)
        j = torch.argmin(d, dim=1, keepdim=True)
        bd = d.gather(1, j)[:, 0]
        improved = bd < cur_d
        cur = torch.where(improved, neigh.gather(1, j)[:, 0], cur)
        cur_d = torch.where(improved, bd, cur_d)
        hops += 1
    return cur, hops


def query(idx: GraphIndex, queries, k: int, *, efs: int = 64,
          max_steps: int = 0, device=device_mod.DEFAULT) -> SearchResult:
    """k-NN of queries [B, n]: greedy descent, then a level-0 beam of
    width max(efs, k) for at most ``max_steps`` (default 4 x width)
    expansions. No guarantee: the graph is ng-only. ``leaves_visited``
    counts hops and steps, ``rows_scanned`` the distances computed."""
    dev = device_mod.matching(idx.data.device, device)
    qf = torch.as_tensor(queries, device=dev).float()
    b = qf.shape[0]
    ef = max(efs, k)  # the candidate list must hold k answers
    max_steps = max_steps or 4 * ef
    lanes = torch.arange(b, device=dev)

    cur = torch.full((b,), idx.entry, dtype=torch.int32, device=dev)
    total_hops = 0
    for level in range(idx.levels - 1, 0, -1):
        cur, hops = _greedy_level(idx, level, qf, cur)
        total_hops += hops

    cand_d = torch.full((b, ef), INF, device=dev)
    cand_i = torch.full((b, ef), -1, dtype=torch.int32, device=dev)
    expanded = torch.zeros((b, ef), dtype=torch.bool, device=dev)
    # one column past the nodes takes the writes of invalid neighbours
    visited = torch.zeros((b, idx.n_total + 1), dtype=torch.bool,
                          device=dev)
    cand_d[:, 0] = _dist_to(qf, idx.data, cur)
    cand_i[:, 0] = cur
    visited[lanes, cur.long()] = True
    active = torch.ones(b, dtype=torch.bool, device=dev)
    ndist = torch.zeros(b, dtype=torch.int32, device=dev)
    fresh = torch.zeros((b, idx.m_links), dtype=torch.bool, device=dev)
    steps = 0
    while steps < max_steps and bool(active.any()):
        md = torch.where(~expanded & (cand_i >= 0), cand_d, INF)
        j = torch.argmin(md, dim=1, keepdim=True)
        best = md.gather(1, j)[:, 0]
        active = active & (best < INF) & (best <= cand_d[:, ef - 1])
        node = cand_i.gather(1, j)[:, 0]
        expanded.scatter_(1, j, expanded.gather(1, j) | active[:, None])
        neigh = idx.adj[0, node.clamp_min(0)]  # [B, M]
        nl = neigh.long()
        valid = (neigh >= 0) & active[:, None] \
            & ~visited.gather(1, nl.clamp_min(0))
        visited[lanes[:, None], torch.where(valid, nl, idx.n_total)] = True
        d = torch.where(valid, _dist_to(qf, idx.data, neigh), INF)
        ndist += valid.sum(1, dtype=torch.int32)
        all_d = torch.cat([cand_d, d], 1)
        all_i = torch.cat([cand_i, torch.where(valid, neigh, -1)], 1)
        all_e = torch.cat([expanded, fresh], 1)
        # stable: the reference's sort is not, but the entries it may
        # order differently are equal (inf, -1, False) tuples
        o = torch.sort(all_d, dim=1, stable=True).indices[:, :ef]
        cand_d, cand_i, expanded = (all_d.gather(1, o), all_i.gather(1, o),
                                    all_e.gather(1, o))
        steps += 1
    return SearchResult(
        dists=torch.sqrt(cand_d[:, :k].clamp_min(0.0)),
        ids=cand_i[:, :k],
        leaves_visited=torch.full((b,), total_hops + steps,
                                  dtype=torch.int32, device=dev),
        rows_scanned=ndist,
        lb_computed=0,
        iterations=total_hops + steps,
    )
