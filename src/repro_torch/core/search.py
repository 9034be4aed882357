"""Batched Algorithm 1 / Algorithm 2 (the paper's §3.2.3) on torch.

  1. lower-bound every leaf in one pass (the box_mindist kernel);
  2. a lazy leaf frontier gives each query its visit order, the stable
     argsort order of the lower bounds, selected window by window;
  3. a loop over visit ranks: every active lane gathers its next
     ``visit_batch`` leaves, scores their rows, merges them into its
     running top-k and evaluates the stopping predicate

         next_lb > bsf/(1+eps)      [Alg.2 line 10/20 pruning]
       | bsf <= (1+eps) * r_delta   [Alg.2 line 16 early stop]
       | visited >= nprobe          [ng-approximate]
       | exhausted                  [scanned everything]

     where bsf is the kth-best distance. The loop runs on the host and
     reads two flags from the device per iteration (does any lane need a
     frontier refill, is any lane still active).

:func:`refine_loop` is that loop over a leaf source (core.refine): the
index's own rows for :func:`search`, or a store on disk streamed through
a device leaf cache for :func:`search_ooc` (store/ooc.py), whose source
also reads each window's leaf ids to the host to fill the cache.

With nprobe unset this is exact for (delta=1, eps=0), epsilon-approximate
for (1, eps) and delta-epsilon otherwise. All comparisons run on squared
distances. ``visit_batch > 1`` can only visit more leaves, never fewer.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import device as device_mod
from repro_torch.kernels import ops

from repro_torch.obs import OocStats

from . import refine
from .guarantees import EXACT, Guarantee
from .histogram import r_delta
from .index import FrozenIndex, index_device


class SearchResult(NamedTuple):
    dists: torch.Tensor           # [B, k] Euclidean distances, ascending
    ids: torch.Tensor             # [B, k] int32 original ids (-1 = none)
    leaves_visited: torch.Tensor  # [B] int32
    rows_scanned: torch.Tensor    # [B] int32 raw series touched
    lb_computed: int              # leaves lower-bounded (the filter pass)
    iterations: int               # refinement loop iterations


def refine_loop(src, queries: torch.Tensor, k: int, *, delta: float = 1.0,
                epsilon: float = 0.0, nprobe: Optional[int] = None,
                visit_batch: int = 1, share_gathers: bool = False,
                frontier: Optional[int] = None,
                stats: Optional[OocStats] = None) -> SearchResult:
    """Algorithm 2 over queries [B, n] already on the device of the leaf
    source ``src`` (core.refine.LeafSource): the one loop of the resident
    and the out-of-core searches.

    share_gathers: every iteration's gathered rows are scored against
    all lanes, not only the lane that asked for them. Extra candidates
    can only improve a lane's top-k, so every guarantee holds.

    frontier: the lazy frontier's width (None -> default_frontier,
    widened to cover ``src.depth`` prefetch windows). Any width gives the
    same visit order.

    stats: when given, the loop's telemetry (iterations, refills, visit
    totals, stop attribution and slack) is written into it; this costs a
    few small device operations per iteration, so the resident search
    passes None. The returned result is the finalized one and
    ``stats.bytes_read_rerank`` holds what finalize read."""
    b = queries.shape[0]
    dev = queries.device
    index = src.resident
    L = index.num_leaves
    v = visit_batch
    depth = src.depth

    ctx = src.query_ctx(queries)
    lb_sq = refine.leaf_lower_bounds(index, queries)  # [B, L]

    # the window covers this iteration's visits, the next lower bound and
    # the prefetcher's lookahead of ``depth`` windows
    la = (1 + depth) * v
    if frontier is None:
        F = min(max(refine.default_frontier(L, v), la + v), L)
    else:
        F = min(max(int(frontier), min(la + v, L) if depth else v + 1), L)
    lookahead = min(la, F)
    eps_mult = torch.tensor((1.0 + epsilon) ** 2, dtype=torch.float32,
                            device=dev)
    rd = r_delta(index.hist, delta, index.n_total).to(dev)
    rd_sq = rd * rd
    max_rank = L if nprobe is None else min(nprobe, L)

    kk = src.track_width(k)
    rank = torch.zeros(b, dtype=torch.long, device=dev)
    top_d = torch.full((b, kk), refine.INF, device=dev)
    top_i = torch.full((b, kk), -1, dtype=torch.int32, device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    leaves = torch.zeros(b, dtype=torch.int32, device=dev)
    rows = torch.zeros(b, dtype=torch.int32, device=dev)
    fr = refine.frontier_init(b, F, dev)
    steps = torch.arange(v, device=dev)[None, :]
    if stats is not None:
        # refills, then (delta, epsilon, exhausted) stops, then the slack
        # sums at delta and epsilon stops
        counts = torch.zeros(4, dtype=torch.long, device=dev)
        slack = torch.zeros(2, dtype=torch.float64, device=dev)

    iterations = 0
    go = True
    while go:
        iterations += 1
        if stats is not None:
            counts[0] += refine.refill_need(fr, active, lookahead).sum()
        fr, leaf = refine.frontier_tick(fr, lb_sq, active, v=v,
                                        lookahead=lookahead)
        in_range = (rank[:, None] + steps) < max_rank
        ok = in_range & active[:, None]
        g = src.gather(leaf, ok)
        if depth:
            # stage the next ``depth`` windows while this one is scored
            windows = []
            for d in range(1, depth + 1):
                base = torch.clamp(rank + d * v, max=max_rank)
                ok_d = ((base[:, None] + steps) < max_rank) & active[:, None]
                windows.append((refine.frontier_window(fr, d * v, v), ok_d))
            src.prefetch(windows)
        # with share_gathers, copies of a leaf pooled twice this iteration
        # are masked so the pool's ids stay distinct; copies across
        # iterations are merged away by id
        top_d, top_i = src.score(
            ctx, g,
            refine.coop_mask(leaf, ok, g.valid) if share_gathers
            else g.valid, top_d, top_i, share=share_gathers)
        leaves += torch.where(active, in_range.sum(1, dtype=torch.int32), 0)
        rows += torch.where(active, g.valid.sum(1, dtype=torch.int32), 0)

        fr, next_lb = refine.frontier_advance(fr, active, v=v)
        rank = torch.clamp(rank + v, max=max_rank)
        exhausted = rank >= max_rank
        bsf = top_d[:, k - 1]
        stop = refine.stop_mask(next_lb, exhausted, bsf, eps_mult, rd_sq)
        if stats is not None:
            _attribute_stops(active & stop, next_lb, bsf, eps_mult, rd_sq,
                             counts, slack)
        active = active & ~stop
        go = bool(active.any())

    top_d, top_i, extra = src.finalize(ctx, top_d, top_i, k)
    if stats is not None:
        c = counts.tolist()
        sl = slack.tolist()
        lv = int(leaves.sum())
        stats.iterations = iterations
        stats.frontier_refills = c[0]
        stats.leaves_visited = lv
        stats.rows_scanned = int(rows.sum())
        stats.pruning_ratio = 1.0 - lv / (b * L) if b * L else 0.0
        stats.stop_delta, stats.stop_epsilon, stats.stop_exhausted = c[1:]
        stats.delta_slack = sl[0] / c[1] if c[1] else 0.0
        stats.eps_slack = sl[1] / c[2] if c[2] else 0.0
        stats.bytes_read_rerank = extra
    return SearchResult(
        dists=torch.sqrt(top_d),
        ids=top_i,
        leaves_visited=leaves,
        rows_scanned=rows,
        lb_computed=L,
        iterations=iterations,
    )


def _attribute_stops(newly, next_lb, bsf, eps_mult, rd_sq, counts,
                     slack) -> None:
    """Attribute each newly stopped lane to one condition (delta, then
    epsilon, then exhausted) and add the slack at stop, on the device."""
    m_delta = newly & (bsf <= eps_mult * rd_sq)
    m_eps = newly & ~m_delta & (next_lb * eps_mult > bsf)
    m_exh = newly & ~m_delta & ~m_eps
    counts[1:] += torch.stack([m_delta.sum(), m_eps.sum(), m_exh.sum()])
    # epsilon slack only over a finite next_lb: an inf next_lb means the
    # frontier ran dry, not a measurable margin
    m_eps_f = m_eps & torch.isfinite(next_lb)
    slack += torch.stack([
        torch.where(m_delta, eps_mult * rd_sq - bsf, 0.0).double().sum(),
        torch.where(m_eps_f, next_lb * eps_mult - bsf, 0.0).double().sum()])


def search_impl(index: FrozenIndex, queries: torch.Tensor, k: int, *,
                delta: float = 1.0, epsilon: float = 0.0,
                nprobe: Optional[int] = None, visit_batch: int = 1,
                share_gathers: bool = False,
                frontier: Optional[int] = None) -> SearchResult:
    """Algorithm 2 over queries [B, n] already on the index's device:
    :func:`refine_loop` over the index's rows."""
    return refine_loop(refine.ResidentSource(index), queries, k,
                       delta=delta, epsilon=epsilon, nprobe=nprobe,
                       visit_batch=visit_batch, share_gathers=share_gathers,
                       frontier=frontier)


def search(index: FrozenIndex, queries, k: int, g: Guarantee = EXACT, *,
           visit_batch: int = 1, share_gathers: bool = False,
           frontier: Optional[int] = None,
           device=device_mod.DEFAULT) -> SearchResult:
    """Answer k-NN queries [B, n] (array or tensor) under the guarantee
    ``g`` (core.guarantees: exact / epsilon / delta_epsilon / ng). Runs
    on ``device``, where the index must live: the card by default."""
    dev = index_device(index, device)
    g = g.validate()
    q = torch.as_tensor(queries, device=dev)
    return search_impl(index, q, k, delta=g.delta, epsilon=g.epsilon,
                       nprobe=g.nprobe, visit_batch=visit_batch,
                       share_gathers=share_gathers, frontier=frontier)


def brute_force(queries, data, k: int, *,
                device=device_mod.DEFAULT) -> SearchResult:
    """Exact linear scan (the l2 kernel + an exact top-k), the paper's
    yardstick for accuracy."""
    dev = device_mod.resolve(device)
    q = torch.as_tensor(queries, device=dev)
    x = torch.as_tensor(data, device=dev)
    d, i = ops.l2_topk(q, x, k)
    b, n = q.shape[0], x.shape[0]
    return SearchResult(
        dists=torch.sqrt(torch.clamp_min(d, 0.0)),
        ids=i.to(torch.int32),
        leaves_visited=torch.full((b,), n, dtype=torch.int32, device=dev),
        rows_scanned=torch.full((b,), n, dtype=torch.int32, device=dev),
        lb_computed=0,
        iterations=0,
    )


def search_ooc(store, queries, k: int, g: Guarantee = EXACT, **kw):
    """Out-of-core Algorithm 2 over a store opened with
    ``load_index(resident="summaries")``: the same loop as
    :func:`search`, with the leaves streamed from disk through a device
    cache (see ``repro_torch.store.ooc.search_ooc`` for the options).
    Returns OocResult(result=SearchResult, stats=OocStats)."""
    from repro_torch.store.ooc import search_ooc as impl

    return impl(store, queries, k, g, **kw)
