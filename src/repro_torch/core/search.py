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

With nprobe unset this is exact for (delta=1, eps=0), epsilon-approximate
for (1, eps) and delta-epsilon otherwise. All comparisons run on squared
distances. ``visit_batch > 1`` can only visit more leaves, never fewer.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import device as device_mod
from repro_torch.kernels import ops

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


def search_impl(index: FrozenIndex, queries: torch.Tensor, k: int, *,
                delta: float = 1.0, epsilon: float = 0.0,
                nprobe: Optional[int] = None, visit_batch: int = 1,
                share_gathers: bool = False,
                frontier: Optional[int] = None) -> SearchResult:
    """Algorithm 2 over queries [B, n] already on the index's device.

    share_gathers: every iteration's gathered rows are scored against
    all lanes (the coop_score_select kernel), not only the lane that
    asked for them. Extra candidates can only improve a lane's top-k, so
    every guarantee holds.

    frontier: the lazy frontier's width (None -> default_frontier). Any
    width gives the same visit order."""
    b = queries.shape[0]
    dev = queries.device
    L = index.num_leaves
    v = visit_batch

    src = refine.ResidentSource(index)
    ctx = src.query_ctx(queries)
    lb_sq = refine.leaf_lower_bounds(index, queries)  # [B, L]

    F = refine.default_frontier(L, v) if frontier is None \
        else min(max(int(frontier), v + 1), L)
    eps_mult = torch.tensor((1.0 + epsilon) ** 2, dtype=torch.float32,
                            device=dev)
    rd = r_delta(index.hist, delta, index.n_total).to(dev)
    rd_sq = rd * rd
    max_rank = L if nprobe is None else min(nprobe, L)

    rank = torch.zeros(b, dtype=torch.long, device=dev)
    top_d = torch.full((b, k), refine.INF, device=dev)
    top_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    leaves = torch.zeros(b, dtype=torch.int32, device=dev)
    rows = torch.zeros(b, dtype=torch.int32, device=dev)
    fr = refine.frontier_init(b, F, dev)
    steps = torch.arange(v, device=dev)[None, :]

    iterations = 0
    go = True
    while go:
        iterations += 1
        fr, leaf = refine.frontier_tick(fr, lb_sq, active, v=v)
        in_range = (rank[:, None] + steps) < max_rank
        ok = in_range & active[:, None]
        idx, valid = src.gather(leaf, ok)
        # with share_gathers, copies of a leaf pooled twice this iteration
        # are masked so the pool's ids stay distinct; copies across
        # iterations are merged away by id
        top_d, top_i = refine.refine_step(
            ctx, index.data, idx,
            refine.coop_mask(leaf, ok, valid) if share_gathers else valid,
            top_d, top_i, share=share_gathers)
        leaves += torch.where(active, in_range.sum(1, dtype=torch.int32), 0)
        rows += torch.where(active, valid.sum(1, dtype=torch.int32), 0)

        fr, next_lb = refine.frontier_advance(fr, active, v=v)
        rank = torch.clamp(rank + v, max=max_rank)
        exhausted = rank >= max_rank
        stop = refine.stop_mask(next_lb, exhausted, top_d[:, k - 1],
                                eps_mult, rd_sq)
        active = active & ~stop
        go = bool(active.any())

    return SearchResult(
        dists=torch.sqrt(top_d),
        ids=top_i,
        leaves_visited=leaves,
        rows_scanned=rows,
        lb_computed=L,
        iterations=iterations,
    )


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
