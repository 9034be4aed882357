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

Every wait for the device in the loop goes through ``obs.host_read`` and
counts under ``search.host_reads{site}`` (always on): ``refill`` and
``settle`` once an iteration, ``eps_mult`` and ``r_delta`` (two scalars
copied up from pageable host memory) once a :class:`Refinement`, and
``stats`` where the out-of-core telemetry is read. The phases are spans
(``search.filter``, ``search.advance`` holding ``search.frontier``,
``search.gather`` and ``search.score``, ``search.settle``,
``search.finish``) that never wait for the device (obs/trace.py).

:class:`Refinement` is that loop over a leaf source (core.refine), one
iteration a step, and :func:`refine_loop` runs it to its end: over the
index's own rows for :func:`search`, or over a store on disk streamed
through a device leaf cache for :func:`search_ooc` (store/ooc.py), whose
source also reads each window's leaf ids to the host to fill the cache.
The engine (core/engine.py) steps several in lockstep.

With nprobe unset this is exact for (delta=1, eps=0), epsilon-approximate
for (1, eps) and delta-epsilon otherwise. All comparisons run on squared
distances. ``visit_batch > 1`` can only visit more leaves, never fewer.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import device as device_mod
from repro_torch import obs
from repro_torch.kernels import ops
from repro_torch.obs import OocStats

from . import refine
from .guarantees import EXACT, Guarantee
from .histogram import r_delta
from .index import FrozenIndex, index_device

_EPS_MULT = obs.read_site("eps_mult")
_R_DELTA = obs.read_site("r_delta")
_SETTLE = obs.read_site("settle")
_STATS = obs.read_site("stats")
_ITERATIONS = obs.REGISTRY.counter("search.iterations")
_POOLED_ROWS = obs.REGISTRY.counter("search.pooled_rows")
_POOLED_PAIRS = obs.REGISTRY.counter("search.pooled_pairs")
POOL_FOLD = 16  # iterations whose coop masks are held before they count


class SearchResult(NamedTuple):
    dists: torch.Tensor           # [B, k] Euclidean distances, ascending
    ids: torch.Tensor             # [B, k] int32 original ids (-1 = none)
    leaves_visited: torch.Tensor  # [B] int32
    rows_scanned: torch.Tensor    # [B] int32 raw series touched
    lb_computed: int              # leaves lower-bounded (the filter pass)
    iterations: int               # refinement loop iterations


class Refinement:
    """Algorithm 2 over queries [B, n] already on the device of the leaf
    source ``src`` (core.refine.LeafSource), one iteration at a time: the
    one loop of the resident and the out-of-core searches.

    Construction runs the filter and sets the loop's state; each
    :meth:`step` is one iteration, and :attr:`go` says whether any lane
    is still active; :meth:`finish` returns the result. A step is
    :meth:`advance` (gather, score, move the frontier) then
    :meth:`settle` (the stopping test against a best-so-far), so the
    engine can step shards in lockstep and settle each against the
    kth-best over all of them.

    share_gathers: every iteration's gathered rows are scored against
    all lanes, not only the lane that asked for them. Extra candidates
    can only improve a lane's top-k, so every guarantee holds.

    frontier: the lazy frontier's width (None -> default_frontier,
    widened to cover ``src.depth`` prefetch windows). Any width gives the
    same visit order.

    stats: when given, the loop's telemetry (iterations, refills, visit
    totals, stop attribution and slack) is written into it by
    :meth:`finish`; this costs a few small device operations per
    iteration, so the resident search passes None.

    With share_gathers and a span sink on (``obs.sink_on()``: tracing
    enabled or a profiler recording), each iteration's coop mask and
    active lanes are kept (references, no launch), and every
    :data:`POOL_FOLD` iterations and at :meth:`finish` their distinct
    valid pooled rows, and those rows times the lanes still active, are
    summed on the device into ``search.pooled_rows`` and
    ``search.pooled_pairs`` (a dozen small launches, read to the host
    when those counters are read): the work the cooperative score pass
    does for the answers.

    fault: the injection hook (duck-typed; serve.fault.FaultContext in
    the engine): ``fault.check("gather")`` runs before every gather and
    ``fault.check("score")`` before every scoring step, where injected
    faults fire and attempt deadlines are polled.

    n_override: the row count r_delta is evaluated at, in place of the
    index's ``n_total``: the write tier's joint live N
    (core.guarantees.joint_n_total), which inserts raise. A stale,
    smaller N would stop delta-epsilon lanes too early. The write tier's
    tombstones reach the loop through the source (``src.query_ctx``)."""

    def __init__(self, src, queries: torch.Tensor, k: int, *,
                 delta: float = 1.0, epsilon: float = 0.0,
                 nprobe: Optional[int] = None, visit_batch: int = 1,
                 share_gathers: bool = False,
                 frontier: Optional[int] = None,
                 stats: Optional[OocStats] = None, fault=None,
                 n_override: Optional[int] = None):
        with obs.span("search.filter"):
            b = queries.shape[0]
            dev = queries.device
            index = src.resident
            L = index.num_leaves
            v = visit_batch
            depth = src.depth
            self.src, self.k, self.v, self.L = src, k, v, L
            self.share = share_gathers
            self.stats, self.fault = stats, fault

            self.ctx = src.query_ctx(queries)
            self.lb_sq = refine.leaf_lower_bounds(index, queries)  # [B, L]

            # the window covers this iteration's visits, the next lower bound
            # and the prefetcher's lookahead of ``depth`` windows
            la = (1 + depth) * v
            if frontier is None:
                F = min(max(refine.default_frontier(L, v), la + v), L)
            else:
                F = min(max(int(frontier), min(la + v, L) if depth else v + 1),
                        L)
            self.lookahead = min(la, F)
            self.eps_mult = obs.host_read(
                _EPS_MULT, torch.tensor, (1.0 + epsilon) ** 2,
                dtype=torch.float32, device=dev)
            n = index.n_total if n_override is None else n_override
            rd = obs.host_read(_R_DELTA,
                               lambda: r_delta(index.hist, delta, n).to(dev))
            self.rd_sq = rd * rd
            self.max_rank = L if nprobe is None else min(nprobe, L)

            kk = src.track_width(k)
            self.rank = torch.zeros(b, dtype=torch.long, device=dev)
            self.top_d = torch.full((b, kk), refine.INF, device=dev)
            self.top_i = torch.full((b, kk), -1, dtype=torch.int32, device=dev)
            self.active = torch.ones(b, dtype=torch.bool, device=dev)
            self.leaves = torch.zeros(b, dtype=torch.int32, device=dev)
            self.rows = torch.zeros(b, dtype=torch.int32, device=dev)
            self.fr = refine.frontier_init(b, F, dev)
            self.steps = torch.arange(v, device=dev)[None, :]
            if stats is not None:
                # refills, then (delta, epsilon, exhausted) stops, then the
                # slack sums at delta and epsilon stops
                self.counts = torch.zeros(4, dtype=torch.long, device=dev)
                self.slack = torch.zeros(2, dtype=torch.float64, device=dev)
            # (coop mask, active lanes) of the iterations not yet counted
            self.pooled = [] if share_gathers and obs.sink_on() else None
            self.iterations = 0
            self.go = True
            self._next_lb = self._exhausted = None

    @property
    def bsf(self) -> torch.Tensor:
        """[B] each lane's kth-best squared distance so far."""
        return self.top_d[:, self.k - 1]

    def advance(self) -> None:
        """The first half of an iteration: every active lane gathers its
        next window, scores it into its top-k, and the frontier moves."""
        with obs.span("search.advance"):
            self._advance()

    def _advance(self) -> None:
        src, v, active = self.src, self.v, self.active
        self.iterations += 1
        _ITERATIONS.inc()
        if self.stats is not None:
            self.counts[0] += refine.refill_need(self.fr, active,
                                                 self.lookahead).sum()
        with obs.span("search.frontier"):
            fr, leaf = refine.frontier_tick(self.fr, self.lb_sq, active, v=v,
                                            lookahead=self.lookahead)
        in_range = (self.rank[:, None] + self.steps) < self.max_rank
        ok = in_range & active[:, None]
        if self.fault is not None:
            self.fault.check("gather")
        with obs.span("search.gather"):
            g = src.gather(leaf, ok)
        if src.depth:
            # stage the next ``depth`` windows while this one is scored
            windows = []
            for d in range(1, src.depth + 1):
                base = torch.clamp(self.rank + d * v, max=self.max_rank)
                ok_d = (((base[:, None] + self.steps) < self.max_rank)
                        & active[:, None])
                windows.append((refine.frontier_window(fr, d * v, v), ok_d))
            src.prefetch(windows)
        if self.fault is not None:
            self.fault.check("score")
        with obs.span("search.score"):
            valid = g.valid
            if self.share:
                # copies of a leaf pooled twice this iteration are masked
                # so the pool's ids stay distinct; copies across
                # iterations are merged away by id
                valid = refine.coop_mask(leaf, ok, g.valid)
                if self.pooled is not None:
                    self.pooled.append((valid, active))
                    if len(self.pooled) == POOL_FOLD:
                        self._count_pool()
            self.top_d, self.top_i = src.score(self.ctx, g, valid, self.top_d,
                                               self.top_i, share=self.share)
        self.leaves += torch.where(active, in_range.sum(1, dtype=torch.int32),
                                   0)
        self.rows += torch.where(active, g.valid.sum(1, dtype=torch.int32), 0)

        self.fr, self._next_lb = refine.frontier_advance(fr, active, v=v)
        self.rank = torch.clamp(self.rank + v, max=self.max_rank)
        self._exhausted = self.rank >= self.max_rank

    def settle(self, bsf: torch.Tensor) -> bool:
        """The second half: stop the lanes that meet a predicate against
        ``bsf`` [B] (:attr:`bsf`, or a kth-best over several shards, no
        larger). Returns :attr:`go`."""
        with obs.span("search.settle"):
            next_lb = self._next_lb
            stop = refine.stop_mask(next_lb, self._exhausted, bsf,
                                    self.eps_mult, self.rd_sq)
            if self.stats is not None:
                _attribute_stops(self.active & stop, next_lb, bsf,
                                 self.eps_mult, self.rd_sq, self.counts,
                                 self.slack)
            self.active = self.active & ~stop
            self.go = obs.host_read(_SETTLE, bool, self.active.any())
        return self.go

    def step(self) -> bool:
        self.advance()
        return self.settle(self.bsf)

    def finish(self) -> SearchResult:
        """The finalized result (``stats.bytes_read_rerank`` holds what
        the source's finalize read)."""
        with obs.span("search.finish"):
            return self._finish()

    def _finish(self) -> SearchResult:
        b = self.top_d.shape[0]
        top_d, top_i, extra = self.src.finalize(self.ctx, self.top_d,
                                                self.top_i, self.k)
        stats, L = self.stats, self.L
        if stats is not None:
            c = obs.host_read(_STATS, self.counts.tolist)
            sl = obs.host_read(_STATS, self.slack.tolist)
            lv = obs.host_read(_STATS, int, self.leaves.sum())
            stats.iterations = self.iterations
            stats.frontier_refills = c[0]
            stats.leaves_visited = lv
            stats.rows_scanned = obs.host_read(_STATS, int, self.rows.sum())
            stats.pruning_ratio = 1.0 - lv / (b * L) if b * L else 0.0
            stats.stop_delta, stats.stop_epsilon, stats.stop_exhausted = c[1:]
            stats.delta_slack = sl[0] / c[1] if c[1] else 0.0
            stats.eps_slack = sl[1] / c[2] if c[2] else 0.0
            stats.bytes_read_rerank = extra
        if self.pooled:
            self._count_pool()
        return SearchResult(
            dists=torch.sqrt(top_d),
            ids=top_i,
            leaves_visited=self.leaves,
            rows_scanned=self.rows,
            lb_computed=L,
            iterations=self.iterations,
        )

    def _count_pool(self) -> None:
        """Add the kept iterations' pooled rows and pairs to the counters,
        on the device, and drop them."""
        masks, lanes = zip(*self.pooled)
        self.pooled = []
        rows = torch.stack(masks).sum((1, 2), dtype=torch.int32)
        pairs = rows * torch.stack(lanes).sum(1)
        _POOLED_ROWS.inc(rows.sum())
        _POOLED_PAIRS.inc(pairs.sum())


def refine_loop(src, queries: torch.Tensor, k: int, **kw) -> SearchResult:
    """Algorithm 2 run to its end over one leaf source: a
    :class:`Refinement` stepped until no lane is active (the keywords
    are its own)."""
    r = Refinement(src, queries, k, **kw)
    while r.go:
        r.step()
    return r.finish()


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
                frontier: Optional[int] = None,
                dead: Optional[torch.Tensor] = None,
                n_override: Optional[int] = None) -> SearchResult:
    """Algorithm 2 over queries [B, n] already on the index's device:
    :func:`refine_loop` over the index's rows. ``dead`` ([Npad] bool on
    the index's device) masks tombstoned rows; ``n_override`` is
    :class:`Refinement`'s."""
    return refine_loop(refine.ResidentSource(index, dead), queries, k,
                       delta=delta, epsilon=epsilon, nprobe=nprobe,
                       visit_batch=visit_batch, share_gathers=share_gathers,
                       frontier=frontier, n_override=n_override)


def search(index: FrozenIndex, queries, k: int, g: Guarantee = EXACT, *,
           visit_batch: int = 1, share_gathers: bool = False,
           frontier: Optional[int] = None, dead=None,
           n_override: Optional[int] = None,
           device=device_mod.DEFAULT) -> SearchResult:
    """Answer k-NN queries [B, n] (array or tensor) under the guarantee
    ``g`` (core.guarantees: exact / epsilon / delta_epsilon / ng). Runs
    on ``device``, where the index must live: the card by default.

    The write tier's hooks: ``dead`` is a bool mask over the index's
    padded rows (shorter masks are padded with False), whose True rows
    never surface; ``n_override`` is the live row count r_delta uses in
    place of ``index.n_total``.

    With tracing on (``repro_torch.obs``) the call is a ``core.search``
    span; its visit totals are read from the device when the spans are
    read, so the call does not wait for the device; untraced calls pay
    one check."""
    dev = index_device(index, device)
    g = g.validate()
    q = torch.as_tensor(queries, device=dev)
    with obs.span("core.search", lanes=q.shape[0], k=k,
                  leaves=index.num_leaves) as sp:
        res = search_impl(index, q, k, delta=g.delta, epsilon=g.epsilon,
                          nprobe=g.nprobe, visit_batch=visit_batch,
                          share_gathers=share_gathers, frontier=frontier,
                          dead=pad_mask(dead, index.data.shape[0], dev),
                          n_override=n_override)
        sp.set(leaves_visited=res.leaves_visited,
               rows_scanned=res.rows_scanned)
    return res


def search_with_guarantee(index: FrozenIndex, queries, k: int,
                          g: Guarantee, **kw) -> SearchResult:
    """:func:`search` under the guarantee ``g`` (the reference's name)."""
    return search(index, queries, k, g, **kw)


def pad_mask(dead, n_rows: int, device) -> Optional[torch.Tensor]:
    """A tombstone mask (array or tensor, or None) as an [n_rows] bool
    tensor on ``device``, padded with False: ``ScoreCtx.dead[row_idx]``
    reads every padded row position. None stays None."""
    if dead is None:
        return None
    m = torch.as_tensor(dead, dtype=torch.bool, device=device).reshape(-1)
    if m.shape[0] > n_rows:
        raise ValueError(f"tombstone mask of {m.shape[0]} rows for "
                         f"{n_rows} padded rows")
    if m.shape[0] < n_rows:
        m = torch.cat([m, m.new_zeros(n_rows - m.shape[0])])
    return m


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
