"""The refinement core of Algorithm 2: frontier, layout, dedup, scoring,
stopping, and the leaf sources that supply residency.

Counterpart of ``src/repro/core/refine.py``:

  frontier    :class:`FrontierState` with :func:`frontier_tick` and
              :func:`frontier_advance`, the lazy visit-order window. A
              refill selects the lexicographic (lb, leaf-id) successors
              of the last consumed pair, so the emitted order is the
              stable argsort order of the lower bounds for any width.
  layout      :func:`candidate_layout`: a [B, V] leaf window becomes
              padded row positions and their validity.
  dedup       :func:`dup_leaf_mask` / :func:`coop_mask`: copies of a leaf
              pooled twice in one iteration are masked, which keeps the
              cooperative merge's distinct-id precondition.
  scoring     :func:`refine_step`: score, select and merge one
              iteration's candidates, in four corners (solo or pooled
              across lanes) x (raw rows or PQ codes).
  stopping    :func:`stop_mask`: Algorithm 2's predicates.

A :class:`LeafSource` supplies residency to the one loop
(``core/search.refine_loop``): ``query_ctx`` builds the scoring context,
``gather`` makes a leaf window's rows reachable on the device
(:class:`Gathered`), ``score`` folds them into the running top-k, and
``finalize`` maps the final pool to the reported top-k. Implementations:
:class:`ResidentSource` here (a device-resident FrozenIndex), and
``store/ooc.CachedStoreSource`` / ``PQSource`` (leaves streamed from a
store on disk through a device cache).

Leaf ids and row positions are int64 here (torch indexes with int64);
the ids of the rows themselves stay int32, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Protocol, runtime_checkable

import torch

from repro_torch import obs
from repro_torch.kernels import ops

INF = float("inf")
_REFILL = obs.read_site("refill")


# ---------------------------------------------------------------- frontier
def default_frontier(num_leaves: int, visit_batch: int) -> int:
    """Default lazy-frontier width: a few refill-free batches of
    lookahead without approaching the full leaf count."""
    return min(num_leaves, max(64, 4 * visit_batch))


def frontier_select(lb_sq: torch.Tensor, thr_lb: torch.Tensor,
                    thr_id: torch.Tensor, f: int) -> tuple:
    """Each lane's next ``f`` visit ranks: the lexicographic (lb,
    leaf-id) successors of the lane's threshold pair ((-1, -1) selects
    the first window). Returns (lb [B, f], leaf ids [B, f] int64)."""
    iota = torch.arange(lb_sq.shape[1], device=lb_sq.device)
    after = (lb_sq > thr_lb[:, None]) | (
        (lb_sq == thr_lb[:, None]) & (iota[None, :] > thr_id[:, None]))
    return ops.smallest_k(torch.where(after, lb_sq, INF), f)


class FrontierState(NamedTuple):
    """Per-lane lazy visit-order window and refill threshold. Starts
    empty (pos = F): the first :func:`frontier_tick` fills it."""
    lb: torch.Tensor      # [B, F] window lower bounds
    ids: torch.Tensor     # [B, F] window leaf ids (int64)
    pos: torch.Tensor     # [B] next unconsumed window position
    thr_lb: torch.Tensor  # [B] last consumed lb (refill threshold)
    thr_id: torch.Tensor  # [B] last consumed leaf id


def frontier_init(b: int, f: int, device) -> FrontierState:
    return FrontierState(
        lb=torch.full((b, f), INF, device=device),
        ids=torch.zeros((b, f), dtype=torch.long, device=device),
        pos=torch.full((b,), f, dtype=torch.long, device=device),
        thr_lb=torch.full((b,), -1.0, device=device),
        thr_id=torch.full((b,), -1, dtype=torch.long, device=device),
    )


def frontier_window(st: FrontierState, offset: int, v: int
                    ) -> torch.Tensor:
    """[B, V] leaf ids at window positions pos+offset .. pos+offset+V-1,
    clamped to the window's end (callers mask out-of-rank slots).
    offset=0 is this iteration's window, offset=d*V the d-th window the
    prefetcher is asked to stage."""
    f = st.lb.shape[1]
    ppos = torch.clamp(st.pos[:, None] + offset
                       + torch.arange(v, device=st.pos.device)[None, :],
                       max=f - 1)
    return st.ids.gather(1, ppos)


def refill_need(st: FrontierState, active: torch.Tensor,
                lookahead: int) -> torch.Tensor:
    """[B] lanes whose window no longer covers the next ``lookahead``
    positions and the next lower bound."""
    f = st.lb.shape[1]
    return active & (st.pos > f - 1 - min(lookahead, f))


def frontier_tick(st: FrontierState, lb_sq: torch.Tensor,
                  active: torch.Tensor, *, v: int, lookahead: int) -> tuple:
    """Refill the lanes that :func:`refill_need` names (skipped when no
    lane needs it: the host reads that flag, ``search.host_reads`` site
    ``refill``), then emit this iteration's [B, V] leaf window."""
    f = st.lb.shape[1]
    need = refill_need(st, active, lookahead)
    if obs.host_read(_REFILL, bool, need.any()):
        nv, ni = frontier_select(lb_sq, st.thr_lb, st.thr_id, f)
        sel = need[:, None]
        st = st._replace(lb=torch.where(sel, nv, st.lb),
                         ids=torch.where(sel, ni, st.ids),
                         pos=torch.where(need, 0, st.pos))
    return st, frontier_window(st, 0, v)


def frontier_advance(st: FrontierState, active: torch.Tensor, *, v: int
                     ) -> tuple:
    """Consume this iteration's v positions: peek the next unvisited lb
    (the stopping predicate's next_lb), move the refill threshold to the
    last consumed (lb, leaf-id) pair, advance the position. Inactive
    lanes keep their threshold."""
    f = st.lb.shape[1]
    peek = torch.clamp(st.pos + v, max=f - 1)[:, None]
    next_lb = st.lb.gather(1, peek)[:, 0]
    last = torch.clamp(st.pos + v - 1, max=f - 1)[:, None]
    thr_lb = torch.where(active, st.lb.gather(1, last)[:, 0], st.thr_lb)
    thr_id = torch.where(active, st.ids.gather(1, last)[:, 0], st.thr_id)
    return st._replace(pos=st.pos + v, thr_lb=thr_lb,
                       thr_id=thr_id), next_lb


# ------------------------------------------------------------------ layout
def candidate_layout(offsets: torch.Tensor, leaf: torch.Tensor,
                     ok: torch.Tensor, max_leaf: int, clamp: int) -> tuple:
    """[B, V] leaf window + slot-usable mask -> ([B, V*M] row positions
    clamped to ``clamp``, [B, V*M] validity). A position is valid iff it
    lies inside its leaf's extent and its slot is usable; invalid ones
    read a clamped row that scoring masks to inf."""
    b, v = leaf.shape
    start = offsets[leaf].long()
    end = offsets[leaf + 1].long()
    pos = torch.arange(max_leaf, device=leaf.device)[None, None, :]
    idx = start[:, :, None] + pos
    valid = (idx < end[:, :, None]) & ok[:, :, None]
    idx = torch.clamp(idx, max=clamp)
    return idx.reshape(b, v * max_leaf), valid.reshape(b, v * max_leaf)


# ------------------------------------------------------------------- dedup
def dup_leaf_mask(leaf: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """[B, V] True where the slot repeats a leaf already pooled by an
    earlier usable slot this iteration: sort slots by (leaf, usable
    first, position), and a slot is a copy iff its group's leader is
    usable and earlier."""
    bv = leaf.numel()
    fl = leaf.reshape(bv).long()
    fo = ok.reshape(bv)
    posv = torch.arange(bv, device=leaf.device)
    rank = torch.where(fo, posv, posv + bv)  # usable slots sort first
    pos_s = torch.argsort(fl * (2 * bv) + rank)  # keys are unique
    leaf_s = fl[pos_s]
    ok_s = fo[pos_s]
    is_start = torch.ones(bv, dtype=torch.bool, device=leaf.device)
    is_start[1:] = leaf_s[1:] != leaf_s[:-1]
    start_idx = torch.cummax(torch.where(is_start, posv, 0), 0).values
    dup_s = ok_s[start_idx] & (pos_s[start_idx] < pos_s)
    dup = torch.zeros(bv, dtype=torch.bool, device=leaf.device)
    dup[pos_s] = dup_s
    return dup.reshape(leaf.shape)


def coop_mask(leaf: torch.Tensor, ok: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Cooperative-pool validity: ``valid`` [B, V*M] with same-iteration
    copies of a leaf masked out. Per-lane visit accounting keeps the
    unmasked ``valid``."""
    m = valid.shape[1] // leaf.shape[1]
    return valid & ~dup_leaf_mask(leaf, ok).repeat_interleave(m, dim=1)


# ----------------------------------------------------------------- scoring
class ScoreCtx(NamedTuple):
    """Per-query-batch scoring context."""
    qf: torch.Tensor                # [B, n] f32 queries
    ids: torch.Tensor               # [Npad] int32 row ids
    norms: Optional[torch.Tensor]   # [Npad] f32 squared row norms (raw)
    luts: Optional[torch.Tensor] = None  # [B, m, K] ADC tables (pq only)
    # [Npad] bool row tombstones: True rows are superseded by the write
    # tier (deleted or inserted again) and never surface from this frozen
    # unit; None for a unit with nothing killed, at no cost
    dead: Optional[torch.Tensor] = None


class Gathered(NamedTuple):
    """One iteration's candidates: ``pool[gather_idx]`` are the encoded
    rows, ``row_idx`` the same slots' padded row positions (ids, norms,
    re-rank reads). The two differ when the pool is a cache's slots."""
    pool: torch.Tensor        # [P, cols] gather pool (rows or cache slots)
    gather_idx: torch.Tensor  # [B, V*M] int64 into pool
    row_idx: torch.Tensor     # [B, V*M] int64 padded row positions
    valid: torch.Tensor       # [B, V*M] bool


def refine_step(ctx: ScoreCtx, pool: torch.Tensor, gather_idx: torch.Tensor,
                row_idx: torch.Tensor, valid, top_d, top_i, *, share: bool,
                pq: bool) -> tuple:
    """One iteration's score + select + merge into the running top-k:

      solo raw    gather [B, V*M] rows per lane, squared L2 with the
                  cached norms, topk_merge.
      coop raw    pool every lane's rows; every lane scores the whole pool
                  and keeps its best 2k (the coop_score_select kernel),
                  then a merge that keeps each id once.
      solo pq     ADC of each lane's code rows against its table (the
                  pq_adc_batch kernel), merge padded row positions (the
                  exact re-rank maps them to ids).
      coop pq     every lane ADC-scores the whole pool and keeps its best
                  2k (the pq_adc_select kernel), dedup merge.

    For share=True the caller passes the coop_mask'ed validity (the
    distinct-id precondition). Candidates are ids for raw rows and padded
    row positions for pq; masked slots carry -1 in both.

    Tombstones (``ctx.dead``) are folded into validity before the
    candidates are formed, so a dead row scores inf with candidate -1 in
    every corner: it never enters a running top-k, and a pq re-rank never
    reads it."""
    k = top_d.shape[1]
    if ctx.dead is not None:
        valid = valid & ~ctx.dead[row_idx]
    if pq:
        cand = torch.where(valid, row_idx, -1).to(torch.int32)
    else:
        cand = torch.where(valid, ctx.ids[row_idx], -1)
    if share:
        flat = gather_idx.reshape(-1)
        candf = cand.reshape(-1)
        kk = min(2 * k, candf.shape[0])
        if pq:
            sel_d, sel_i = ops.pq_adc_select(pool[flat], ctx.luts, candf, kk)
        else:
            sel_d, sel_i = ops.coop_score_select(
                ctx.qf, pool[flat], ctx.norms[row_idx.reshape(-1)], candf,
                kk)
        return ops.dedup_merge_topk(sel_d, sel_i, top_d, top_i)
    rows = pool[gather_idx]
    if pq:
        d = ops.pq_adc_batch(rows, ctx.luts)
    else:
        d = ops.sq_l2(ctx.qf, rows, ctx.norms[row_idx])
    return ops.topk_merge(torch.where(valid, d, INF), cand, top_d, top_i)


# ---------------------------------------------------------------- stopping
def stop_mask(next_lb, exhausted, bsf, eps_mult, rd_sq):
    """Algorithm 2's stopping predicates in squared-distance space:

        next_lb * (1+eps)^2 > bsf      [Alg.2 line 10/20 pruning]
      | bsf <= (1+eps)^2 * r_delta^2   [Alg.2 line 16 early stop]
      | exhausted                      [rank budget / scanned all]
    """
    return (next_lb * eps_mult > bsf) | (bsf <= eps_mult * rd_sq) \
        | exhausted


def leaf_lower_bounds(index, queries: torch.Tensor) -> torch.Tensor:
    """Filter stage: the squared lower bound of every leaf for every lane
    [B, L], through the box_mindist kernel."""
    q_sum = index.summarize_queries(queries).contiguous()
    return ops.box_mindist(q_sum, index.box_lo, index.box_hi,
                           index.weights)


# -------------------------------------------------------------- LeafSource
@runtime_checkable
class LeafSource(Protocol):
    """Residency behind the refinement loop. ``pq`` selects the scoring
    codec (ADC + re-rank, or L2 on raw rows); ``track_width`` is the
    per-lane candidate pool the loop carries (k, or rerank*k for pq);
    ``depth`` is how many visit windows ahead ``prefetch`` stages (0: no
    prefetching); ``finalize`` maps the final pool to the reported top-k
    and returns the bytes it read."""

    pq: bool
    depth: int

    @property
    def resident(self): ...

    def query_ctx(self, queries: torch.Tensor) -> ScoreCtx: ...

    def track_width(self, k: int) -> int: ...

    def gather(self, leaf: torch.Tensor, ok: torch.Tensor) -> Gathered: ...

    def prefetch(self, windows: list) -> None: ...

    def score(self, ctx: ScoreCtx, g: Gathered, valid, top_d, top_i, *,
              share: bool) -> tuple: ...

    def finalize(self, ctx: ScoreCtx, top_d, top_i, k: int) -> tuple: ...


class ResidentSource:
    """The leaf source of a device-resident FrozenIndex: gathering is
    device indexing into the index's rows. ``dead`` ([Npad] bool on the
    index's device, or None) masks tombstoned rows."""

    pq = False
    depth = 0

    def __init__(self, index, dead: Optional[torch.Tensor] = None):
        self.index = index
        self.dead = dead

    @property
    def resident(self):
        return self.index

    def query_ctx(self, queries: torch.Tensor) -> ScoreCtx:
        return ScoreCtx(qf=queries.float(), ids=self.index.ids,
                        norms=self.index.row_norms, dead=self.dead)

    def track_width(self, k: int) -> int:
        return k

    def gather(self, leaf: torch.Tensor, ok: torch.Tensor) -> Gathered:
        idx, valid = candidate_layout(self.index.offsets, leaf, ok,
                                      self.index.max_leaf,
                                      self.index.data.shape[0] - 1)
        return Gathered(pool=self.index.data, gather_idx=idx, row_idx=idx,
                        valid=valid)

    def prefetch(self, windows: list) -> None:
        pass

    def score(self, ctx, g, valid, top_d, top_i, *, share):
        return refine_step(ctx, g.pool, g.gather_idx, g.row_idx, valid,
                           top_d, top_i, share=share, pq=False)

    def finalize(self, ctx, top_d, top_i, k):
        return top_d, top_i, 0
