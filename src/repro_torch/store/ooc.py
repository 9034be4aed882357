"""Out-of-core Algorithm 2: the filter on the device, the leaves streamed.

The port of ``src/repro/store/ooc.py``. It runs the same loop as the
in-memory search (``core/search.refine_loop``) over a leaf source that
streams leaves from a store on disk, so visit order, scoring and
stopping, and with them the guarantees, are the in-memory search's:

  CachedStoreSource   f32/bf16 leaves in the DeviceLeafCache's slot pool
                      (filled from disk through the prefetcher), scored
                      with the cached norms of the decoded rows; bf16
                      slots are upcast in the scoring, so the search is
                      the in-memory search over the bfloat16 index.
  PQSource            uint8 PQ codes ADC-scored on the card (K5 solo, K6
                      cooperative); the loop carries padded row positions
                      and ``finalize`` re-ranks them exactly against
                      exact.bin, so the epsilon and delta-epsilon checks
                      hold on exact distances. The exact (epsilon = 0)
                      guarantee does not survive pq: the stopping test's
                      kth-best is an ADC estimate that can prune the true
                      neighbour's leaf, and search_ooc warns if asked.

Each iteration the source reads the window's leaf ids to the host,
makes those leaves cache-resident (one batched upload), and schedules
the next ``prefetch_depth`` windows on the prefetcher, so the disk reads
overlap the scoring. Those reads and the window's upload count under
``search.host_reads{site=ooc_window}``, the pq re-rank's under
``rerank`` (the cache's fills are counted in bytes, ``bytes_h2d``).

With tracing on (``repro_torch.obs``), a search is an ``ooc.query`` span
over ``ooc.filter``, one ``ooc.iteration`` per step (each holding its
``ooc.gather`` and ``ooc.score``) and ``ooc.finalize``, the reference's
taxonomy, with the loop's ``search.*`` spans inside them. The root's
attributes are set from the same OocStats the caller gets; a traced
phase synchronizes the device before its span closes. With tracing off
each site costs one check.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import refine
from repro_torch.core.guarantees import EXACT, Guarantee
from repro_torch.core.refine import INF, Gathered, ScoreCtx
from repro_torch.core.search import Refinement, SearchResult, pad_mask
from repro_torch.core.summaries.pq import adc_lut_batch
from repro_torch.obs import OocStats

from .cache import DeviceLeafCache
from .layout import LeafStore, to_tensor
from .prefetch import LeafPrefetcher

_WINDOW = obs.read_site("ooc_window")
_RERANK = obs.read_site("rerank")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class OocResult(NamedTuple):
    result: SearchResult
    stats: OocStats


class CachedStoreSource:
    """LeafSource over a LeafStore: leaves reach the card through a
    DeviceLeafCache, ``gather`` maps a window to cache slots, and
    ``prefetch`` hands the next windows to the cache's prefetcher.
    ``dead`` ([npad] bool on the store's device, or None) masks
    tombstoned rows."""

    pq = False

    def __init__(self, store: LeafStore, cache: DeviceLeafCache, *,
                 prefetch: bool = True, depth: int = 1,
                 dead: Optional[torch.Tensor] = None):
        self.store = store
        self.cache = cache
        self.prefetch_enabled = prefetch
        self.depth = int(depth)
        self.dead = dead

    @property
    def resident(self):
        return self.store.resident

    def query_ctx(self, queries: torch.Tensor) -> ScoreCtx:
        res = self.store.resident
        return ScoreCtx(qf=queries.float(), ids=res.ids,
                        norms=res.row_norms, dead=self.dead)

    def track_width(self, k: int) -> int:
        return k

    def gather(self, leaf: torch.Tensor, ok: torch.Tensor) -> Gathered:
        """Make the [B, V] window cache-resident and expose it as a gather
        pool. Every lane's request, copies included, goes to the cache, so
        lanes sharing a leaf each count a hit."""
        m = self.store.max_leaf
        leaf_h = obs.host_read(_WINDOW, _host, leaf)
        ok_h = obs.host_read(_WINDOW, _host, ok)
        needed = leaf_h[ok_h]
        with obs.span("ooc.gather") as sp:
            # demand reads only: the prefetcher lands its bytes
            # concurrently, so the root span carries the total
            traced = obs.enabled()
            pre = self.cache.stats().bytes_read_sync if traced else 0
            slots = self.cache.get_slots(needed.tolist())
            slot_h = np.zeros(leaf_h.shape, np.int64)
            slot_h[ok_h] = slots
            dev = leaf.device
            gi = (obs.host_read(_WINDOW, torch.as_tensor, slot_h,
                                device=dev)[:, :, None] * m
                  + torch.arange(m, device=dev)).reshape(leaf.shape[0], -1)
            row_idx, valid = refine.candidate_layout(
                self.resident.offsets, leaf, ok, m,
                self.store.mmap.shape[0] - 1)
            if traced:
                sp.set(bytes_read_sync=(self.cache.stats().bytes_read_sync
                                        - pre))
        return Gathered(pool=self.cache.pool(), gather_idx=gi,
                        row_idx=row_idx, valid=valid)

    def prefetch(self, windows: list) -> None:
        """Stage future windows ([(leaf [B, V], ok [B, V])], nearest
        first), skipping leaves already resident: a warm cache does not
        touch the disk. prefetch=False schedules nothing, so the stats
        measure demand reads only."""
        pf = self.cache.prefetcher
        if not self.prefetch_enabled or pf is None:
            return
        for leaf_w, ok_w in windows:
            ok_h = obs.host_read(_WINDOW, _host, ok_w)
            if not ok_h.any():
                continue
            leaf_h = obs.host_read(_WINDOW, _host, leaf_w)
            nxt = [int(lf) for lf in np.unique(leaf_h[ok_h])
                   if not self.cache.contains(int(lf))]
            if nxt:
                pf.schedule(nxt)

    def score(self, ctx, g, valid, top_d, top_i, *, share):
        with obs.span("ooc.score"):
            out = refine.refine_step(ctx, g.pool, g.gather_idx, g.row_idx,
                                     valid, top_d, top_i, share=share,
                                     pq=self.pq)
            if obs.enabled():
                _sync(out[0])
        return out

    def finalize(self, ctx, top_d, top_i, k: int):
        return top_d, top_i, 0


class PQSource(CachedStoreSource):
    """CachedStoreSource whose slots hold uint8 PQ codes: scoring is the
    pq corner of refine_step (ADC tables in the context, padded row
    positions as candidates), and ``finalize`` re-ranks exactly."""

    pq = True

    def __init__(self, store: LeafStore, cache: DeviceLeafCache, *,
                 rerank: int = 4, **kw):
        super().__init__(store, cache, **kw)
        if store.codebook is None:
            raise ValueError("codec='pq' store has no codebook")
        self.rerank = max(1, int(rerank))

    def query_ctx(self, queries: torch.Tensor) -> ScoreCtx:
        return ScoreCtx(qf=queries.float(), ids=self.resident.ids,
                        norms=None,
                        luts=adc_lut_batch(self.store.codebook, queries),
                        dead=self.dead)

    def track_width(self, k: int) -> int:
        return k * self.rerank

    def finalize(self, ctx, top_d, top_i, k: int):
        return _exact_rerank(self.store, ctx.qf, top_d, top_i, k)


def _exact_rerank(store: LeafStore, qf: torch.Tensor, top_d, top_i,
                  k: int) -> tuple:
    """Re-score the PQ candidate pool (padded row positions [B, kk]) in
    f32 against the raw rows of exact.bin and return the exact top-k
    (squared distances, ids) and the bytes read. Each distinct candidate
    row is read once for the whole batch. A position of -1 (a masked or
    tombstoned slot, or an unfilled one) is never read and stays
    (inf, -1)."""
    pos = obs.host_read(_RERANK, _host, top_i)
    uniq = np.unique(pos[pos >= 0])
    if uniq.size == 0:
        return top_d[:, :k], top_i[:, :k], 0
    raw = store.read_rows_exact(uniq)
    rerank_bytes = int(raw.nbytes)
    dev = qf.device
    rows = obs.host_read(_RERANK, to_tensor, raw, store.meta["data_dtype"],
                         dev).float()
    gather = obs.host_read(_RERANK, torch.as_tensor,
                           np.searchsorted(uniq, np.clip(pos, 0, None)),
                           device=dev)
    # the direct difference, not |q|^2 - 2 q.x + |x|^2: the expanded form
    # loses about 1e-3 to cancellation near zero, and the re-rank promises
    # exact distances (a query equal to a stored row comes back at 0)
    diff = rows[gather] - qf[:, None, :]                # [B, kk, n]
    d = (diff * diff).sum(-1)
    real = obs.host_read(_RERANK, torch.as_tensor, pos >= 0, device=dev)
    d = torch.where(real, d, INF)
    cids = torch.where(real, store.resident.ids[top_i.long().clamp_min(0)],
                       -1)
    o = torch.sort(d, dim=1, stable=True).indices[:, :k]
    return d.gather(1, o), cids.gather(1, o), rerank_bytes


def _sync(t: torch.Tensor) -> None:
    """Wait for the device work behind ``t`` (a traced span covers it)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def make_source(store: LeafStore, cache: DeviceLeafCache, *,
                prefetch: bool = True, depth: int = 1, rerank: int = 4,
                dead: Optional[torch.Tensor] = None):
    """PQSource for a codec="pq" store, CachedStoreSource otherwise."""
    if store.codec == "pq":
        return PQSource(store, cache, prefetch=prefetch, depth=depth,
                        rerank=rerank, dead=dead)
    return CachedStoreSource(store, cache, prefetch=prefetch, depth=depth,
                             dead=dead)


def search_ooc(store: LeafStore, queries, k: int, g: Guarantee = EXACT, *,
               visit_batch: int = 1,
               cache: Optional[DeviceLeafCache] = None,
               cache_leaves: Optional[int] = None, prefetch: bool = True,
               share_gathers: bool = False, rerank: int = 4,
               frontier: Optional[int] = None,
               prefetch_depth: int = 1, fault=None, dead=None,
               n_override: Optional[int] = None) -> OocResult:
    """k-NN over a store opened with ``load_index(resident="summaries")``
    under the guarantee ``g``, on the store's device.

    ``cache`` reuses (and warms) a cache across calls; ``cache_leaves``
    sizes a fresh one (default 1/8 of the leaves, at least one
    iteration's working set). ``prefetch=False`` schedules no reads
    ahead, even on a prefetcher attached to ``cache``, so the stats count
    demand reads only. ``prefetch_depth`` is the lookahead in visit
    windows. ``share_gathers`` scores every gathered leaf against every
    lane. For a pq store, ``rerank * k`` candidates per lane go through
    the ADC loop and are re-ranked exactly at the end. ``frontier`` is
    the visit-order window width (None: the default, widened to the
    prefetch lookahead); any width gives the same visit order. ``fault``
    is the injection hook (serve.fault.FaultContext), checked before
    every gather and score: an exception it raises leaves the cache
    consistent (no gather is half done) and its prefetcher running, so
    the next search on the same cache starts clean. ``dead`` and
    ``n_override`` are the write tier's hooks: a bool mask over the
    store's rows (array or tensor, padded with False to the store's
    padded row count), whose True rows never surface, and the live row
    count r_delta uses in place of the store's ``n_total``."""
    g = g.validate()
    res = store.resident
    q = torch.as_tensor(queries, device=store.device)
    b = q.shape[0]
    L = res.num_leaves
    v = int(visit_batch)
    depth = max(1, int(prefetch_depth))
    if cache is None:
        if cache_leaves is None:
            cache_leaves = max(L // 8, 1)
        cache_leaves = min(max(cache_leaves, b * v), max(L, 1))
        cache = DeviceLeafCache(store, cache_leaves)
    own_prefetcher = None
    if prefetch and cache.prefetcher is None:
        # the staging bound covers every window in flight
        own_prefetcher = cache.prefetcher = LeafPrefetcher(
            store, depth=depth + 1)
    pf_used = cache.prefetcher
    if store.codec == "pq" and g.epsilon == 0.0 and g.nprobe is None:
        # the stopping test compares exact leaf lower bounds with the ADC
        # kth-best, which can underestimate and prune the true
        # neighbour's leaf; the re-rank cannot bring it back
        warnings.warn(
            "codec='pq' cannot honor the exact (epsilon=0) guarantee: "
            "ADC-scored stopping may prune the true neighbor's leaf. Use "
            "epsilon>0 (the epsilon/delta-epsilon checks hold after the "
            "exact re-rank), nprobe, or a lossless codec.", UserWarning,
            stacklevel=2)

    src = make_source(store, cache, prefetch=prefetch, depth=depth,
                      rerank=rerank, dead=pad_mask(dead, store.mmap.shape[0],
                                                   store.device))
    stats = OocStats(codec=store.codec, share_gathers=bool(share_gathers),
                     prefetch_depth=depth, dataset_bytes=store.dataset_nbytes)
    traced = obs.enabled()
    with obs.span("ooc.query", codec=store.codec, lanes=b, k=k,
                  guarantee=g.kind, share_gathers=bool(share_gathers)) as root:
        try:
            # core.search.refine_loop, stepped here so that each phase is
            # a span; the construction runs the filter
            with obs.span("ooc.filter", leaves=L, lanes=b):
                run = Refinement(src, q, k, delta=g.delta, epsilon=g.epsilon,
                                 nprobe=g.nprobe, visit_batch=v,
                                 share_gathers=share_gathers,
                                 frontier=frontier, stats=stats, fault=fault,
                                 n_override=n_override)
                if traced:
                    _sync(run.lb_sq)
            while run.go:
                with obs.span("ooc.iteration", iter=run.iterations):
                    run.step()
            with obs.span("ooc.finalize") as f_span:
                result = run.finish()
                if traced:
                    _sync(result.dists)
                    # the root owns the subtree's one "bytes_read"
                    f_span.set(bytes_read_rerank=stats.bytes_read_rerank)
        finally:
            if own_prefetcher is not None:
                own_prefetcher.close()
                cache.prefetcher = None
        cs = cache.stats()
        for name in ("capacity_leaves", "hits", "hits_distinct", "misses",
                     "hit_rate", "hit_rate_distinct", "bytes_read_sync",
                     "bytes_h2d", "prefetch_hits"):
            setattr(stats, name, getattr(cs, name))
        # every disk byte once: demand reads, the prefetcher's, the
        # re-rank's
        stats.bytes_read = cs.bytes_read_sync + stats.bytes_read_rerank
        if pf_used is not None:
            stats.prefetch_bytes_read = pf_used.bytes_read
            stats.prefetch_leaves_read = pf_used.leaves_read
            stats.bytes_read += pf_used.bytes_read
        # the same OocStats instance feeds the span and the caller
        root.set(bytes_read=stats.bytes_read, bytes_h2d=stats.bytes_h2d,
                 iterations=stats.iterations,
                 frontier_refills=stats.frontier_refills,
                 leaves_visited=stats.leaves_visited,
                 rows_scanned=stats.rows_scanned,
                 pruning_ratio=stats.pruning_ratio,
                 stop_delta=stats.stop_delta,
                 stop_epsilon=stats.stop_epsilon,
                 stop_exhausted=stats.stop_exhausted,
                 delta_slack=stats.delta_slack, eps_slack=stats.eps_slack)
    return OocResult(result=result, stats=stats)
