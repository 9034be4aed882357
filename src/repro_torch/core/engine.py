"""DistributedEngine: the paper's methods over a range-sharded collection.

The port of ``src/repro/core/engine.py`` for one card: S shards live on
one device, with no mesh. Each shard owns a FrozenIndex over its rows
(ids stay global) plus the global distance histogram and the global N,
so every shard's r_delta has the single-index semantics. A query batch
goes to every shard, each runs Algorithm 2 over its rows, and the
per-shard top-k rows are merged.

Guarantees survive the sharding: every global r-th neighbour lies in
some shard where it ranks <= r; that shard's guarantee bounds its
reported r-th by (1 + eps) times its true r-th, which is no larger than
the global true r-th, and the merge only improves each rank. For
delta < 1 each shard's stop radius uses the global N, which is
conservative.

Two modes:

  resident      ``build(..., store=StoreSpec(keep_resident=True))``:
                the shards stay on the device, padded to the widest
                shard's leaves and rows as the reference pads them for
                its mesh, and are searched one after another;
                ``sync_bsf=True`` steps them in lockstep and stops each
                lane against the kth-best over all shards (the
                single-card form of the reference's pmin).
  out of core   ``build(..., keep_resident=False)`` or
                :meth:`DistributedEngine.open_spill`: each shard is a
                store on disk, with ``replicas`` copies. The shards are
                served one after another through
                serve/fault.serve_shard_with_failover, with retries,
                failover across copies and a circuit breaker, and each
                answer is folded with ``ops.topk_merge_unique`` as it
                lands (a commutative (d, id)-lex selection, so the order
                of the shards cannot change the answer). A shard lost
                past every copy degrades the answer honestly: the fold
                completes over the survivors and the stats carry
                ``degraded``, ``shards_lost`` and an ``effective_delta``
                recomputed from the histogram mass that the missing rows
                own (core.guarantees.effective_delta_after_loss).

On one card the shards are folded sequentially: owner threads sharing
one interpreter and one stream slowed each other (4 owners took 1.9x
the sequential fold's time on an H100). Concurrent queries stay safe:
each store copy's warm cache serves one query at a time under its lock.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import threading
import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.kernels import ops
from repro_torch.obs import REGISTRY, OocStats

from . import refine
from .guarantees import EXACT, Guarantee, effective_delta_after_loss
from .histogram import DEFAULT_SEED, build_histogram
from .index import FrozenIndex
from .indexes import dstree, isax, vafile
from .search import Refinement
from .spec import IndexSpec, StoreSpec


class QueryResult(NamedTuple):
    """What :meth:`DistributedEngine.query` returns: the merged answer,
    the visit counts summed over shards, the per-query OocStats (None on
    the resident path, which does no I/O) and each shard's iterations
    (0 for a lost shard)."""

    dists: torch.Tensor           # [B, k] Euclidean distances, ascending
    ids: torch.Tensor             # [B, k] int32 global row ids (-1 = none)
    leaves_visited: torch.Tensor  # [B] int32, summed over shards
    rows_scanned: torch.Tensor    # [B] int32, summed over shards
    lb_computed: int
    stats: Optional[OocStats] = None
    iterations: Tuple[int, ...] = ()


_BUILDERS = {
    "isax2+": isax.build,
    "dstree": dstree.build,
    "va+file": vafile.build,
}


def _pad_to(t: torch.Tensor, target: int, fill) -> torch.Tensor:
    """t with rows of ``fill`` appended up to ``target`` rows."""
    if t.shape[0] == target:
        return t
    pad = torch.full((target - t.shape[0],) + tuple(t.shape[1:]), fill,
                     dtype=t.dtype, device=t.device)
    return torch.cat([t, pad])


def _pad_shard(idx: FrozenIndex, n_leaves: int,
               n_rows: int) -> FrozenIndex:
    """One shard padded to the widest shard, as the reference pads its
    stacked shards: extra leaves get boxes at 1e30 (their lower bound is
    inf, so they come last) and empty extents at the end; extra rows are
    zero, with norm 0 and id -1. The shard keeps its own ``max_leaf``
    (the reference's stacked index shares the largest): the candidate
    width is then its store's, so a resident shard and its out-of-core
    store score with the same shapes and agree bit for bit, and no count
    changes (padded slots are invalid)."""
    off = idx.offsets
    return dataclasses.replace(
        idx,
        box_lo=_pad_to(idx.box_lo, n_leaves, 1e30),
        box_hi=_pad_to(idx.box_hi, n_leaves, 1e30),
        offsets=_pad_to(off, n_leaves + 1, int(off[-1])),
        data=_pad_to(idx.data, n_rows, 0.0),
        ids=_pad_to(idx.ids, n_rows, -1),
        row_norms=_pad_to(idx.row_norms, n_rows, 0.0))


def _discover_replicas(spill_dir: str, shard_dirs: Tuple[str, ...]
                       ) -> Tuple[Tuple[str, ...], ...]:
    """Per shard: (primary, *replica copies) found on disk. Replicas live
    under spill_dir/replicas/rN/shard_NNNN, not under top-level shard_*
    names, which open_spill would take for more shards."""
    rep_root = os.path.join(spill_dir, "replicas")
    rdirs = sorted(os.listdir(rep_root)) if os.path.isdir(rep_root) else []
    out = []
    for d in shard_dirs:
        name = os.path.basename(d)
        copies = [d]
        for rd in rdirs:
            cand = os.path.join(rep_root, rd, name)
            if os.path.isdir(cand):
                copies.append(cand)
        out.append(tuple(copies))
    return tuple(out)


@dataclasses.dataclass
class DistributedEngine:
    shards: Optional[int] = None  # None: the count of spilled shards
    method: str = "dstree"
    device: object = device_mod.DEFAULT
    # the resident shards, padded to one shape (build with keep_resident)
    resident: Optional[Tuple[FrozenIndex, ...]] = None
    shard_dirs: Optional[Tuple[str, ...]] = None  # spilled store dirs
    # per shard: every on-disk copy of its store, primary first; the
    # failover loop rotates the order per shard (round-robin owners)
    shard_replica_dirs: Optional[Tuple[Tuple[str, ...], ...]] = None
    index_spec: Optional[IndexSpec] = None
    store_spec: Optional[StoreSpec] = None
    # out-of-core serving state: per store copy, the opened LeafStore and
    # its warm device cache with a prefetcher, kept across queries
    _stores: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    _shard_caches: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    # serializes _stores, _shard_caches and _copy_locks against
    # concurrent queries and close(); searches run outside it
    _ooc_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)
    # one serving lock per store copy: a copy's warm cache serves one
    # query at a time (another query's get_slots could evict a slot this
    # one is about to gather). Lock order: copy lock, then _ooc_lock,
    # then the cache's lock
    _copy_locks: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    # the persistent circuit breaker of (shard, copy), made on the first
    # out-of-core query
    _breaker: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def n_shards(self) -> int:
        if self.shards is not None:
            return int(self.shards)
        return len(self.shard_dirs) if self.shard_dirs else 1

    @classmethod
    def open_spill(cls, store: StoreSpec, *,
                   index: Optional[IndexSpec] = None,
                   device=device_mod.DEFAULT) -> "DistributedEngine":
        """An engine over a spilled build (``store.spill_dir``), with no
        shard on the device: every query runs out of core. Replica
        copies (spill_dir/replicas/rN/shard_NNNN) are found too and arm
        failover."""
        device_mod.resolve(device)
        sspec = store.validate()
        if sspec.spill_dir is None:
            raise ValueError("open_spill: StoreSpec.spill_dir is required")
        ispec = index or IndexSpec()
        shard_dirs = tuple(sorted(
            os.path.join(sspec.spill_dir, d)
            for d in os.listdir(sspec.spill_dir) if d.startswith("shard_")))
        if not shard_dirs:
            raise ValueError(f"no shard_* stores under {sspec.spill_dir!r}")
        return cls(shards=len(shard_dirs), method=ispec.method,
                   device=device, shard_dirs=shard_dirs,
                   shard_replica_dirs=_discover_replicas(sspec.spill_dir,
                                                         shard_dirs),
                   index_spec=ispec, store_spec=sspec)

    # ------------------------------------------------------------------
    def build(self, data: np.ndarray, seed: int = DEFAULT_SEED, *,
              index: Optional[IndexSpec] = None,
              store: Optional[StoreSpec] = None) -> "DistributedEngine":
        """Range-shard the rows [N, n] (host array) into ``n_shards``
        shards and build one index per shard on ``device``.

        ``index`` says what to build (method and builder params);
        ``store`` where and how to serve it. Every shard is built against
        one global histogram, from 100,000 sample rows (numpy seed 0)
        and ``seed`` for its pairs (the reference's ``PRNGKey(0)`` draws
        :data:`DEFAULT_SEED`), with its ids remapped to global ids and
        ``n_total = N``. ``StoreSpec.spill_dir`` saves every shard as a
        store (spill_dir/shard_NNNN, in ``codec``) and ``replicas - 1``
        byte-identical copies under spill_dir/replicas/rN/;
        ``keep_resident=False`` keeps only the stores."""
        ispec = index or IndexSpec(method=self.method)
        sspec = (store or StoreSpec()).validate()
        dev = device_mod.resolve(self.device)
        self.close()  # the previous build's out-of-core state
        self.method = ispec.method
        self.index_spec, self.store_spec = ispec, sspec
        n = data.shape[0]
        s = self.n_shards
        bounds = np.linspace(0, n, s + 1).astype(np.int64)
        sample = data[np.random.default_rng(0).choice(
            n, min(n, 100_000), replace=False)]
        hist = build_histogram(sample, seed, device=dev)  # global
        builder = _BUILDERS[ispec.method]

        shards, spilled = [], []
        for si in range(s):
            lo, hi = int(bounds[si]), int(bounds[si + 1])
            idx = builder(data[lo:hi], hist=hist, seed=seed, device=dev,
                          **ispec.build_params)
            ids = torch.where(idx.ids >= 0, idx.ids + lo, -1)
            idx = dataclasses.replace(idx, ids=ids.to(torch.int32),
                                      n_total=n)
            if sspec.spill_dir is not None:
                d = os.path.join(sspec.spill_dir, f"shard_{si:04d}")
                spilled.append(idx.save(d, codec=sspec.codec))
                # replicas are file copies of the saved store (same ids,
                # histogram and pq codebook), under replicas/rN so that
                # open_spill cannot take them for more shards
                for rep in range(1, sspec.replicas):
                    rd = os.path.join(sspec.spill_dir, "replicas",
                                      f"r{rep}", f"shard_{si:04d}")
                    if os.path.isdir(rd):
                        shutil.rmtree(rd)
                    shutil.copytree(spilled[-1], rd)
            if sspec.keep_resident:
                shards.append(idx)
            del idx
        self.shard_dirs = tuple(spilled) or None
        self.shard_replica_dirs = _discover_replicas(
            sspec.spill_dir, self.shard_dirs) if spilled else None
        self.resident = None
        if shards:
            n_leaves = max(sh.num_leaves for sh in shards)
            n_rows = max(sh.data.shape[0] for sh in shards)
            self.resident = tuple(_pad_shard(sh, n_leaves, n_rows)
                                  for sh in shards)
        return self

    # ------------------------------------------------------------------
    def query(self, queries, k: int, g: Guarantee = EXACT,
              visit_batch: int = 1, sync_bsf: bool = False,
              share_gathers: bool = False, ooc: Optional[bool] = None,
              ooc_opts: Optional[dict] = None) -> QueryResult:
        """Batched k-NN over every shard under the guarantee ``g``.

        An engine with no resident shards (``keep_resident=False`` or
        :meth:`open_spill`) serves out of core; ``ooc=True`` forces it
        on an engine that has both. ``share_gathers`` scores each
        iteration's rows against every lane on either path.
        ``ooc_opts`` passes the out-of-core knobs to search_ooc
        (cache_leaves, prefetch, prefetch_depth, rerank, frontier) and
        the fault-tolerance knobs the engine takes itself: ``fault`` (a
        repro_torch.fault.FaultInjector) and ``retry`` (a
        serve.fault.RetryPolicy). Concurrent calls return what serial
        calls return."""
        g = g.validate()
        if ooc is None:
            ooc = self.resident is None and self.shard_dirs is not None
        if ooc:
            if sync_bsf:
                warnings.warn(
                    "sync_bsf is not supported on the out-of-core "
                    "path: shards are searched without cross-shard "
                    "best-so-far exchange (results are identical, "
                    "bytes-read/leaves-visited are not tightened).",
                    UserWarning, stacklevel=2)
            opts = dict(ooc_opts or {})
            if share_gathers:
                opts["share_gathers"] = True
            return self._query_ooc(queries, k, g, visit_batch, opts)
        if self.resident is None:
            raise ValueError("no resident shards: build() first")
        return self._query_resident(queries, k, g, visit_batch, sync_bsf,
                                    share_gathers)

    def _query_resident(self, queries, k: int, g: Guarantee,
                        visit_batch: int, sync_bsf: bool,
                        share_gathers: bool) -> QueryResult:
        """Algorithm 2 on every resident shard, then the reference's
        merge: the [S, B, k] answers laid out shard-major as [B, S*k],
        sorted by distance with ties in position order, cut to k."""
        q = torch.as_tensor(queries, device=self.resident[0].device)
        runs = [Refinement(refine.ResidentSource(idx), q, k,
                           delta=g.delta, epsilon=g.epsilon,
                           nprobe=g.nprobe, visit_batch=visit_batch,
                           share_gathers=share_gathers)
                for idx in self.resident]
        if sync_bsf:
            # lockstep: after each step every lane stops against the
            # kth-best over all shards, which is no larger than its own,
            # so the answer is the same and the visits can only fall
            while any(r.go for r in runs):
                live = [r for r in runs if r.go]
                for r in live:
                    r.advance()
                bsf = torch.stack([r.bsf for r in runs]).amin(0)
                for r in live:
                    r.settle(bsf)
        else:
            for r in runs:
                while r.go:
                    r.step()
        res = [r.finish() for r in runs]
        b = q.shape[0]
        md = torch.stack([r.dists for r in res], 1).reshape(b, -1)
        mi = torch.stack([r.ids for r in res], 1).reshape(b, -1)
        o = torch.sort(md, dim=1, stable=True).indices[:, :k]
        return QueryResult(
            dists=md.gather(1, o), ids=mi.gather(1, o),
            leaves_visited=torch.stack([r.leaves_visited for r in res]).sum(
                0, dtype=torch.int32),
            rows_scanned=torch.stack([r.rows_scanned for r in res]).sum(
                0, dtype=torch.int32),
            lb_computed=sum(r.lb_computed for r in res),
            iterations=tuple(r.iterations for r in res))

    # ------------------------------------------------------------------
    def _copy_lock(self, d: str) -> threading.RLock:
        """The serving lock of one store copy, held for a whole
        per-shard search (made under ``_ooc_lock``)."""
        with self._ooc_lock:
            lk = self._copy_locks.get(d)
            if lk is None:
                lk = self._copy_locks[d] = threading.RLock()
            return lk

    def _store(self, d: str):
        """The opened store of one copy, opened on first use."""
        with self._ooc_lock:
            store = self._stores.get(d)
        if store is not None:
            return store
        from repro_torch.store import load_index

        store = load_index(d, resident="summaries", device=self.device)
        with self._ooc_lock:
            # a concurrent open of the same dir keeps the first handle
            return self._stores.setdefault(d, store)

    def _shard_cache(self, d: str, store, need_leaves: int,
                     cache_leaves: Optional[int], *, prefetch_depth: int,
                     prefetch: bool):
        """The copy's persistent warm cache and prefetcher, checked per
        query: a cache that cannot hold this query's per-iteration
        working set (b * visit_batch leaves) is retired and made larger,
        and the prefetcher's depth grows with the lookahead. Runs under
        ``_ooc_lock``, which makes it atomic against ``close()`` (a query
        in flight keeps its own reference and finishes on it)."""
        from repro_torch.store import DeviceLeafCache, LeafPrefetcher

        need = max(int(need_leaves), 1)
        with self._ooc_lock:
            cache = self._shard_caches.get(d)
            if cache is not None and cache.capacity < min(
                    need, max(store.num_leaves, 1)):
                if cache.prefetcher is not None:
                    cache.prefetcher.close()
                    cache.prefetcher = None
                cache = None
            if cache is None:
                cap = cache_leaves if cache_leaves is not None \
                    else max(store.num_leaves // 8, 1)
                cap = min(max(cap, need), max(store.num_leaves, 1))
                cache = DeviceLeafCache(store, cap)
                self._shard_caches[d] = cache
            else:
                # warm contents persist; the counters report this query
                cache.reset_counters()
            if prefetch:
                depth = max(2, prefetch_depth + 1)
                if cache.prefetcher is not None \
                        and cache.prefetcher.depth < depth:
                    cache.prefetcher.close()
                    cache.prefetcher = None
                if cache.prefetcher is None:
                    cache.prefetcher = LeafPrefetcher(store, depth=depth)
        return cache

    def close(self) -> None:
        """Release the out-of-core state: stop every prefetcher and drop
        the warm caches and stores. Idempotent and thread-safe: the state
        is detached under the lock and the prefetchers are joined outside
        it (a query in flight keeps its cache and reads on demand once
        its prefetcher stops). build() calls it first."""
        with self._ooc_lock:
            caches = list(self._shard_caches.values())
            self._shard_caches.clear()
            self._stores.clear()
        for cache in caches:
            if cache.prefetcher is not None:
                cache.prefetcher.close()
                cache.prefetcher = None

    def _query_ooc(self, queries, k: int, g: Guarantee, visit_batch: int,
                   opts: dict) -> QueryResult:
        """Serve the batch from the spilled stores: shard after shard,
        the search loop runs over its store under
        serve_shard_with_failover, and each answer is folded as it
        lands. Per shard the answer is the
        resident search's bit for bit on a lossless codec, and both
        merges select the k smallest distances."""
        from repro_torch.serve import fault as sfault
        from repro_torch.store import search_ooc

        if not self.shard_dirs:
            raise ValueError("no spilled shards: build with a spill_dir "
                             "or open_spill() first")
        dev = device_mod.resolve(self.device)
        q = torch.as_tensor(queries, device=dev)
        b = q.shape[0]
        cache_leaves = opts.pop("cache_leaves", None)
        injector = opts.pop("fault", None)
        policy = opts.pop("retry", None) or sfault.RetryPolicy()
        n_sh = len(self.shard_dirs)
        prefetch_depth = int(opts.get("prefetch_depth", 1))
        prefetch = bool(opts.get("prefetch", True))
        replica_dirs = self.shard_replica_dirs \
            or tuple((d,) for d in self.shard_dirs)
        with self._ooc_lock:
            if self._breaker is None:
                self._breaker = sfault.CircuitBreaker()
            breaker = self._breaker

        def attempt(d, fctx):
            # one query's use of one copy is one critical section; an
            # attempt that waits out its deadline here fails at its first
            # check and fails over to another copy's lock
            with self._copy_lock(d):
                store = self._store(d)
                cache = self._shard_cache(
                    d, store, b * visit_batch, cache_leaves,
                    prefetch_depth=prefetch_depth, prefetch=prefetch)
                return search_ooc(store, q, k, g, visit_batch=visit_batch,
                                  cache=cache, fault=fctx, **opts)

        top_d = torch.full((b, k), float("inf"), device=dev)
        top_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
        leaves = torch.zeros(b, dtype=torch.int32, device=dev)
        rows = torch.zeros(b, dtype=torch.int32, device=dev)
        lbs = 0
        iters = [0] * n_sh
        per_shard, infos, lost = [], [], []
        for si in range(n_sh):
            copies = replica_dirs[si]
            # round-robin ownership: shard si's owner is copy si % R, and
            # failover walks the other copies in order
            order = tuple(copies[(si + j) % len(copies)]
                          for j in range(len(copies)))
            try:
                out, info = sfault.serve_shard_with_failover(
                    attempt, shard=si, replica_dirs=order, policy=policy,
                    breaker=breaker, injector=injector)
            except sfault.ShardLost:
                lost.append(si)
                continue
            out.stats.retries = info.retries
            out.stats.failovers = info.failovers
            REGISTRY.counter("engine.shard.bytes_read", shard=str(si)).inc(
                out.stats.bytes_read)
            r = out.result
            # ids are disjoint across shards: the unique merge is used for
            # its (d, id)-lex selection
            top_d, top_i = ops.topk_merge_unique(r.dists, r.ids, top_d,
                                                 top_i)
            leaves += r.leaves_visited
            rows += r.rows_scanned
            lbs += r.lb_computed
            iters[si] = r.iterations
            per_shard.append(out.stats)
            infos.append(info)
        if len(lost) == n_sh:
            raise sfault.ShardLost(-1, RuntimeError(
                f"every shard lost ({sorted(lost)}): no surviving answer "
                "to degrade to"))
        stats = OocStats.aggregate(per_shard)
        stats.effective_delta = float(g.delta)
        if lost:
            self._degrade(stats, sorted(lost), infos, top_d, k, g)
        return QueryResult(dists=top_d, ids=top_i, leaves_visited=leaves,
                           rows_scanned=rows, lb_computed=lbs, stats=stats,
                           iterations=tuple(iters))

    def _degrade(self, stats: OocStats, lost, infos, top_d, k: int,
                 g: Guarantee) -> None:
        """Downgrade the answer's guarantee honestly after shard loss:
        count the rows the fold never saw (global N minus the survivors'
        real rows) and recompute delta from the global histogram mass
        those rows own at each lane's surviving kth distance. The result
        is a delta-epsilon guarantee whatever was asked."""
        surv = [self._store(i.served_dir) for i in infos]
        n_total = int(surv[0].resident.n_total)
        n_seen = sum(int((s.resident.ids >= 0).sum()) for s in surv)
        n_lost = max(n_total - n_seen, 0)
        stats.degraded = True
        stats.shards_lost = len(lost)
        stats.effective_delta = effective_delta_after_loss(
            surv[0].resident.hist, top_d[:, k - 1], n_lost, delta=g.delta,
            epsilon=g.epsilon)
        REGISTRY.counter("engine.degraded_queries").inc()
        REGISTRY.counter("engine.shards_lost").inc(len(lost))
        warnings.warn(
            f"shards {lost} lost past retries and replicas: answer "
            f"degraded to delta-epsilon with effective_delta="
            f"{stats.effective_delta:.3g} over {n_lost} unseen rows",
            UserWarning, stacklevel=4)

