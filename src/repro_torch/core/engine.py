"""DistributedEngine: the paper's methods over a range-sharded collection.

The port of ``src/repro/core/engine.py``. Each shard owns a FrozenIndex
over its rows (ids stay global) plus the global distance histogram and
the global N, so every shard's r_delta has the single-index semantics. A
query batch goes to every shard, each runs Algorithm 2 over its rows,
and the per-shard top-k rows are merged. The shards live either on one
device (``shards=S``, no mesh) or one on each rank of a mesh
(``mesh=..., axes=...``; see "Across ranks" below).

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

The write tier (:meth:`DistributedEngine.enable_writes`, ``insert``,
``delete``, ``compact``): a store.delta.DeltaTier absorbs writes while
the engine serves. A query snapshots it first, so every unit serves one
point in time: each frozen shard and segment masks the rows the
snapshot's kills supersede (``ScoreCtx.dead``), r_delta uses the joint
live N (core.guarantees.joint_n_total), each compacted segment is served
as one more shard and the memtable is brute-scored last, all folded
through ``ops.topk_merge_unique``. The kill rule leaves at most one live
copy of an id, so the fold equals a rebuild that holds the same live
rows. Compaction freezes the memtable into an on-disk segment
(spill_dir/segments/writer-*/seg_NNNN, in the base codec), by hand or on
a daemon thread (``StoreSpec.auto_compact``) that polls with
``Event.wait``.

Across ranks (``DistributedEngine(mesh=..., axes=("data",))``, the
reference's shard_map engine over ``torch.distributed``): the shard
count is the product of the mesh's sizes over ``axes``, and a rank's
shard is its coordinates along them flattened row-major
(core/ranks.shard_layout). Ranks that differ only off those axes (along
``model``) hold the same shard and give the same answer; every
collective runs over the shard group, the ranks that share this rank's
other coordinates, so no shard is counted twice. Every rank calls every
method with the same arguments (SPMD): the build (each rank builds only
its shard, against rank 0's histogram, padded to the widest shard; the
writer copy alone spills it), queries and writes (each rank keeps its
own copy of the write tier and compacts into its own writer directory).
A resident query runs the rank's shard, with ``sync_bsf`` one
all_reduce(MIN) a step for the kth-best over the group and whether any
shard still steps; then one all_gather brings every shard's answer and
counts, merged as one card merges its shards. Out of core, each rank
serves its shard with failover, and the answers and OocStats are
gathered and folded in shard order. Collectives run where the engine
runs: NCCL on the card, gloo on the CPU; a failed one raises.

With tracing on (``repro_torch.obs``), or a profiler recording, a query
is an ``engine.query`` span (``path`` resident, resident+delta or ooc; a
resident query's visit totals are read from the device only when the
spans are read, so the span does not wait for it). A resident query
holds each shard's ``search.*`` loop spans (core/search.py), then
``engine.merge``; on a mesh ``engine.sync_bsf`` and
``engine.gather_results`` hold the collectives. Out of core it holds one
``engine.shard`` span per shard served, over that shard's
``ooc.query``, and a compaction is a ``delta.compact`` span, the
reference's taxonomy (docs/OBSERVABILITY.md). A build is an
``engine.build`` span over ``engine.histogram``, ``index.build`` and
``engine.pad``, whose host seconds are also the always-on gauges
``engine.build_s{phase}`` (histogram, index, pad, total). The resident
path's waits for the device count under ``search.host_reads{site}``:
``shard_ids`` and ``dead_mask`` (the write tier's masks, once a kill
set), ``mesh_flag`` (each lockstep step's all_reduce) and
``mesh_gather`` (the answers' all_gather). On a mesh, always-on
counters time the merge on the host clock, at points where the host
waits already: ``engine.mesh_s{part=loop}`` the rank's own search
(from the query's entry to its own answer), ``engine.mesh_s{part=gather}``
the all_gather up to the tails on the host (the wait for the slowest
shard, then the exchange), ``engine.gathers`` the gathers, and
``engine.mesh_spread_s`` the slowest shard's search less the fastest's,
each rank's loop time travelling in the tail it gathers anyway.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import tempfile
import threading
import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import device as device_mod
from repro_torch import obs
from repro_torch.kernels import ops
from repro_torch.obs import REGISTRY, OocStats

from . import ranks, refine
from .guarantees import (EXACT, Guarantee, effective_delta_after_loss,
                         joint_n_total)
from .histogram import DEFAULT_SEED, build_histogram
from .index import FrozenIndex
from .indexes import dstree, isax, vafile
from .search import Refinement, SearchResult, pad_mask, search_impl
from .spec import IndexSpec, StoreSpec

_SHARD_IDS = obs.read_site("shard_ids")
_DEAD_MASK = obs.read_site("dead_mask")
_MESH_FLAG = obs.read_site("mesh_flag")
_MESH_GATHER = obs.read_site("mesh_gather")
_BUILD_S = {p: REGISTRY.gauge("engine.build_s", phase=p)
            for p in ("histogram", "index", "pad", "total")}
_MESH_S = {p: REGISTRY.counter("engine.mesh_s", part=p)
           for p in ("loop", "gather")}
_GATHERS = REGISTRY.counter("engine.gathers")
_MESH_SPREAD = REGISTRY.counter("engine.mesh_spread_s")


@contextlib.contextmanager
def _build_phase(phase: str, name: str):
    """One phase of a build: the span ``name``, and its host seconds in
    the gauge ``engine.build_s{phase}`` (the device work it launched may
    end later; the build's uploads from host memory wait for theirs)."""
    t0 = obs.now()
    with obs.span(name):
        yield
    _BUILD_S[phase].set(obs.now() - t0)


class QueryResult(NamedTuple):
    """What :meth:`DistributedEngine.query` returns: the merged answer,
    the visit counts summed over shards, the per-query OocStats (None on
    the resident path, which does no I/O) and each shard's iterations
    (0 for a lost shard), then each compacted segment's."""

    dists: torch.Tensor           # [B, k] Euclidean distances, ascending
    ids: torch.Tensor             # [B, k] int32 global row ids (-1 = none)
    leaves_visited: torch.Tensor  # [B] int32, summed over shards
    rows_scanned: torch.Tensor    # [B] int32, summed over shards
    lb_computed: int
    stats: Optional[OocStats] = None
    iterations: Tuple[int, ...] = ()


class EngineSegment(NamedTuple):
    """One compacted delta segment: the leaf-contiguous store the
    compactor froze out of the write tier, served as one more shard.
    ``born_seq`` is the write sequence of the freeze: a kill with a newer
    sequence masks the segment's copy of its id (store.delta), which
    makes publishing safe while deletes race the build. ``index`` keeps
    the f32 FrozenIndex on the device for a resident engine, which scores
    it as it scores its resident shards; an out-of-core engine serves the
    segment's store (in the base codec) instead."""
    dir: str
    born_seq: int
    n_rows: int
    ids_np: np.ndarray                 # [npad] global ids (-1 pad)
    index: Optional[FrozenIndex] = None


class _MutView(NamedTuple):
    """What one query needs to serve a write-tier snapshot with the
    frozen base: the snapshot, the joint r_delta row count
    (core.guarantees.joint_n_total: inserts raise N, deletes never lower
    it) and each published segment's tombstone mask under the snapshot's
    kills. Made once per query, never changed."""
    snap: object                        # store.delta.DeltaSnapshot
    joint_n: int
    seg_dead: Tuple[np.ndarray, ...]    # per segment, [npad] bool


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


def _group_min_bsf(lay, bsf: torch.Tensor, going: bool) -> tuple:
    """(the kth-best [B] over every shard of the group, whether any of
    them stepped): the reference's pmin of the kth-best and pmax of
    ``go`` in one all_reduce(MIN), the flag as 0 for a rank that
    stepped. A step in which no shard stepped changes nothing, so the
    loop may end one collective after the reference's."""
    with obs.span("engine.sync_bsf"):
        v = torch.cat([bsf, torch.full((1,), 0.0 if going else 1.0,
                                       dtype=bsf.dtype, device=bsf.device)])
        dist.all_reduce(v, op=dist.ReduceOp.MIN, group=lay.group)
        return v[:-1], obs.host_read(_MESH_FLAG, float, v[-1]) == 0.0


def _gather_results(lay, res: SearchResult, loop_s: float) -> list:
    """Every shard's SearchResult in shard order, from one all_gather
    over the shard group: the distances (their f32 bits), ids, visit
    counts, lb_computed, iterations and the rank's ``loop_s`` (its own
    search, in whole microseconds) travel as one int32 tensor. Counts
    the gather's host seconds and the spread of the loop times (the
    module's ``engine.*`` counters; the span's ``spread_s``)."""
    b, k = res.ids.shape
    dev = res.ids.device
    t0 = obs.now()
    with obs.span("engine.gather_results") as sp:
        mine = torch.cat([
            res.dists.float().contiguous().view(torch.int32).reshape(-1),
            res.ids.to(torch.int32).reshape(-1),
            res.leaves_visited.to(torch.int32),
            res.rows_scanned.to(torch.int32),
            obs.host_read(_MESH_GATHER, torch.tensor,
                          [res.lb_computed, res.iterations,
                           round(loop_s * 1e6)],
                          dtype=torch.int32, device=dev)])
        parts = [torch.empty_like(mine) for _ in lay.shard_of]
        dist.all_gather(parts, mine, group=lay.group)
        tails = obs.host_read(_MESH_GATHER,
                              torch.stack([p[-3:] for p in parts]).tolist)
        gather_s = obs.now() - t0
        loops = [t[2] for t in tails]
        spread_s = (max(loops) - min(loops)) * 1e-6
        sp.set(spread_s=spread_s)
    _MESH_S["loop"].inc(loop_s)
    _MESH_S["gather"].inc(gather_s)
    _GATHERS.inc()
    _MESH_SPREAD.inc(spread_s)
    out = [None] * lay.count
    for p, (lb, iters, _), si in zip(parts, tails, lay.shard_of):
        d, i, lv, rs, _ = p.split([b * k, b * k, b, b, 3])
        out[si] = SearchResult(d.view(torch.float32).reshape(b, k),
                               i.reshape(b, k), lv, rs, lb, iters)
    return out


def _gather_served(lay, mine, b: int, k: int, dev, loop_s: float) -> dict:
    """Every shard's (OocResult, ShardServeInfo) by shard, None for a
    shard lost past its copies: the answers through
    :func:`_gather_results` (``loop_s`` this rank's serving), the stats
    and serve infos through one all_gather_object."""
    from repro_torch.store.ooc import OocResult

    if mine is None:  # lost: a placeholder answer, dropped from the fold
        res = SearchResult(torch.full((b, k), float("inf"), device=dev),
                           torch.full((b, k), -1, dtype=torch.int32,
                                      device=dev),
                           torch.zeros(b, dtype=torch.int32, device=dev),
                           torch.zeros(b, dtype=torch.int32, device=dev), 0, 0)
        meta = None
    else:
        res, meta = mine[0].result, (mine[0].stats, mine[1])
    results = _gather_results(lay, res, loop_s)
    metas = [None] * len(lay.shard_of)
    dist.all_gather_object(metas, meta, group=lay.group)
    out = {}
    for m, si in zip(metas, lay.shard_of):
        out[si] = None if m is None else (
            OocResult(results[si], m[0]), m[1])
    return out


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
    # a torch DeviceMesh (launch/mesh.py): one shard per rank over
    # ``axes``; ``shards`` is then ignored. The device must be the mesh's
    mesh: Optional[object] = None
    axes: Tuple[str, ...] = ("data",)
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
    # ---- the write tier, armed by enable_writes() ----
    _delta: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False)
    # serializes enable_writes and segment numbering (the delta tier has
    # its own lock). Lock order: _write_lock is a leaf, never held across
    # a delta or store call
    _write_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)
    _seg_dir: Optional[str] = dataclasses.field(
        default=None, repr=False, compare=False)
    _seg_seq: int = dataclasses.field(
        default=0, repr=False, compare=False)
    _compactor: Optional[threading.Thread] = dataclasses.field(
        default=None, repr=False, compare=False)
    _compactor_stop: Optional[threading.Event] = dataclasses.field(
        default=None, repr=False, compare=False)
    # host copies of each frozen unit's padded ids, keyed ("rshard", si),
    # ("sshard", si) or ("seg", dir): masks are made from them when the
    # kill set moves, with no device read per query
    _ids_host: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    # per unit (kills_version, host mask) and (kills_version, device mask
    # or None). Lock-free: dict get and set are atomic under the GIL, the
    # version keys a hit, and racing queries make interchangeable masks
    # from their own snapshots
    _dead_cache: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    _dead_dev: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    # this rank's core/ranks.ShardLayout on a mesh engine, else None
    _layout: Optional[object] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        if self.mesh is None:
            return
        dev = device_mod.resolve(self.device)
        if dev.type != self.mesh.device_type:
            raise ValueError(f"the mesh runs on {self.mesh.device_type}, the "
                             f"engine was asked to run on {dev}")
        self.device = ranks.rank_device(dev)
        self.axes = tuple(self.axes)
        self._layout = ranks.shard_layout(self.mesh, self.axes)

    @property
    def n_shards(self) -> int:
        if self._layout is not None:
            return self._layout.count
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
        ``keep_resident=False`` keeps only the stores. The write tier of a
        previous build is dropped with its rows.

        On a mesh every rank calls it with the same rows: each builds its
        own shard, against the histogram of rank 0 (every rank draws the
        same sample; the broadcast makes the bytes equal), padded to the
        widest shard of the mesh; a shard is spilled by its writer rank,
        and after a barrier every rank's ``shard_dirs`` lists every
        shard."""
        with _build_phase("total", "engine.build"):
            self._build(data, seed, index, store)
        return self

    def _build(self, data, seed, index, store) -> None:
        ispec = index or IndexSpec(method=self.method)
        sspec = (store or StoreSpec()).validate()
        dev = device_mod.resolve(self.device)
        self.close()  # the previous build's out-of-core state and daemon
        self._delta = None
        self._seg_dir = None
        self._seg_seq = 0
        self._ids_host.clear()
        self._dead_cache.clear()
        self._dead_dev.clear()
        self.method = ispec.method
        self.index_spec, self.store_spec = ispec, sspec
        n = data.shape[0]
        s = self.n_shards
        lay = self._layout
        bounds = np.linspace(0, n, s + 1).astype(np.int64)
        with _build_phase("histogram", "engine.histogram"):
            sample = data[np.random.default_rng(0).choice(
                n, min(n, 100_000), replace=False)]
            hist = build_histogram(sample, seed, device=dev)  # global
            if lay is not None:
                for t in hist:
                    dist.broadcast(t, src=0)
        builder = _BUILDERS[ispec.method]
        write = sspec.spill_dir is not None and (lay is None or lay.writer)

        with _build_phase("index", "index.build"):
            shards = []
            for si in range(s) if lay is None else (lay.index,):
                lo, hi = int(bounds[si]), int(bounds[si + 1])
                idx = builder(data[lo:hi], hist=hist, seed=seed, device=dev,
                              **ispec.build_params)
                ids = torch.where(idx.ids >= 0, idx.ids + lo, -1)
                idx = dataclasses.replace(idx, ids=ids.to(torch.int32),
                                          n_total=n)
                if write:
                    d = idx.save(os.path.join(sspec.spill_dir,
                                              f"shard_{si:04d}"),
                                 codec=sspec.codec)
                    # replicas are file copies of the saved store (same ids,
                    # histogram and pq codebook), under replicas/rN so that
                    # open_spill cannot take them for more shards
                    for rep in range(1, sspec.replicas):
                        rd = os.path.join(sspec.spill_dir, "replicas",
                                          f"r{rep}", f"shard_{si:04d}")
                        if os.path.isdir(rd):
                            shutil.rmtree(rd)
                        shutil.copytree(d, rd)
                if sspec.keep_resident:
                    shards.append(idx)
                del idx
        with _build_phase("pad", "engine.pad"):
            self.shard_dirs = self.shard_replica_dirs = None
            if sspec.spill_dir is not None:
                if lay is not None:
                    dist.barrier()  # every writer has saved its shard
                self.shard_dirs = tuple(
                    os.path.join(sspec.spill_dir, f"shard_{si:04d}")
                    for si in range(s))
                self.shard_replica_dirs = _discover_replicas(sspec.spill_dir,
                                                             self.shard_dirs)
            self.resident = None
            if shards:
                n_leaves = max(sh.num_leaves for sh in shards)
                n_rows = max(sh.data.shape[0] for sh in shards)
                if lay is not None:
                    wide = torch.tensor([n_leaves, n_rows], device=dev)
                    dist.all_reduce(wide, op=dist.ReduceOp.MAX)
                    n_leaves, n_rows = wide.tolist()
                self.resident = tuple(_pad_shard(sh, n_leaves, n_rows)
                                      for sh in shards)

    # ------------------------------------------------------ the write tier
    def _base_meta(self) -> tuple:
        """(n_total, series_len, hist) of the frozen base: from a resident
        shard, else from shard 0's store (every shard holds the global
        values)."""
        if self.resident is not None:
            idx = self.resident[0]
        elif self.shard_dirs:
            idx = self._store(self.shard_dirs[0]).resident
        else:
            raise ValueError("build() or open_spill() first")
        return int(idx.n_total), int(idx.series_len), idx.hist

    def enable_writes(self) -> "DistributedEngine":
        """Arm the write tier: a store.delta.DeltaTier that takes
        ``insert`` and ``delete`` while the engine serves, searched with
        the frozen shards by every later :meth:`query`; with
        ``StoreSpec.auto_compact``, also the daemon that compacts the
        memtable into segments. Idempotent; ``insert`` and ``delete``
        call it."""
        from repro_torch.store.delta import DeltaTier

        spec = self.store_spec or StoreSpec()
        if self._delta is None:
            # the metadata read may open a store (under _ooc_lock): done
            # before _write_lock, which stays a leaf
            n_total, series_len, _ = self._base_meta()
            with self._write_lock:
                if self._delta is None:
                    if self._seg_dir is None:
                        # one directory per writer: engines that serve
                        # one spill (a resident build and an open_spill
                        # of it) keep their segments apart
                        root = None
                        if spec.spill_dir is not None:
                            root = os.path.join(spec.spill_dir, "segments")
                            os.makedirs(root, exist_ok=True)
                        self._seg_dir = tempfile.mkdtemp(
                            prefix="writer-" if root else "repro-segments-",
                            dir=root)
                    self._delta = DeltaTier(series_len, start_id=n_total)
        if spec.auto_compact:
            with self._write_lock:
                if self._compactor is None \
                        or not self._compactor.is_alive():
                    self._compactor_stop = threading.Event()
                    t = threading.Thread(target=self._compact_loop,
                                         name="delta-compactor",
                                         daemon=True)
                    self._compactor = t
                    t.start()
        return self

    def insert(self, rows, ids=None) -> np.ndarray:
        """Absorb rows [m, n] (host array); the next :meth:`query` finds
        them. Returns their global ids (past the frozen id space unless
        given); inserting an id that exists supersedes every older
        copy."""
        self.enable_writes()
        return self._delta.insert(rows, ids)

    def delete(self, ids) -> int:
        """Tombstone global ids everywhere: frozen shards, compacted
        segments and the memtable."""
        self.enable_writes()
        return self._delta.delete(ids)

    def compact(self) -> bool:
        """Freeze the live memtable into one on-disk segment (the base
        codec) and publish it. A query in flight keeps its snapshot and
        never blocks; writes during the build go to the fresh memtable.
        Returns True iff a segment was published; a second compaction
        while one is in flight returns False."""
        delta = self._delta
        if delta is None:
            return False
        batch = delta.begin_freeze()
        if batch is None:
            return False
        with obs.span("delta.compact", rows=int(batch.ids.shape[0])):
            try:
                seg = self._build_segment(batch)
            except BaseException:  # re-raised: the fold-back must run even for KeyboardInterrupt or SystemExit, or the frozen batch's writes would be lost
                delta.abort_freeze()
                raise
            delta.publish_segment(seg)
        return True

    def _segment_codec(self) -> str:
        """The codec segments are saved in: the base shards' (so a rebuild
        from scratch and frozen+delta encode rows alike), else the
        StoreSpec's for a resident engine with no spill."""
        if self.shard_dirs:
            return self._store(self.shard_dirs[0]).codec
        return (self.store_spec or StoreSpec()).codec

    def _build_segment(self, batch) -> EngineSegment:
        """One delta batch as a segment store: a FrozenIndex over the
        batch's rows with the base's method and params, the global
        histogram and the builders' default seed (the reference's
        ``PRNGKey(0)``), its row ids mapped to the batch's global ids,
        saved under the writer's segment directory as seg_NNNN in the
        base codec; a pq batch with
        fewer rows than the codebook's centroids is saved as f32."""
        from repro_torch.store.layout import PQ_K

        n_base, _, hist = self._base_meta()
        ispec = self.index_spec or IndexSpec(method=self.method)
        dev = device_mod.resolve(self.device)
        idx = _BUILDERS[ispec.method](batch.rows, hist=hist,
                                      seed=DEFAULT_SEED, device=dev,
                                      **ispec.build_params)
        local = idx.ids.cpu().numpy()
        gids = np.asarray(batch.ids, np.int64)
        ext = np.where(local >= 0,
                       gids[np.clip(local, 0, gids.shape[0] - 1)], -1)
        idx = dataclasses.replace(
            idx, ids=torch.as_tensor(ext, dtype=torch.int32, device=dev),
            n_total=n_base)
        with self._write_lock:  # a leaf: segment numbering only
            seq = self._seg_seq
            self._seg_seq += 1
        d = os.path.join(self._seg_dir, f"seg_{seq:04d}")
        codec = self._segment_codec()
        if codec == "pq" and batch.rows.shape[0] < PQ_K:
            # a codebook trains one centroid per code: a smaller batch
            # cannot train one, and the small segment is kept lossless
            codec = "f32"
        idx.save(d, codec=codec)
        return EngineSegment(
            dir=d, born_seq=batch.born_seq, n_rows=int(batch.ids.shape[0]),
            ids_np=ext.astype(np.int32),
            index=idx if self.resident is not None else None)

    def _compact_loop(self) -> None:
        """The compaction daemon (``StoreSpec.auto_compact``): every
        ``compact_interval_s`` it checks the memtable and compacts once
        ``delta_max_rows`` live rows wait."""
        spec = self.store_spec or StoreSpec()
        stop = self._compactor_stop
        while not stop.wait(spec.compact_interval_s):
            delta = self._delta
            if delta is None or not delta.freeze_threshold_reached(
                    spec.delta_max_rows):
                continue
            try:
                self.compact()
            except Exception:  # noqa: BLE001 the daemon must outlive one failed compaction (disk full, a build error): compact() already folded the batch back into the memtable through abort_freeze, so count it and retry at the next tick
                REGISTRY.counter("delta.compaction_errors").inc()

    def _stop_compactor(self) -> None:
        """Stop the compaction daemon if it runs (idempotent; close() and
        build() call it). The thread is joined outside _write_lock, which
        its body takes for segment numbering."""
        with self._write_lock:
            t, self._compactor = self._compactor, None
            ev, self._compactor_stop = self._compactor_stop, None
        if ev is not None:
            ev.set()
        if t is not None and t.is_alive():
            t.join(timeout=60.0)

    def _mutable_view(self, snap) -> _MutView:
        """The joint r_delta N and every published segment's mask for one
        snapshot. ``base_dead`` counts the kills in the frozen id range
        [0, n_base), the ids the range-sharded build assigns, so a delete
        of an id never inserted costs nothing."""
        n_base, _, _ = self._base_meta()
        base_dead = 0
        if snap.kills:
            kid = np.fromiter(snap.kills.keys(), np.int64,
                              count=len(snap.kills))
            base_dead = int(((kid >= 0) & (kid < n_base)).sum())
        seg_dead, seg_live = [], 0
        for seg in snap.segments:
            self._ids_host.setdefault(("seg", seg.dir), seg.ids_np)
            m = self._unit_dead(("seg", seg.dir), seg.born_seq, snap)
            seg_dead.append(m)
            seg_live += seg.n_rows - int(m.sum())
        return _MutView(snap=snap,
                        joint_n=joint_n_total(n_base, base_dead,
                                              seg_live + snap.live_rows),
                        seg_dead=tuple(seg_dead))

    def _unit_dead(self, unit, born_seq: int, snap) -> np.ndarray:
        """One frozen unit's tombstone mask under this snapshot (host,
        unpadded), cached by kills_version: an ``isin`` over the unit's
        ids per query would dominate serving between writes."""
        hit = self._dead_cache.get(unit)
        if hit is not None and hit[0] == snap.kills_version:
            return hit[1]
        mask = snap.dead_mask(self._ids_host[unit], born_seq)
        self._dead_cache[unit] = (snap.kills_version, mask)
        return mask

    def _unit_dead_dev(self, unit, born_seq: int, snap, pad_to: int,
                       dev) -> Optional[torch.Tensor]:
        """The unit's mask on ``dev``, padded with False to ``pad_to``
        rows (the unit's padded row count, which ``ScoreCtx.dead[row_idx]``
        reads), or None when the snapshot kills none of its rows; cached
        by kills_version like :meth:`_unit_dead`."""
        hit = self._dead_dev.get(unit)
        if hit is not None and hit[0] == snap.kills_version:
            return hit[1]
        mask = self._unit_dead(unit, born_seq, snap)
        out = obs.host_read(_DEAD_MASK, pad_mask, mask, pad_to, dev) \
            if mask.any() else None
        self._dead_dev[unit] = (snap.kills_version, out)
        return out

    def _fold_mutable(self, base: "QueryResult", mut: _MutView, q, k: int,
                      g: Guarantee, visit_batch: int, *,
                      resident: bool) -> "QueryResult":
        """Fold the write tier into the frozen base's answer: each
        published segment is served as one more shard (a resident engine
        searches the segment's f32 index as it searches its shards, an
        out-of-core engine the segment's store), then the memtable is
        brute-scored (store.delta.search_snapshot), each answer merged by
        ``ops.topk_merge_unique``. The kill rule leaves one live copy of
        an id across them, the merge's precondition, and the merge is a
        commutative (d, id)-lex selection, so the staged fold equals a
        rebuild's single sort. A segment's iterations follow the
        shards'."""
        from repro_torch.store import search_ooc
        from repro_torch.store.delta import search_snapshot

        snap = mut.snap
        b = q.shape[0]
        top_d, top_i = base.dists, base.ids
        leaves = base.leaves_visited.clone()
        rows = base.rows_scanned.clone()
        lbs = base.lb_computed
        iters = list(base.iterations)
        for seg in snap.segments:
            unit = ("seg", seg.dir)
            if resident and seg.index is not None:
                dead = self._unit_dead_dev(unit, seg.born_seq, snap,
                                           seg.index.data.shape[0], q.device)
                r = search_impl(seg.index, q, k, delta=g.delta,
                                epsilon=g.epsilon, nprobe=g.nprobe,
                                visit_batch=visit_batch, dead=dead,
                                n_override=mut.joint_n)
            else:
                with self._copy_lock(seg.dir):
                    store = self._store(seg.dir)
                    cache = self._shard_cache(seg.dir, store,
                                              b * visit_batch, None,
                                              prefetch_depth=1,
                                              prefetch=True)
                    dead = self._unit_dead_dev(unit, seg.born_seq, snap,
                                               store.mmap.shape[0],
                                               store.device)
                    r = search_ooc(store, q, k, g, visit_batch=visit_batch,
                                   cache=cache, dead=dead,
                                   n_override=mut.joint_n).result
            top_d, top_i = ops.topk_merge_unique(r.dists, r.ids, top_d,
                                                 top_i)
            leaves += r.leaves_visited
            rows += r.rows_scanned
            lbs += r.lb_computed
            iters.append(r.iterations)
        sd, si = search_snapshot(
            snap, q, k, codec="f32" if resident else self._segment_codec())
        top_d, top_i = ops.topk_merge_unique(sd, si, top_d, top_i)
        rows += snap.live_rows  # the memtable scan touches every row
        return base._replace(dists=top_d, ids=top_i, leaves_visited=leaves,
                             rows_scanned=rows, lb_computed=lbs,
                             iterations=tuple(iters))

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
        calls return. With the write tier armed, the answer is over the
        live rows: the frozen shards less their tombstoned rows, the
        compacted segments and the memtable, as of one snapshot taken
        before anything is searched."""
        g = g.validate()
        mut = None
        if self._delta is not None:
            snap = self._delta.snapshot()
            if snap.live_rows or snap.kills or snap.segments:
                mut = self._mutable_view(snap)
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
            return self._query_ooc(queries, k, g, visit_batch, opts, mut)
        if self.resident is None:
            raise ValueError("no resident shards: build() first")
        # the visit totals stay on the device until the spans are read
        attrs = {} if mut is None else dict(
            delta_rows=mut.snap.live_rows, segments=len(mut.snap.segments))
        with obs.span("engine.query",
                      path="resident" if mut is None else "resident+delta",
                      lanes=len(queries), k=k, shards=self.n_shards,
                      **attrs) as sp:
            out = self._query_resident(queries, k, g, visit_batch, sync_bsf,
                                       share_gathers, mut)
            sp.set(leaves_visited=out.leaves_visited,
                   rows_scanned=out.rows_scanned)
        return out

    def _query_resident(self, queries, k: int, g: Guarantee,
                        visit_batch: int, sync_bsf: bool,
                        share_gathers: bool,
                        mut: Optional[_MutView] = None) -> QueryResult:
        """Algorithm 2 on every resident shard (on a mesh, the rank's
        own; the others' answers come from one all_gather), then the
        reference's merge: the [S, B, k] answers laid out shard-major as
        [B, S*k], sorted by distance with ties in position order, cut to
        k. With the write tier, each shard masks its tombstoned rows (a
        device mask per shard, padded to its padded rows and kept until
        the kill set moves), r_delta uses the joint N, and the segments
        and the memtable are folded in after."""
        t0 = obs.now()
        dev = self.resident[0].device
        q = torch.as_tensor(queries, device=dev)
        dead = [None] * len(self.resident)
        n_over = None
        if mut is not None:
            n_over = mut.joint_n
            for si, idx in enumerate(self.resident):
                unit = ("rshard", si)
                if unit not in self._ids_host:  # one device read a shard
                    self._ids_host[unit] = obs.host_read(
                        _SHARD_IDS, lambda t: t.cpu().numpy(), idx.ids)
                dead[si] = self._unit_dead_dev(unit, 0, mut.snap,
                                               idx.data.shape[0], dev)
        runs = [Refinement(refine.ResidentSource(idx, dead[si]), q, k,
                           delta=g.delta, epsilon=g.epsilon,
                           nprobe=g.nprobe, visit_batch=visit_batch,
                           share_gathers=share_gathers, n_override=n_over)
                for si, idx in enumerate(self.resident)]
        lay = self._layout
        if sync_bsf:
            # lockstep: after each step every lane stops against the
            # kth-best over all shards, which is no larger than its own,
            # so the answer is the same and the visits can only fall
            while True:
                live = [r for r in runs if r.go]
                for r in live:
                    r.advance()
                bsf = torch.stack([r.bsf for r in runs]).amin(0)
                if lay is not None:
                    bsf, stepped = _group_min_bsf(lay, bsf, bool(live))
                    if not stepped:
                        break
                elif not live:
                    break
                for r in live:
                    r.settle(bsf)
        else:
            for r in runs:
                while r.go:
                    r.step()
        res = [r.finish() for r in runs]
        if lay is not None:
            res = _gather_results(lay, res[0], obs.now() - t0)
        b = q.shape[0]
        with obs.span("engine.merge"):
            md = torch.stack([r.dists for r in res], 1).reshape(b, -1)
            mi = torch.stack([r.ids for r in res], 1).reshape(b, -1)
            o = torch.sort(md, dim=1, stable=True).indices[:, :k]
            out = QueryResult(
                dists=md.gather(1, o), ids=mi.gather(1, o),
                leaves_visited=torch.stack(
                    [r.leaves_visited for r in res]).sum(0, dtype=torch.int32),
                rows_scanned=torch.stack(
                    [r.rows_scanned for r in res]).sum(0, dtype=torch.int32),
                lb_computed=sum(r.lb_computed for r in res),
                iterations=tuple(r.iterations for r in res))
        if mut is not None:
            out = self._fold_mutable(out, mut, q, k, g, visit_batch,
                                     resident=True)
        return out

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
        """Release the out-of-core state: stop the compaction daemon and
        every prefetcher and drop the warm caches and stores. Idempotent
        and thread-safe: the state is detached under the lock and the
        prefetchers are joined outside it (a query in flight keeps its
        cache and reads on demand once its prefetcher stops). The write
        tier's data survives (a later insert or enable_writes starts the
        daemon again); build() calls it first and drops the tier."""
        self._stop_compactor()
        with self._ooc_lock:
            caches = list(self._shard_caches.values())
            self._shard_caches.clear()
            self._stores.clear()
        for cache in caches:
            if cache.prefetcher is not None:
                cache.prefetcher.close()
                cache.prefetcher = None

    def _query_ooc(self, queries, k: int, g: Guarantee, visit_batch: int,
                   opts: dict, mut: Optional[_MutView] = None
                   ) -> QueryResult:
        """Serve the batch from the spilled stores: shard after shard
        (on a mesh, each rank its own, the answers then gathered), the
        search loop runs over its store under serve_shard_with_failover,
        and the answers are folded in shard order. Per shard the answer
        is the resident search's bit for bit on a lossless codec, and
        both merges select the k smallest distances. With the write tier,
        each attempt masks the shard's tombstoned rows (one mask per
        shard, shared by its byte-identical copies, padded to the store's
        padded rows) and r_delta uses the joint N; the segments and the
        memtable are folded in after the shards."""
        from repro_torch.serve import fault as sfault
        from repro_torch.store import search_ooc

        t0 = obs.now()
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
                dead = n_over = None
                if mut is not None:
                    # a shard's copies are byte-identical (same ids), so
                    # the mask is the shard's, shared by its copies
                    unit = ("sshard", fctx.shard)
                    if unit not in self._ids_host:
                        self._ids_host[unit] = obs.host_read(
                            _SHARD_IDS, lambda t: t.cpu().numpy(),
                            store.resident.ids)
                    dead = self._unit_dead_dev(unit, 0, mut.snap,
                                               store.mmap.shape[0],
                                               store.device)
                    n_over = mut.joint_n
                # the child ooc.query span carries the shard's bytes_read
                with obs.span("engine.shard", shard=fctx.shard,
                              copy=fctx.replica):
                    return search_ooc(store, q, k, g,
                                      visit_batch=visit_batch, cache=cache,
                                      fault=fctx, dead=dead,
                                      n_override=n_over, **opts)

        # the span holds the frozen shards' fold; the write tier's fold
        # follows it, as in the reference
        with obs.span("engine.query", path="ooc", lanes=b, k=k,
                      shards=n_sh) as root:
            top_d = torch.full((b, k), float("inf"), device=dev)
            top_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
            leaves = torch.zeros(b, dtype=torch.int32, device=dev)
            rows = torch.zeros(b, dtype=torch.int32, device=dev)
            lbs = 0
            iters = [0] * n_sh
            per_shard, infos, lost = [], [], []
            served = {}
            lay = self._layout
            for si in range(n_sh) if lay is None else (lay.index,):
                copies = replica_dirs[si]
                # round-robin ownership: shard si's owner is copy si % R, and
                # failover walks the other copies in order
                order = tuple(copies[(si + j) % len(copies)]
                              for j in range(len(copies)))
                try:
                    out, info = served[si] = sfault.serve_shard_with_failover(
                        attempt, shard=si, replica_dirs=order, policy=policy,
                        breaker=breaker, injector=injector)
                except sfault.ShardLost:
                    served[si] = None
                    continue
                out.stats.retries = info.retries
                out.stats.failovers = info.failovers
                REGISTRY.counter("engine.shard.bytes_read", shard=str(si)).inc(
                    out.stats.bytes_read)
            if lay is not None:
                served = _gather_served(lay, served[lay.index], b, k, dev,
                                        obs.now() - t0)
            for si in range(n_sh):
                if served[si] is None:
                    lost.append(si)
                    continue
                out, info = served[si]
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
                root.set(degraded=True, shards_lost=stats.shards_lost,
                         effective_delta=stats.effective_delta)
            root.set(bytes_read_total=stats.bytes_read,
                     iterations=stats.iterations)
        out = QueryResult(dists=top_d, ids=top_i, leaves_visited=leaves,
                          rows_scanned=rows, lb_computed=lbs, stats=stats,
                          iterations=tuple(iters))
        if mut is not None:
            out = self._fold_mutable(out, mut, q, k, g, visit_batch,
                                     resident=False)
        return out

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

