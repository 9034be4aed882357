"""OocStats: the typed per-query out-of-core telemetry.

The port's copy of ``src/repro/obs/stats.py``'s schema, with the fields
that the out-of-core loop (``store/ooc.py``) and the device leaf cache
(``store/cache.py``) fill, and the fields of the engine's cross-shard
fold (``core/engine.py``). ``stats["bytes_read"]`` reads a field, as in
the reference.

Field groups:

  cache/prefetch   byte and hit accounting of DeviceLeafCache and
                   LeafPrefetcher, windowed per query by
                   ``reset_counters()``.
  refinement       what the loop measured: iterations, frontier refills,
                   per-lane visit totals, which stop condition fired per
                   lane, and the mean slack at stop in squared-distance
                   units. Attribution priority for a lane that meets
                   several predicates at once: delta (the r_delta early
                   stop), then epsilon (lower-bound pruning), then
                   exhausted (rank budget or every leaf scanned).
  fault tolerance  per shard its retries and failovers; on the engine's
                   aggregate the degradation triple (``degraded``,
                   ``shards_lost``, ``effective_delta``).
  engine fold      ``shards`` holds the per-shard OocStats of a
                   cross-shard query.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List


@dataclasses.dataclass
class OocStats:
    # ---- identity / knobs
    codec: str = ""
    share_gathers: bool = False
    prefetch_depth: int = 0
    # ---- cache / prefetcher accounting (DeviceLeafCache.stats())
    capacity_leaves: int = 0
    hits: int = 0
    hits_distinct: int = 0
    misses: int = 0
    hit_rate: float = 0.0
    hit_rate_distinct: float = 0.0
    bytes_read: int = 0          # total disk bytes incl. rerank + prefetch
    bytes_read_sync: int = 0     # demand-path reads only
    bytes_h2d: int = 0
    prefetch_hits: int = 0
    prefetch_bytes_read: int = 0
    prefetch_leaves_read: int = 0
    bytes_read_rerank: int = 0
    dataset_bytes: int = 0
    # ---- refinement-loop telemetry
    iterations: int = 0
    frontier_refills: int = 0    # lane-refill events across the loop
    leaves_visited: int = 0      # summed over lanes
    rows_scanned: int = 0        # candidates scored, summed over lanes
    pruning_ratio: float = 0.0   # 1 - leaves_visited / (lanes * L)
    stop_delta: int = 0          # lanes stopped by the r_delta early stop
    stop_epsilon: int = 0        # lanes stopped by (1+eps) lb pruning
    stop_exhausted: int = 0      # lanes that ran out of rank budget
    delta_slack: float = 0.0     # mean (1+eps)^2*rd^2 - bsf at delta stops
    eps_slack: float = 0.0       # mean next_lb*(1+eps)^2 - bsf at eps stops
    # ---- fault tolerance
    retries: int = 0             # failed shard attempts that were retried
    failovers: int = 0           # shards served from a non-owner copy
    degraded: bool = False       # answer computed without >= 1 shard
    shards_lost: int = 0
    effective_delta: float = 1.0  # honest delta of the returned answer
    # ---- engine cross-shard fold
    shards: List["OocStats"] = dataclasses.field(default_factory=list)

    # the reference's mapping view: the fields by name
    def __getitem__(self, key: str):
        try:
            return getattr(self, key)
        except AttributeError:
            raise KeyError(key) from None

    def get(self, key: str, default=None):
        return getattr(self, key, default)

    def __contains__(self, key) -> bool:
        return isinstance(key, str) and hasattr(self, key)

    def keys(self) -> List[str]:
        return [f.name for f in dataclasses.fields(self)]

    def items(self) -> list:
        return [(k, getattr(self, k)) for k in self.keys()]

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def as_dict(self) -> dict:
        out = {f.name: getattr(self, f.name)
               for f in dataclasses.fields(self) if f.name != "shards"}
        out["shards"] = [s.as_dict() for s in self.shards]
        return out

    _SUM_FIELDS = (
        "capacity_leaves", "hits", "hits_distinct", "misses",
        "bytes_read", "bytes_read_sync", "bytes_h2d", "prefetch_hits",
        "prefetch_bytes_read", "prefetch_leaves_read",
        "bytes_read_rerank", "dataset_bytes", "iterations",
        "frontier_refills", "leaves_visited", "rows_scanned",
        "stop_delta", "stop_epsilon", "stop_exhausted",
        "retries", "failovers",
    )

    @classmethod
    def aggregate(cls, per_shard: List["OocStats"]) -> "OocStats":
        """Cross-shard fold, as the reference's: sum the bytes and
        counts, recompute the hit rates from the summed counts, weight
        the slacks by the lanes attributed to each stop condition, take
        the plain mean of the pruning ratios, and keep the per-shard
        stats under ``shards``."""
        agg = cls()
        if not per_shard:
            return agg
        agg.codec = per_shard[0].codec
        agg.share_gathers = per_shard[0].share_gathers
        agg.prefetch_depth = per_shard[0].prefetch_depth
        for f in cls._SUM_FIELDS:
            setattr(agg, f, sum(getattr(s, f) for s in per_shard))
        total = agg.hits + agg.misses
        distinct = agg.hits_distinct + agg.misses
        agg.hit_rate = agg.hits / total if total else 0.0
        agg.hit_rate_distinct = \
            agg.hits_distinct / distinct if distinct else 0.0
        for slack, n in (("delta_slack", "stop_delta"),
                         ("eps_slack", "stop_epsilon")):
            w = sum(getattr(s, n) for s in per_shard)
            if w:
                setattr(agg, slack, sum(
                    getattr(s, slack) * getattr(s, n)
                    for s in per_shard) / w)
        if any(s.pruning_ratio or s.leaves_visited for s in per_shard):
            agg.pruning_ratio = float(
                sum(s.pruning_ratio for s in per_shard) / len(per_shard))
        agg.shards = list(per_shard)
        return agg
