"""OocStats: the typed per-query out-of-core telemetry.

The port's copy of ``src/repro/obs/stats.py``'s schema, with the fields
that the out-of-core loop (``store/ooc.py``) and the device leaf cache
(``store/cache.py``) fill. The engine's fold and fault fields come with
the engine slice. ``stats["bytes_read"]`` reads a field, as in the
reference.

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
"""

from __future__ import annotations

import dataclasses


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

    def __getitem__(self, key: str):
        try:
            return getattr(self, key)
        except AttributeError:
            raise KeyError(key) from None
