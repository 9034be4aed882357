"""Typed build and open specs: the engine's configuration surface.

The port's copy of ``src/repro/core/spec.py``:

  IndexSpec   what to build: the method and its build params (leaf_cap
              and friends), everything that shapes the frozen artifact.
  StoreSpec   where and how to serve it: spill directory, leaf codec,
              residency, replica count and the write tier's knobs.

The reference's shims for the older loose keywords are not ported: the
port has no caller of that spelling.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class IndexSpec:
    """What to build: a method name plus its build params (passed to
    the builder as keywords, e.g. ``leaf_cap``). ``params`` is kept as a
    sorted item tuple so the spec stays frozen and hashable; read it
    back through :attr:`build_params`."""

    method: str = "dstree"
    params: Tuple[Tuple[str, Any], ...] = ()

    def __init__(self, method: str = "dstree",
                 params: Optional[Mapping[str, Any]] = None, **kw):
        object.__setattr__(self, "method", method)
        merged = dict(params or {})
        merged.update(kw)
        object.__setattr__(self, "params", tuple(sorted(merged.items())))

    @property
    def build_params(self) -> Dict[str, Any]:
        return dict(self.params)


@dataclasses.dataclass(frozen=True)
class StoreSpec:
    """Where and how the built shards are served, and the write tier's
    knobs:

      spill_dir        persist every shard as an on-disk store
                       (spill_dir/shard_NNNN) and the compacted delta
                       segments under spill_dir/segments/; None =
                       resident only.
      codec            the leaf payload's encoding ("f32", "bf16",
                       "pq"), for shards and segments.
      keep_resident    keep the shards on the device (False requires
                       spill_dir: out-of-core serving only).
      replicas         on-disk copies per shard (failover).
      delta_max_rows   live delta rows at which the compaction daemon
                       freezes the memtable (writes always succeed; this
                       bounds the brute-scored tier, not the write rate).
      auto_compact     run the compaction daemon (started by
                       ``engine.enable_writes``; ``engine.compact()``
                       works either way).
      compact_interval_s  the daemon's poll period.
    """

    spill_dir: Optional[str] = None
    codec: str = "f32"
    keep_resident: bool = True
    replicas: int = 1
    delta_max_rows: int = 8192
    auto_compact: bool = False
    compact_interval_s: float = 0.05

    def validate(self) -> "StoreSpec":
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if self.replicas > 1 and self.spill_dir is None:
            raise ValueError("replicas > 1 requires spill_dir")
        if not self.keep_resident and self.spill_dir is None:
            raise ValueError("keep_resident=False requires spill_dir")
        if self.delta_max_rows < 1:
            raise ValueError(
                f"delta_max_rows must be >= 1, got {self.delta_max_rows}")
        return self
