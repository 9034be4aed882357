"""Typed build and open specs: the engine's configuration surface.

The port's copy of ``src/repro/core/spec.py``:

  IndexSpec   what to build: the method and its build params (leaf_cap
              and friends), everything that shapes the frozen artifact.
  StoreSpec   where and how to serve it: spill directory, leaf codec,
              residency and replica count.

The reference's mutable-tier fields (``delta_max_rows``,
``auto_compact``, ``compact_interval_s``) come with the port's write
path, and its shims for the older loose keywords are not ported: the
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
    """Where and how the built shards are served:

      spill_dir        persist every shard as an on-disk store
                       (spill_dir/shard_NNNN); None = resident only.
      codec            the leaf payload's encoding ("f32", "bf16",
                       "pq").
      keep_resident    keep the shards on the device (False requires
                       spill_dir: out-of-core serving only).
      replicas         on-disk copies per shard (failover).
    """

    spill_dir: Optional[str] = None
    codec: str = "f32"
    keep_resident: bool = True
    replicas: int = 1

    def validate(self) -> "StoreSpec":
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if self.replicas > 1 and self.spill_dir is None:
            raise ValueError("replicas > 1 requires spill_dir")
        if not self.keep_resident and self.spill_dir is None:
            raise ValueError("keep_resident=False requires spill_dir")
        return self
