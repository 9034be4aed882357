"""The out-of-core tier: the v2 on-disk store, the device leaf cache and
its prefetcher, the out-of-core search, and the write tier's delta."""

from .cache import DeviceLeafCache
from .delta import DeltaSnapshot, DeltaTier, FreezeBatch, search_snapshot
from .layout import LeafStore, load_index, save_index
from .ooc import CachedStoreSource, OocResult, PQSource, search_ooc
from .prefetch import LeafPrefetcher

__all__ = ["save_index", "load_index", "LeafStore", "DeviceLeafCache",
           "LeafPrefetcher", "search_ooc", "OocResult", "CachedStoreSource",
           "PQSource", "DeltaTier", "DeltaSnapshot", "FreezeBatch",
           "search_snapshot"]
