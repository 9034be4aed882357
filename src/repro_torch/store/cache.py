"""Fixed-size device leaf cache over a LeafStore.

A slot pool ``slots [S, max_leaf, payload_cols]`` lives on the device in
the store's encoded dtype (f32 or bf16 rows, or uint8 PQ codes: decoding
happens in the scoring step, never here); the host keeps the leaf->slot
map and evicts by CLOCK (second chance). Each search iteration calls
:meth:`get_slots` with the leaves it is about to score: a hit sets the
slot's reference bit; the misses are taken from the prefetcher or read
from disk into ONE pinned host buffer, shipped with one asynchronous
copy and written into the pool with one ``index_copy_``, so the upload
is one transfer per iteration and the pool is updated in place.

Counters (``stats()``) are plain integers under the lock, windowed by
``reset_counters()``: disk bytes read, h2d bytes shipped (real misses
only), hits and misses, and how many misses the prefetcher had staged.
Hits count per request: every occurrence of a leaf in a ``get_slots``
batch that needed no read is a hit, so lanes sharing a leaf each earn
one; ``hits_distinct`` counts the leaves resident at the batch's start.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.obs import OocStats

from .layout import LeafStore
from .prefetch import LeafPrefetcher

# host dtype of a staged payload row: bfloat16 travels as its int16 bits
_HOST_DTYPES = {torch.bfloat16: torch.int16}


class DeviceLeafCache:
    def __init__(self, store: LeafStore, capacity_leaves: int,
                 prefetcher: Optional[LeafPrefetcher] = None):
        if capacity_leaves < 1:
            raise ValueError("capacity_leaves must be >= 1")
        self.store = store
        self.capacity = int(capacity_leaves)
        self.prefetcher = prefetcher
        # one critical section per get_slots batch: residency decisions,
        # eviction and the upload happen under the lock, so a concurrent
        # caller never sees a slot that points at payload not yet written.
        # Lock order: cache._lock, then the prefetcher's, never the reverse
        self._lock = threading.RLock()
        m, c = store.max_leaf, store.payload_cols
        self.slots = torch.zeros((self.capacity, m, c),
                                 dtype=store.payload_dtype,
                                 device=store.device)  # guarded_by: _lock
        self.slot_of: dict = {}  # leaf -> slot        # guarded_by: _lock
        self.owner = np.full(self.capacity, -1,
                             np.int64)                # guarded_by: _lock
        self.refbit = np.zeros(self.capacity, bool)   # guarded_by: _lock
        self.hand = 0                                 # guarded_by: _lock
        # the pinned staging buffer of the misses and the event that marks
        # the end of its last upload (the next fill waits for it)
        self._staging: Optional[torch.Tensor] = None  # guarded_by: _lock
        self._uploaded = None                         # guarded_by: _lock
        self._hits = 0                                # guarded_by: _lock
        self._hits_distinct = 0                       # guarded_by: _lock
        self._misses = 0                              # guarded_by: _lock
        self._bytes_read_sync = 0                     # guarded_by: _lock
        self._bytes_h2d = 0                           # guarded_by: _lock
        self._prefetch_hits = 0                       # guarded_by: _lock

    # ------------------------------------------------------------------
    def contains(self, leaf: int) -> bool:
        """True if the leaf is slot-resident now (no side effects: no
        reference bit, no hit). The prefetch scheduler skips such leaves."""
        with self._lock:
            return int(leaf) in self.slot_of

    def pool(self) -> torch.Tensor:
        """The slot pool as gatherable rows [S * max_leaf, payload_cols]."""
        with self._lock:
            return self.slots.reshape(-1, self.slots.shape[2])

    def _evict_one(self, pinned: set) -> int:
        """CLOCK: advance the hand, clearing reference bits, until an
        unpinned slot with a clear bit comes up."""
        with self._lock:
            for _ in range(2 * self.capacity + 1):
                s = self.hand
                self.hand = (self.hand + 1) % self.capacity
                if s in pinned:
                    continue
                if self.refbit[s]:
                    self.refbit[s] = False
                    continue
                if self.owner[s] >= 0:
                    del self.slot_of[int(self.owner[s])]
                self.owner[s] = -1
                return s
        raise RuntimeError(
            f"cache thrash: all {self.capacity} slots pinned by one "
            "iteration; raise capacity_leaves above the per-iteration "
            "working set")

    def get_slots(self, leaves: Sequence[int]) -> np.ndarray:
        """Make every leaf resident; returns their slot numbers. ``leaves``
        may repeat (lanes visiting one leaf): each distinct leaf is read
        and uploaded once, and every other occurrence is a hit."""
        slots = np.empty(len(leaves), np.int64)
        with self._lock:
            pinned = {self.slot_of[lf] for lf in leaves
                      if lf in self.slot_of}
            miss_leaves: List[int] = []
            miss_slots: List[int] = []
            seen: set = set()
            for i, lf in enumerate(leaves):
                lf = int(lf)
                s = self.slot_of.get(lf)
                if s is not None:
                    # resident, or filled earlier in this batch; only
                    # leaves resident before the batch are distinct hits
                    self._hits += 1
                    if lf not in seen:
                        self._hits_distinct += 1
                    self.refbit[s] = True
                    slots[i] = s
                    seen.add(lf)
                    continue
                s = self._evict_one(pinned)
                pinned.add(s)
                self.slot_of[lf] = s
                self.owner[s] = lf
                self.refbit[s] = True
                seen.add(lf)
                self._misses += 1
                miss_leaves.append(lf)
                miss_slots.append(s)
                slots[i] = s
            if miss_leaves:
                self._fill(miss_leaves, miss_slots)
        return slots

    def _fill(self, leaves: List[int], slot_ids: List[int]) -> None:
        """Stage the missed leaves in the pinned buffer and upload them
        with one copy and one index_copy_ into their slots."""
        n = len(leaves)
        m, c = self.store.max_leaf, self.store.payload_cols
        with self._lock:
            on_card = self.slots.is_cuda
            if self._uploaded is not None:
                self._uploaded.synchronize()  # the buffer is free again
            if self._staging is None or self._staging.shape[0] < n:
                self._staging = torch.empty(
                    (n, m, c),
                    dtype=_HOST_DTYPES.get(self.slots.dtype,
                                           self.slots.dtype),
                    pin_memory=on_card)
            host = self._staging[:n]
            buf = host.numpy().view(self.store.mmap.dtype)
            for j, lf in enumerate(leaves):
                staged = None
                if self.prefetcher is not None:
                    staged = self.prefetcher.take(lf)
                if staged is not None:
                    buf[j] = staged  # its bytes were counted by the reader
                    self._prefetch_hits += 1
                else:
                    self.store.read_leaf(lf, out=buf[j])
                    self._bytes_read_sync += self.store.leaf_nbytes(lf)
            self._bytes_h2d += buf.nbytes
            ids = torch.as_tensor(slot_ids, device=self.slots.device)
            rows = host.to(self.slots.device, non_blocking=True)
            self.slots.index_copy_(0, ids, rows.view(self.slots.dtype))
            if on_card:
                self._uploaded = torch.cuda.Event()
                self._uploaded.record()

    # ------------------------------------------------------------------
    def reset_counters(self) -> None:
        """Start a fresh measurement window (the prefetcher's too)."""
        with self._lock:
            self._hits = self._hits_distinct = self._misses = 0
            self._bytes_read_sync = self._bytes_h2d = 0
            self._prefetch_hits = 0
        if self.prefetcher is not None:
            self.prefetcher.reset_counters()

    def stats(self) -> OocStats:
        """The window's cache fields of an OocStats."""
        with self._lock:
            total = self._hits + self._misses
            distinct = self._hits_distinct + self._misses
            return OocStats(
                capacity_leaves=self.capacity,
                hits=self._hits,
                hits_distinct=self._hits_distinct,
                misses=self._misses,
                hit_rate=self._hits / total if total else 0.0,
                hit_rate_distinct=self._hits_distinct / distinct
                if distinct else 0.0,
                # each disk byte once: demand reads and the prefetcher's
                bytes_read=self._bytes_read_sync + (
                    self.prefetcher.bytes_read if self.prefetcher else 0),
                bytes_read_sync=self._bytes_read_sync,
                bytes_h2d=self._bytes_h2d,
                prefetch_hits=self._prefetch_hits)
