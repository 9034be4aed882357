"""Host-side leaf prefetcher: a reader thread that stages future leaves.

While the card scores iteration t's leaves, the out-of-core loop knows
which leaves iteration t+1 (and the next few) will want: each lane's
next ranks in its visit order. ``schedule()`` hands such a batch to a
daemon thread that reads the leaves from the memmap into host buffers;
``take()`` pops a staged buffer on the cache's miss path. The staging
area is bounded to ``depth`` scheduled batches, so a lane that stops
early wastes at most ``depth`` batches of reads.

The prefetcher only reads. The upload stays in DeviceLeafCache._fill,
which copies an iteration's misses, staged or read on demand, into one
pinned buffer and ships it with one copy: the staged buffers themselves
are pageable, since the card never reads them directly.

Every field shared with the reader thread is annotated ``guarded_by``
and touched only under ``self._lock`` (a Condition). Waits use
``Condition.wait_for`` with a timeout, so no clock is read here; an
expired wait is reported with a warning, and the caller falls back to a
read of its own.
"""

from __future__ import annotations

import collections
import threading
import warnings
from typing import Optional, Sequence

import numpy as np

from .layout import LeafStore


class LeafPrefetcher:
    def __init__(self, store: LeafStore, depth: int = 2):
        self.store = store
        self.depth = int(depth)
        self._lock = threading.Condition()
        self._queue: collections.deque = \
            collections.deque()                   # guarded_by: _lock
        self._staged: "collections.OrderedDict[int, np.ndarray]" = \
            collections.OrderedDict()             # guarded_by: _lock
        self._inflight: set = set()               # guarded_by: _lock
        self._wanted: set = set()                 # guarded_by: _lock
        self._batches: collections.deque = \
            collections.deque()                   # guarded_by: _lock
        self._stop = False                        # guarded_by: _lock
        self._dead = False                        # guarded_by: _lock
        self._reading: Optional[int] = None       # guarded_by: _lock
        # the measurement window: reset_counters() bumps the epoch, and a
        # read that started in an earlier window adds nothing to this one
        self._epoch = 0                           # guarded_by: _lock
        self._bytes_read = 0                      # guarded_by: _lock
        self._leaves_read = 0                     # guarded_by: _lock
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @property
    def bytes_read(self) -> int:
        """Disk bytes read this window (speculative reads included)."""
        with self._lock:
            return self._bytes_read

    @property
    def leaves_read(self) -> int:
        with self._lock:
            return self._leaves_read

    # ------------------------------------------------------------------
    def schedule(self, leaves: Sequence[int]) -> None:
        """Stage a predicted batch of leaves (nearest window first: it is
        read first)."""
        batch = list(dict.fromkeys(int(x) for x in leaves))
        with self._lock:
            while len(self._batches) >= self.depth:
                self._batches.popleft()
            todo = [lf for lf in batch
                    if lf not in self._staged and lf not in self._inflight]
            self._batches.append(batch)
            # keep every structure bounded to the live batches; membership
            # is tested against their union, so overlapping windows never
            # drop a buffer that a newer batch still wants
            self._wanted = set()
            for bt in self._batches:
                self._wanted.update(bt)
            for lf in [s for s in self._staged if s not in self._wanted]:
                del self._staged[lf]
            self._queue = collections.deque(
                lf for lf in self._queue if lf in self._wanted)
            self._inflight &= self._wanted
            self._inflight.update(todo)
            self._queue.extend(todo)
            self._lock.notify_all()

    def take(self, leaf: int, timeout: float = 10.0) -> Optional[np.ndarray]:
        """Pop a staged leaf buffer; None if the leaf was never scheduled,
        was dropped, or the thread stopped. A leaf still queued or being
        read is waited for (the read is already paid for); a wait that
        outlasts ``timeout`` seconds warns and returns None."""
        leaf = int(leaf)
        with self._lock:
            def settled() -> bool:
                return (leaf in self._staged or self._stop or self._dead
                        or (leaf not in self._inflight
                            and leaf not in self._queue))

            if not self._lock.wait_for(settled, timeout):
                warnings.warn(
                    f"prefetcher: take({leaf}) gave up after {timeout:.1f}s "
                    "with the read still pending; the caller reads the "
                    "leaf itself (slow disk?)", RuntimeWarning, stacklevel=2)
                return None
            return self._staged.pop(leaf, None)

    def reset_counters(self, timeout: float = 10.0) -> None:
        """Start a fresh measurement window: drop the queued reads, wait
        for the one in flight, and zero the counters."""
        with self._lock:
            for lf in self._queue:
                self._inflight.discard(lf)
            self._queue.clear()
            if not self._lock.wait_for(
                    lambda: self._reading is None or self._dead, timeout):
                warnings.warn(
                    f"prefetcher: reset_counters waited {timeout:.1f}s for "
                    f"leaf {self._reading}; the epoch keeps its bytes out "
                    "of the new window", RuntimeWarning, stacklevel=2)
            self._epoch += 1
            self._bytes_read = 0
            self._leaves_read = 0

    def close(self, timeout: float = 5.0) -> None:
        """Stop the reader thread and join it (a thread wedged in a read
        past ``timeout`` is reported, not waited for)."""
        with self._lock:
            self._stop = True
            self._lock.notify_all()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            warnings.warn(
                f"prefetcher: reader thread alive {timeout:.1f}s after "
                "close(), wedged in a read?", RuntimeWarning, stacklevel=2)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------------
    def _run(self) -> None:
        try:
            while True:
                with self._lock:
                    self._lock.wait_for(lambda: self._queue or self._stop)
                    if self._stop:
                        return
                    leaf = self._queue.popleft()
                    self._reading = leaf
                    epoch = self._epoch
                buf = self.store.read_leaf(leaf)
                nbytes = self.store.leaf_nbytes(leaf)
                with self._lock:
                    self._inflight.discard(leaf)
                    self._reading = None
                    if not self._stop and leaf in self._wanted:
                        self._staged[leaf] = buf
                    if epoch == self._epoch:  # not reset mid-read
                        self._bytes_read += nbytes
                        self._leaves_read += 1
                    self._lock.notify_all()
        except Exception:  # I/O failure: wake waiters, cache reads on demand
            with self._lock:
                self._dead = True
                self._reading = None
                self._inflight.clear()
                self._queue.clear()
                self._lock.notify_all()
