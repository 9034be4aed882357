"""The write tier: an LSM-style in-memory delta over the frozen stores.

The port of ``src/repro/store/delta.py``. Everything below the engine is
frozen at build time; this module absorbs writes while the engine
serves:

  active      a dict memtable taking ``insert(rows)`` and
              ``delete(ids)`` under one lock; a read holds it no longer
              than a snapshot copy.
  immutable   the memtable frozen by ``begin_freeze`` while compaction
              builds it into a leaf-contiguous segment (the engine owns
              that step); still served from snapshots until the segment
              is published.
  kills       id -> kill sequence. Both ``delete(id)`` and an insert of
              an id that exists record a kill at the current global
              sequence, which supersedes every older copy of the id: in
              the frozen base shards (born at sequence 0), in a
              compacted segment (born at its freeze sequence) or in the
              immutable memtable (each row carries its insert sequence).
              A frozen unit's copy of ``id`` is dead iff
              ``kills[id] > born_seq``; delete-then-reinsert needs no
              special case (the reinsert's kill masks the old copies,
              and the new active row is the newest by construction).

Search side: :func:`search_snapshot` brute-scores a snapshot's live rows
with the same arithmetic per codec as the frozen store of that codec
(the expanded-form L2 over the f32 rows or their bfloat16 image, with
the image's own norms; the direct difference for pq, which is what the
exact re-rank reports) and returns square-rooted (dists, ids) shaped
like one more shard's answer. The engine folds it through
``ops.topk_merge_unique``, whose distinct-id precondition the kill rule
guarantees (at most one live copy of an id across base, segments and
snapshot). That keeps frozen+delta answers equal to a rebuild from
scratch that holds the same live rows.

Thread safety: every mutable field is guarded by ``_lock``; snapshots
are copied out under the lock and never change afterwards, so queries
score without the lock and compaction never blocks a query in flight
(it swaps the published state under the same lock).
"""

from __future__ import annotations

import threading
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels import ops
from repro_torch.obs import REGISTRY

_UPLOAD = obs.read_site("delta_rows")


class DeltaSnapshot(NamedTuple):
    """A consistent point-in-time view for one query: the live delta rows
    (active, plus the immutable rows still live), the kill map as of the
    same instant (the frozen units' masks must come from the state the
    rows were read at, or a superseded base row and its replacement could
    both vanish) and the published segments. Never changes after it is
    made, so it is scored without a lock."""
    rows: np.ndarray          # [m, n] f32 live delta rows
    ids: np.ndarray           # [m] int32
    kills: Dict[int, int]     # id -> kill sequence (a copy)
    kills_version: int        # monotone; keys the per-unit mask caches
    segments: Tuple           # published engine segments
    live_rows: int            # m

    def dead_mask(self, unit_ids: np.ndarray, born_seq: int,
                  pad_to: Optional[int] = None) -> np.ndarray:
        """[len(unit_ids)] bool: the rows of a frozen unit that this
        snapshot supersedes (a kill newer than the unit's birth).
        ``pad_to`` pads with False up to a store's padded row count, so
        ``ScoreCtx.dead[row_idx]`` never reads past its end."""
        uids = np.asarray(unit_ids)
        if not self.kills:
            mask = np.zeros(uids.shape[0], bool)
        else:
            kid = np.fromiter(self.kills.keys(), np.int64,
                              count=len(self.kills))
            kseq = np.fromiter(self.kills.values(), np.int64,
                               count=len(self.kills))
            killed = kid[kseq > born_seq]
            mask = np.isin(uids, killed) if killed.size \
                else np.zeros(uids.shape[0], bool)
        if pad_to is not None and pad_to > mask.shape[0]:
            mask = np.pad(mask, (0, pad_to - mask.shape[0]))
        return mask


class FreezeBatch(NamedTuple):
    """What ``begin_freeze`` hands the compactor: the immutable
    memtable's live rows and the birth sequence their segment carries.
    Deletes and reinserts that land during the build have kill sequences
    above ``born_seq`` and mask the published segment's copies, so
    publishing stale rows is safe."""
    rows: np.ndarray   # [m, n] f32
    ids: np.ndarray    # [m] int32
    born_seq: int


class DeltaTier:
    """The engine's write buffer. Every public method is thread-safe;
    ``insert`` and ``delete`` are dict updates on the host (no device
    work)."""

    def __init__(self, series_len: int, *, start_id: int = 0):
        self.series_len = int(series_len)
        self._lock = threading.RLock()
        self._seq = 0             # guarded_by: _lock (global mutation seq)
        self._active: Dict[int, tuple] = {}   # guarded_by: _lock id -> (row, seq)
        self._immutable: Optional[Dict[int, tuple]] = None  # guarded_by: _lock
        self._immutable_born = 0  # guarded_by: _lock
        self._kills: Dict[int, int] = {}      # guarded_by: _lock
        self._kills_version = 0   # guarded_by: _lock
        self._segments: Tuple = ()            # guarded_by: _lock
        self._next_id = int(start_id)         # guarded_by: _lock

    # ------------------------------------------------------------ writes
    def insert(self, rows, ids=None) -> np.ndarray:
        """Absorb rows [m, n] (or one row [n]); returns their ids, past
        the frozen id space unless given. Inserting an id that exists
        anywhere records a kill at the new sequence: the newest copy wins,
        older frozen copies are masked, an older active copy is
        replaced."""
        rows = np.ascontiguousarray(np.asarray(rows, np.float32))
        if rows.ndim == 1:
            rows = rows[None, :]
        if rows.shape[1] != self.series_len:
            raise ValueError(
                f"insert: rows have length {rows.shape[1]}, "
                f"store serves length {self.series_len}")
        with self._lock:
            if ids is None:
                ids = np.arange(self._next_id,
                                self._next_id + rows.shape[0],
                                dtype=np.int64)
                self._next_id += rows.shape[0]
            else:
                ids = np.asarray(ids, np.int64).reshape(-1)
                if ids.shape[0] != rows.shape[0]:
                    raise ValueError("insert: len(ids) != len(rows)")
                self._next_id = max(self._next_id, int(ids.max()) + 1)
            for i, rid in enumerate(ids.tolist()):
                self._seq += 1
                # supersede any older copy of this id (a fresh id's kill
                # masks nothing)
                self._kills[rid] = self._seq
                self._active[rid] = (rows[i], self._seq)
            self._kills_version += rows.shape[0]
        REGISTRY.counter("delta.inserts").inc(rows.shape[0])
        REGISTRY.gauge("delta.live_rows").set(self.live_rows())
        return ids

    def delete(self, ids) -> int:
        """Tombstone ids everywhere (base, segments, memtables). Returns
        the number of ids processed; deleting an id that was never
        inserted is a kill that masks nothing."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        with self._lock:
            for rid in ids.tolist():
                self._seq += 1
                self._kills[rid] = self._seq
                self._active.pop(rid, None)
            self._kills_version += ids.shape[0]
        REGISTRY.counter("delta.deletes").inc(ids.shape[0])
        REGISTRY.gauge("delta.live_rows").set(self.live_rows())
        return int(ids.shape[0])

    # ------------------------------------------------------------- reads
    def _live_items(self):
        """(id, row) pairs still live: all of active (newest by
        construction) and the immutable rows no kill has outrun. Takes
        the (reentrant) lock itself."""
        with self._lock:
            out = [(rid, row) for rid, (row, _) in self._active.items()]
            if self._immutable:
                for rid, (row, seq) in self._immutable.items():
                    if self._kills.get(rid, -1) <= seq:
                        out.append((rid, row))
            return out

    def live_rows(self) -> int:
        with self._lock:
            return len(self._live_items())

    def snapshot(self) -> DeltaSnapshot:
        with self._lock:
            items = self._live_items()
            if items:
                ids = np.asarray([rid for rid, _ in items], np.int64)
                rows = np.stack([row for _, row in items])
            else:
                ids = np.zeros((0,), np.int64)
                rows = np.zeros((0, self.series_len), np.float32)
            return DeltaSnapshot(
                rows=rows, ids=ids.astype(np.int32),
                kills=dict(self._kills),
                kills_version=self._kills_version,
                segments=self._segments,
                live_rows=int(ids.shape[0]))

    # -------------------------------------------------------- compaction
    def freeze_threshold_reached(self, max_rows: int) -> bool:
        with self._lock:
            return len(self._active) >= max_rows \
                and self._immutable is None

    def begin_freeze(self) -> Optional[FreezeBatch]:
        """Swap the active memtable to immutable and hand its live rows
        to the compactor. None when there is nothing to compact or a
        freeze is already in flight (one compaction at a time)."""
        with self._lock:
            if self._immutable is not None or not self._active:
                return None
            self._immutable, self._active = self._active, {}
            self._immutable_born = self._seq
            live = [(rid, row) for rid, (row, seq)
                    in self._immutable.items()
                    if self._kills.get(rid, -1) <= seq]
            if not live:
                self._immutable = None
                return None
            ids = np.asarray([rid for rid, _ in live], np.int64)
            rows = np.stack([row for _, row in live])
            return FreezeBatch(rows=rows, ids=ids.astype(np.int32),
                               born_seq=self._immutable_born)

    def publish_segment(self, segment) -> None:
        """Put the built segment in the immutable memtable's place: one
        tuple append under the lock, so a query sees the segment or the
        immutable memtable, never both and never neither."""
        with self._lock:
            self._segments = self._segments + (segment,)
            self._immutable = None
        REGISTRY.counter("delta.compactions").inc()
        REGISTRY.gauge("delta.live_rows").set(self.live_rows())

    def abort_freeze(self) -> None:
        """Compaction failed: fold the immutable memtable back into
        active (the newest copy of an id wins), so no write is lost."""
        with self._lock:
            if self._immutable is None:
                return
            imm, self._immutable = self._immutable, None
            for rid, (row, seq) in imm.items():
                cur = self._active.get(rid)
                if cur is None or cur[1] < seq:
                    self._active[rid] = (row, seq)

    @property
    def kills_version(self) -> int:
        with self._lock:
            return self._kills_version

    def segments(self) -> Tuple:
        with self._lock:
            return self._segments


# ------------------------------------------------------------- scoring
def search_snapshot(snap: DeltaSnapshot, queries: torch.Tensor, k: int,
                    *, codec: str = "f32") -> tuple:
    """Brute-score a snapshot's live rows as one more shard, on the
    queries' device: square-rooted ([B, k] dists, [B, k] int32 ids, -1
    padded), ready for the engine's ``ops.topk_merge_unique`` fold. The
    arithmetic per codec is the frozen store's of the same codec:

      f32    the expanded-form L2 over the f32 rows with their norms
             (refine_step's solo raw corner);
      bf16   the same over the bfloat16 image of the rows, with norms of
             the image (what save_index persists and the store's source
             scores);
      pq     the direct difference, which is what the exact re-rank
             reports (store/ooc._exact_rerank): delta rows need no code.
    """
    dev = queries.device
    b = queries.shape[0]
    qf = queries.float()
    top_d = torch.full((b, k), float("inf"), device=dev)
    top_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    if snap.live_rows == 0:
        return top_d, top_i
    m = snap.live_rows
    with obs.span("delta.search", lanes=b, rows=m):
        cand = obs.host_read(_UPLOAD, torch.as_tensor, snap.ids,
                             device=dev)[None, :].expand(b, m)
        rows = obs.host_read(_UPLOAD, torch.as_tensor, snap.rows, device=dev)
        if codec == "pq":
            diff = rows[None] - qf[:, None, :]
            d = (diff * diff).sum(-1)
        else:
            if codec == "bf16":
                rows = rows.to(torch.bfloat16)
            # per lane, as refine_step scores a leaf's rows
            d = ops.sq_l2(qf, rows[None].expand(b, m, -1),
                          ops.row_sq_norms(rows)[None].expand(b, m))
        top_d, top_i = ops.topk_merge(d, cand, top_d, top_i)
    return torch.sqrt(top_d), top_i
