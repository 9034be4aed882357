"""Continuous-batching serving front: per-guarantee lanes, no barrier.

The port's copy of ``src/repro/serve/loop.py``. The static front
(:meth:`repro_torch.serve.batching.Scheduler.run_retrieval` on one
server thread) drains one batch, answers it to completion, then drains
the next: a cheap ng query drained beside an expensive epsilon group
waits for the whole round. :class:`ServeFront` refills as it finishes:

  lanes     requests are routed by their nominal guarantee kind (mapped
            from the submitted deadline) into one of three lanes,
            ``epsilon`` (which also takes ``exact``), ``delta-epsilon``
            and ``ng``. Each lane has its own worker thread draining up
            to ``max_batch`` requests at a time, so an epsilon batch in
            flight never blocks the ng lane from refilling.
  remap     at drain time each request's guarantee is recomputed from
            its remaining deadline budget
            (:func:`repro_torch.serve.batching.retrieval_groups` with
            ``at=drain_stamp``): queue wait spends the budget.
  shed      while the :class:`repro_torch.serve.admission.AdmissionController`
            reports sustained pressure, each drained group is degraded
            one further tier.
  admission past the depth cap, submit() rejects with a reason instead
            of queueing into a certain deadline miss.
  writes    ``submit_write`` puts inserts and deletes on their own
            ``write`` lane, applied in submission order.

Each engine call is one ``engine.query`` per (lane batch x remapped
guarantee) group, padded to a power of two as the static front pads.
Every lane launches on the current CUDA stream (one stream for the whole
front: a stream per lane would need ``record_stream`` on every cached
tensor). Concurrent queries return what serial ones return: stats ride
the result (``QueryResult.stats``), a store copy's warm cache serves one
query at a time under its copy lock, and a query takes its write-tier
snapshot before it searches anything (core/engine.py).

Thread-safety: the lane deques are guarded by one condition
(``# guarded_by: _cond``); completion is per ticket (an Event), so a
submitter waits on its own request only. Lock order: the front's
condition is released before ``engine.query`` runs, so no front-lock ->
engine-lock edge forms while a worker holds it; ``lock_recorder`` (an
``obs.LockOrderRecorder``) wraps the condition's lock so a stress test
can assert the whole graph acyclic.

Every stamp is on ``repro_torch.clock.now``.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.clock import now
from repro_torch.core.guarantees import Guarantee

from .admission import AdmissionController
from .batching import (Request, degraded_entry, guarantee_for_deadline,
                       pad_lanes, retrieval_groups)

__all__ = ["LANES", "Rejected", "ServeFront", "Ticket", "WRITE_LANE",
           "lane_of"]

LANES = ("epsilon", "delta-epsilon", "ng")
# mutations ride their own worker, so a burst of inserts never queues
# behind an epsilon batch, nor the reverse. Writes are O(rows) memtable
# updates (store/delta.py), not queries, and take no admission slot:
# admission protects retrieval deadlines, which writes cannot miss
WRITE_LANE = "write"


def lane_of(kind: str) -> str:
    """Lane routing: ``exact`` rides the ``epsilon`` lane (the same cost
    regime, guarantee-driven visits); the other kinds get their own."""
    return "epsilon" if kind == "exact" else kind


class Rejected(RuntimeError):
    """submit() refused by admission control; ``reason`` says why."""

    def __init__(self, reason: str):
        super().__init__(f"request rejected: {reason}")
        self.reason = reason


class Ticket:
    """A submitted request's completion handle: ``result()`` blocks until
    the lane worker answers (or fails), then returns the entry dict
    ({ids, dists, kind, guarantee, retrieval_ms, queue_wait_ms,
    latency_ms, done_at, ...} or {"error": ...})."""

    __slots__ = ("uid", "_event", "_entry")

    def __init__(self, uid: int):
        self.uid = uid
        self._event = threading.Event()
        self._entry: Optional[Dict[str, Any]] = None

    def done(self) -> bool:
        return self._event.is_set()

    def _complete(self, entry: Dict[str, Any]) -> None:
        self._entry = entry
        self._event.set()

    def result(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.uid} not answered within {timeout}s")
        if self._entry is None:
            raise RuntimeError(f"request {self.uid} completed with no entry")
        return self._entry


class ServeFront:
    """The continuous-batching retrieval front (module docstring).

    Construct over a built engine (the front runs on the engine's
    device), ``start()`` it (or use it as a context manager),
    ``submit(Request)`` from any number of threads and read answers
    through the returned :class:`Ticket`. ``stop(drain=True)`` answers
    everything queued before it returns; ``drain=False`` completes the
    pending tickets with an error entry instead.
    """

    def __init__(self, engine, k: int = 5, *, max_batch: int = 8,
                 admission: Optional[AdmissionController] = None,
                 guarantee_kw: Optional[dict] = None,
                 lock_recorder=None):
        self.engine = engine
        self.k = k
        self.max_batch = max_batch
        self.admission = admission or AdmissionController()
        self.gkw = dict(guarantee_kw or {})
        lock: Any = threading.RLock()
        if lock_recorder is not None:
            lock = lock_recorder.wrap(lock, "serve.front._cond")
        self._cond = threading.Condition(lock)
        self._lanes: Dict[str, deque] = {
            ln: deque()
            for ln in LANES + (WRITE_LANE,)}          # guarded_by: _cond
        self._stopping = False                        # guarded_by: _cond
        self._drain_on_stop = True                    # guarded_by: _cond
        self._workers: List[threading.Thread] = []

    # ---------------------------------------------------- lifecycle
    def start(self) -> "ServeFront":
        if self._workers:
            return self
        for ln in LANES + (WRITE_LANE,):
            t = threading.Thread(target=self._worker, args=(ln,),
                                 name=f"serve-lane-{ln}", daemon=True)
            self._workers.append(t)
            t.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the lane workers. ``drain=True`` answers every queued
        request first; ``drain=False`` fails the pending tickets with an
        ``{"error": "stopped"}`` entry."""
        with self._cond:
            self._stopping = True
            self._drain_on_stop = drain
            self._cond.notify_all()
        for t in self._workers:
            t.join()
        self._workers = []

    def __enter__(self) -> "ServeFront":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=True)

    # ------------------------------------------------------- submit
    def submit(self, req: Request) -> Ticket:
        """Admit and enqueue one request; raises :class:`Rejected` past
        the admission cap. Safe from any thread."""
        kind = guarantee_for_deadline(req.deadline_ms, **self.gkw).kind
        reason = self.admission.try_admit(kind)
        if reason is not None:
            raise Rejected(reason)
        ticket = Ticket(req.uid)
        with self._cond:
            if self._stopping:
                self.admission.release()
                raise Rejected("stopped")
            self._lanes[lane_of(kind)].append((req, ticket))
            self._cond.notify_all()
        return ticket

    def submit_write(self, op: str, rows=None, ids=None,
                     uid: int = -1) -> Ticket:
        """Enqueue one mutation on the write lane: ``op='insert'`` with
        ``rows`` (optionally ``ids``), or ``op='delete'`` with ``ids``.
        The ticket's entry reports the global ids and ``applied_at``, the
        instant from which the next query's snapshot holds the write (the
        freshness measure). Safe from any thread; writes take no
        admission slot."""
        if op not in ("insert", "delete"):
            raise ValueError(f"op must be 'insert'|'delete', got {op!r}")
        if op == "insert" and rows is None:
            raise ValueError("insert needs rows")
        if op == "delete" and ids is None:
            raise ValueError("delete needs ids")
        ticket = Ticket(uid)
        with self._cond:
            if self._stopping:
                raise Rejected("stopped")
            self._lanes[WRITE_LANE].append(
                ((op, rows, ids, now()), ticket))
            self._cond.notify_all()
        return ticket

    # -------------------------------------------------------- drain
    def _take(self, lane: str) -> Optional[List[Tuple[Any, Ticket]]]:
        """Block until this lane has work (or the front stops). Returns
        up to ``max_batch`` entries, or None to exit."""
        with self._cond:
            q = self._lanes[lane]
            while not q and not self._stopping:
                self._cond.wait()
            if not q:
                return None           # stopping, and drained
            if self._stopping and not self._drain_on_stop:
                batch = list(q)
                q.clear()
                for _r, t in batch:
                    t._complete({"error": "stopped"})
                if lane != WRITE_LANE:  # writes hold no admission slot
                    self.admission.release(len(batch))
                return None
            return [q.popleft() for _ in range(min(len(q),
                                                   self.max_batch))]

    def _worker(self, lane: str) -> None:
        while True:
            batch = self._take(lane)
            if batch is None:
                return
            obs.REGISTRY.histogram(
                "serve.lane.batch_size", lane=lane).record(len(batch))
            try:
                if lane == WRITE_LANE:
                    self._process_writes(batch)
                else:
                    self._process(batch)
            except Exception as e:  # noqa: BLE001 a lane worker must outlive any one batch (a kernel that fails to build or launch, an engine error): its tickets complete with the error, serve.loop.errors counts it, and the lane keeps serving
                obs.REGISTRY.counter("serve.loop.errors", lane=lane).inc()
                for _r, t in batch:
                    if not t.done():
                        t._complete({"error": repr(e)})
            finally:
                if lane != WRITE_LANE:  # writes hold no admission slot
                    self.admission.release(len(batch))

    def _process_writes(self, batch) -> None:
        """Apply one drained write-lane batch in submission order
        (``engine.insert`` / ``engine.delete``, memtable updates). The
        entry's ``applied_at`` is the instant from which a query's
        snapshot holds the write."""
        for (op, rows, ids, submitted), t in batch:
            t0 = now()
            if op == "insert":
                out_ids = np.asarray(self.engine.insert(rows, ids))
            else:
                out_ids = np.asarray(ids, np.int64).reshape(-1)
                self.engine.delete(out_ids)
            done = now()
            obs.REGISTRY.counter("serve.writes", op=op).inc(
                int(out_ids.shape[0]))
            t._complete({
                "op": op, "ids": out_ids, "applied_at": done,
                "queue_wait_ms": max((t0 - submitted) * 1e3, 0.0),
                "latency_ms": max((done - submitted) * 1e3, 0.0),
                "done_at": done,
            })

    def _process(self, batch: List[Tuple[Request, Ticket]]) -> None:
        """Answer one drained lane batch: remap guarantees from the
        remaining deadline budget, degrade one tier under shedding, then
        one engine call per resulting guarantee group."""
        drained_at = now()
        tickets = {r.uid: t for r, t in batch}
        for r, t in batch:
            if r.series is None:
                # nothing to retrieve: answered at once
                t._complete({
                    "ids": None, "dists": None,
                    "kind": guarantee_for_deadline(
                        r.deadline_ms, **self.gkw).kind,
                    "retrieval_ms": 0.0,
                    "queue_wait_ms": max(
                        (drained_at - r.submitted_at) * 1e3, 0.0),
                    "latency_ms": max((now() - r.submitted_at) * 1e3, 0.0),
                    "done_at": now(),
                })
        shedding = self.admission.shedding()
        for g, group in retrieval_groups(
                [r for r, _t in batch if r.series is not None],
                at=drained_at, **self.gkw):
            g_final = self.admission.shed(g) if shedding else g
            self._query_group(g, g_final, group, tickets, drained_at,
                              shed=g_final != g)

    def _query_group(self, g_nominal: Guarantee, g: Guarantee,
                     group: List[Request], tickets: Dict[int, Ticket],
                     drained_at: float, *, shed: bool) -> None:
        qs, lanes = pad_lanes(group)
        with obs.span("serve.retrieval_group", kind=g.kind,
                      lanes=lanes, requests=len(group)):
            t0 = now()
            res = self.engine.query(qs, self.k, g)
            # the read-back waits for the device: the group's time covers
            # the whole engine call
            ids_np = res.ids.cpu().numpy()
            dists_np = res.dists.cpu().numpy()
            group_ms = (now() - t0) * 1e3
        obs.REGISTRY.histogram(
            "serve.retrieval_ms", kind=g.kind).record(group_ms)
        # a shard lost past every copy degrades the answer's guarantee,
        # read from the result's own stats, never engine state
        kind, extra = degraded_entry(res, g, len(group))
        done_at = now()
        for i, r in enumerate(group):
            entry: Dict[str, Any] = {
                "ids": ids_np[i],
                "dists": dists_np[i],
                "guarantee": g,
                "kind": kind,
                "nominal_kind": g_nominal.kind,
                "retrieval_ms": group_ms,
                "queue_wait_ms": max(
                    (drained_at - r.submitted_at) * 1e3, 0.0),
                "latency_ms": max((done_at - r.submitted_at) * 1e3, 0.0),
                "done_at": done_at,
                "stats": getattr(res, "stats", None),
                **extra,
            }
            if shed:
                entry["shed"] = True
            tickets[r.uid]._complete(entry)
