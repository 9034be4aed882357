"""Request batching for serving: buckets, deadlines, graceful degrade.

The port's copy of ``src/repro/serve/batching.py``. Requests are bucketed
by prompt length (power-of-two buckets bound the batch shapes), each
bucket drains as a uniform batch, and a per-request deadline maps onto
the paper's guarantee taxonomy for the retrieval path
(:func:`guarantee_for_deadline`): a relaxed deadline gets the epsilon
guarantee, a moderate one the probabilistic delta-epsilon tier (the
paper's Fig. 8 regime: almost always exact, bounded failure
probability), and a tight one ng(nprobe), the paper's observation that
the first best-so-far answers are near-exact. Load shedding is then a
quality knob, not a drop decision.

The retrieval front (:meth:`Scheduler.run_retrieval`) drives
``DistributedEngine.query`` (resident or out of core, the engine
decides), one query batch per guarantee group: requests drained together
with different deadlines are partitioned by their mapped guarantee
(:func:`retrieval_groups`), each group padded to a power-of-two lane
bucket. The group's queries go to the engine as one numpy stack, which
the engine moves to its device; the answers come back with one
``.cpu()`` per group, inside the group's timed window, so
``retrieval_ms`` covers the device work.

Every stamp is on ``repro_torch.clock.now``, the port's one clock.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.clock import now
from repro_torch.core.guarantees import Guarantee

__all__ = ["Request", "Scheduler", "bucket_of", "degraded_entry",
           "guarantee_for_deadline", "pad_lanes", "remaining_budget_ms",
           "retrieval_groups"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # [S] int32
    max_new_tokens: int = 16
    deadline_ms: Optional[float] = None
    # the retrieval query in the engine's series space ([n] float); None:
    # this request wants no retrieval
    series: Optional[np.ndarray] = None
    # stamped on the port's one clock, which every wait and latency of the
    # serving stack subtracts it from
    submitted_at: float = dataclasses.field(default_factory=now)


def bucket_of(length: int, min_bucket: int = 16) -> int:
    b = min_bucket
    while b < length:
        b *= 2
    return b


def guarantee_for_deadline(
    deadline_ms: Optional[float], *, full_budget_ms: float = 50.0,
    delta_budget_frac: float = 0.5, nprobe_floor: int = 1,
    nprobe_ceil: int = 64, epsilon: float = 0.0,
    degraded_delta: float = 0.99, degraded_epsilon: float = 1.0,
) -> Guarantee:
    """Map a latency budget onto the paper's taxonomy:

      deadline >= full budget (or none)   Guarantee(epsilon=epsilon)
      >= delta_budget_frac * full         delta-epsilon (degraded_delta,
                                          max(epsilon, degraded_epsilon))
      below that                          ng(nprobe), nprobe scaled
                                          linearly with the remaining
                                          fraction of the delta budget

    Every tier still returns an answer."""
    if deadline_ms is None or deadline_ms >= full_budget_ms:
        return Guarantee(epsilon=epsilon)
    frac = max(deadline_ms, 1e-3) / full_budget_ms
    if frac >= delta_budget_frac:
        return Guarantee(delta=degraded_delta,
                         epsilon=max(epsilon, degraded_epsilon))
    sub = frac / delta_budget_frac
    nprobe = int(round(nprobe_floor
                       + sub * (nprobe_ceil - nprobe_floor)))
    return Guarantee(nprobe=max(nprobe_floor, nprobe))


def remaining_budget_ms(r: Request, at: float) -> Optional[float]:
    """The deadline budget a request has left at ``at`` (a clock stamp):
    ``deadline_ms`` less the queue wait already spent. None (no deadline)
    stays None; a spent budget clamps to ~0, the bottom ng tier."""
    if r.deadline_ms is None:
        return None
    waited_ms = (at - r.submitted_at) * 1e3
    return max(r.deadline_ms - waited_ms, 1e-3)


def retrieval_groups(
    reqs: Sequence[Request], at: Optional[float] = None, **gkw,
) -> List[Tuple[Guarantee, List[Request]]]:
    """Partition a drained batch by its deadline-mapped guarantee
    (insertion-ordered): the engine takes one guarantee per query batch,
    so a mixed batch fans out into one engine call per guarantee.

    ``at`` (a clock stamp) maps from the budget left at drain time
    instead of the submitted deadline: a request that spent 40 ms of a
    50 ms budget in the queue maps from the 10 ms it has left. None keeps
    the submitted-deadline partition."""
    groups: Dict[Guarantee, List[Request]] = {}
    for r in reqs:
        budget = (r.deadline_ms if at is None
                  else remaining_budget_ms(r, at))
        g = guarantee_for_deadline(budget, **gkw)
        groups.setdefault(g, []).append(r)
    return list(groups.items())


def pad_lanes(group: Sequence[Request]) -> Tuple[np.ndarray, int]:
    """A group's series stacked as float32 [lanes, n], padded to a
    power-of-two lane count by repeating the last row (the extra lanes'
    answers are dropped). Returns (stack, lanes)."""
    qs = np.stack([np.asarray(r.series, np.float32) for r in group])
    lanes = bucket_of(qs.shape[0], 1)
    if lanes > qs.shape[0]:
        qs = np.concatenate(
            [qs, np.repeat(qs[-1:], lanes - qs.shape[0], 0)])
    return qs, lanes


class Scheduler:
    """Length-bucketed FIFO batching and the deadline-aware retrieval
    front. Queue state is lock-guarded: submitters and the drain loop may
    run on different threads."""

    def __init__(self, max_batch: int = 8, min_bucket: int = 16):
        self.max_batch = max_batch
        self.min_bucket = min_bucket
        self._lock = threading.Lock()
        self.queues: Dict[int, List[Request]] = \
            defaultdict(list)                     # guarded_by: _lock

    def submit(self, req: Request):
        bucket = bucket_of(len(req.prompt), self.min_bucket)
        with self._lock:
            self.queues[bucket].append(req)

    def next_batch(self) -> Optional[Tuple[int, List[Request]]]:
        """Drain up to ``max_batch`` requests from the bucket whose head
        request has waited longest: FIFO across buckets (each bucket is
        FIFO inside), so sustained small-prompt load cannot starve a
        larger bucket."""
        with self._lock:
            best = None
            for bucket, q in self.queues.items():
                if q and (best is None
                          or q[0].submitted_at
                          < self.queues[best][0].submitted_at):
                    best = bucket
            if best is None:
                return None
            q = self.queues[best]
            take = q[: self.max_batch]
            self.queues[best] = q[len(take):]
            return best, take

    def pad_prompts(self, bucket: int, reqs: List[Request]) -> np.ndarray:
        out = np.zeros((len(reqs), bucket), np.int32)
        for i, r in enumerate(reqs):
            out[i, bucket - len(r.prompt):] = r.prompt  # left-pad
        return out

    # ---------------------------------------------- retrieval front
    def run_retrieval(
        self, engine, reqs: Sequence[Request], k: int, **gkw,
    ) -> Dict[int, Dict[str, Any]]:
        """Drive ``engine.query`` for a drained batch: one call per
        deadline-mapped guarantee group (:func:`retrieval_groups`, mapped
        from the budget left at drain time), each padded by
        :func:`pad_lanes`. Requests without a ``series`` are skipped.
        Returns {uid: {ids, dists, guarantee, kind, retrieval_ms, stats}}:
        ``retrieval_ms`` is the request's own group's time, engine call
        and read-back, so no request is charged for another group's work;
        group times also land in the ``serve.retrieval_ms{kind}``
        histogram. A group whose engine lost shards past every copy
        reports the honest tier, delta-epsilon, with ``effective_delta``
        and ``shards_lost`` (the stats ride the result, never engine
        state, which concurrent queries would race on)."""
        out: Dict[int, Dict[str, Any]] = {}
        drained_at = now()
        for g, group in retrieval_groups(
                [r for r in reqs if r.series is not None],
                at=drained_at, **gkw):
            qs, lanes = pad_lanes(group)
            with obs.span("serve.retrieval_group", kind=g.kind,
                          lanes=lanes, requests=len(group)):
                t0 = now()
                res = engine.query(qs, k, g)
                # the read-back waits for the device: the group's time
                # covers the whole engine call
                ids_np = res.ids.cpu().numpy()
                dists_np = res.dists.cpu().numpy()
                group_ms = (now() - t0) * 1e3
            obs.REGISTRY.histogram(
                "serve.retrieval_ms", kind=g.kind).record(group_ms)
            kind, extra = degraded_entry(res, g, len(group))
            for i, r in enumerate(group):
                out[r.uid] = {"ids": ids_np[i], "dists": dists_np[i],
                              "guarantee": g, "kind": kind,
                              "retrieval_ms": group_ms,
                              "stats": getattr(res, "stats", None), **extra}
        return out


def degraded_entry(res, g: Guarantee, n_requests: int
                   ) -> Tuple[str, Dict[str, Any]]:
    """The tier an answer honestly reports, and the entry fields that say
    why: a result whose engine lost shards past every copy is
    delta-epsilon with its recomputed ``effective_delta``, whatever was
    asked, and counts ``serve.degraded{kind}`` per request. ``getattr``
    takes results with no ``stats`` (stub engines in tests)."""
    stats = getattr(res, "stats", None)
    if stats is None or not stats.degraded:
        return g.kind, {}
    obs.REGISTRY.counter("serve.degraded", kind=g.kind).inc(n_requests)
    # the entry fields the reference's fronts set, one by one
    extra: Dict[str, Any] = {"degraded": True, "requested_kind": g.kind}
    extra["effective_delta"] = float(stats.effective_delta)
    extra["shards_lost"] = int(stats.shards_lost)
    return "delta-epsilon", extra
