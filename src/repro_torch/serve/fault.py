"""Serving-side fault tolerance: retries, failover, circuit breaking.

The port's copy of ``src/repro/serve/fault.py``, the policy layer
between the engine's shard owners and the injection points of
:mod:`repro_torch.fault`:

    RetryPolicy     capped exponential backoff and a per-attempt
                    deadline (a slow shard fails over instead of
                    stalling the query).
    CircuitBreaker  consecutive failures per (shard, copy): a copy that
                    keeps failing is skipped without paying its deadline
                    until a cooldown has passed (half-open: the next
                    attempt probes it again).
    FaultContext    what one shard-serve attempt threads into the search
                    loop: the injector and the attempt's deadline,
                    checked at every gather and score point (the loop
                    cannot be preempted mid-I/O, so deadlines are
                    polled).
    serve_shard_with_failover
                    the attempt loop: owner copy first, then each
                    replica in attempt order, backoff between attempts,
                    ShardLost when every copy is exhausted.

A deadline and a cooldown are each an :class:`Expiry`: a timer that
sets an event when its time is up, which ``check`` and ``allow`` read.
``TIMER`` is the timer factory (``threading.Timer``); a test replaces it
to expire a deadline or a cooldown when it chooses. Elapsed time is
read only for the ``fault.failover_latency_ms{shard}`` histogram (first
failure to the success on another attempt), on the port's one clock
(``repro_torch.clock.now``).

Counters: ``fault.attempt_failed``, ``fault.retries``,
``fault.failovers``, ``fault.shard_lost``, ``fault.breaker_open`` and
``fault.breaker_skip``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

from repro_torch.clock import now
from repro_torch.fault import FaultInjected, FaultInjector  # noqa: F401
from repro_torch.obs import REGISTRY

__all__ = [
    "Expiry", "FaultContext", "FaultInjected", "FaultInjector",
    "RetryPolicy", "CircuitBreaker", "ShardLost", "ShardServeInfo",
    "ShardTimeout", "serve_shard_with_failover",
]

# the factory of an Expiry's timer: (seconds, callback) -> an object with
# start() and cancel(), as threading.Timer
TIMER = threading.Timer


class Expiry:
    """A flag that a timer raises ``seconds`` after construction. The
    timer is a daemon thread; :meth:`cancel` stops it early."""

    def __init__(self, seconds: float):
        self._event = threading.Event()
        self._timer = TIMER(float(seconds), self._event.set)
        self._timer.daemon = True
        self._timer.start()

    def expired(self) -> bool:
        return self._event.is_set()

    def cancel(self) -> None:
        self._timer.cancel()


class ShardTimeout(RuntimeError):
    """A shard-serve attempt overran its per-attempt deadline."""


class ShardLost(RuntimeError):
    """Every copy of a shard failed past the retry budget: the query
    degrades (core/engine recomputes the honest delta)."""

    def __init__(self, shard: int, cause: Optional[BaseException] = None):
        super().__init__(
            f"shard {shard} lost after retries and replicas"
            + (f": {cause!r}" if cause is not None else ""))
        self.shard = shard
        self.cause = cause


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Per-shard retry, backoff and deadline policy.

    The attempt budget is ``max(max_attempts, n_copies)``, so every
    replica gets at least one attempt. ``attempt_deadline_s`` is the
    per-attempt budget, checked at the loop's gather and score points;
    None disables timeouts."""

    max_attempts: int = 3
    backoff_base_s: float = 0.005
    backoff_cap_s: float = 0.25
    attempt_deadline_s: Optional[float] = None

    def backoff_s(self, attempt: int) -> float:
        return min(self.backoff_cap_s,
                   self.backoff_base_s * (2.0 ** attempt))


class CircuitBreaker:
    """Consecutive-failure breaker keyed by (shard, copy dir).

    ``threshold`` consecutive failures open the circuit for
    ``cooldown_s``; while it is open ``allow`` is False and the failover
    loop skips the copy. After the cooldown the circuit is half-open:
    one attempt probes the copy, and its outcome closes or re-opens it."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0):
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._lock = threading.Lock()
        # key -> [consecutive failures, the cooldown's Expiry or None]
        self._state: Dict[object, list] = {}  # guarded_by: _lock

    def allow(self, key) -> bool:
        with self._lock:
            cooldown = self._state.get(key, [0, None])[1]
            return cooldown is None or cooldown.expired()

    def is_open(self, key) -> bool:
        return not self.allow(key)

    def record_success(self, key) -> None:
        with self._lock:
            old = self._state.pop(key, [0, None])[1]
        if old is not None:
            old.cancel()

    def record_failure(self, key) -> None:
        with self._lock:
            slot = self._state.setdefault(key, [0, None])
            slot[0] += 1
            # at or past the threshold every failure re-opens: a failed
            # half-open probe goes straight back to open
            opened = slot[0] >= self.threshold
            old = slot[1]
            if opened:
                slot[1] = Expiry(self.cooldown_s)
        if opened:
            if old is not None:
                old.cancel()
            REGISTRY.counter("fault.breaker_open", key=str(key)).inc()


@dataclasses.dataclass
class FaultContext:
    """Per-attempt context threaded into the search loop through
    ``search_ooc(..., fault=ctx)``: the loop calls ``check(point)``
    before every gather and score, which evaluates the injector's rules
    and the attempt's deadline. ``replica`` is the attempt-order
    position (0 = the copy that owns the shard now)."""

    shard: int
    replica: int = 0
    injector: Optional[FaultInjector] = None
    deadline: Optional[Expiry] = None

    def check(self, point: str) -> None:
        if self.injector is not None:
            self.injector.check(point, shard=self.shard,
                                replica=self.replica)
        if self.deadline is not None and self.deadline.expired():
            raise ShardTimeout(
                f"shard {self.shard} attempt (copy position "
                f"{self.replica}) overran its deadline at "
                f"point {point!r}")


@dataclasses.dataclass
class ShardServeInfo:
    """How one shard's answer was obtained (feeds OocStats)."""

    shard: int
    attempts: int = 1
    retries: int = 0      # failed attempts before the success
    failovers: int = 0    # 1 when served from a non-owner copy
    served_dir: str = ""
    served_replica: int = 0  # attempt-order position that served


def serve_shard_with_failover(
    attempt_fn: Callable[[str, FaultContext], object],
    *,
    shard: int,
    replica_dirs: Sequence[str],
    policy: Optional[RetryPolicy] = None,
    breaker: Optional[CircuitBreaker] = None,
    injector: Optional[FaultInjector] = None,
) -> Tuple[object, ShardServeInfo]:
    """Serve one shard with retries and replica failover.

    ``replica_dirs`` are the shard's store copies in attempt order
    (owner first); attempt ``i`` uses copy ``i % len(replica_dirs)``, so
    retries past the copy count wrap around. A failed attempt is
    followed by the policy's backoff. Returns ``(attempt_fn's result,
    ShardServeInfo)``; raises :class:`ShardLost` with the last cause when
    every attempt failed."""
    if not replica_dirs:
        raise ValueError(f"shard {shard}: no store copies to serve")
    policy = policy or RetryPolicy()
    n_attempts = max(int(policy.max_attempts), len(replica_dirs))
    label = str(shard)
    first_failure_t: Optional[float] = None
    cause: Optional[BaseException] = None
    failed = 0
    for attempt in range(n_attempts):
        pos = attempt % len(replica_dirs)
        d = replica_dirs[pos]
        if breaker is not None and not breaker.allow((shard, d)):
            REGISTRY.counter("fault.breaker_skip", shard=label).inc()
            if cause is None:
                cause = RuntimeError(
                    f"circuit open for shard {shard} copy {d!r}")
            continue
        deadline = None
        if policy.attempt_deadline_s is not None:
            deadline = Expiry(policy.attempt_deadline_s)
        ctx = FaultContext(shard=shard, replica=pos, injector=injector,
                           deadline=deadline)
        try:
            ctx.check("shard")  # the whole-shard kill gate
            result = attempt_fn(d, ctx)
        # repro: allow[broad-except] failover boundary: any attempt failure (injected fault, deadline, I/O or device error, a kernel that fails to build or launch) means retry or failover; the last cause leaves on ShardLost
        except Exception as e:
            failed += 1
            cause = e
            if first_failure_t is None:
                first_failure_t = now()
            if breaker is not None:
                breaker.record_failure((shard, d))
            REGISTRY.counter("fault.attempt_failed", shard=label).inc()
            if attempt + 1 < n_attempts:
                REGISTRY.counter("fault.retries", shard=label).inc()
                time.sleep(policy.backoff_s(attempt))
            continue
        finally:
            if deadline is not None:
                deadline.cancel()
        if breaker is not None:
            breaker.record_success((shard, d))
        info = ShardServeInfo(shard=shard, attempts=attempt + 1,
                              retries=failed, failovers=int(pos != 0),
                              served_dir=d, served_replica=pos)
        if pos != 0:
            REGISTRY.counter("fault.failovers", shard=label).inc()
        if first_failure_t is not None:
            REGISTRY.histogram("fault.failover_latency_ms",
                               shard=label).record(
                                   (now() - first_failure_t) * 1e3)
        return result, info
    REGISTRY.counter("fault.shard_lost", shard=label).inc()
    raise ShardLost(shard, cause)
