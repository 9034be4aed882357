"""Fault injection at named points of a query.

The port's copy of ``src/repro/fault.py``. An injector holds a set of
rules; code under test calls ``check(point, shard=..., replica=...)`` at
its fault points and the injector does nothing, sleeps (a slow-shard
rule) or raises :class:`FaultInjected`. The points wired in the port:

    gather   before a shard's leaf gather (core/search.Refinement)
    score    before a shard's scoring step (same loop)
    shard    at the start of every shard serve attempt
             (serve/fault.serve_shard_with_failover); ``kill_shard``
             arms a rule here to take a whole shard down

Rule semantics: ``after`` skips the first N matching checks (so a kill
lands mid-query, after real work), ``times`` bounds how often the rule
fires (``inf`` = down for good), ``delay_s`` sleeps instead of raising.
``replica`` in a rule matches the attempt-order position that the
failover loop passes to ``check``: position 0 is whichever copy owns the
shard, so "kill the owner" is ``replica=0``.

Every firing is counted in the registry (``fault.injected{point,
shard}``, ``fault.delayed{point, shard}``). The class is thread-safe:
the engine's shard owners share one injector, and a test may arm rules
from another thread mid-query. ``maybe_fail(step)`` is the training
contract of the reference (fail once per step in ``fail_at``).
"""

from __future__ import annotations

import math
import threading
import time
from typing import List, Optional

from repro_torch.obs import REGISTRY


class FaultInjected(RuntimeError):
    """An armed fault rule fired at an injection point."""

    def __init__(self, point: str, shard: Optional[int] = None,
                 replica: Optional[int] = None):
        super().__init__(
            f"injected fault at point {point!r}"
            + (f" shard={shard}" if shard is not None else "")
            + (f" replica={replica}" if replica is not None else ""))
        self.point = point
        self.shard = shard
        self.replica = replica


class _Rule:
    """One armed fault (its counters are guarded by the injector's
    lock)."""

    __slots__ = ("point", "shard", "replica", "times", "after",
                 "delay_s", "exc")

    def __init__(self, point, shard, replica, times, after, delay_s,
                 exc):
        self.point = point
        self.shard = shard
        self.replica = replica
        self.times = times
        self.after = after
        self.delay_s = delay_s
        self.exc = exc

    def matches(self, point, shard, replica) -> bool:
        if self.point != "*" and self.point != point:
            return False
        if self.shard is not None and self.shard != shard:
            return False
        if self.replica is not None and self.replica != replica:
            return False
        return True


class FaultInjector:
    """Deterministic fault injection for tests and the chip smoke."""

    def __init__(self, fail_at=()):
        self.fail_at = set(fail_at)
        self.fired = set()
        self._lock = threading.Lock()
        self._rules: List[_Rule] = []  # guarded_by: _lock

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected fault at step {step}")

    def fail(self, point: str = "*", *, shard: Optional[int] = None,
             replica: Optional[int] = None, times: float = 1,
             after: int = 0, exc=FaultInjected) -> "FaultInjector":
        """Arm a raising rule: the next ``times`` matching checks (after
        skipping the first ``after``) raise ``exc``."""
        with self._lock:
            self._rules.append(_Rule(point, shard, replica,
                                     float(times), int(after), 0.0, exc))
        return self

    def kill_shard(self, shard: int, *, replica: Optional[int] = None,
                   after: int = 0) -> "FaultInjector":
        """Take a shard down for good: every point on every copy (or
        only attempt position ``replica``) fails from the
        ``after``-th matching check on."""
        return self.fail("*", shard=shard, replica=replica,
                         times=math.inf, after=after)

    def delay(self, point: str = "gather", *,
              shard: Optional[int] = None,
              replica: Optional[int] = None, seconds: float = 0.05,
              times: float = math.inf,
              after: int = 0) -> "FaultInjector":
        """Arm a slow-shard rule: matching checks sleep instead of
        raising (with RetryPolicy.attempt_deadline_s, the timeout and
        failover path)."""
        with self._lock:
            self._rules.append(_Rule(point, shard, replica,
                                     float(times), int(after),
                                     float(seconds), FaultInjected))
        return self

    def clear(self) -> None:
        with self._lock:
            self._rules.clear()

    def check(self, point: str, *, shard: Optional[int] = None,
              replica: Optional[int] = None) -> None:
        """Evaluate every armed rule at an injection point. A raising
        rule wins over a delay rule armed at the same point; a delay
        sleeps outside the lock, so a sleeping shard blocks no other."""
        sleep_s = 0.0
        fire: Optional[_Rule] = None
        with self._lock:
            for r in self._rules:
                if not r.matches(point, shard, replica) or r.times <= 0:
                    continue
                if r.after > 0:
                    r.after -= 1
                    continue
                r.times -= 1
                if r.delay_s > 0:
                    sleep_s = max(sleep_s, r.delay_s)
                elif fire is None:
                    fire = r
        label = str(shard if shard is not None else "-")
        if fire is not None:
            REGISTRY.counter("fault.injected", point=point,
                             shard=label).inc()
            raise fire.exc(point, shard, replica)
        if sleep_s > 0:
            REGISTRY.counter("fault.delayed", point=point,
                             shard=label).inc()
            time.sleep(sleep_s)
