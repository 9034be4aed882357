"""Process-wide metrics registry: labeled counters, gauges and
log-bucketed histograms with p50/p95/p99 extraction.

The port's copy of ``src/repro/obs/metrics.py``. The registry is always
on: host-side code updates labeled metrics unconditionally, each update
one attribute op under a lock, nanoseconds against the millisecond I/O
and device steps it measures. Metrics are keyed by (name, sorted labels).
Nothing here reads a clock: the callers record durations taken on
``repro_torch.clock.now``.

Histograms are log-bucketed: geometric bucket bounds with growth
``GROWTH`` (= 2^(1/8), ~9% relative resolution), an underflow bucket for
values <= ``lo``, exact min/max/count/sum tracked alongside. Quantiles
interpolate linearly inside the hit bucket and clamp to the exact
[min, max], so any quantile is within one bucket of the true sample
quantile. The bucket constants are the reference's, so the same recorded
values give bit-equal quantiles.

Window semantics: counters are cumulative, and an owner that needs
per-query windows calls ``mark()`` and reads ``since_mark``; the
registry keeps the process-lifetime total either way.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional, Tuple

GROWTH = 2.0 ** 0.125          # ~9.05% geometric bucket width
_LN_GROWTH = math.log(GROWTH)
_LO = 1e-9                     # first positive bucket upper bound
_N_BUCKETS = 480               # covers (1e-9, ~1e9] + underflow at [0]


class Counter:
    """Monotonic counter with an owner-managed window mark.

    An increment may be a 0-d device tensor: the total then stays on its
    device, each further increment one small addition there, and is read
    to the host once, when the counter is next read (``value``,
    ``since_mark``, ``mark``), so counting does not wait for the
    device."""

    __slots__ = ("name", "labels", "_lock", "_value", "_mark")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0                           # guarded_by: _lock
        self._mark = 0                            # guarded_by: _lock

    def inc(self, n=1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        """Cumulative process-lifetime total."""
        # repro: allow[guarded-by] deliberate lock-free monitoring read: a single load is atomic under the GIL and this sits on snapshot()/bench hot paths
        v = self._value
        if isinstance(v, (int, float)):
            return v
        with self._lock:  # a device total, read to the host once
            if not isinstance(self._value, (int, float)):
                self._value = self._value.item()
            return self._value

    def mark(self) -> None:
        """Start a new measurement window (owner-private)."""
        v = self.value
        with self._lock:
            self._mark = v

    @property
    def since_mark(self):
        v = self.value
        # repro: allow[guarded-by] deliberate lock-free read: worst case is a window view one inc() stale, never torn — both fields are GIL-atomic ints
        return v - self._mark


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "labels", "_value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self._value = 0.0

    def set(self, v) -> None:
        self._value = v

    @property
    def value(self):
        return self._value


class Histogram:
    """Log-bucketed value histogram with quantile extraction.

    Bucket i > 0 spans (lo*G^(i-1), lo*G^i]; bucket 0 is the underflow
    [<= lo], zeros included. ``quantile(q)`` returns the value at
    fractional rank q*(count-1): walk the cumulative bucket counts,
    interpolate linearly inside the hit bucket, clamp to the exact
    tracked [min, max].
    """

    __slots__ = ("name", "labels", "_lock", "_counts", "count", "sum",
                 "min", "max")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._counts = [0] * _N_BUCKETS           # guarded_by: _lock
        self.count = 0                            # guarded_by: _lock
        self.sum = 0.0                            # guarded_by: _lock
        self.min = math.inf                       # guarded_by: _lock
        self.max = -math.inf                      # guarded_by: _lock

    @staticmethod
    def _bucket(v: float) -> int:
        if v <= _LO:
            return 0
        i = int(math.log(v / _LO) / _LN_GROWTH) + 1
        return min(i, _N_BUCKETS - 1)

    @staticmethod
    def _bounds(i: int) -> Tuple[float, float]:
        if i == 0:
            return 0.0, _LO
        return _LO * GROWTH ** (i - 1), _LO * GROWTH ** i

    def record(self, v) -> None:
        v = float(v)
        with self._lock:
            self._counts[self._bucket(v)] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def quantile(self, q: float) -> float:
        with self._lock:
            if self.count == 0:
                return math.nan
            rank = q * (self.count - 1)
            cum = 0
            for i, c in enumerate(self._counts):
                if c == 0:
                    continue
                if cum + c > rank:
                    lo, hi = self._bounds(i)
                    frac = (rank - cum + 0.5) / c
                    v = lo + (hi - lo) * min(max(frac, 0.0), 1.0)
                    return min(max(v, self.min), self.max)
                cum += c
            return self.max

    def quantiles(self, qs=(0.5, 0.95, 0.99)) -> Dict[str, float]:
        return {f"p{round(q * 100) if q < 1 else 100}":
                self.quantile(q) for q in qs}

    @property
    def mean(self) -> float:
        # sum and count are read together under the lock: a record()
        # between the two loads would skew the ratio
        with self._lock:
            return self.sum / self.count if self.count else math.nan

    def snapshot(self) -> Dict[str, float]:
        # the scalar fields under one hold; quantiles() takes the lock
        # again per call, outside it
        with self._lock:
            n = self.count
            out = {"count": n, "sum": self.sum,
                   "min": self.min if n else math.nan,
                   "max": self.max if n else math.nan,
                   "mean": self.sum / n if n else math.nan}
        out.update(self.quantiles())
        return out


class MetricsRegistry:
    """Get-or-create registry keyed by (name, sorted label kv-pairs).
    One process-wide instance (``REGISTRY``); tests may build private
    ones."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[tuple, object] = {}    # guarded_by: _lock

    def _get(self, cls, name: str, labels: dict):
        lbl = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        key = (name, lbl)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(name, lbl)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} is a "
                                f"{type(m).__name__}, not a {cls.__name__}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def collect(self, prefix: Optional[str] = None):
        """All registered metric objects, optionally name-filtered."""
        with self._lock:
            ms = list(self._metrics.values())
        if prefix is not None:
            ms = [m for m in ms if m.name.startswith(prefix)]
        return ms

    def snapshot(self, prefix: Optional[str] = None) -> Dict[str, object]:
        """Flat {\"name{k=v,...}\": value-or-quantile-dict} view."""
        out: Dict[str, object] = {}
        for m in self.collect(prefix):
            lbl = ",".join(f"{k}={v}" for k, v in m.labels)
            key = f"{m.name}{{{lbl}}}" if lbl else m.name
            out[key] = m.snapshot() if isinstance(m, Histogram) \
                else m.value
        return out

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return REGISTRY


def read_site(site: str) -> Counter:
    """The ``search.host_reads{site}`` counter of one place in the query
    path where the host waits for the device. Bind it once, when the
    module that holds the site is imported."""
    return REGISTRY.counter("search.host_reads", site=site)


def host_read(site: Counter, fn, *args, **kw):
    """``fn(*args, **kw)``, a step that waits for the device (a device
    value read to the host, or a copy from pageable host memory),
    counted at ``site`` (:func:`read_site`). Every such step of the
    query path goes through here, so the count misses none."""
    site.inc()
    return fn(*args, **kw)

