"""Process-wide metrics registry: labeled counters and gauges.

The port's copy of the counters and gauges of
``src/repro/obs/metrics.py``. The registry is always on: host-side code
updates labeled metrics unconditionally, each update one attribute op,
nanoseconds against the millisecond I/O and device steps it counts.
Metrics are keyed by (name, sorted labels). Nothing here reads a clock.
The reference's log-bucketed histograms come with the serving slice, the
first code of the port that records one.

Window semantics: counters are cumulative, and an owner that needs
per-query windows calls ``mark()`` and reads ``since_mark``; the
registry keeps the process-lifetime total either way.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple


class Counter:
    """Monotonic counter with an owner-managed window mark."""

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
        # repro: allow[guarded-by] deliberate lock-free monitoring read: a single int load is atomic under the GIL and this sits on snapshot()/bench hot paths
        return self._value

    def mark(self) -> None:
        """Start a new measurement window (owner-private)."""
        with self._lock:
            self._mark = self._value

    @property
    def since_mark(self):
        # repro: allow[guarded-by] deliberate lock-free read: worst case is a window view one inc() stale, never torn — both fields are GIL-atomic ints
        return self._value - self._mark


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

    def collect(self, prefix: Optional[str] = None):
        """All registered metric objects, optionally name-filtered."""
        with self._lock:
            ms = list(self._metrics.values())
        if prefix is not None:
            ms = [m for m in ms if m.name.startswith(prefix)]
        return ms

    def snapshot(self, prefix: Optional[str] = None) -> Dict[str, object]:
        """Flat {\"name{k=v,...}\": value} view."""
        out: Dict[str, object] = {}
        for m in self.collect(prefix):
            lbl = ",".join(f"{k}={v}" for k, v in m.labels)
            key = f"{m.name}{{{lbl}}}" if lbl else m.name
            out[key] = m.value
        return out


REGISTRY = MetricsRegistry()

