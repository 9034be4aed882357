"""The port's observability (docs/OBSERVABILITY.md):

  trace      the opt-in span tracer (disabled by default, one bool check
             per site when off): nestable spans on the port's one clock
             (``now``, from ``repro_torch.clock``), per-query
             :class:`QueryProfile` summaries, Chrome trace-event export.
  metrics    the always-on process-wide registry of labeled counters,
             gauges and log-bucketed histograms (p50/p95/p99).
  stats      ``OocStats``, the typed per-query out-of-core telemetry.
  lockorder  the debug-mode lock-order recorder.
"""

from .lockorder import LockOrderError, LockOrderRecorder
from .metrics import (GROWTH, REGISTRY, Counter, Gauge, Histogram,
                      MetricsRegistry, registry)
from .stats import OocStats
from .trace import (NULL_SPAN, QueryProfile, Span, Tracer, chrome_events,
                    clear, disable, dump_chrome_trace, enable, enabled,
                    last_profile, now, profile, span, tracer)

__all__ = [
    "GROWTH", "REGISTRY", "Counter", "Gauge", "Histogram",
    "LockOrderError", "LockOrderRecorder", "MetricsRegistry", "OocStats",
    "NULL_SPAN", "QueryProfile", "Span", "Tracer", "chrome_events",
    "clear", "disable", "dump_chrome_trace", "enable", "enabled",
    "last_profile", "now", "profile", "registry", "span", "tracer",
]
