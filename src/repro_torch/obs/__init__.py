"""The port's observability (docs/OBSERVABILITY.md):

  trace      the opt-in span tracer (disabled by default, one check per
             site when off): nestable spans on the port's one clock
             (``now``, from ``repro_torch.clock``), per-query
             :class:`QueryProfile` summaries, Chrome trace-event export;
             while a ``torch.profiler`` records, the same sites are the
             profiler's ``record_function`` annotations.
  metrics    the always-on process-wide registry of labeled counters,
             gauges and log-bucketed histograms (p50/p95/p99), and
             ``host_read``, through which the query path's waits for
             the device are counted (``search.host_reads{site}``).
  stats      ``OocStats``, the typed per-query out-of-core telemetry.
  lockorder  the debug-mode lock-order recorder.
"""

from .lockorder import LockOrderError, LockOrderRecorder
from .metrics import (GROWTH, REGISTRY, Counter, Gauge, Histogram,
                      MetricsRegistry, host_read, read_site, registry)
from .stats import OocStats
from .trace import (NULL_SPAN, QueryProfile, Span, Tracer, chrome_events,
                    clear, disable, dump_chrome_trace, enable, enabled,
                    last_profile, now, profile, sink_on, span, tracer)

__all__ = [
    "GROWTH", "REGISTRY", "Counter", "Gauge", "Histogram",
    "LockOrderError", "LockOrderRecorder", "MetricsRegistry", "OocStats",
    "NULL_SPAN", "QueryProfile", "Span", "Tracer", "chrome_events",
    "clear", "disable", "dump_chrome_trace", "enable", "enabled",
    "host_read", "last_profile", "now", "profile", "read_site", "registry",
    "sink_on", "span", "tracer",
]
