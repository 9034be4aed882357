"""Lightweight thread-safe span tracer for the port's retrieval stack.

The port's copy of ``src/repro/obs/trace.py``. Every span is stamped on
``repro_torch.clock.now``, the port's one monotonic clock, which the
serving front (``serve/batching.Request.submitted_at``) and the failover
latency share, so stamps taken in different modules subtract coherently.
This module reads no clock of its own.

A span site has two sinks. The in-memory tracer takes it while tracing
is enabled (:func:`enable`); and while a ``torch.profiler`` is recording
(or ``torch.autograd.profiler.emit_nvtx``), the same site enters
``torch.profiler.record_function(<span name>)``, so the span lands in
the profiler's trace as a ``user_annotation`` on the kernels' clock (an
NVTX range under ``emit_nvtx``). With neither on, :func:`span` returns a
shared no-op context manager after one check.

When enabled, spans nest through a thread-local stack (each thread
builds its own subtree; ids are process-unique), finished spans land in
the tracer's ordered list, and two consumers read them:

  QueryProfile        a structured per-query summary of one span's
                      subtree: phase durations aggregated by child
                      name, plus ``total(attr)`` folds over numeric
                      span attributes.
  dump_chrome_trace   the same spans as Chrome trace-event JSON
                      (chrome://tracing, Perfetto): ``ph="X"`` complete
                      events, µs timestamps, span attrs in ``args``.

Spans are host time. An attribute may be a device tensor: it is kept as
it is, and read to the host (the Python number of its sum) only when the
spans are read (:meth:`Tracer.spans`, :func:`profile`,
:func:`chrome_events`), so a span over asynchronous device work does not
wait for it; the site hands over a tensor that nothing writes after. The
resident search's spans (``core.search``, ``engine.query``, the
``search.*`` loop phases) so never wait on the device; the out-of-core
phases (``ooc.filter``, ``ooc.score``, ``ooc.finalize``) wait for it
while the in-memory tracer is on, so that their spans cover the work
they launched. The span taxonomy and attribute names are the
reference's, and the port's own (docs/OBSERVABILITY.md).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import threading
from typing import Any, Dict, List, Optional

import torch

from repro_torch.clock import now

__all__ = [
    "NULL_SPAN", "QueryProfile", "Span", "Tracer", "chrome_events",
    "clear", "disable", "dump_chrome_trace", "enable", "enabled",
    "last_profile", "now", "profile", "sink_on", "span", "tracer",
]

_enabled = False
# whether a torch.profiler (or emit_nvtx) is recording: one C call
_profiling = torch.autograd._profiler_enabled


def enabled() -> bool:
    """Fast global flag — the only cost tracing adds when off."""
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def sink_on() -> bool:
    """Whether a span site records anywhere: the in-memory tracer is
    enabled or a profiler is recording. Counts that cost device work
    (``search.pooled_rows``) are made only then."""
    return _enabled or _profiling()


class _NullSpan:
    """Shared do-nothing span: what :func:`span` hands out while
    tracing is disabled. Accepts the full Span surface so call sites
    never branch."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass

    def add(self, key: str, n) -> None:
        pass


NULL_SPAN = _NullSpan()


class _ProfilerSpan(_NullSpan):
    """What :func:`span` hands out while only a profiler records: the
    profiler's ``record_function`` under the span's name; attributes go
    nowhere."""

    __slots__ = ("_rf",)

    def __init__(self, name: str):
        self._rf = torch.profiler.record_function(name)

    def __enter__(self):
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        return False


def _resolve(attrs: Dict[str, Any]) -> None:
    """Replace each device-tensor attribute by the Python number of its
    sum (a host read, once)."""
    for k, v in attrs.items():
        if isinstance(v, torch.Tensor):
            attrs[k] = v.sum().item()


@dataclasses.dataclass
class Span:
    """One timed region. Context-manager: ``with tracer.span(...) as
    sp: sp.set(bytes_read=...)``. ``t0``/``t1`` are ``now()`` stamps;
    ``parent`` is the enclosing span's id (-1 at a thread's root)."""

    name: str
    id: int = -1
    parent: int = -1
    t0: float = 0.0
    t1: float = 0.0
    tid: int = 0
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    _tracer: Optional["Tracer"] = dataclasses.field(
        default=None, repr=False, compare=False)
    _rf: Optional[Any] = dataclasses.field(
        default=None, repr=False, compare=False)

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def add(self, key: str, n) -> None:
        self.attrs[key] = self.attrs.get(key, 0) + n

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    @property
    def duration_ms(self) -> float:
        return (self.t1 - self.t0) * 1e3

    def __enter__(self) -> "Span":
        if _profiling():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self._tracer._push(self)
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = now()
        self._tracer._pop(self)
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        return False


class Tracer:
    """Collects finished spans. Thread-safe: each thread nests through
    its own stack; the finished list and the id counter are shared
    under one lock."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._ids = itertools.count()             # guarded_by: _lock
        self._spans: List[Span] = []              # guarded_by: _lock
        self._local = threading.local()

    # ------------------------------------------------------- internals
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _push(self, sp: Span) -> None:
        st = self._stack()
        sp.parent = st[-1].id if st else -1
        sp.t0 = now()
        st.append(sp)

    def _pop(self, sp: Span) -> None:
        st = self._stack()
        if st and st[-1] is sp:
            st.pop()
        else:  # mis-nested exit: drop it from wherever it sits
            try:
                st.remove(sp)
            except ValueError:
                pass
        with self._lock:
            self._spans.append(sp)

    # ------------------------------------------------------------- API
    def span(self, name: str, **attrs) -> Span:
        with self._lock:
            sid = next(self._ids)
        return Span(name=name, id=sid, tid=threading.get_ident(),
                    attrs=dict(attrs), _tracer=self)

    def current(self) -> Optional[Span]:
        """The innermost OPEN span on this thread (None outside any)."""
        st = self._stack()
        return st[-1] if st else None

    def spans(self) -> List[Span]:
        """Finished spans, completion-ordered (children before their
        parent — a parent exits last), their device attributes read."""
        with self._lock:
            out = list(self._spans)
        for sp in out:
            _resolve(sp.attrs)
        return out

    def find(self, name: str) -> List[Span]:
        return [s for s in self.spans() if s.name == name]

    def last(self, name: str) -> Optional[Span]:
        hits = self.find(name)
        return hits[-1] if hits else None

    def subtree(self, root: Span) -> List[Span]:
        """root + every finished descendant, completion-ordered."""
        all_spans = self.spans()
        keep = {root.id}
        # completion order puts children BEFORE parents, so walk the
        # list backwards: every span's parent is seen first
        out = []
        for sp in reversed(all_spans):
            if sp.id in keep or sp.parent in keep:
                keep.add(sp.id)
                out.append(sp)
        out.reverse()
        return out

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()


_TRACER = Tracer()


def tracer() -> Tracer:
    return _TRACER


def span(name: str, **attrs):
    """The instrumentation entry point: a real span when tracing is
    enabled, the profiler's annotation alone while only a profiler
    records, the shared no-op otherwise. ``with obs.span("x") as sp:``
    works identically in every state."""
    if not _enabled:
        return _ProfilerSpan(name) if _profiling() else NULL_SPAN
    return _TRACER.span(name, **attrs)


def clear() -> None:
    _TRACER.clear()


# ------------------------------------------------------- QueryProfile
@dataclasses.dataclass
class QueryProfile:
    """Structured summary of one query's span subtree.

    ``phase_ms`` aggregates DIRECT children by name (the per-phase
    breakdown: filter / iterations / finalize, or queue-wait /
    generate / retrieval on the serving side); ``attrs`` are the root
    span's attributes; :meth:`total` folds a numeric attribute over
    the whole subtree (each span counted once)."""

    name: str
    duration_ms: float
    attrs: Dict[str, Any]
    phase_ms: Dict[str, float]
    spans: List[Span]

    def total(self, attr: str, default=0):
        out = default
        for sp in self.spans:
            v = sp.attrs.get(attr)
            if v is not None:
                out = out + v
        return out

    def count(self, name: str) -> int:
        return sum(1 for sp in self.spans if sp.name == name)


def profile(root: Span, trc: Optional[Tracer] = None) -> QueryProfile:
    """Build a QueryProfile from a FINISHED root span."""
    trc = trc or _TRACER
    spans = trc.subtree(root)
    phase: Dict[str, float] = {}
    for sp in spans:
        if sp.parent == root.id:
            phase[sp.name] = phase.get(sp.name, 0.0) + sp.duration_ms
    return QueryProfile(name=root.name, duration_ms=root.duration_ms,
                        attrs=dict(root.attrs), phase_ms=phase,
                        spans=spans)


def last_profile(name: str,
                 trc: Optional[Tracer] = None) -> Optional[QueryProfile]:
    """Profile of the most recent finished span with this name."""
    trc = trc or _TRACER
    root = trc.last(name)
    return profile(root, trc) if root is not None else None


# ------------------------------------------------------- chrome trace
def _json_safe(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    try:  # numpy scalars
        return v.item()
    except AttributeError:
        return str(v)


def chrome_events(spans: List[Span]) -> List[dict]:
    """Spans -> Chrome trace-event "complete" (ph=X) events. ts/dur in
    µs on the shared monotonic clock; attrs become ``args``."""
    pid = os.getpid()
    for sp in spans:
        _resolve(sp.attrs)
    return [{
        "name": sp.name, "ph": "X", "pid": pid, "tid": sp.tid,
        "ts": sp.t0 * 1e6, "dur": max(sp.t1 - sp.t0, 0.0) * 1e6,
        "args": {k: _json_safe(v) for k, v in sp.attrs.items()},
    } for sp in spans]


def dump_chrome_trace(path: str,
                      trc: Optional[Tracer] = None) -> str:
    """Write every finished span as Chrome trace-event JSON (load in
    chrome://tracing or https://ui.perfetto.dev). Returns ``path``."""
    trc = trc or _TRACER
    doc = {"traceEvents": chrome_events(trc.spans()),
           "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
