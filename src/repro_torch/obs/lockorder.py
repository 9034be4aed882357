"""Debug-mode lock-order recorder: deadlock prevention as a test asset.

The port's copy of ``src/repro/obs/lockorder.py`` (stdlib only). The
guarded-by analysis proves that each field is touched under its lock; it
cannot prove that two locks are always taken in the same order across
threads, the AB/BA deadlock. This module records the acquisition graph
instead: wrap each lock (``wrap(lock, "name")``), run a concurrent
workload, then ``assert_acyclic()``. An edge a->b means some thread took
b while holding a; a cycle in that graph is a lock-order inversion, a
deadlock waiting for the right interleaving even if this run never hit
it.

The wrapper is a delegating proxy, so Condition objects keep their whole
interface (``wait``/``notify_all`` pass through ``__getattr__``); taking
an RLock again records no self-edge. A ``Condition.wait`` releases and
takes its lock again internally, unseen by the recorder, which is
harmless: a waiting thread makes no other lock transition while parked.

Tests wrap the real locks (the engine's ``_write_lock``, the delta
tier's ``_lock``) around a concurrent workload; code paths outside tests
never pay for it.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set

__all__ = ["LockOrderError", "LockOrderRecorder", "RECORDER", "wrap"]


class LockOrderError(AssertionError):
    """A cycle exists in the observed lock-acquisition graph."""


class _TrackedLock:
    """Delegating proxy around a Lock/RLock/Condition that reports
    acquire/release to its recorder. ``with`` works; everything not
    intercepted (wait, notify, locked, ...) passes through."""

    def __init__(self, recorder: "LockOrderRecorder", inner, name: str):
        self._recorder = recorder
        self._inner = inner
        self._name = name

    def acquire(self, *args, **kwargs):
        got = self._inner.acquire(*args, **kwargs)
        if got:
            self._recorder._on_acquire(self._name)
        return got

    def release(self):
        self._recorder._on_release(self._name)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __getattr__(self, attr):
        return getattr(self._inner, attr)

    def __repr__(self):
        return f"<tracked {self._name} {self._inner!r}>"


class LockOrderRecorder:
    """Collects held-before edges per thread; asserts acyclicity."""

    def __init__(self) -> None:
        self._meta = threading.Lock()   # guards _edges only
        self._edges: Dict[str, Set[str]] = {}  # guarded_by: _meta
        self._local = threading.local()

    # ------------------------------------------------------- recording
    def _held(self) -> List[str]:
        st = getattr(self._local, "held", None)
        if st is None:
            st = self._local.held = []
        return st

    def _on_acquire(self, name: str) -> None:
        held = self._held()
        new_edges = [h for h in held if h != name]
        if new_edges:
            with self._meta:
                for h in new_edges:
                    self._edges.setdefault(h, set()).add(name)
        held.append(name)

    def _on_release(self, name: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                break

    # ------------------------------------------------------------- API
    def wrap(self, lock, name: str) -> _TrackedLock:
        return _TrackedLock(self, lock, name)

    def edges(self) -> Dict[str, Set[str]]:
        with self._meta:
            return {a: set(bs) for a, bs in self._edges.items()}

    def find_cycle(self) -> Optional[List[str]]:
        """A lock-name cycle in the acquisition graph, or None. DFS
        with the standard white/grey/black coloring; the returned list
        starts and ends on the same name."""
        graph = self.edges()
        color: Dict[str, int] = {}      # 0 white, 1 grey, 2 black
        stack: List[str] = []

        def visit(node: str) -> Optional[List[str]]:
            color[node] = 1
            stack.append(node)
            for nxt in sorted(graph.get(node, ())):
                c = color.get(nxt, 0)
                if c == 1:
                    return stack[stack.index(nxt):] + [nxt]
                if c == 0:
                    cyc = visit(nxt)
                    if cyc:
                        return cyc
            stack.pop()
            color[node] = 2
            return None

        for start in sorted(graph):
            if color.get(start, 0) == 0:
                cyc = visit(start)
                if cyc:
                    return cyc
        return None

    def assert_acyclic(self) -> None:
        cyc = self.find_cycle()
        if cyc:
            raise LockOrderError(
                "lock-order inversion (potential deadlock): "
                + " -> ".join(cyc)
                + "; observed edges: "
                + "; ".join(f"{a}->{sorted(bs)}"
                            for a, bs in sorted(self.edges().items())))

    def clear(self) -> None:
        with self._meta:
            self._edges.clear()


#: process-wide default recorder (tests typically build private ones)
RECORDER = LockOrderRecorder()


def wrap(lock, name: str,
         recorder: Optional[LockOrderRecorder] = None) -> _TrackedLock:
    """Wrap ``lock`` so its acquisition order is recorded under
    ``name`` (in ``recorder`` or the process-wide default)."""
    return (recorder or RECORDER).wrap(lock, name)
