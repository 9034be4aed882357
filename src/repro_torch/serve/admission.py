"""Admission control and QoS load shedding for the continuous serving
front.

The port's copy of ``src/repro/serve/admission.py``. Two pressure
valves in front of :mod:`repro_torch.serve.loop`, each making overload an
explicit, observable decision instead of an unbounded queue:

  admission   a hard cap on in-system depth (queued + in flight). Past
              the cap a submit is rejected with a reason, so the caller
              hears "try later" at once instead of joining a queue whose
              wait already guarantees a missed deadline. Depth is the
              ``serve.queue_depth`` gauge; decisions are the
              ``serve.admission.accepted{kind}`` and
              ``serve.admission.rejected{reason}`` counters.
  shedding    a hysteresis band below the cap. While depth sits above
              ``shed_high`` the controller reports ``shedding()`` and the
              drain loop degrades each drained group one guarantee tier
              (:func:`degrade_tier`); shedding switches off only once
              depth falls to ``shed_low``, so the valve does not flap.
              Sheds are counted per original kind
              (``serve.admission.shed{kind}``).

The guarantee each response reports is the degraded one: quality is
traded, never misreported. One mutex guards depth and the shed flag;
every method is safe from any submitter or lane-worker thread.
"""

from __future__ import annotations

import threading
from typing import Optional

from repro_torch import obs
from repro_torch.core.guarantees import Guarantee

__all__ = ["AdmissionController", "degrade_tier"]

QUEUE_FULL = "queue_full"


def degrade_tier(g: Guarantee) -> Guarantee:
    """One step down the paper's guarantee lattice (quality knob, not
    a drop decision): epsilon/exact -> delta-epsilon (0.99, eps>=1),
    delta-epsilon -> ng(nprobe=16), ng -> ng with nprobe halved
    (floor 1 — the bottom tier still answers)."""
    kind = g.kind
    if kind in ("exact", "epsilon"):
        return Guarantee(delta=0.99, epsilon=max(g.epsilon, 1.0))
    if kind == "delta-epsilon":
        return Guarantee(nprobe=16)
    return Guarantee(nprobe=max(1, (g.nprobe or 1) // 2))


class AdmissionController:
    """Bounded-depth admission with hysteresis load-shedding.

    ``max_depth`` bounds requests IN THE SYSTEM (admitted and not yet
    released — queued or in flight). ``shed_high`` / ``shed_low`` are
    absolute depths derived from the given fractions of the cap;
    construction validates ``0 <= shed_low <= shed_high <= max_depth``.
    """

    def __init__(self, max_depth: int = 64, *,
                 shed_high_frac: float = 0.75,
                 shed_low_frac: float = 0.25):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        if not 0.0 <= shed_low_frac <= shed_high_frac <= 1.0:
            raise ValueError(
                "need 0 <= shed_low_frac <= shed_high_frac <= 1, got "
                f"{shed_low_frac}, {shed_high_frac}")
        self.max_depth = max_depth
        self.shed_high = max(1, int(round(shed_high_frac * max_depth)))
        self.shed_low = int(round(shed_low_frac * max_depth))
        self._lock = threading.Lock()
        self._depth = 0                           # guarded_by: _lock
        self._shedding = False                    # guarded_by: _lock
        self._gauge = obs.REGISTRY.gauge("serve.queue_depth")

    # ------------------------------------------------------- admit
    def try_admit(self, kind: str = "none") -> Optional[str]:
        """Admit one request (labeled by its nominal guarantee kind
        for the accept counter). Returns None on admit, or the reject
        reason string — currently only ``"queue_full"`` — when the
        system is at ``max_depth``. Each admit must be paired with one
        :meth:`release` when the request leaves the system (completed,
        failed, or dropped at drain)."""
        with self._lock:
            if self._depth >= self.max_depth:
                obs.REGISTRY.counter(
                    "serve.admission.rejected", reason=QUEUE_FULL).inc()
                return QUEUE_FULL
            self._depth += 1
            self._update_locked()
        obs.REGISTRY.counter("serve.admission.accepted", kind=kind).inc()
        return None

    def release(self, n: int = 1) -> None:
        """A request (or n of them) left the system."""
        with self._lock:
            self._depth = max(0, self._depth - n)
            self._update_locked()

    def _update_locked(self) -> None:
        # hysteresis: on above shed_high, off below shed_low, sticky
        # in between. Lexically outside a with-block because BOTH
        # callers (try_admit/release) already hold _lock — the _locked
        # suffix is the calling convention.
        if self._depth >= self.shed_high:  # repro: allow[guarded-by] called with _lock held by both callers (_locked calling convention)
            self._shedding = True  # repro: allow[guarded-by] called with _lock held by both callers (_locked calling convention)
        elif self._depth <= self.shed_low:  # repro: allow[guarded-by] called with _lock held by both callers (_locked calling convention)
            self._shedding = False  # repro: allow[guarded-by] called with _lock held by both callers (_locked calling convention)
        self._gauge.set(self._depth)  # repro: allow[guarded-by] called with _lock held by both callers (_locked calling convention)

    # ------------------------------------------------------- state
    @property
    def depth(self) -> int:
        # repro: allow[guarded-by] lock-free monitoring read: a single int load is GIL-atomic and this sits on submit/bench hot paths
        return self._depth

    def shedding(self) -> bool:
        """True while the drain loop should degrade tiers (hysteresis
        band: latched above ``shed_high``, cleared below
        ``shed_low``)."""
        # repro: allow[guarded-by] lock-free monitoring read: a single bool load is GIL-atomic; staleness by one transition only widens/narrows shedding by one request
        return self._shedding

    def shed(self, g: Guarantee) -> Guarantee:
        """Degrade one tier and count it against the ORIGINAL kind.
        No-op (no counter) when the tier cannot drop further."""
        out = degrade_tier(g)
        if out != g:
            obs.REGISTRY.counter(
                "serve.admission.shed", kind=g.kind).inc()
        return out
