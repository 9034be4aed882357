"""The paper's guarantee taxonomy (Fig. 1 / Table 1) as a type.

    exact            delta=1, epsilon=0, unbounded visits
    epsilon          delta=1, epsilon>0            (deterministic bound)
    delta-epsilon    delta<1, epsilon>=0           (probabilistic bound)
    ng               nprobe-bounded visits         (no guarantee)

Every search takes one :class:`Guarantee`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional


class Guarantee(NamedTuple):
    delta: float = 1.0
    epsilon: float = 0.0
    nprobe: Optional[int] = None  # None = guarantee-driven (unbounded)

    @property
    def kind(self) -> str:
        if self.nprobe is not None:
            return "ng"
        if self.delta < 1.0:
            return "delta-epsilon"
        if self.epsilon > 0.0:
            return "epsilon"
        return "exact"

    def validate(self) -> "Guarantee":
        if not (0.0 <= self.delta <= 1.0):
            raise ValueError(f"delta must be in [0,1], got {self.delta}")
        if self.epsilon < 0.0:
            raise ValueError(f"epsilon must be >= 0, got {self.epsilon}")
        if self.nprobe is not None and self.nprobe < 1:
            raise ValueError(f"nprobe must be >= 1, got {self.nprobe}")
        return self


EXACT = Guarantee()


def exact() -> Guarantee:
    return EXACT


def epsilon(eps: float) -> Guarantee:
    return Guarantee(epsilon=eps).validate()


def delta_epsilon(delta: float, eps: float = 0.0) -> Guarantee:
    return Guarantee(delta=delta, epsilon=eps).validate()


def ng(nprobe: int = 1) -> Guarantee:
    """The paper's ng-approximate: visit nprobe leaves, keep the best."""
    return Guarantee(nprobe=nprobe).validate()
