"""The paper's guarantee taxonomy (Fig. 1 / Table 1) as a type.

    exact            delta=1, epsilon=0, unbounded visits
    epsilon          delta=1, epsilon>0            (deterministic bound)
    delta-epsilon    delta<1, epsilon>=0           (probabilistic bound)
    ng               nprobe-bounded visits         (no guarantee)

Every search takes one :class:`Guarantee`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


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


def joint_n_total(base_n_total: int, frozen_dead: int,
                  delta_live: int) -> int:
    """The row count N that r_delta is evaluated at when the frozen store
    is served with the write tier.

    The live collection holds ``base - frozen_dead + delta_live`` rows,
    but r_delta = F^-1(1 - delta^(1/N)) falls as N grows: counting too
    few rows (ignoring inserts) would stop too early and break the delta
    guarantee, while counting too many (ignoring deletes) only shrinks
    the stop radius. So the joint N is the live count floored at the
    frozen N."""
    live = base_n_total - int(frozen_dead) + int(delta_live)
    return max(int(base_n_total), live, 1)


def effective_delta_after_loss(hist, kth_dists, n_lost: int, *,
                               delta: float = 1.0,
                               epsilon: float = 0.0) -> float:
    """The honest delta of an answer computed without ``n_lost`` rows.

    Under the independence model that defines r_delta (distances to the
    query are draws from the global F of ``hist``), the answer stays
    epsilon-correct iff no unseen row lies within d_k / (1 + epsilon) of
    the query; each unseen row misses that ball with probability
    1 - F(d_k / (1 + epsilon)), so per lane

        P[answer still epsilon-correct] = (1 - F(d_k/(1+eps)))**n_lost

    and the batch's delta is the prior ``delta`` times the worst lane's
    survival. ``kth_dists`` are the lanes' kth-best distances of the
    surviving fold (Euclidean, like the histogram's edges); an infinite
    kth (fewer than k survivors) gives 0. F is evaluated in f32 as the
    reference's ``jnp.interp`` does, the rest in float64."""
    if n_lost <= 0:
        return float(delta)
    import torch

    from .histogram import f_of

    if isinstance(kth_dists, torch.Tensor):
        kth_dists = kth_dists.detach().cpu().double().numpy()
    d = np.asarray(kth_dists, np.float64).reshape(-1)
    d = d / (1.0 + float(epsilon))
    finite = np.isfinite(d)
    r = torch.as_tensor(np.where(finite, d, 0.0).astype(np.float32),
                        device=hist.edges.device)
    # F at the shrunk kth radius; an infinite radius -> F = 1 -> 0
    p_hit = np.where(finite, f_of(hist, r).cpu().numpy().astype(np.float64),
                     1.0)
    survival = np.power(np.clip(1.0 - p_hit, 0.0, 1.0), float(n_lost))
    return float(np.clip(float(delta) * survival.min(), 0.0, 1.0))
