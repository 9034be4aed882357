"""Optimizers: AdamW and SGD with momentum, the schedule, clipping.

The port's copy of ``src/repro/train/optimizer.py``. The optimizer state
mirrors the parameters leaf by leaf in the reference's layout: a dict of
dotted reference paths (``blocks.sub0.attn.wq``) to tensors shaped like
the reference's leaves (layer leaves stacked ``[L, ...]``), in its leaf
order. ``params`` is a :class:`~repro_torch.models.model.Model` (its
:meth:`reference_leaves`) or such a dict, and ``grads`` such a dict.

The arithmetic is the reference's, in f32: the schedule and the bias
corrections ``1 - b ** t`` from the step in f32, the global norm summed
leaf by leaf in the reference's leaf order, every update computed in f32
and cast to the parameter's and the state's dtype. The parameters and the
moments are updated in place (no second copy of either); ``apply``
returns the same parameters and a new :class:`OptState` holding the
updated moments.

Across ranks the parameters, the moments and the gradients are DTensors
of the same placements (``launch/sharding``): ``apply`` updates each
rank's local shards in place, and the global norm is taken over the
whole leaves, each rank's shard sums of squares added up by one
all-reduce over the mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.models.sharding_utils import flat_group, is_dtensor

__all__ = ["OptConfig", "OptState", "apply", "global_norm", "init", "local",
           "schedule"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: Any = torch.float32  # bf16 halves optimizer memory


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``: f32 0-d."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0,
                       1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


class OptState(NamedTuple):
    step: torch.Tensor  # int32 0-d
    mu: Dict[str, torch.Tensor]  # first moment, by reference path
    nu: Dict[str, torch.Tensor]  # second moment (zeros for sgdm)


def _leaves(params) -> Dict[str, torch.Tensor]:
    return (params.reference_leaves() if hasattr(params, "reference_leaves")
            else params)


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (its storage), a tensor itself."""
    return t.to_local() if is_dtensor(t) else t


def init(cfg: OptConfig, params) -> OptState:
    """Zero moments shaped (and, across ranks, placed) as the parameters;
    the step a 0-d int32, replicated across ranks."""
    leaves = _leaves(params)
    first = next(iter(leaves.values()))

    def zeros():
        return {k: torch.zeros_like(p, dtype=cfg.state_dtype)
                for k, p in leaves.items()}

    step = torch.zeros((), dtype=torch.int32, device=first.device)
    if is_dtensor(first):
        from torch.distributed.tensor import DTensor, Replicate

        mesh = first.device_mesh
        step = DTensor.from_local(step, mesh, [Replicate()] * mesh.ndim)
    return OptState(step, zeros(), zeros())


def _sq_sums_across_ranks(leaves) -> torch.Tensor:
    """Each leaf's f32 sum of squares over the whole leaf [n], summed by
    one all-reduce: a rank adds its shard's, or 0 where another rank holds
    the same replica (it is not first on every dim the leaf is replicated
    over)."""
    import torch.distributed as dist

    mesh = next(l.device_mesh for l in leaves if is_dtensor(l))
    coord = mesh.get_coordinate()
    parts = []
    for leaf in leaves:
        if is_dtensor(leaf):
            if any(p.is_partial() for p in leaf.placements):
                raise ValueError("global_norm: reduce the gradients to "
                                 "their placements first")
            first = all(c == 0 for c, p in zip(coord, leaf.placements)
                        if p.is_replicate())
        else:
            first = all(c == 0 for c in coord)
        sq = torch.sum(torch.square(local(leaf).float()))
        parts.append(sq if first else torch.zeros_like(sq))
    sums = torch.stack(parts)
    dist.all_reduce(sums, group=flat_group(mesh))
    return sums


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum, leaf after leaf in order, of each leaf's f32 sum
    of squares (a plain 0-d tensor, the same on every rank)."""
    leaves = list(tree.values())
    if any(is_dtensor(l) for l in leaves):
        leaves = list(_sq_sums_across_ranks(leaves).unbind(0))
    else:
        leaves = [torch.sum(torch.square(l.float())) for l in leaves]
    total = 0
    for sq in leaves:
        total = total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply(cfg: OptConfig, params, grads: Dict[str, torch.Tensor],
          state: OptState) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One update of ``params`` (in place) from ``grads``: (params, the
    new state, {lr, grad_norm})."""
    if cfg.name not in ("adamw", "sgdm"):
        raise ValueError(cfg.name)
    leaves = _leaves(params)
    step = state.step + 1
    lr = schedule(cfg, local(step))
    gnorm = global_norm({k: grads[k] for k in leaves})
    if cfg.clip_norm:
        scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                                1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    b1, b2 = cfg.b1, cfg.b2
    t = local(step).float()
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)

    for k, p in leaves.items():
        p = local(p)
        m, v = local(state.mu[k]), local(state.nu[k])
        gf = local(grads[k]).float() * scale
        pf = p.float()
        if cfg.name == "adamw":
            m1 = b1 * m.float() + (1 - b1) * gf
            v1 = ((1 - b2) * gf).mul_(gf).add_(b2 * v.float())
            del gf
            delta = (m1 / bc1).div_(torch.sqrt(v1 / bc2).add_(cfg.eps))
            if cfg.weight_decay:
                delta.add_(cfg.weight_decay * pf)
            delta.mul_(lr)
            v.copy_(v1)
            del v1
        else:
            m1 = b1 * m.float() + gf
            del gf
            delta = m1 * lr
        m.copy_(m1)
        del m1
        p.copy_(pf - delta)
        del delta
    return params, OptState(step, state.mu, state.nu), {"lr": lr,
                                                         "grad_norm": gnorm}
