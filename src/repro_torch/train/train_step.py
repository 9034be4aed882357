"""The train step: loss -> gradients -> (compression) -> update.

The port's copy of ``src/repro/train/train_step.py``.
:func:`loss_and_grads` runs autograd over ``model.loss_fn`` and returns
the gradients in the reference's layout: a dict of dotted reference paths
to tensors shaped like its leaves (a layer leaf's [L, ...] whole), each
in its parameter's dtype, as jax's are. A parameter
that the loss does not use (an encoder-decoder's top-level
``final_norm``) gets zeros, as jax gives it: it still enters the global
norm, the moments' decay and the weight decay.

``build_train_step`` returns ``train_step(params, opt_state, batch[,
error_state])``. With ``grad_accum = A > 1`` the batch is split into A
microbatches along its first axis; their gradients are summed in f32,
divided by A and stay f32, and the metrics are the last microbatch's.

Across ranks (the parameters DTensors laid out by ``launch/sharding``,
the batch a DTensor sharded over the data axes, the step run inside
``sharding_utils.use_mesh``) the forward and the backward run on
DTensors: the loss is the global batch's, normalised by its global token
count. Every gradient is then reduced to its parameter's placements
(:func:`reduce_to`), so that the optimizer updates each rank's shards,
and the metrics come back as plain tensors, the same on every rank.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_mod
from repro_torch.models.sharding_utils import (constrain, flat_group,
                                               is_dtensor)

from . import compress as compress_mod
from . import optimizer as opt_mod

__all__ = ["build_train_step", "loss_and_grads", "reduce_to"]


@contextlib.contextmanager
def _requiring_grad(params):
    for p in params:
        p.requires_grad_(True)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(False)


def loss_and_grads(params: model_mod.Model, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                              Dict[str, torch.Tensor]]:
    """(loss, metrics, grads) of ``loss_fn`` at ``params``; the loss and
    the metrics detached, the grads by reference path."""
    leaves = params.reference_leaves()
    with _requiring_grad(leaves.values()), torch.enable_grad():
        loss, metrics = model_mod.loss_fn(params, batch, cfg)
        got = torch.autograd.grad(loss, list(leaves.values()),
                                  allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(leaves.items(), got)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def reduce_to(g: torch.Tensor, placements) -> torch.Tensor:
    """A DTensor gradient (partial sums) reduced to ``placements`` (its
    parameter's): the partial sums over a dim the parameter is sharded on
    are
    reduce-scattered, those over a dim it is replicated on all-reduced;
    where it is replicated on several such dims one all-reduce runs over
    them all at once (``sharding_utils.flat_group``), so that every replica holds
    the same bits."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    mesh = g.device_mesh
    names = mesh.mesh_dim_names
    joint = [i for i, (have, want) in enumerate(zip(g.placements,
                                                    placements))
             if have.is_partial() and want.is_replicate()]
    if len(joint) > 1:
        loc = g.to_local().clone()
        dist.all_reduce(loc, group=flat_group(mesh, tuple(names[i]
                                                          for i in joint)))
        pl = [Replicate() if i in joint else p
              for i, p in enumerate(g.placements)]
        g = DTensor.from_local(loc, mesh, pl, run_check=False,
                               shape=g.shape, stride=g.stride())
    if tuple(g.placements) != tuple(placements):
        g = g.redistribute(mesh, placements)
    return g


def _reduced(grads, leaves):
    """Every DTensor gradient at its parameter's placements."""
    return {k: reduce_to(g, leaves[k].placements) if is_dtensor(g) else g
            for k, g in grads.items()}


def _plain(metrics):
    """Metrics as plain tensors, whole on every rank."""
    return {k: v.full_tensor() if is_dtensor(v) else v
            for k, v in metrics.items()}


def build_train_step(cfg: ModelConfig, opt_cfg: opt_mod.OptConfig, *,
                     grad_accum: int = 1,
                     compression: bool = False) -> Callable:
    """train_step(params, opt_state, batch[, error_state]) -> (params,
    opt_state[, error_state], metrics); the parameters and the moments
    are updated in place."""

    def single(params, batch):
        _, metrics, grads = loss_and_grads(params, batch, cfg)
        return _plain(metrics), _reduced(grads, params.reference_leaves())

    def accumulated(params, batch):
        for name, x in batch.items():
            if x.shape[0] % grad_accum:
                raise ValueError(f"batch {name} of {x.shape[0]} rows does "
                                 f"not split into {grad_accum} microbatches")
        acc = {k: torch.zeros_like(p, dtype=torch.float32)
               for k, p in params.reference_leaves().items()}
        metrics = None
        # on a mesh a microbatch is a run of the global batch's rows, as
        # on one card: the batch is gathered, and each microbatch sharded
        # over the data axes again (no-ops without a mesh)
        whole = {name: constrain(x, *(None,) * x.ndim)
                 for name, x in batch.items()}
        for i in range(grad_accum):
            micro = {name: constrain(
                x.reshape((grad_accum, x.shape[0] // grad_accum)
                          + x.shape[1:])[i], "batch", *(None,) * (x.ndim - 1))
                for name, x in whole.items()}
            metrics, grads = single(params, micro)
            for k, g in grads.items():
                acc[k].add_(g)
            del grads
        return metrics, {k: g.div_(grad_accum) for k, g in acc.items()}

    def train_step(params, opt_state, batch, error_state=None):
        if grad_accum > 1:
            metrics, grads = accumulated(params, batch)
        else:
            metrics, grads = single(params, batch)
        if compression:
            if error_state is None:
                raise ValueError("a compressed step needs its error state")
            grads, error_state = compress_mod.ef_quantize(grads, error_state)
        params, opt_state, opt_metrics = opt_mod.apply(opt_cfg, params, grads,
                                                       opt_state)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        if compression:
            return params, opt_state, error_state, metrics
        return params, opt_state, metrics

    return train_step
