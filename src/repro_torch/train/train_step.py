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
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_mod

from . import compress as compress_mod
from . import optimizer as opt_mod

__all__ = ["build_train_step", "loss_and_grads"]


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


def build_train_step(cfg: ModelConfig, opt_cfg: opt_mod.OptConfig, *,
                     grad_accum: int = 1,
                     compression: bool = False) -> Callable:
    """train_step(params, opt_state, batch[, error_state]) -> (params,
    opt_state[, error_state], metrics); the parameters and the moments
    are updated in place."""

    def single(params, batch):
        _, metrics, grads = loss_and_grads(params, batch, cfg)
        return metrics, grads

    def accumulated(params, batch):
        for name, x in batch.items():
            if x.shape[0] % grad_accum:
                raise ValueError(f"batch {name} of {x.shape[0]} rows does "
                                 f"not split into {grad_accum} microbatches")
        acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.reference_leaves().items()}
        metrics = None
        for i in range(grad_accum):
            micro = {name: x.reshape((grad_accum, x.shape[0] // grad_accum)
                                     + x.shape[1:])[i]
                     for name, x in batch.items()}
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
