"""The training entry point: ``fit`` on one card.

The port's copy of ``src/repro/launch/train.py`` without its mesh (the
multi-GPU slice): the stateless token pipeline -> the train step ->
the :class:`~repro_torch.train.fault.Supervisor` (checkpoints, restarts,
stragglers). ``examples/train_embedder.py``'s flow runs through it. The
model is drawn from ``seed`` on ``device``, the card unless the caller
asks for the CPU. An encoder-decoder's frames [B, F, d_model] come from
a generator seeded with ``seed + 1`` folded with the step. Without a
``ckpt_dir`` the supervisor checkpoints into a temporary directory that
is removed when the run ends.
"""

from __future__ import annotations

import shutil
import tempfile
from typing import Any, Dict, Optional

import torch

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.data import tokens as tokens_mod
from repro_torch.models.model import Model
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.fault import FaultInjector, Supervisor
from repro_torch.train.train_step import build_train_step

__all__ = ["fit"]


def fit(cfg: ModelConfig, *, steps: int = 100, batch: int = 8,
        seq: int = 128, seed: int = 0,
        opt_cfg: Optional[opt_mod.OptConfig] = None,
        ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
        grad_accum: int = 1, resume: bool = True,
        injector: Optional[FaultInjector] = None, log_every: int = 10,
        device=device_mod.DEFAULT) -> Dict[str, Any]:
    """Train for ``steps`` steps (resuming from the latest checkpoint in
    ``ckpt_dir`` when ``resume``): the supervisor's result (params,
    opt_state, losses, restarts, stragglers, final_step)."""
    dev = device_mod.resolve(device)
    opt_cfg = opt_cfg or opt_mod.OptConfig(
        lr=1e-3, warmup_steps=min(20, steps // 5 + 1), total_steps=steps)
    params = Model.init(cfg, seed, dev)
    opt_state = opt_mod.init(opt_cfg, params)
    step_fn = build_train_step(cfg, opt_cfg, grad_accum=grad_accum)

    def make_batch(step: int):
        b = {k: v.to(dev) for k, v in tokens_mod.batch_at_step(
            seed, step, batch, seq, cfg.vocab_size).items()}
        if cfg.is_encdec:
            g = torch.Generator(device=dev).manual_seed(
                tokens_mod.stream_seed(seed + 1, step))
            b["frames"] = torch.randn(
                (batch, cfg.encoder_frames, cfg.d_model), generator=g,
                device=dev, dtype=cfg.compute_dtype)
        return b

    start_step = 0
    scratch = None
    if ckpt_dir:
        ckpt = Checkpointer(ckpt_dir)
        latest = ckpt.latest_step() if resume else None
        if latest is not None:
            ckpt.restore({"params": params, "opt_state": opt_state}, latest)
            start_step = latest
    else:
        scratch = tempfile.mkdtemp(prefix=f"hydra_torch_ckpt_{seed}_")
        ckpt = Checkpointer(scratch)
    sup = Supervisor(train_step=step_fn, make_batch=make_batch, ckpt=ckpt,
                     ckpt_every=ckpt_every, injector=injector)
    try:
        return sup.run(params, opt_state, start_step, steps - start_step,
                       log_every=log_every)
    finally:
        if scratch is not None:
            ckpt.wait()
            shutil.rmtree(scratch, ignore_errors=True)
