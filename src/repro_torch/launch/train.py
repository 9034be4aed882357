"""The training entry point: ``fit`` on one card or across ranks.

The port's copy of ``src/repro/launch/train.py``: the stateless token
pipeline -> the train step -> the
:class:`~repro_torch.train.fault.Supervisor` (checkpoints, restarts,
stragglers). ``examples/train_embedder.py``'s flow runs through it. The
model is drawn from ``seed`` on ``device``, the card unless the caller
asks for the CPU. An encoder-decoder's frames [B, F, d_model] come row
by row from generators seeded with ``seed + 1`` folded with the step and
the row. Without a ``ckpt_dir`` the supervisor checkpoints into a
temporary directory that is removed when the run ends (on a mesh rank
0's, which every rank reads).

With a ``mesh`` (``launch/mesh.make_mesh``: NCCL on the card, gloo on the
CPU) every rank calls ``fit`` with the same arguments. The parameters
are drawn from ``seed`` exactly as on one card, then laid out by the
mesh's rules (``launch/sharding.param_shardings``), the moments as their
parameters; each rank draws only its rows of the global batch, which
enter as a DTensor sharded over the data axes, and the step runs under
the ambient mesh (``sharding_utils.use_mesh``). Every rank resumes and
replays from rank 0's latest checkpoint, so a ``ckpt_dir`` must be one
that every rank sees. Nothing drops to one rank or to the CPU on its
own.
"""

from __future__ import annotations

import shutil
import tempfile
from typing import Any, Dict, Optional

import torch

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.data import tokens as tokens_mod
from repro_torch.launch import sharding as shard_mod
from repro_torch.models.model import Model
from repro_torch.models.params import mesh_axis_sizes
from repro_torch.models.sharding_utils import use_mesh
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.fault import FaultInjector, Supervisor
from repro_torch.train.train_step import build_train_step

__all__ = ["batch_rows", "fit"]


def batch_rows(mesh, batch: int):
    """(row_start, row_count) of this rank's rows of a global batch of
    ``batch`` rows, and the batch's placements: Shard(0) over the data
    axes of more than one rank (the first the major), replicated over the
    others."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    sizes = mesh_axis_sizes(mesh)
    groups, index = 1, 0
    for name, c in zip(names, coord):
        if name in shard_mod.DATA_AXES:
            groups, index = groups * sizes[name], index * sizes[name] + c
    if batch % groups:
        raise ValueError(f"a batch of {batch} rows does not split over "
                         f"{groups} data-parallel ranks")
    rows = batch // groups
    placements = tuple(Shard(0) if n in shard_mod.DATA_AXES and sizes[n] > 1
                       else Replicate() for n in names)
    return index * rows, rows, placements


def fit(cfg: ModelConfig, *, steps: int = 100, batch: int = 8,
        seq: int = 128, seed: int = 0,
        opt_cfg: Optional[opt_mod.OptConfig] = None, mesh=None,
        ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
        grad_accum: int = 1, resume: bool = True,
        injector: Optional[FaultInjector] = None, log_every: int = 10,
        device=device_mod.DEFAULT) -> Dict[str, Any]:
    """Train for ``steps`` steps (resuming from the latest checkpoint in
    ``ckpt_dir`` when ``resume``): the supervisor's result (params,
    opt_state, losses, restarts, stragglers, final_step). On a ``mesh``
    the parameters and the moments in it are DTensors."""
    dev = device_mod.resolve(device)
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot train on "
                         f"{dev.type}")
    opt_cfg = opt_cfg or opt_mod.OptConfig(
        lr=1e-3, warmup_steps=min(20, steps // 5 + 1), total_steps=steps)
    params = Model.init(cfg, seed, dev)
    row_start, rows, placements = 0, batch, None
    if mesh is not None:
        rules = shard_mod.mesh_rules(mesh)
        shard_mod.distribute_params(
            params, mesh, shard_mod.param_shardings(cfg, mesh, rules))
        row_start, rows, placements = batch_rows(mesh, batch)
    # the moments take their parameters' placements (opt_shardings)
    opt_state = opt_mod.init(opt_cfg, params)
    step_fn = build_train_step(cfg, opt_cfg, grad_accum=grad_accum)

    def make_batch(step: int):
        b = tokens_mod.batch_at_step(seed, step, batch, seq, cfg.vocab_size,
                                     row_start=row_start, row_count=rows)
        b = {k: v.to(dev) for k, v in b.items()}
        if cfg.is_encdec:
            frames = []
            for r in range(row_start, row_start + rows):
                g = torch.Generator(device=dev).manual_seed(
                    tokens_mod.stream_seed(seed + 1, step, r))
                frames.append(torch.randn(
                    (cfg.encoder_frames, cfg.d_model), generator=g,
                    device=dev, dtype=cfg.compute_dtype))
            b["frames"] = torch.stack(frames)
        if placements is not None:
            from torch.distributed.tensor import DTensor

            b = {k: DTensor.from_local(v, mesh, placements, run_check=False)
                 for k, v in b.items()}
        return b

    start_step = 0
    scratch = None
    if ckpt_dir:
        ckpt = Checkpointer(ckpt_dir)
        latest = (ckpt.latest_step(across=mesh is not None) if resume
                  else None)
        if latest is not None:
            ckpt.restore({"params": params, "opt_state": opt_state}, latest)
            start_step = latest
    else:
        scratch = _scratch_dir(seed, mesh)
        ckpt = Checkpointer(scratch)
    sup = Supervisor(train_step=step_fn, make_batch=make_batch, ckpt=ckpt,
                     ckpt_every=ckpt_every, injector=injector)
    try:
        with use_mesh(mesh):
            return sup.run(params, opt_state, start_step,
                           steps - start_step, log_every=log_every)
    finally:
        if scratch is not None:
            ckpt.wait()
            # a rank past its last step is past every rank's reads: each
            # restore precedes collectives of the step it replays
            if mesh is None or mesh.get_rank() == 0:
                shutil.rmtree(scratch, ignore_errors=True)


def _scratch_dir(seed: int, mesh) -> str:
    """A temporary checkpoint directory; on a mesh rank 0's, its path
    broadcast, so that every rank restores what rank 0 saved."""
    path = None
    if mesh is None or mesh.get_rank() == 0:
        path = tempfile.mkdtemp(prefix=f"hydra_torch_ckpt_{seed}_")
    if mesh is None:
        return path
    import torch.distributed as dist

    box = [path]
    dist.broadcast_object_list(box, src=0)
    return box[0]
