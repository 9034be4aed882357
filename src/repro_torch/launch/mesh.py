"""Device meshes and the process group under them: the port of
``src/repro/launch/mesh.py`` over ``torch.distributed``.

jax sees every device of a host from one process; torch runs one process
per card, a rank, and the ranks of a job form one process group.
:func:`init_world` brings that group up (NCCL for the card, gloo for the
CPU); the mesh functions lay the world's ranks out row-major over named
axes with ``init_device_mesh``, as ``jax.make_mesh`` lays out devices.
Single pod: 16 x 16 = 256 ranks (data, model). Two pods: 2 x 16 x 16 =
512 (pod, data, model). Which shard a rank owns on a mesh engine is the
engine's own (core/ranks.py). The dry run lays those meshes over a dry
world (:func:`init_dry_world`): torch's ``fake`` backend, every rank of
it but rank 0 imagined, in one process.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import device as device_mod
from repro_torch.core.ranks import rank_device
# the reference's name for it here; the model layer owns it
from repro_torch.models.params import mesh_axis_sizes

__all__ = ["BACKENDS", "data_axes", "destroy_world", "init_dry_world",
           "init_world", "make_mesh", "make_production_mesh",
           "make_test_mesh", "mesh_axis_sizes"]

# the backend that drives each device type's world
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_world(device=device_mod.DEFAULT, *,
               store: Optional[dist.Store] = None, rank: Optional[int] = None,
               world_size: Optional[int] = None) -> torch.device:
    """Bring up this process's world and return its rank's device.

    The world comes from, in order: an explicit ``store`` with ``rank``
    and ``world_size``; torchrun's variables (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``); else a world of
    one. NCCL runs it for a CUDA ``device`` (after
    ``torch.cuda.set_device(LOCAL_RANK)``), gloo for the CPU. A CUDA
    device without a card raises: the world never moves to gloo or the
    CPU on its own. With a world already up, checks that it runs the
    device's backend."""
    dev = device_mod.resolve(device)
    backend = BACKENDS[dev.type]
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise RuntimeError(f"the world runs {have}; {dev.type} needs "
                               f"{backend}")
        return rank_device(dev)
    env = os.environ
    kw = {}
    if store is not None:
        if rank is None or world_size is None:
            raise ValueError("init_world: a store needs rank and world_size")
        kw = dict(store=store, rank=rank, world_size=world_size)
        local = rank
    elif "RANK" in env and "WORLD_SIZE" in env:
        kw = dict(init_method="env://", rank=int(env["RANK"]),
                  world_size=int(env["WORLD_SIZE"]))
        local = int(env.get("LOCAL_RANK", env["RANK"]))
    else:
        kw = dict(store=dist.HashStore(), rank=0, world_size=1)
        local = 0
    if dev.type == "cuda":
        torch.cuda.set_device(local % torch.cuda.device_count())
        kw["device_id"] = rank_device(dev)
    dist.init_process_group(backend, **kw)
    return rank_device(dev)


def init_dry_world(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    """A dry world: ``prod(shape)`` ranks of torch's ``fake`` backend, of
    which this process is rank 0, and a CPU mesh of ``shape`` over named
    ``axes`` on it. Its collectives move nothing and return their outputs
    as they are, so a run on ``meta`` tensors over it issues every
    collective a real world would, at rank 0's shapes: what the dry run
    (``launch/dryrun.py``) counts. Only asked for by name, never reached
    from :func:`init_world`; raises if a world is up.
    :func:`destroy_world` tears it down."""
    if dist.is_initialized():
        raise RuntimeError("a dry world needs this process free of any "
                           "other world")
    # registers the fake backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def destroy_world() -> None:
    """Tear the world down (idempotent)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device=device_mod.DEFAULT):
    """A DeviceMesh of ``shape`` over named ``axes``, the world's ranks
    laid out row-major; brings the world up first if it is not. Raises,
    as ``jax.make_mesh`` does, when the world has another size."""
    dev = init_world(device)
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; "
                         f"the world has {world}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device=device_mod.DEFAULT, dry: bool = False):
    """The production mesh over the world's ranks; with ``dry`` over a
    dry world of its 256 or 512 ranks (:func:`init_dry_world`), whatever
    ``device`` says."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if dry:
        return init_dry_world(shape, axes)
    return make_mesh(shape, axes, device)


def make_test_mesh(shape: Tuple[int, ...] = (4, 2),
                   axes: Tuple[str, ...] = ("data", "model"),
                   device=device_mod.DEFAULT):
    """A small mesh, for tests on a world of ``prod(shape)`` ranks."""
    return make_mesh(shape, axes, device)


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
