"""A rank's place among the shards of a mesh engine (core/engine.py).

torch runs one process per card, a rank; a DeviceMesh (launch/mesh.py)
lays the world's ranks out row-major over named axes. The engine shards
its collection over some of those axes: :func:`shard_layout` gives this
rank's shard and the process group it merges over, the ranks that share
its coordinates off the shard axes (one per shard).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import device as device_mod


def rank_device(device) -> torch.device:
    """The device of this rank: the CPU, or the card set for it when its
    world came up (launch/mesh.init_world)."""
    dev = device_mod.resolve(device)
    if dev.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class ShardLayout(NamedTuple):
    """This rank's place among the shards of a mesh.

    group: the ranks that share this rank's coordinates off the shard
    axes (one per shard), as a process group. index: this rank's shard,
    its coordinates along the shard axes flattened row-major in the
    order the axes are named (the order of the reference's ``P(axes)``).
    shard_of: for each rank of ``group`` in group order, its shard.
    writer: whether every coordinate off the shard axes is 0 (the one
    copy of each shard that writes it to disk)."""
    group: object
    index: int
    count: int
    shard_of: Tuple[int, ...]
    writer: bool


def shard_layout(mesh, axes: Tuple[str, ...]) -> ShardLayout:
    """The :class:`ShardLayout` of this rank for shards over ``axes`` of
    ``mesh``. Every rank makes every group (``dist.new_group``), in the
    same order, so each rank must call it, once per engine."""
    names = tuple(mesh.mesh_dim_names)
    missing = [a for a in axes if a not in names]
    if missing:
        raise ValueError(f"axes {missing} are not in the mesh's {names}")
    shard = [names.index(a) for a in axes]
    other = [i for i in range(len(names)) if i not in shard]
    ranks = np.asarray(mesh.mesh.cpu()).transpose(other + shard)
    count = math.prod(int(mesh.mesh.shape[i]) for i in shard)
    rows = ranks.reshape(-1, count)  # one row per shard group
    me = dist.get_rank()
    mine = None
    for ri, row in enumerate(rows):
        members = [int(r) for r in row]
        g = dist.new_group(members)
        if me in members:
            mine = (ri, members, g)
    ri, members, g = mine
    shard_of = tuple(members.index(dist.get_global_rank(g, i))
                     for i in range(len(members)))
    return ShardLayout(group=g, index=members.index(me), count=count,
                       shard_of=shard_of, writer=ri == 0)
