"""The ranks a cell runs on: one process, or one process a card brought
up by ``bench/launch.py`` through the port's ``launch/mesh.init_world``.
Rank 0 decides and the others follow, so every rank calls the system
with the same arguments."""

from __future__ import annotations

import torch


class World:
    def __init__(self, device, rank: int = 0, size: int = 1):
        self.device = torch.device(device)
        self.rank, self.size = rank, size

    def _tensor(self, v: float) -> torch.Tensor:
        dev = self.device if self.device.type == "cuda" else "cpu"
        return torch.tensor([float(v)], dtype=torch.float64, device=dev)

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank."""
        if self.size == 1:
            return flag
        import torch.distributed as dist

        t = self._tensor(1.0 if flag else 0.0)
        dist.broadcast(t, src=0)
        return bool(t.item())

    def reduce(self, v: float, op: str) -> float:
        """``max`` or ``mean`` of ``v`` over the ranks, on every rank."""
        if self.size == 1:
            return v
        import torch.distributed as dist

        t = self._tensor(v)
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM)
        return float(t.item()) / (1 if op == "max" else self.size)
