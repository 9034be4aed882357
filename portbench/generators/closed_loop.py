"""A closed loop of one client: it draws a batch of noisy queries
(``frozen/queries.py``), sends it, waits until the batch's ids and
distances are on the host, and sends the next.

The traffic file gives ``batch``, ``warm_batches`` and
``queries.levels``; a batch is timed from its send, once its queries are
on the device, to its answer on the host.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, NamedTuple

import torch

from portbench.bench import seeds
from portbench.frozen.queries import NoisyQueries


class Batch(NamedTuple):
    sent: float                 # host clock, s
    done: float
    queries: torch.Tensor       # [B, n] on the device
    dists: torch.Tensor         # [B, k] on the host
    ids: torch.Tensor           # [B, k] on the host
    iterations: int
    rows_scanned: torch.Tensor  # [B] on the device, read after the window


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Loop:
    def __init__(self, system, traffic: dict, seed: int, world):
        self.system, self.world = system, world
        self.batch = traffic["batch"]
        self.warm_batches = traffic["warm_batches"]
        levels = traffic["queries"]["levels"]
        dev = system.device
        self.timed = NoisyQueries(system.collection, levels,
                                  seeds.stream(seed, seeds.QUERIES, dev),
                                  system.scale)
        self.warmup = NoisyQueries(system.collection, levels,
                                   seeds.stream(seed, seeds.WARMUP, dev),
                                   system.scale)

    def _one(self, src: NoisyQueries, mark=None) -> Batch:
        dev = self.system.device
        q = src.next(self.batch)
        _sync(dev)
        span = mark or (lambda name: contextlib.nullcontext())
        with span("batch"):
            sent = time.perf_counter()
            with span("entry"):
                a = self.system.query(q)
            d, i = a.dists.cpu(), a.ids.cpu()
            done = time.perf_counter()
        return Batch(sent, done, q, d, i, a.iterations, a.rows_scanned)

    def warm(self) -> None:
        """The cell's shapes, once each batch: kernels built or loaded,
        the allocator grown."""
        for _ in range(self.warm_batches):
            self._one(self.warmup)

    def run(self, seconds: float, min_batches: int = 1,
            mark=None) -> List[Batch]:
        """Batches until ``seconds`` have passed since the first was sent
        (and at least ``min_batches``); ``mark(name)`` gives the
        profiler's annotation around each batch (``"batch"``: from its
        send to its answer on the host) and around the system's entry
        inside it (``"entry"``)."""
        out: List[Batch] = []
        while True:
            out.append(self._one(self.timed, mark))
            go = (out[-1].done - out[0].sent < seconds
                  or len(out) < min_batches)
            if not self.world.agree(go):
                return out
