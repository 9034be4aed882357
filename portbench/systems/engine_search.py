"""The system under test of the search cells: the port's
``repro_torch.core.engine.DistributedEngine``, built resident over a
collection the benchmark makes on the card, and queried through
``DistributedEngine.query``, the entry the serving front and the mesh
mode call.

The configuration names the collection's law and size, the index and
its build parameters, the shards and whether a query shares its gathers
across lanes; the traffic names k, the guarantee and visit_batch.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from portbench.bench import seeds
from portbench.frozen import queries as query_law
from portbench.frozen import randomwalk


class Answer(NamedTuple):
    dists: torch.Tensor        # [B, k] on the device
    ids: torch.Tensor          # [B, k] on the device
    iterations: int            # refinement iterations, summed over shards
    rows_scanned: torch.Tensor  # [B] on the device, summed over shards


class EngineSearch:
    def __init__(self, cfg: dict, traffic: dict, seed: int, world):
        from repro_torch.core.engine import DistributedEngine
        from repro_torch.core.guarantees import Guarantee
        from repro_torch.core.spec import IndexSpec

        dev = world.device
        self.device = dev
        t = time.perf_counter()
        col = cfg["collection"]
        if col["law"] != "random_walk":
            raise ValueError(f"unknown collection law {col['law']!r}")
        self.collection = randomwalk.generate(
            col["n_series"], col["series_len"],
            seeds.stream(seed, seeds.COLLECTION, dev))
        self.scale = query_law.collection_std(self.collection)
        self.timings = {"collection_s": time.perf_counter() - t}
        t = time.perf_counter()
        host = self.collection.cpu().numpy()  # the build takes host rows
        self.timings["to_host_s"] = time.perf_counter() - t
        t = time.perf_counter()
        ix = dict(cfg["index"])
        method = ix.pop("method")
        mesh = None
        if world.size > 1:
            from repro_torch.launch.mesh import make_mesh

            mesh = make_mesh((world.size,), ("data",), dev)
        self.engine = DistributedEngine(
            shards=cfg["store"]["shards"], method=method, device=dev,
            mesh=mesh).build(host, index=IndexSpec(method, **ix))
        del host
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.timings["build_s"] = time.perf_counter() - t
        g = traffic["guarantee"]
        self.k = traffic["k"]
        self.g = Guarantee(delta=g.get("delta", 1.0),
                           epsilon=g.get("epsilon", 0.0),
                           nprobe=g.get("nprobe"))
        self.visit_batch = traffic["visit_batch"]
        self.share = cfg["search"]["share_gathers"]
        shards = self.engine.resident  # this process's shards
        self.facts = {"leaves": sum(sh.num_leaves for sh in shards),
                      "box_dims": int(shards[0].box_lo.shape[1]),
                      "series_len": col["series_len"], "k": self.k,
                      "bytes_per_value": 4}

    def query(self, q: torch.Tensor) -> Answer:
        r = self.engine.query(q, self.k, self.g, visit_batch=self.visit_batch,
                              share_gathers=self.share)
        return Answer(r.dists, r.ids, sum(r.iterations), r.rows_scanned)

    def counters(self) -> dict:
        """The kernel wrappers' launch counts."""
        from repro_torch.kernels import ops

        return {name: getattr(ops, name).launches
                for name in ("box_mindist", "coop_score_select",
                             "lex_select")}

    def close(self) -> None:
        """Free the program's state; the collection stays for the
        reference."""
        self.engine.close()
        self.engine = None


def setup(cfg: dict, traffic: dict, seed: int, world) -> EngineSearch:
    return EngineSearch(cfg, traffic, seed, world)
