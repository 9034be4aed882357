"""The sharded search engine across ranks: the port of
``examples/distributed_search.py``.

The collection is range-sharded over the mesh's ``data`` axis, one shard
a rank; each rank runs the batched Algorithm 2 over its shard, and the
per-shard top-k rows are merged after one all_gather, so exact answers
match brute force and the guarantees carry over (core/engine.py).

    # world 1 on the card
    PYTHONPATH=src python -m repro_torch.launch.distributed_search
    # W ranks, one card each, W // model shards
    PYTHONPATH=src torchrun --nproc-per-node=W \\
        -m repro_torch.launch.distributed_search --model 2
    # on the CPU (gloo)
    PYTHONPATH=src python -m repro_torch.launch.distributed_search \\
        --device cpu --backend gloo
"""

from __future__ import annotations

import argparse

import torch
import torch.distributed as dist

from repro_torch.core import guarantees as G
from repro_torch.core import search as S
from repro_torch.core.engine import DistributedEngine
from repro_torch.core.metrics import workload_metrics
from repro_torch.core.spec import IndexSpec
from repro_torch.data import queries, randomwalk
from repro_torch.launch import mesh as mesh_mod


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None,
                    help="nccl for cuda, gloo for cpu: the device chooses it, "
                         "the flag is checked against that")
    ap.add_argument("--model", type=int, default=1,
                    help="ranks along the mesh's model axis")
    ap.add_argument("--n-series", type=int, default=16384)
    ap.add_argument("--series-len", type=int, default=128)
    ap.add_argument("--leaf-cap", type=int, default=128)
    args = ap.parse_args(argv)
    k = 10
    want = mesh_mod.BACKENDS[torch.device(args.device).type]
    if args.backend not in (None, want):
        ap.error(f"a world on {args.device} runs {want}, not {args.backend}")

    up = dist.is_initialized()
    dev = mesh_mod.init_world(args.device)
    try:
        world = dist.get_world_size()
        if world % args.model:
            raise ValueError(f"--model {args.model} does not divide the "
                             f"world of {world}")
        mesh = mesh_mod.make_test_mesh((world // args.model, args.model),
                                       ("data", "model"), device=dev.type)
        lead = dist.get_rank() == 0
        say = print if lead else (lambda *a, **kw: None)
        say(f"ranks: {world}, mesh {mesh_mod.mesh_axis_sizes(mesh)} on "
            f"{dev.type} ({dist.get_backend()})")
        data = randomwalk.generate(5, args.n_series, args.series_len)
        q = queries.noisy_queries(data, 8)
        truth = S.brute_force(q, data, k, device=dev)

        eng = DistributedEngine(mesh=mesh, axes=("data",), device=dev)
        say(f"building dstree over {eng.n_shards} shards ...")
        eng.build(data, index=IndexSpec("dstree", leaf_cap=args.leaf_cap))
        for name, g in [("exact", G.exact()), ("eps=1", G.epsilon(1.0)),
                        ("ng(4)", G.ng(4))]:
            res = eng.query(q, k, g)
            m = workload_metrics(res.ids, res.dists, truth.ids, truth.dists)
            say(f"{name:8s} MAP={m['map']:.3f} "
                f"recall={m['avg_recall']:.3f} mre={m['mre']:.4f} "
                f"leaves(sum-shards)={int(res.leaves_visited[0])}")
        res = eng.query(q, k, G.exact())
        m = workload_metrics(res.ids, res.dists, truth.ids, truth.dists)
        assert m["map"] == 1.0, m
        say("ok — sharded exact search matches the single-node brute force")
    finally:
        if not up:
            mesh_mod.destroy_world()


if __name__ == "__main__":
    main()
