"""Dry run of the paper's own technique: the sharded engine's query, its
roofline terms and, on the card, its measurement, on one H100 or on the
production meshes of 256 and 512 ranks.

The port's counterpart of ``src/repro/launch/dryrun_search.py``. The
configuration mirrors the paper's disk-scale setting: 2M series x 256 f32
a shard, leaf_cap 512, batched 256 queries, k = 100, nprobe 128 leaves
visited, visit_batch 8. On a mesh every axis holds a shard, as in the
reference: 256 shards x 2M = 512M series on one pod, 512 x 2M = 1.02B on
two (the Deep1B/Sift1B regime).

The search loop depends on the data (when each lane stops, which leaves
it visits), so it cannot run on ``meta``: the abstract half of
:func:`lower_search` is the reference's compile-only half (the analytic
FLOP and byte terms, and the memory of one shard's abstract index), and
given a real index and queries on the card it also runs ``search_impl``
under ``roofline.profile_device`` and adds the measurement. On a mesh
(a dry world, ``launch/mesh.make_production_mesh(dry=True)``) the
collectives are the engine's own: its resident merge
(``core/engine._gather_results`` over ``core/ranks.shard_layout``'s
group), run on the cell's [batch, k] answers and recorded by
``roofline.CollectiveRecorder``. The engine merges the answers and the
visit counts in one all-gather a query batch, where the reference's
``shard_map`` gathers the distances and the ids and sums three counts.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_search
    PYTHONPATH=src python -m repro_torch.launch.dryrun_search --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun_search --measure
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.histogram import DistanceHistogram
from repro_torch.core.index import FrozenIndex
from repro_torch.core.search import search_impl
from repro_torch.launch import roofline as roof
from repro_torch.launch.dryrun import MESHES
from repro_torch.launch.mesh import destroy_world, make_production_mesh

__all__ = ["abstract_index", "lower_search", "main"]


def abstract_index(n_per_shard: int, series_len: int, leaf_cap: int,
                   summary: str = "eapca") -> Tuple[FrozenIndex, int]:
    """(a ``meta`` FrozenIndex with the reference's field shapes at one
    shard, its leaves): the reference's [shards, ...] fields without
    their shard axis."""
    leaves = n_per_shard // leaf_cap
    dims = {"paa": 16, "eapca": 16, "dft": 16}[summary]

    def f32(shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    def i32(shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    idx = FrozenIndex(
        box_lo=f32((leaves, dims)),
        box_hi=f32((leaves, dims)),
        weights=f32((dims,)),
        offsets=i32((leaves + 1,)),
        data=f32((n_per_shard, series_len)),
        ids=i32((n_per_shard,)),
        hist=DistanceHistogram(edges=f32((513,)), cdf=f32((513,))),
        kind="dstree", summary=summary, n_summary=8,
        max_leaf=leaf_cap, n_total=n_per_shard,
        series_len=series_len,
        row_norms=f32((n_per_shard,)),
    )
    return idx, leaves


def _bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _merge_collectives(mesh, batch: int, k: int) -> list:
    """The engine's resident merge of one query batch on ``mesh``, every
    axis a shard axis, recorded: one rank's (kind, bytes, group, op)."""
    from repro_torch.core.engine import _gather_results
    from repro_torch.core.ranks import shard_layout
    from repro_torch.core.search import SearchResult

    lay = shard_layout(mesh, tuple(mesh.mesh_dim_names))
    # CPU tensors: the merge reads the counts on the host (.tolist())
    res = SearchResult(torch.zeros(batch, k),
                       torch.zeros(batch, k, dtype=torch.int32),
                       torch.zeros(batch, dtype=torch.int32),
                       torch.zeros(batch, dtype=torch.int32), 0, 0)
    with roof.CollectiveRecorder() as rec:
        _gather_results(lay, res, 0.0)
    return rec.records


def lower_search(mesh=None, *, n_per_shard: int = 2_000_000,
                 series_len: int = 256,
                 leaf_cap: int = 512, batch: int = 256, k: int = 100,
                 nprobe: int = 128, visit_batch: int = 8,
                 data_bf16: bool = False, coop: bool = False,
                 index: Optional[FrozenIndex] = None,
                 queries: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """The search cell's roofline report: the reference's analytic terms
    over one shard's abstract index, at ``world`` = the mesh's size with
    a shard a rank (one shard on one card); on a ``mesh`` the engine's
    merge collectives; with ``index`` and ``queries`` (on the card, no
    mesh) the measured keys of ``search_impl(..., nprobe=nprobe,
    visit_batch=visit_batch, share_gathers=coop)`` and what the search did
    (``search``)."""
    if mesh is not None and index is not None:
        raise ValueError("a measurement runs one shard on the card, not "
                         "on a mesh")
    idx, leaves = abstract_index(n_per_shard, series_len, leaf_cap)
    if data_bf16:
        idx = dataclasses.replace(idx, data=torch.empty(
            idx.data.shape, dtype=torch.bfloat16, device="meta"))
    world = 1 if mesh is None else mesh.size()
    shards = world  # every axis holds a shard
    # analytic terms (per shard, data-dependent loop bounded by nprobe)
    visited_rows = nprobe * leaf_cap
    # cooperative batching: measured 25% fewer gathers at exact, and
    # every gathered row is scored by all B lanes (one MXU matmul)
    gather_eff = 0.75 if coop else 1.0
    score_mult = batch if coop else 1.0
    dbytes = 2.0 if data_bf16 else 4.0
    flops_shard = (
        batch * leaves * idx.n_summary * 4.0          # box lb pass
        + gather_eff * batch * visited_rows * series_len * 2.0
        * score_mult                                  # refinement L2
    )
    bytes_shard = (
        leaves * idx.n_summary * 2 * 4.0              # boxes
        + gather_eff * batch * visited_rows * series_len * dbytes
    )
    memory = {
        "argument_bytes": _bytes(
            idx.box_lo, idx.box_hi, idx.weights, idx.offsets, idx.data,
            idx.ids, idx.row_norms, idx.hist.edges, idx.hist.cdf)
        + batch * series_len * 4,
        # dists and ids [B, k], leaves_visited and rows_scanned [B]
        "output_bytes": batch * k * 8 + batch * 8,
        # the loop's working set depends on the data: nothing ran
        "temp_bytes": None,
    }
    measured, search = None, None
    if index is not None:
        last = []

        def step():
            last[:] = [search_impl(index, queries, k, nprobe=nprobe,
                                   visit_batch=visit_batch,
                                   share_gathers=coop)]

        measured = roof.profile_device(step, inputs=(index, queries))
        res = last[0]
        search = {"index_leaves": index.num_leaves,
                  "index_rows": index.data.shape[0],
                  "loop_iterations": res.iterations,
                  "mean_leaves": float(res.leaves_visited.float().mean()),
                  "mean_rows": float(res.rows_scanned.float().mean())}
    colls = None
    if mesh is not None:
        colls = roof.parse_collectives(_merge_collectives(mesh, batch, k),
                                       world)
    rep = roof.roofline_report(
        world=world,
        model_flops_global=flops_shard * shards,
        analytic_flops_global=flops_shard * shards,
        analytic_bytes_global=bytes_shard * shards,
        memory=memory, measured=measured, collectives=colls,
        steps_hint=f"search nprobe={nprobe} vb={visit_batch} "
                   f"chips/shard={world / shards:.0f}",
    )
    rep.update({
        "arch": "search-engine", "shape": f"scan_n{n_per_shard}",
        "status": "ok",
        "mesh": [world] if mesh is None else [int(n) for n in
                                             mesh.mesh.shape],
        "mesh_axes": [] if mesh is None else list(mesh.mesh_dim_names),
        "n_total_series": n_per_shard * shards,
    })
    if search is not None:
        rep["search"] = search
    return rep


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--n-per-shard", type=int, default=2_000_000)
    ap.add_argument("--nprobe", type=int, default=128)
    ap.add_argument("--bf16-data", action="store_true")
    ap.add_argument("--coop", action="store_true")
    ap.add_argument("--tag", default="scan")
    ap.add_argument("--measure", action="store_true",
                    help="build a DSTree over the random walks on the "
                         "card and measure the search (needs a card)")
    ap.add_argument("--mesh", default="h100",
                    choices=["h100", "single", "multi", "both"],
                    help="one H100, or the 16 x 16 / 2 x 16 x 16 dry "
                         "meshes")
    args = ap.parse_args(argv)
    if args.measure and args.bf16_data:
        ap.error("--measure searches the f32 collection")
    if args.measure and args.mesh != "h100":
        ap.error("--measure runs on one card")
    kw = dict(n_per_shard=args.n_per_shard, nprobe=args.nprobe,
              data_bf16=args.bf16_data, coop=args.coop)
    if args.measure:
        from repro_torch.core.indexes import dstree
        from repro_torch.data import queries, randomwalk

        data = randomwalk.generate(seed=11, n_series=args.n_per_shard,
                                   series_len=256)
        kw["index"] = dstree.build(data, leaf_cap=512, device="cuda")
        kw["queries"] = torch.as_tensor(
            queries.noisy_queries(data, 256, seed=11), device="cuda")
    for name in ["single", "multi"] if args.mesh == "both" else [args.mesh]:
        out_dir, multi = MESHES[name]
        mesh = (None if multi is None
                else make_production_mesh(multi_pod=multi, dry=True))
        try:
            rep = lower_search(mesh, **kw)
        finally:
            if mesh is not None:
                destroy_world()
        outdir = os.path.join(args.out, out_dir)
        os.makedirs(outdir, exist_ok=True)
        print(f"=== {out_dir} :: search-engine ===", flush=True)
        with open(os.path.join(outdir, f"search-engine__{args.tag}.json"),
                  "w") as f:
            json.dump(rep, f, indent=2, default=str)
        t = rep["terms_seconds"]
        line = (f"ok compute={t['compute']:.4f}s "
                f"memory={t['memory']:.4f}s "
                f"coll={t['collective']:.4f}s "
                f"bottleneck={rep['bottleneck']} "
                f"series={rep['n_total_series']:,} "
                f"collectives={rep['n_collectives']}")
        if "measured_seconds" in rep:
            line += (f" measured={rep['measured_seconds']:.4f}s "
                     f"busy={rep['busy_seconds']:.4f}s "
                     f"idle={rep['idle_share']:.3f} "
                     f"roofline={rep['roofline_share']:.4f}")
        print(line, flush=True)


if __name__ == "__main__":
    main()
