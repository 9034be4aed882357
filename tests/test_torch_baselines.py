"""repro_torch's IMI and HNSW (graph) against the JAX package on the CPU.

Build artifacts are held apart from queries. The builds draw from jax
keys in the reference, so IMI's layout step gets the reference's trained
codebooks, and HNSW's levels come from the same numpy generator (its
adjacency must be equal). Queries run on the reference's index carried
across with ``from_arrays``: ids, rows_scanned and leaves_visited equal
(swaps only between ties), distances within 1e-3. Then the reference's
behaviour tests (tests/test_indexes_other.py), mirrored on the port.
The helpers ``carry`` and ``assert_same_search`` serve
tests/test_torch_baselines_lsh.py too.
"""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import guarantees as JG
from repro.core.indexes import graph as jgraph
from repro.core.indexes import imi as jimi
from repro_torch.core import guarantees as G
from repro_torch.core import search
from repro_torch.core.indexes import graph, imi
from repro_torch.core.metrics import workload_metrics
from repro_torch.device import to_device

K = 5
DIST_TOL = dict(atol=1e-3, rtol=1e-3)


def carry(jidx, module, device="cpu"):
    """The port's copy of the JAX index ``jidx`` through
    ``module.from_arrays``: every array field as numpy, the static ones
    as they are."""
    arrays, meta = {}, {}
    for f in dataclasses.fields(jidx):
        v = getattr(jidx, f.name)
        if f.metadata.get("static"):
            meta[f.name] = v
        else:
            arrays[f.name] = np.asarray(v)
    return module.from_arrays(arrays, meta, device=device)


def assert_same_search(want, got, lanes=None):
    """ids, rows_scanned and leaves_visited equal to the reference's and
    distances within 1e-3, over ``lanes`` (all by default). An id may
    differ at a rank only where the reference's distance there ties
    (within 1e-3) with a neighbouring rank's: a swap between ties."""
    lanes = np.arange(np.asarray(want.ids).shape[0]) if lanes is None \
        else np.asarray(lanes)
    wi, gi = np.asarray(want.ids)[lanes], got.ids.cpu().numpy()[lanes]
    wd, gd = np.asarray(want.dists)[lanes], got.dists.cpu().numpy()[lanes]
    for f in ("rows_scanned", "leaves_visited"):
        np.testing.assert_array_equal(
            np.broadcast_to(getattr(got, f).cpu().numpy(),
                            np.asarray(want.ids).shape[:1])[lanes],
            np.broadcast_to(np.asarray(getattr(want, f)),
                            np.asarray(want.ids).shape[:1])[lanes], f)
    np.testing.assert_allclose(gd, wd, **DIST_TOL)
    tie = np.zeros(wd.shape, bool)
    with np.errstate(invalid="ignore"):  # inf - inf: unfilled slots
        near = (wd[:, 1:] == wd[:, :-1]) | (
            np.abs(np.diff(wd, axis=1)) <= 1e-3 + 1e-3 * np.abs(wd[:, 1:]))
    tie[:, 1:] |= near
    tie[:, :-1] |= near
    bad = (wi != gi) & ~tie
    assert not bad.any(), f"ids differ where no tie: {np.argwhere(bad)}"
    return int((wi != gi).sum())


@pytest.fixture(scope="module")
def bf(walk_data, walk_queries):
    return search.brute_force(walk_queries, walk_data, K, device="cpu")


@pytest.fixture(scope="module")
def ref_imi(walk_data):
    return jimi.build(walk_data, kc=8, m=16, kmeans_iters=10)


@pytest.fixture(scope="module")
def ref_graph(walk_data):
    return jgraph.build(walk_data, m_links=8)


@pytest.fixture(scope="module")
def port_imi(walk_data):
    return imi.build(walk_data, kc=8, m=16, kmeans_iters=10, device="cpu")


@pytest.fixture(scope="module")
def port_graph(walk_data):
    return graph.build(walk_data, m_links=8, device="cpu")


def test_graph_build_equals_reference(ref_graph, port_graph):
    """Same levels (numpy's generator, seed 0), same M nearest members
    per level in lax.top_k's order: the adjacency is equal."""
    assert port_graph.levels == ref_graph.levels
    assert port_graph.entry == int(ref_graph.entry)
    np.testing.assert_array_equal(port_graph.adj.numpy(),
                                  np.asarray(ref_graph.adj))


def test_imi_layout_equals_reference(walk_data, ref_imi):
    """Given the reference's trained codebooks, the layout step puts the
    same rows in the same cells in the same order, with the same codes."""
    t = {f: torch.tensor(np.asarray(getattr(ref_imi, f)))
         for f in ("u_cent", "v_cent", "pq_centroids", "pq_rotation")}
    got = imi.layout(walk_data, t["u_cent"], t["v_cent"],
                     t["pq_centroids"], t["pq_rotation"])
    for f in ("cell_offsets", "codes", "ids", "data"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy().astype(np.asarray(
                getattr(ref_imi, f)).dtype),
            np.asarray(getattr(ref_imi, f)), f)
    assert got.max_cell == ref_imi.max_cell
    assert got.codes.dtype == torch.uint8


@pytest.mark.parametrize("nprobe,refine", [(1, False), (32, False),
                                           (64, True)])
def test_imi_query_matches_reference(walk_queries, ref_imi, nprobe,
                                     refine):
    want = jimi.query(ref_imi, jnp.asarray(walk_queries), K,
                      JG.ng(nprobe), refine=refine)
    got = imi.query(carry(ref_imi, imi), walk_queries, K, G.ng(nprobe),
                    refine=refine, device="cpu")
    assert_same_search(want, got)


@pytest.mark.parametrize("efs", [8, 128])
def test_graph_query_matches_reference(walk_queries, ref_graph, efs):
    want = jgraph.query(ref_graph, jnp.asarray(walk_queries), K, efs=efs)
    got = graph.query(carry(ref_graph, graph), walk_queries, K, efs=efs,
                      device="cpu")
    assert_same_search(want, got)


def test_imi_recall_improves_with_nprobe(walk_queries, port_imi, bf):
    r1 = imi.query(port_imi, walk_queries, K, G.ng(1), device="cpu")
    r2 = imi.query(port_imi, walk_queries, K, G.ng(32), device="cpu")
    m1 = workload_metrics(r1.ids, r1.dists, bf.ids, bf.dists)
    m2 = workload_metrics(r2.ids, r2.dists, bf.ids, bf.dists)
    assert m2["avg_recall"] >= m1["avg_recall"]
    assert m2["avg_recall"] > 0.4


def test_imi_refine_closes_the_map_gap(walk_queries, port_imi, bf):
    """Paper finding C4: ADC-only IMI has MAP below its recall; raw
    re-ranking recovers it."""
    plain = imi.query(port_imi, walk_queries, K, G.ng(64), device="cpu")
    ref = imi.query(port_imi, walk_queries, K, G.ng(64), refine=True,
                    device="cpu")
    mp = workload_metrics(plain.ids, plain.dists, bf.ids, bf.dists)
    mr = workload_metrics(ref.ids, ref.dists, bf.ids, bf.dists)
    assert mr["map"] >= mp["map"]
    assert mr["mre"] <= mp["mre"] + 1e-6


def test_graph_beam_width_tradeoff(walk_queries, port_graph, bf):
    lo = graph.query(port_graph, walk_queries, K, efs=8, device="cpu")
    hi = graph.query(port_graph, walk_queries, K, efs=128, device="cpu")
    mlo = workload_metrics(lo.ids, lo.dists, bf.ids, bf.dists)
    mhi = workload_metrics(hi.ids, hi.dists, bf.ids, bf.dists)
    assert mhi["avg_recall"] >= mlo["avg_recall"]
    assert mhi["avg_recall"] > 0.6


def test_graph_is_ng_only_interface():
    """Graph query takes no guarantee params (Table 1)."""
    params = inspect.signature(graph.query).parameters
    for name in ("epsilon", "delta", "g"):
        assert name not in params


@pytest.mark.parametrize("g", [G.delta_epsilon(0.9, 0.0), G.epsilon(1.0)])
def test_imi_refuses_a_delta_or_epsilon_guarantee(walk_queries, port_imi,
                                                  g):
    with pytest.raises(ValueError, match="ng-only"):
        imi.query(port_imi, walk_queries, K, g, device="cpu")


def test_imi_refuses_codes_wider_than_8_bits(walk_data):
    with pytest.raises(ValueError, match="8-bit"):
        imi.build(walk_data, kc=4, m=16, k_pq=512, device="cpu")


def test_imi_default_probes_16_cells(walk_queries, port_imi):
    """No guarantee, or the exact one, probes 16 cells as the reference
    does."""
    for g in (G.exact(), G.ng(16)):
        res = imi.query(port_imi, walk_queries, K, g, device="cpu")
        assert res.iterations == 16
        assert bool((res.leaves_visited == 16).all())


def test_to_device_copies_every_tensor_field(walk_queries, port_imi):
    """``to_device`` copies an index's tensors and shares its other
    fields; the copy answers as the original does. Without a card, a
    move to it raises."""
    moved = to_device(port_imi, "cpu")
    for f in dataclasses.fields(port_imi):
        a, b = getattr(port_imi, f.name), getattr(moved, f.name)
        if isinstance(a, torch.Tensor):
            assert b.device.type == "cpu" and torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    want = imi.query(port_imi, walk_queries, K, G.ng(4), device="cpu")
    got = imi.query(moved, walk_queries, K, G.ng(4), device="cpu")
    assert torch.equal(got.ids, want.ids)
    assert torch.equal(got.dists, want.dists)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            to_device(port_imi, "cuda")
