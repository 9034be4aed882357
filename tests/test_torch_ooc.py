"""repro_torch's out-of-core search against the JAX package's, on stores
the reference wrote: the guarantee taxonomy, solo and share_gathers,
with a cache (6 leaves) smaller than the working set. f32 and bf16 give
the reference's ids, leaves_visited and rows_scanned (distances within
1e-3, as in tests/test_torch_search.py); pq gives its ids up to swaps
between tied distances. With prefetch=False the I/O counters are the
reference's too."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import guarantees as JG
from repro.core import search as JS
from repro.core.indexes import dstree as jdstree
from repro.core.indexes import vafile as jvafile
from repro.store import layout as jlayout
from repro_torch.core import guarantees as G
from repro_torch.core import search as S
from repro_torch.core.index import FrozenIndex
from repro_torch.store import DeviceLeafCache, search_ooc

K = 5
GUARANTEES = {
    "exact": (JG.exact(), G.exact()),
    "eps": (JG.epsilon(1.0), G.epsilon(1.0)),
    "delta_eps": (JG.delta_epsilon(0.99, 1.0), G.delta_epsilon(0.99, 1.0)),
    "ng": (JG.ng(4), G.ng(4)),
}
IO_FIELDS = ("bytes_read", "bytes_h2d", "misses", "hits", "iterations",
             "rows_scanned", "leaves_visited", "hits_distinct",
             "bytes_read_rerank", "stop_delta", "stop_epsilon",
             "stop_exhausted")


@pytest.fixture(scope="module")
def stores(walk_data, tmp_path_factory):
    """DSTree stores the reference wrote, by codec."""
    index = jdstree.build(walk_data, leaf_cap=32)
    root = tmp_path_factory.mktemp("ooc_stores")
    return {c: jlayout.save_index(index, str(root / c), codec=c)
            for c in ("f32", "bf16", "pq")}


def open_both(path):
    return (jlayout.load_index(path, resident="summaries"),
            FrozenIndex.load(path, resident="summaries", device="cpu"))


def run_both(path, queries, g, **kw):
    jstore, store = open_both(path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        want = JS.search_ooc(jstore, jnp.asarray(queries), K, g[0], **kw)
        got = search_ooc(store, queries, K, g[1], **kw)
    return want, got


def assert_same_walk(want, got):
    np.testing.assert_array_equal(got.leaves_visited.numpy(),
                                  np.asarray(want.leaves_visited))
    np.testing.assert_array_equal(got.rows_scanned.numpy(),
                                  np.asarray(want.rows_scanned))


@pytest.mark.parametrize("share", [False, True])
@pytest.mark.parametrize("gname", sorted(GUARANTEES))
@pytest.mark.parametrize("codec", ["f32", "bf16"])
def test_raw_codecs_match_reference(stores, walk_queries, codec, gname,
                                    share):
    want, got = run_both(stores[codec], walk_queries, GUARANTEES[gname],
                         cache_leaves=6, share_gathers=share)
    np.testing.assert_array_equal(got.result.ids.numpy(),
                                  np.asarray(want.result.ids))
    assert_same_walk(want.result, got.result)
    np.testing.assert_allclose(got.result.dists.numpy(),
                               np.asarray(want.result.dists), atol=1e-3,
                               rtol=1e-3)
    assert got.stats.iterations == want.stats["iterations"]
    assert got.stats.codec == codec and got.stats.share_gathers is share
    assert got.stats.misses > 0


def tie_swaps(data, queries, got_ids, want_ids, tol=1e-3):
    """Positions where the ids differ must hold two ids at the same true
    distance (float64, within tol); returns how many differ."""
    diff = got_ids != want_ids
    for lane, rank in zip(*np.nonzero(diff)):
        a, b = got_ids[lane, rank], want_ids[lane, rank]
        da = np.linalg.norm(data[a].astype(np.float64) - queries[lane])
        db = np.linalg.norm(data[b].astype(np.float64) - queries[lane])
        assert abs(da - db) <= tol * max(1.0, db), (lane, rank, da, db)
    return int(diff.sum())


@pytest.mark.parametrize("share", [False, True])
@pytest.mark.parametrize("gname", ["eps", "delta_eps"])
def test_pq_matches_reference_up_to_ties(stores, walk_data, walk_queries,
                                         gname, share):
    want, got = run_both(stores["pq"], walk_queries, GUARANTEES[gname],
                         cache_leaves=6, share_gathers=share)
    tie_swaps(walk_data, walk_queries, got.result.ids.numpy(),
              np.asarray(want.result.ids))
    assert_same_walk(want.result, got.result)
    np.testing.assert_allclose(got.result.dists.numpy(),
                               np.asarray(want.result.dists), atol=1e-3,
                               rtol=1e-3)
    assert got.stats.bytes_read_rerank == want.stats["bytes_read_rerank"]
    assert got.stats.bytes_read_rerank > 0


@pytest.mark.parametrize("share", [False, True])
@pytest.mark.parametrize("codec", ["f32", "bf16", "pq"])
def test_io_counters_match_reference_without_prefetch(
        stores, walk_queries, codec, share):
    want, got = run_both(stores[codec], walk_queries, GUARANTEES["eps"],
                         cache_leaves=6, prefetch=False,
                         share_gathers=share)
    for f in IO_FIELDS:
        assert got.stats[f] == want.stats[f], f
    assert got.stats.prefetch_bytes_read == 0
    assert got.stats.bytes_read == got.stats.bytes_read_sync \
        + got.stats.bytes_read_rerank


@pytest.mark.parametrize("share", [False, True])
@pytest.mark.parametrize("codec", ["f32", "bf16"])
def test_ooc_equals_in_memory_search_of_the_decoded_index(
        stores, walk_queries, codec, share):
    """The reference's own contract, held by the port: out-of-core search
    is the in-memory search over load_index(resident="full"), bit for
    bit (for bf16, over the bfloat16 image)."""
    full = FrozenIndex.load(stores[codec], device="cpu")
    store = FrozenIndex.load(stores[codec], resident="summaries",
                             device="cpu")
    g = G.delta_epsilon(0.99, 1.0)
    want = S.search(full, walk_queries, K, g, share_gathers=share,
                    device="cpu")
    got = S.search_ooc(store, walk_queries, K, g, share_gathers=share,
                       cache_leaves=6).result
    for f in ("ids", "dists", "leaves_visited", "rows_scanned"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.iterations == want.iterations


def test_ooc_vafile_visit_batch_matches_reference(walk_data, walk_queries,
                                                  tmp_path):
    d = jlayout.save_index(jvafile.build(walk_data), str(tmp_path / "va"))
    want, got = run_both(d, walk_queries, GUARANTEES["eps"],
                         visit_batch=64, cache_leaves=400)
    np.testing.assert_array_equal(got.result.ids.numpy(),
                                  np.asarray(want.result.ids))
    assert_same_walk(want.result, got.result)


def test_warm_cache_reads_nothing(stores, walk_queries):
    store = FrozenIndex.load(stores["f32"], resident="summaries",
                             device="cpu")
    cache = DeviceLeafCache(store, store.num_leaves)
    cold = search_ooc(store, walk_queries, K, cache=cache)
    cache.reset_counters()
    warm = search_ooc(store, walk_queries, K, cache=cache)
    assert torch.equal(cold.result.ids, warm.result.ids)
    assert cold.stats.bytes_read > 0
    assert warm.stats.bytes_read == 0 and warm.stats.hit_rate == 1.0


def test_pq_exact_guarantee_request_warns(stores, walk_queries):
    store = FrozenIndex.load(stores["pq"], resident="summaries",
                             device="cpu")
    with pytest.warns(UserWarning, match="cannot honor the exact"):
        search_ooc(store, walk_queries, K, cache_leaves=6)
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        search_ooc(store, walk_queries, K, G.epsilon(1.0), cache_leaves=6)
        search_ooc(store, walk_queries, K, G.ng(4), cache_leaves=6)


def test_pq_rerank_distance_is_exact_at_zero(stores, walk_data):
    """The re-rank's direct difference form: a query equal to a stored
    series comes back at distance exactly 0."""
    store = FrozenIndex.load(stores["pq"], resident="summaries",
                             device="cpu")
    out = search_ooc(store, walk_data[:4], K, G.epsilon(1.0))
    ids, dists = out.result.ids.numpy(), out.result.dists.numpy()
    for lane in range(4):
        hit = np.where(ids[lane] == lane)[0]
        assert hit.size == 1, (lane, ids[lane])
        assert dists[lane, hit[0]] == 0.0


@pytest.mark.parametrize("delta", [1.0, 0.99])
def test_pq_guarantee_holds_after_rerank(stores, walk_data, walk_queries,
                                         delta):
    """The reported distances are exact, so Definition 5's (1+eps) bound
    is checked against brute force directly."""
    store = FrozenIndex.load(stores["pq"], resident="summaries",
                             device="cpu")
    bf = S.brute_force(walk_queries, walk_data, K, device="cpu")
    out = search_ooc(store, walk_queries, K, G.Guarantee(delta=delta,
                                                         epsilon=1.0),
                     share_gathers=True, cache_leaves=6)
    ok = out.result.dists.numpy() <= 2.0 * bf.dists.numpy() * (1 + 1e-4) \
        + 1e-4
    assert ok.all() if delta == 1.0 else ok.mean() >= 0.9
