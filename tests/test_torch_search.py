"""repro_torch search on an index the JAX package built, carried across
with frozen_index_from_arrays: the whole guarantee taxonomy, solo and
share_gathers. ids, leaves_visited and rows_scanned must be equal and
distances within 1e-3, so search parity is held apart from build
parity (tests/test_torch_builds.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import search as jsearch
from repro.core.guarantees import delta_epsilon, epsilon, exact, ng
from repro.core.indexes import dstree as jdstree
from repro.core.indexes import isax as jisax
from repro.core.indexes import vafile as jvafile
from repro_torch.core import guarantees as G
from repro_torch.core import search
from repro_torch.core.index import (ARRAY_FIELDS, META_FIELDS,
                                    frozen_index_from_arrays)

K = 5
VISIT = {"isax": 1, "dstree": 1, "vafile": 32}
BUILDERS = {
    "isax": lambda d: jisax.build(d, leaf_cap=32),
    "dstree": lambda d: jdstree.build(d, leaf_cap=32),
    "vafile": lambda d: jvafile.build(d),
}
GUARANTEES = {
    "exact": (exact(), G.exact()),
    "eps": (epsilon(0.5), G.epsilon(0.5)),
    "delta_eps": (delta_epsilon(0.9, 0.5), G.delta_epsilon(0.9, 0.5)),
    "ng": (ng(3), G.ng(3)),
}


def host_arrays(index):
    """The host arrays and static fields of a JAX FrozenIndex."""
    arrays = {f: np.asarray(getattr(index, f)) for f in ARRAY_FIELDS}
    arrays["edges"] = np.asarray(index.hist.edges)
    arrays["cdf"] = np.asarray(index.hist.cdf)
    return arrays, {f: getattr(index, f) for f in META_FIELDS}


def carry(index):
    """The port's copy of a JAX FrozenIndex, on the CPU."""
    return frozen_index_from_arrays(*host_arrays(index), device="cpu")


def assert_same_search(want, got):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.leaves_visited.numpy(),
                                  np.asarray(want.leaves_visited))
    np.testing.assert_array_equal(got.rows_scanned.numpy(),
                                  np.asarray(want.rows_scanned))
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               atol=1e-3, rtol=1e-3)


@pytest.fixture(scope="module", params=sorted(BUILDERS))
def built(request, walk_data):
    ref_index = BUILDERS[request.param](walk_data)
    return request.param, ref_index, carry(ref_index)


@pytest.mark.parametrize("share", [False, True], ids=["solo", "share"])
@pytest.mark.parametrize("gname", sorted(GUARANTEES))
def test_search_matches_reference(built, walk_queries, gname, share):
    name, ref_index, index = built
    jg, tg = GUARANTEES[gname]
    want = jsearch.search(ref_index, jnp.asarray(walk_queries), K, jg,
                          visit_batch=VISIT[name], share_gathers=share)
    got = search.search(index, walk_queries, K, tg,
                        visit_batch=VISIT[name], share_gathers=share,
                        device="cpu")
    assert_same_search(want, got)
    assert got.iterations >= 1 and got.lb_computed == index.num_leaves


@pytest.mark.parametrize("gname", sorted(GUARANTEES))
def test_search_with_guarantee_matches_reference(built, walk_queries,
                                                 gname):
    name, ref_index, index = built
    jg, tg = GUARANTEES[gname]
    want = jsearch.search_with_guarantee(
        ref_index, jnp.asarray(walk_queries), K, jg,
        visit_batch=VISIT[name])
    got = search.search_with_guarantee(index, walk_queries, K, tg,
                                       visit_batch=VISIT[name],
                                       device="cpu")
    assert_same_search(want, got)


def test_brute_force_matches_reference(walk_data, walk_queries):
    want = jsearch.brute_force(jnp.asarray(walk_queries),
                               jnp.asarray(walk_data), K)
    got = search.brute_force(walk_queries, walk_data, K, device="cpu")
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               atol=1e-3, rtol=1e-3)


def test_exact_search_finds_the_brute_force_answer(built, walk_data,
                                                   walk_queries):
    name, _, index = built
    bf = search.brute_force(walk_queries, walk_data, K, device="cpu")
    res = search.search(index, walk_queries, K,
                        visit_batch=VISIT[name], device="cpu")
    np.testing.assert_array_equal(res.ids.numpy(), bf.ids.numpy())


def test_bf16_index_matches_reference(walk_data, walk_queries):
    ref_index = jisax.build(walk_data, leaf_cap=32, data_dtype=jnp.bfloat16)
    index = carry(ref_index)
    assert index.data.dtype == torch.bfloat16
    for share in (False, True):
        want = jsearch.search(ref_index, jnp.asarray(walk_queries), K,
                              exact(), share_gathers=share)
        got = search.search(index, walk_queries, K, G.exact(),
                            share_gathers=share, device="cpu")
        assert_same_search(want, got)


@pytest.mark.parametrize("entry", ["search", "brute_force",
                                   "frozen_index_from_arrays", "isax",
                                   "dstree", "vafile"])
def test_entry_points_default_to_the_card(entry, walk_data, walk_queries):
    """Without device= an entry point asks for the card and raises where
    there is none: it never falls back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.core.indexes import dstree, isax, vafile

    ref_index = jisax.build(walk_data[:64], leaf_cap=32)
    calls = {
        "search": lambda: search.search(carry(ref_index), walk_queries, K),
        "brute_force": lambda: search.brute_force(walk_queries, walk_data,
                                                  K),
        "frozen_index_from_arrays": lambda: frozen_index_from_arrays(
            *host_arrays(ref_index)),
        "isax": lambda: isax.build(walk_data),
        "dstree": lambda: dstree.build(walk_data),
        "vafile": lambda: vafile.build(walk_data),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
