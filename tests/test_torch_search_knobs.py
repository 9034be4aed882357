"""repro_torch search knobs on a reference-built index: visit_batch 4
and two lazy-frontier widths (the narrowest and the full leaf count)
give the JAX package's ids, leaves_visited and rows_scanned."""

import jax.numpy as jnp
import pytest

from repro.core import search as jsearch
from repro.core.guarantees import delta_epsilon, exact
from repro.core.indexes import dstree as jdstree
from repro.core.indexes import isax as jisax
from repro_torch.core import guarantees as G
from repro_torch.core import search

from test_torch_search import K, assert_same_search, carry

BUILDERS = {"isax": lambda d: jisax.build(d, leaf_cap=32),
            "dstree": lambda d: jdstree.build(d, leaf_cap=32)}


@pytest.fixture(scope="module", params=sorted(BUILDERS))
def built(request, walk_data):
    ref_index = BUILDERS[request.param](walk_data)
    return ref_index, carry(ref_index)


@pytest.mark.parametrize("share", [False, True], ids=["solo", "share"])
def test_visit_batch_four(built, walk_queries, share):
    ref_index, index = built
    want = jsearch.search(ref_index, jnp.asarray(walk_queries), K,
                          delta_epsilon(0.9, 0.2), visit_batch=4,
                          share_gathers=share)
    got = search.search(index, walk_queries, K, G.delta_epsilon(0.9, 0.2),
                        visit_batch=4, share_gathers=share, device="cpu")
    assert_same_search(want, got)


@pytest.mark.parametrize("width", ["narrow", "full"])
def test_frontier_width(built, walk_queries, width):
    ref_index, index = built
    f = 2 if width == "narrow" else index.num_leaves
    want = jsearch.search(ref_index, jnp.asarray(walk_queries), K, exact(),
                          frontier=f)
    got = search.search(index, walk_queries, K, G.exact(), frontier=f,
                        device="cpu")
    assert_same_search(want, got)
