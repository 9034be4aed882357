"""repro_torch selection and merge ops: bit-exact against the JAX
package on identical inputs, ties included (small-integer distances make
ties common)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import refine as jrefine
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import refine
from repro_torch.kernels import ops, ref


def _ties(seed, *shape, hi=6):
    """Small-integer distances with some +inf: many exact ties."""
    g = np.random.default_rng(seed)
    d = g.integers(0, hi, shape).astype(np.float32)
    d[g.random(shape) < 0.1] = np.inf
    return d


def _running(seed, b, k):
    """A sorted running top-k with distinct ids and (inf, -1) tails."""
    g = np.random.default_rng(seed)
    d = np.sort(_ties(seed, b, k), axis=1)
    i = np.stack([g.permutation(1000)[:k] for _ in range(b)]).astype(
        np.int32)
    i[np.isinf(d)] = -1
    return d, i


def _eq(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("b,w,k", [(3, 17, 5), (4, 64, 64), (2, 300, 33)])
def test_smallest_k_is_lax_top_k(b, w, k):
    x = _ties(b * w, b, w)
    d, pos = ops.smallest_k(torch.from_numpy(x), k)
    import jax

    nv, ni = jax.lax.top_k(-jnp.asarray(x), k)
    _eq((d, pos), (-nv, ni))


@pytest.mark.parametrize("m", [3, 12, 40])
def test_topk_merge_bit_exact(m):
    dists = _ties(m, 4, m)
    ids = np.random.default_rng(m).permutation(10_000)[:4 * m].reshape(
        4, m).astype(np.int32)
    top_d, top_i = _running(m + 1, 4, 8)
    args = [torch.from_numpy(a) for a in (dists, ids, top_d, top_i)]
    jargs = [jnp.asarray(a) for a in (dists, ids, top_d, top_i)]
    got = ops.topk_merge(*args)
    _eq(got, jops.topk_merge(*jargs))
    _eq(got, jref.ref_topk_merge(*jargs))
    _eq(got, ref.ref_topk_merge(*args))


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("m", [5, 40])
def test_topk_merge_unique_bit_exact(shared, m):
    b, k = 3, 8
    g = np.random.default_rng(m)
    dists = _ties(m + 7, b, m)
    if shared:  # one pool for every lane; some ids repeat running ones
        ids = g.permutation(60)[:m].astype(np.int32)
        ids[::4] = -1
        full_ids = np.broadcast_to(ids, (b, m))
    else:
        ids = np.stack([g.permutation(60)[:m] for _ in range(b)]).astype(
            np.int32)
        full_ids = ids
    dists = np.where(full_ids < 0, np.inf, dists).astype(np.float32)
    top_d, top_i = _running(m + 3, b, k)
    top_i = np.where(top_i >= 0, top_i % 60, -1).astype(np.int32)
    for r in range(b):  # running ids distinct per lane
        seen = set()
        for j in range(k):
            if top_i[r, j] in seen:
                top_i[r, j], top_d[r, j] = -1, np.inf
            seen.add(top_i[r, j])
        o = np.lexsort((top_i[r], top_d[r]))
        top_d[r], top_i[r] = top_d[r][o], top_i[r][o]
    args = [torch.from_numpy(np.array(a)) for a in (dists, ids, top_d,
                                                    top_i)]
    jargs = [jnp.asarray(a) for a in (dists, ids, top_d, top_i)]
    got = ops.topk_merge_unique(*args)
    _eq(got, jops.topk_merge_unique(*jargs))
    _eq(got, jref.ref_topk_merge_unique(jnp.asarray(dists),
                                        jnp.asarray(full_ids),
                                        *jargs[2:]))
    _eq(got, ref.ref_topk_merge_unique(torch.from_numpy(dists),
                                       torch.from_numpy(
                                           np.array(full_ids)),
                                       *args[2:]))


def test_dedup_merge_topk_bit_exact():
    sel_d, sel_i = _running(5, 4, 12)
    sel_i = np.where(sel_i >= 0, sel_i % 20, -1).astype(np.int32)
    top_d, top_i = _running(6, 4, 6)
    top_i = np.where(top_i >= 0, top_i % 20 + 10, -1).astype(np.int32)
    for r in range(4):
        for arr_d, arr_i in ((sel_d, sel_i), (top_d, top_i)):
            _, first = np.unique(arr_i[r], return_index=True)
            keep = np.zeros(arr_i.shape[1], bool)
            keep[first] = True
            arr_i[r][~keep], arr_d[r][~keep] = -1, np.inf
            o = np.lexsort((arr_i[r], arr_d[r]))
            arr_d[r], arr_i[r] = arr_d[r][o], arr_i[r][o]
    got = ops.dedup_merge_topk(*[torch.from_numpy(a) for a in
                                 (sel_d, sel_i, top_d, top_i)])
    _eq(got, jops.dedup_merge_topk(*[jnp.asarray(a) for a in
                                     (sel_d, sel_i, top_d, top_i)]))


@pytest.mark.parametrize("ka,kb", [(1, 1), (5, 3), (8, 8), (7, 20)])
def test_bitonic_merge_sorted_bit_exact(ka, kb):
    da, ia = _running(ka, 3, ka)
    db, ib = _running(kb + 50, 3, kb)
    got = ops.bitonic_merge_sorted(*[torch.from_numpy(a) for a in
                                     (da, ia, db, ib)])
    _eq(got, jops.bitonic_merge_sorted(*[jnp.asarray(a) for a in
                                         (da, ia, db, ib)]))


@pytest.mark.parametrize("f", [1, 6, 40])
def test_frontier_select_bit_exact(f):
    lb = _ties(f, 5, 40, hi=4)
    g = np.random.default_rng(f)
    thr_lb = g.integers(-1, 3, 5).astype(np.float32)
    thr_id = g.integers(-1, 40, 5).astype(np.int32)
    got = refine.frontier_select(*[torch.from_numpy(a) for a in
                                   (lb, thr_lb, thr_id.astype(np.int64))],
                                 f)
    _eq(got, jrefine.frontier_select(jnp.asarray(lb), jnp.asarray(thr_lb),
                                     jnp.asarray(thr_id), f))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dup_leaf_mask_bit_exact(seed):
    g = np.random.default_rng(seed)
    leaf = g.integers(0, 6, (5, 4))
    ok = g.random((5, 4)) < 0.7
    got = refine.dup_leaf_mask(torch.from_numpy(leaf), torch.from_numpy(ok))
    want = jrefine.dup_leaf_mask(jnp.asarray(leaf, jnp.int32),
                                 jnp.asarray(ok))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
