"""repro_torch kernels: the plain versions against the JAX package's
Pallas kernels (interpret mode) and its jnp oracles, at ragged shapes,
atol = rtol = 1e-3 (the reference's own kernel tolerance). The CUDA
kernels are held against the plain versions on the card by
tests/test_torch_gpu.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops

TOL = dict(atol=1e-3, rtol=1e-3)


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _boxes(seed, b, L, d):
    q, lo = _rand(seed, b, d), _rand(seed + 1, L, d) - 1.0
    hi = lo + np.abs(_rand(seed + 2, L, d))
    w = np.abs(_rand(seed + 3, d)) + 0.5
    return q, lo, hi, w


@pytest.mark.parametrize("n_rows,n,l", [(1, 64, 16), (70, 96, 8),
                                        (33, 100, 5)])
def test_paa_matches_pallas_and_oracle(n_rows, n, l):
    x = _rand(0, n_rows, n)
    got = ops.paa(_t(x), l).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jops.paa(jnp.asarray(x), l, force_pallas=True,
                                 tile=32)), **TOL)
    # segment means add left to right: bit for bit the reference's sums
    np.testing.assert_array_equal(got, np.asarray(jref.ref_paa(
        jnp.asarray(x), l)))


@pytest.mark.parametrize("b,L,d", [(1, 3, 16), (9, 70, 32), (5, 100, 8)])
def test_box_mindist_matches_pallas_and_oracle(b, L, d):
    q, lo, hi, w = _boxes(1, b, L, d)
    got = ops.box_mindist(_t(q), _t(lo), _t(hi), _t(w)).numpy()
    jargs = [jnp.asarray(a) for a in (q, lo, hi, w)]
    np.testing.assert_allclose(
        got, np.asarray(jops.box_mindist(*jargs, force_pallas=True,
                                         tile_b=8, tile_l=32)), **TOL)
    np.testing.assert_array_equal(got,
                                  np.asarray(jref.ref_box_mindist(*jargs)))


@pytest.mark.parametrize("b,m,n", [(1, 1, 32), (5, 67, 96), (9, 40, 50)])
def test_l2_matches_pallas_and_oracle(b, m, n):
    q, x = _rand(2, b, n), _rand(3, m, n)
    got = ops.l2(_t(q), _t(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jops.l2(jnp.asarray(q), jnp.asarray(x),
                                force_pallas=True, tile_b=8, tile_m=32,
                                tile_k=32)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jref.ref_l2(jnp.asarray(q), jnp.asarray(x))), **TOL)


def test_l2_bf16_rows_accumulate_in_f32():
    q, x = _rand(4, 3, 64), _rand(5, 40, 64)
    xb = jnp.asarray(x, jnp.bfloat16)
    got = ops.l2(_t(q), torch.from_numpy(np.asarray(xb, np.float32))
                 .to(torch.bfloat16)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jref.ref_l2(jnp.asarray(q), xb)), **TOL)


@pytest.mark.parametrize("b,r,n,kk", [(5, 96, 32, 7), (3, 50, 24, 50),
                                      (9, 70, 16, 20)])
def test_coop_score_select_matches_pallas_and_oracle(b, r, n, kk):
    q, rows = _rand(6, b, n), _rand(7, r, n)
    norms = (rows * rows).sum(-1).astype(np.float32)
    ids = np.random.default_rng(8).permutation(r).astype(np.int32)
    ids[::5] = -1
    got = ops.coop_score_select(_t(q), _t(rows), _t(norms), _t(ids), kk)
    jargs = [jnp.asarray(a) for a in (q, rows, norms, ids)]
    for want in (jops.coop_score_select(*jargs, kk, force_pallas=True,
                                        tile_b=8, tile_r=32),
                 jref.ref_coop_score_select(*jargs, kk)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   **TOL)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_coop_score_select_ties_decided_by_id():
    """Small-integer inputs make every distance exact in both packages,
    so many distances tie and the (d, id) order must match exactly."""
    g = np.random.default_rng(9)
    q = g.integers(-2, 3, (6, 8)).astype(np.float32)
    rows = g.integers(-2, 3, (120, 8)).astype(np.float32)
    norms = (rows * rows).sum(-1).astype(np.float32)
    ids = g.permutation(300)[:120].astype(np.int32)
    ids[::9] = -1
    got = ops.coop_score_select(_t(q), _t(rows), _t(norms), _t(ids), 60)
    jargs = [jnp.asarray(a) for a in (q, rows, norms, ids)]
    for want in (jops.coop_score_select(*jargs, 60, force_pallas=True,
                                        tile_b=8, tile_r=32),
                 jref.ref_coop_score_select(*jargs, 60)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_l2_topk_matches_reference_with_ties():
    g = np.random.default_rng(10)
    q = g.integers(-2, 3, (4, 6)).astype(np.float32)
    x = g.integers(-2, 3, (90, 6)).astype(np.float32)
    d, i = ops.l2_topk(_t(q), _t(x), 12)
    jd, ji = jops.l2_topk(jnp.asarray(q), jnp.asarray(x), 12)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_cpu_tensors_take_the_plain_version_without_launching():
    x = torch.randn(8, 32)
    before = (ops.paa.launches, ops.box_mindist.launches, ops.l2.launches,
              ops.coop_score_select.launches)
    ops.paa(x, 4)
    ops.box_mindist(x[:, :4], x[:3, :4], x[:3, :4] + 1, torch.ones(4))
    ops.l2(x, x)
    ops.coop_score_select(x, x, ops.row_sq_norms(x),
                          torch.arange(8, dtype=torch.int32), 4)
    assert (ops.paa.launches, ops.box_mindist.launches, ops.l2.launches,
            ops.coop_score_select.launches) == before


def test_coop_score_select_rejects_kk_above_the_pool():
    x = torch.randn(4, 8)
    with pytest.raises(ValueError):
        ops.coop_score_select(x, x, ops.row_sq_norms(x),
                              torch.arange(4, dtype=torch.int32), 5)
