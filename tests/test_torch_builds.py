"""repro_torch builds, summaries, data and metrics against the JAX
package on the same inputs. iSAX2+ and DSTree builds are equal (offsets,
ids, box corners); VA+file box corners agree within a tolerance, since
the two packages' FFTs round differently."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import histogram as jhist
from repro.core import metrics as jmetrics
from repro.core.indexes import dstree as jdstree
from repro.core.indexes import isax as jisax
from repro.core.indexes import vafile as jvafile
from repro.core.summaries import dft as jdft
from repro.core.summaries import eapca as jeapca
from repro.core.summaries import paa as jpaa
from repro.core.summaries import sax as jsax
from repro.data import queries as jqueries
from repro.data import randomwalk as jrandomwalk
from repro_torch.core import histogram, metrics
from repro_torch.core.indexes import dstree, isax, vafile
from repro_torch.core.summaries import dft, eapca, paa, sax
from repro_torch.data import queries, randomwalk

FIELDS = ("offsets", "ids", "box_lo", "box_hi", "weights", "data")


def _same(got, want, fields=FIELDS):
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert got.max_leaf == want.max_leaf and got.n_total == want.n_total


@pytest.mark.parametrize("leaf_cap,tighten", [(32, False), (16, True)])
def test_isax_build_equal(walk_data, leaf_cap, tighten):
    _same(isax.build(walk_data, leaf_cap=leaf_cap, tighten=tighten,
                     device="cpu"),
          jisax.build(walk_data, leaf_cap=leaf_cap, tighten=tighten))


@pytest.mark.parametrize("leaf_cap,n_segments", [(32, 8), (20, 4)])
def test_dstree_build_equal(walk_data, leaf_cap, n_segments):
    _same(dstree.build(walk_data, leaf_cap=leaf_cap, n_segments=n_segments,
                       device="cpu"),
          jdstree.build(walk_data, leaf_cap=leaf_cap, n_segments=n_segments))


def test_vafile_build_close(walk_data):
    got, want = vafile.build(walk_data, device="cpu"), \
        jvafile.build(walk_data)
    _same(got, want, ("offsets", "ids", "weights", "data"))
    for f in ("box_lo", "box_hi"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   atol=1e-4, rtol=1e-4, err_msg=f)


def test_builds_share_the_reference_histogram(walk_data):
    """DEFAULT_SEED is what the JAX package draws from PRNGKey(0)."""
    seed = int(jax.random.randint(jax.random.PRNGKey(0), (), 0,
                                  2**31 - 1))
    assert seed == histogram.DEFAULT_SEED
    got = isax.build(walk_data, leaf_cap=32, device="cpu").hist
    want = jisax.build(walk_data, leaf_cap=32).hist
    np.testing.assert_array_equal(got.edges.numpy(), np.asarray(want.edges))
    np.testing.assert_array_equal(got.cdf.numpy(), np.asarray(want.cdf))


@pytest.mark.parametrize("delta,n", [(0.5, 512), (0.9, 1000), (0.99, 512),
                                     (0.999, 2**20), (1.0, 512)])
def test_r_delta_equal(walk_data, delta, n):
    key = jax.random.PRNGKey(3)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    want = jhist.build_histogram(walk_data, key)
    got = histogram.build_histogram(walk_data, seed, device="cpu")
    assert float(histogram.r_delta(got, delta, n)) == float(
        jhist.r_delta(want, delta, n))
    r = np.linspace(0, float(want.edges[-1]) * 1.1, 50, dtype=np.float32)
    np.testing.assert_array_equal(
        histogram.f_of(got, torch.from_numpy(r)).numpy(),
        np.asarray(jhist.f_of(want, jnp.asarray(r))))


@pytest.mark.parametrize("bits", range(1, 9))
def test_breakpoints_bit_equal(bits):
    got = sax.breakpoints(2**bits)
    want = jsax.breakpoints(2**bits)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,l", [(128, 16), (96, 8), (100, 5)])
def test_summaries_equal(walk_data, n, l):
    x = np.ascontiguousarray(np.resize(walk_data, (64, n)), np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_array_equal(paa.transform(xt, l).numpy(),
                                  np.asarray(jpaa.transform(xj, l)))
    np.testing.assert_array_equal(eapca.transform(xt, l).numpy(),
                                  np.asarray(jeapca.transform(xj, l)))
    np.testing.assert_allclose(dft.transform(xt, l).numpy(),
                               np.asarray(jdft.transform(xj, l)),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(paa.weights(n, l),
                                  np.asarray(jpaa.weights(n, l)))


@pytest.mark.parametrize("seed,n,length,start", [(11, 1500, 64, 0),
                                                 (3, 700, 32, 900)])
def test_data_generators_bit_equal(seed, n, length, start):
    got = randomwalk.generate(seed, n, length, start=start)
    want = jrandomwalk.generate(seed, n, length, start=start)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(queries.noisy_queries(got, 12),
                                  jqueries.noisy_queries(want, 12))


def test_metrics_equal():
    g = np.random.default_rng(4)
    true_ids = np.stack([g.permutation(50)[:10] for _ in range(6)])
    ret_ids = np.where(g.random((6, 10)) < 0.7, true_ids,
                       g.integers(-1, 60, (6, 10)))
    true_d = np.sort(g.random((6, 10)), 1).astype(np.float32)
    ret_d = (true_d * (1 + g.random((6, 10)))).astype(np.float32)
    ret_d[0, -2:] = np.inf
    true_d[1, 0] = 0.0
    got = metrics.workload_metrics(*[torch.from_numpy(a) for a in
                                     (ret_ids, ret_d, true_ids, true_d)])
    want = jmetrics.workload_metrics(*[jnp.asarray(a) for a in
                                       (ret_ids, ret_d, true_ids, true_d)])
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-6), key
