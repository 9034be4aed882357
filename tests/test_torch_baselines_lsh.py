"""repro_torch's SRS and QALSH against the JAX package on the CPU.

The reference draws both projections from jax keys, so the builds here
take the reference's matrix (SRS's ``feats`` and QALSH's sorted
projections within 1e-5 relative: the same matmul, summed in another
order), and queries run on the reference's index carried across with
``from_arrays``: ids, rows_scanned and leaves_visited equal (swaps only
between ties), distances within 1e-3. SRS stops on psi, the chi^2 CDF,
which torch and jax compute to within 2e-6 of each other: a lane whose
stopping test lies that close to delta may stop a chunk apart, and is
exempt (the test prints how many were). Then the reference's behaviour
tests, mirrored on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import guarantees as JG
from repro.core.indexes import qalsh as jqalsh
from repro.core.indexes import srs as jsrs
from repro.core.summaries import randproj as jrandproj
from repro.kernels import ops as jops
from repro_torch.core import guarantees as G
from repro_torch.core import search
from repro_torch.core.indexes import qalsh, srs
from repro_torch.core.metrics import workload_metrics
from repro_torch.core.summaries import randproj
from repro_torch.data import queries, randomwalk
from test_torch_baselines import assert_same_search, carry

K = 5
PSI_TOL = 2e-6


@pytest.fixture(scope="module")
def bf(walk_data, walk_queries):
    return search.brute_force(walk_queries, walk_data, K, device="cpu")


@pytest.fixture(scope="module")
def ref_srs(walk_data):
    return jsrs.build(walk_data, m=16)


@pytest.fixture(scope="module")
def ref_qalsh(walk_data):
    return jqalsh.build(walk_data, m=8)


@pytest.mark.parametrize("m", [8, 16])
def test_psi_matches_jax(m):
    x = np.random.default_rng(m).uniform(0, 60, 20000).astype(np.float32)
    x[:5] = [0.0, -1.0, 1e-6, 59.99, 1e3]
    got = randproj.psi(m, torch.as_tensor(x)).numpy()
    want = np.asarray(jrandproj.psi(m, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=PSI_TOL, rtol=0)


def test_srs_build_with_the_reference_projection(walk_data, ref_srs):
    idx = srs.build(walk_data, m=16, seed=np.asarray(ref_srs.proj),
                    device="cpu")
    np.testing.assert_allclose(idx.feats.numpy(), np.asarray(ref_srs.feats),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(idx.proj.numpy(), np.asarray(ref_srs.proj))


def test_qalsh_build_with_the_reference_projection(walk_data, ref_qalsh):
    idx = qalsh.build(walk_data, m=8, seed=np.asarray(ref_qalsh.proj),
                      device="cpu")
    assert idx.l_threshold == ref_qalsh.l_threshold
    got_v, want_v = idx.sorted_vals.numpy(), np.asarray(ref_qalsh.sorted_vals)
    np.testing.assert_allclose(got_v, want_v, atol=1e-5, rtol=1e-5)
    # the order may differ only between values within that bound
    got_i, want_i = idx.sorted_ids.numpy(), np.asarray(ref_qalsh.sorted_ids)
    for j in range(idx.m):
        for p in np.nonzero(got_i[j] != want_i[j])[0]:
            a = np.asarray(ref_qalsh.data) @ np.asarray(ref_qalsh.proj)[:, j]
            assert abs(a[got_i[j, p]] - a[want_i[j, p]]) <= 1e-5 * (
                1 + abs(want_v[j, p]))


def _srs_near_delta(idx, q, g, chunk=256):
    """Lanes whose stopping test came within PSI_TOL of delta at a chunk
    boundary the reference reached (a replay of its loop)."""
    qf = jnp.asarray(q)
    p_sq = np.asarray(jops.l2(qf @ idx.proj, idx.feats))
    order = np.argsort(p_sq, axis=1, kind="stable")
    data = np.asarray(idx.data)
    res = jsrs.query(idx, qf, K, g)
    near = []
    for b in range(q.shape[0]):
        stop = int(res.rows_scanned[b])
        for t in range(chunk, stop + 1, chunk):
            rows = data[order[b, :t]]
            d = np.sort(((rows - q[b]) ** 2).sum(-1))
            bsf = d[K - 1] if t >= K else np.inf
            p_cur = p_sq[b, order[b, min(t, idx.n_total - 1)]]
            arg = p_cur * np.float32((1 + g.epsilon) ** 2) / max(bsf, 1e-30)
            psi = float(jrandproj.psi(idx.m, jnp.float32(arg)))
            if abs(psi - g.delta) <= PSI_TOL:
                near.append(b)
    return res, sorted(set(near))


@pytest.mark.parametrize("delta,eps", [(0.5, 1.0), (0.99, 0.0)])
def test_srs_query_matches_reference(walk_queries, ref_srs, delta, eps):
    want, exempt = _srs_near_delta(ref_srs, walk_queries,
                                   JG.delta_epsilon(delta, eps))
    got = srs.query(carry(ref_srs, srs), walk_queries, K,
                    G.delta_epsilon(delta, eps), device="cpu")
    print(f"srs delta={delta} eps={eps}: {len(exempt)} lanes exempt "
          f"(psi within {PSI_TOL} of delta)")
    lanes = [b for b in range(walk_queries.shape[0]) if b not in exempt]
    assert_same_search(want, got, lanes)


@pytest.mark.parametrize("steps,frontier", [(8, 64), (1, 16)])
def test_qalsh_query_matches_reference(walk_queries, ref_qalsh, steps,
                                       frontier):
    want = jqalsh.query(ref_qalsh, jnp.asarray(walk_queries), K,
                        steps=steps, frontier=frontier)
    got = qalsh.query(carry(ref_qalsh, qalsh), walk_queries, K, steps=steps,
                      frontier=frontier, device="cpu")
    assert_same_search(want, got)


@pytest.mark.parametrize("log2_n", [13, 15])
def test_qalsh_leaves_the_reference_unanswered_queries_unanswered(log2_n):
    """QALSH's windows are fixed in ranks (frontier x steps = 512 a line),
    so in a larger collection a noisy query may collide with no point on
    l of its m lines and return no neighbour. At N = 2^13 and 2^15
    series of 256 and the chip smoke's 100 queries (random walks of seed 11), the
    reference and the port, on one index, answer the same queries; some
    find none, and every query that is a row of the collection (noise
    level 0: every fifth) finds that row, at distance 0."""
    data = randomwalk.generate(seed=11, n_series=1 << log2_n,
                               series_len=256)
    q = queries.noisy_queries(data, 100)
    ref_idx = jqalsh.build(data)
    want_d = np.asarray(jqalsh.query(ref_idx, jnp.asarray(q), 100).dists)
    got_d = qalsh.query(carry(ref_idx, qalsh), q, 100,
                        device="cpu").dists.numpy()
    want, got = np.isfinite(want_d[:, 0]), np.isfinite(got_d[:, 0])
    print(f"qalsh N=2^{log2_n}: {int(want.sum())} of {len(q)} queries answered "
          f"by the reference, {int(got.sum())} by the port")
    np.testing.assert_array_equal(got, want)
    assert not want.all()
    assert (want_d[::5, 0] == 0).all() and (got_d[::5, 0] == 0).all()


def test_srs_delta_controls_scan_depth(walk_data, walk_queries, bf):
    idx = srs.build(walk_data, m=16, device="cpu")
    loose = srs.query(idx, walk_queries, K, G.delta_epsilon(0.5, 1.0),
                      device="cpu")
    tight = srs.query(idx, walk_queries, K, G.delta_epsilon(0.99, 0.0),
                      device="cpu")
    assert int(loose.rows_scanned.sum()) <= int(tight.rows_scanned.sum())
    m = workload_metrics(tight.ids, tight.dists, bf.ids, bf.dists)
    assert m["avg_recall"] > 0.8


def test_srs_tiny_index_footprint(walk_data):
    """SRS's selling point: the index (projections) is m/n of the data."""
    idx = srs.build(walk_data, m=8, device="cpu")
    feat_bytes = idx.feats.numel() * 4
    data_bytes = idx.data.numel() * 4
    assert feat_bytes <= data_bytes * 8 / walk_data.shape[1] + 1024


@pytest.mark.parametrize("g", [G.ng(4), G.Guarantee(nprobe=1)])
def test_srs_refuses_an_ng_guarantee(walk_data, walk_queries, g):
    idx = srs.build(walk_data[:64], m=4, device="cpu")
    with pytest.raises(ValueError, match="delta-epsilon"):
        srs.query(idx, walk_queries, K, g, device="cpu")


def test_srs_defaults_to_delta_095(walk_data, walk_queries):
    idx = srs.build(walk_data, m=16, device="cpu")
    a = srs.query(idx, walk_queries, K, device="cpu")
    b = srs.query(idx, walk_queries, K, G.delta_epsilon(0.95, 0.0),
                  device="cpu")
    assert torch.equal(a.ids, b.ids) and a.iterations == b.iterations


def test_qalsh_recall_grows_with_budget(walk_data, walk_queries, bf):
    idx = qalsh.build(walk_data, m=8, device="cpu")
    lo = qalsh.query(idx, walk_queries, K, steps=1, frontier=16,
                     device="cpu")
    hi = qalsh.query(idx, walk_queries, K, steps=6, frontier=64,
                     device="cpu")
    mlo = workload_metrics(lo.ids, lo.dists, bf.ids, bf.dists)
    mhi = workload_metrics(hi.ids, hi.dists, bf.ids, bf.dists)
    assert mhi["avg_recall"] >= mlo["avg_recall"]
    assert mhi["avg_recall"] > 0.6
    assert int(hi.rows_scanned.sum()) >= int(lo.rows_scanned.sum())


def test_qalsh_refines_on_raw_distances(walk_data, walk_queries, bf):
    """QALSH re-ranks candidates on true distances: recall == MAP
    (the paper's C5 applies to it, unlike IMI)."""
    idx = qalsh.build(walk_data, m=8, device="cpu")
    res = qalsh.query(idx, walk_queries, K, steps=6, frontier=64,
                      device="cpu")
    m = workload_metrics(res.ids, res.dists, bf.ids, bf.dists)
    assert abs(m["avg_recall"] - m["map"]) < 1e-6


@pytest.mark.parametrize("module", [srs, qalsh])
def test_lsh_builds_default_to_the_card(walk_data, module):
    """Entry points run on the card unless asked for the CPU; without a
    card they raise rather than move there."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default build runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        module.build(walk_data[:32])


def test_make_projection_defaults_to_the_card():
    """The projection lands on the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default projection goes there")
    with pytest.raises(RuntimeError, match="CUDA"):
        randproj.make_projection(0, 16, 4)
    assert randproj.make_projection(0, 16, 4, "cpu").device.type == "cpu"
