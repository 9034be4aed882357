"""repro_torch's PQ codec against the JAX package's: encoding and ADC
tables under the same codebook, the plain versions of the two PQ
kernels (bit for bit, ties and masks included), and properties of the
port's own k-means and training (their random draws cannot be the
reference's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.summaries import pq as jpq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.summaries import pq
from repro_torch.kernels import ops, ref


def walk(seed, n, length):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.normal(size=(n, length)), axis=1).astype(np.float32)
    return (x - x.mean(1, keepdims=True)) / (x.std(1, keepdims=True) + 1e-9)


@pytest.fixture(scope="module")
def data():
    return walk(0, 2048, 128)


@pytest.fixture(scope="module")
def jax_codebook(data):
    return jpq.pq_train(jax.random.PRNGKey(0), jnp.asarray(data), 16, k=256,
                        iters=6)


@pytest.fixture(scope="module")
def codebook(jax_codebook):
    """The port's copy of the reference's trained codebook."""
    return pq.PQCodebook(torch.as_tensor(np.array(jax_codebook.centroids)),
                         torch.as_tensor(np.array(jax_codebook.rotation)))


def test_encode_equals_reference_under_its_codebook(data, jax_codebook,
                                                    codebook):
    want = np.asarray(jpq.pq_encode(jax_codebook, jnp.asarray(data)))
    got = pq.pq_encode(codebook, torch.as_tensor(data))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        pq.pq_reconstruct(codebook, got).numpy(),
        np.asarray(jpq.pq_reconstruct(jax_codebook, jnp.asarray(want))))


@pytest.mark.parametrize("fn", ["adc_lut", "adc_lut_batch", "adc_scan"])
def test_adc_tables_and_scan_match_reference(data, jax_codebook, codebook,
                                             fn):
    q = walk(1, 5, 128)
    codes = np.array(jpq.pq_encode(jax_codebook, jnp.asarray(data)))
    if fn == "adc_lut":
        want = jpq.adc_lut(jax_codebook, jnp.asarray(q[0]))
        got = pq.adc_lut(codebook, torch.as_tensor(q[0]))
    elif fn == "adc_lut_batch":
        want = jpq.adc_lut_batch(jax_codebook, jnp.asarray(q))
        got = pq.adc_lut_batch(codebook, torch.as_tensor(q))
    else:
        want = jpq.adc_scan(jax_codebook, jnp.asarray(codes),
                            jnp.asarray(q[2]))
        got = pq.adc_scan(codebook, torch.as_tensor(codes),
                          torch.as_tensor(q[2]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


def adc_inputs(seed, b, r, m=16, k=256, integer=False):
    """Codes [r, m] uint8 and tables [b, m, k]; small integer tables make
    many ADC sums tie exactly."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, k, (r, m)).astype(np.uint8)
    if integer:
        luts = rng.integers(0, 3, (b, m, k)).astype(np.float32)
    else:
        luts = rng.random((b, m, k), dtype=np.float32) * 4.0
    return codes, luts


@pytest.mark.parametrize("integer", [False, True])
def test_plain_pq_adc_is_bit_equal_to_reference(integer):
    codes, luts = adc_inputs(2, 1, 777, integer=integer)
    want = np.asarray(jref.ref_pq_adc(jnp.asarray(codes, jnp.int32),
                                      jnp.asarray(luts[0])))
    got = ops.pq_adc(torch.as_tensor(codes), torch.as_tensor(luts[0]))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.ref_pq_adc(torch.as_tensor(codes), torch.as_tensor(luts[0])),
        want)


@pytest.mark.parametrize("per_lane", [False, True])
@pytest.mark.parametrize("m", [16, 8, 5])
def test_plain_pq_adc_batch_is_bit_equal_to_reference(per_lane, m):
    rng = np.random.default_rng(3)
    b, r = 6, 300
    luts = rng.random((b, m, 256), dtype=np.float32)
    shape = (b, r, m) if per_lane else (r, m)
    codes = rng.integers(0, 256, shape).astype(np.uint8)
    want = np.asarray(jref.ref_pq_adc_batch(jnp.asarray(codes, jnp.int32),
                                            jnp.asarray(luts)))
    got = ops.pq_adc_batch(torch.as_tensor(codes), torch.as_tensor(luts))
    assert got.shape == (b, r)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("b,r,kk,integer", [
    (3, 200, 17, False),      # masked slots, distinct distances
    (5, 900, 64, True),       # ties decided by id
    (4, 1000, 800, True),     # the pq corner's kk at k=100, rerank=4
    (2, 40, 40, False),       # kk = R: every masked slot comes back
])
def test_plain_pq_adc_select_is_bit_equal_to_reference(b, r, kk, integer):
    codes, luts = adc_inputs(4, b, r, integer=integer)
    rng = np.random.default_rng(5)
    ids = rng.permutation(4 * r)[:r].astype(np.int32)
    ids[rng.random(r) < 0.2] = -1
    want = jref.ref_pq_adc_select(jnp.asarray(codes, jnp.int32),
                                  jnp.asarray(luts), jnp.asarray(ids), kk)
    jop = jops.pq_adc_select(jnp.asarray(codes), jnp.asarray(luts),
                             jnp.asarray(ids), kk)
    args = (torch.as_tensor(codes), torch.as_tensor(luts),
            torch.as_tensor(ids), kk)
    for got in (ops.pq_adc_select(*args), ref.ref_pq_adc_select(*args)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for g, w in zip(got, jop):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # masked slots come out as (inf, -1)
    d, i = ops.pq_adc_select(*args)
    assert torch.equal(torch.isinf(d), i == -1)


def test_pq_adc_select_rejects_kk_beyond_the_pool():
    codes, luts = adc_inputs(6, 2, 30)
    with pytest.raises(ValueError, match="exceeds the pool"):
        ops.pq_adc_select(torch.as_tensor(codes), torch.as_tensor(luts),
                          torch.arange(30, dtype=torch.int32), 31)


def test_kmeans_objective_never_rises():
    """Lloyd's iterations from one start (the same seed replays the same
    draws, so iters=t is the t-th iterate): with no empty cluster the
    objective is non-increasing."""
    x = torch.as_tensor(walk(7, 600, 8))

    def objective(c):
        return float(ops.l2(x, c).min(1).values.mean())

    objs = [objective(pq.kmeans(3, x, 16, iters=t)) for t in range(0, 8)]
    for a, b in zip(objs, objs[1:]):
        assert b <= a * (1 + 1e-6), objs


def test_kmeans_accepts_a_generator():
    x = torch.as_tensor(walk(8, 300, 4))
    a = pq.kmeans(torch.Generator().manual_seed(9), x, 8, iters=3)
    b = pq.kmeans(9, x, 8, iters=3)
    assert torch.equal(a, b)


def test_train_codes_range_and_error_near_reference(data, jax_codebook):
    cb = pq.pq_train(0, torch.as_tensor(data), 16, k=256, iters=6)
    assert cb.centroids.shape == (16, 256, 8)
    codes = pq.pq_encode(cb, torch.as_tensor(data))
    assert int(codes.min()) >= 0 and int(codes.max()) < 256
    err = float(((pq.pq_reconstruct(cb, codes).numpy() - data) ** 2)
                .sum(1).mean())
    jcodes = jpq.pq_encode(jax_codebook, jnp.asarray(data))
    jerr = float(((np.asarray(jpq.pq_reconstruct(jax_codebook, jcodes))
                   - data) ** 2).sum(1).mean())
    assert abs(err - jerr) <= 0.05 * jerr, (err, jerr)


def test_opq_rotation_is_orthogonal():
    x = torch.as_tensor(walk(10, 512, 32))
    cb = pq.pq_train(1, x, 4, k=16, iters=3, opq_iters=1)
    eye = torch.eye(32)
    torch.testing.assert_close(cb.rotation @ cb.rotation.T, eye, atol=1e-4,
                               rtol=0)
