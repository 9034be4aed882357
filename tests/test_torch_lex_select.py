"""The exact (d, id) selection shared by K4 and K6: the port's plain
version ``ref.ref_lex_select`` against the JAX package's in-kernel
selection ``lex_min_select`` and its jnp oracle, bit for bit (ties
decided by id, masked slots as (inf, -1)), and the two score + select
oracles rebuilt on it against the reference's oracles. The CUDA kernel
is held against the plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lex_cases import LEX_CASES, lex_case
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.topk import lex_min_select
from repro_torch.kernels import ops, ref


def _reference_selections(d, ids, kk):
    """The reference's two ways to the same selection: lex_min_select
    over the masked scores (what its fused kernels run in VMEM), and its
    pq oracle with one subspace whose table is the scores themselves
    (code r of row r), which sorts with lax.sort(num_keys=2)."""
    dm = np.where(ids[None, :] < 0, np.float32(np.inf), d)
    idm = np.broadcast_to(ids[None, :], d.shape)
    yield lex_min_select(jnp.asarray(dm), jnp.asarray(idm), kk)
    codes = np.arange(d.shape[1], dtype=np.int32)[:, None]
    yield jref.ref_pq_adc_select(jnp.asarray(codes), jnp.asarray(d[:, None]),
                                 jnp.asarray(ids), kk)


@pytest.mark.parametrize("case", LEX_CASES)
def test_ref_lex_select_matches_the_reference(case):
    d, ids, kk = lex_case(case)
    got = ref.ref_lex_select(torch.as_tensor(d), torch.as_tensor(ids), kk)
    assert got[0].shape == (d.shape[0], kk) and got[1].dtype == torch.int32
    for want in _reference_selections(d, ids, kk):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # masked slots come out as (inf, -1), after every real key
    assert torch.equal(torch.isinf(got[0]), got[1] == -1)


@pytest.mark.parametrize("case", LEX_CASES)
def test_lex_select_wrapper_takes_the_plain_version_on_cpu(case):
    d, ids, kk = lex_case(case)
    args = (torch.as_tensor(d), torch.as_tensor(ids), kk)
    before = ops.lex_select.launches
    got, want = ops.lex_select(*args), ref.ref_lex_select(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ops.lex_select.launches == before


def test_lex_select_rejects_kk_beyond_the_pool():
    with pytest.raises(ValueError, match="exceeds the pool"):
        ops.lex_select(torch.zeros(2, 5), torch.arange(5, dtype=torch.int32),
                       6)


@pytest.mark.parametrize("integer", [False, True])
def test_plain_pq_adc_select_with_negative_tables_is_bit_equal(integer):
    """K6's plain path orders negative ADC distances as the reference
    does (the kernel's key is sign-aware for the same reason)."""
    rng = np.random.default_rng(11)
    b, r, m, kk = 4, 700, 16, 300
    luts = (rng.random((b, m, 256), dtype=np.float32) * 4 - 2)
    if integer:
        luts = np.floor(luts)
    codes = rng.integers(0, 256, (r, m)).astype(np.uint8)
    ids = rng.permutation(2 * r)[:r].astype(np.int32)
    ids[::6] = -1
    want = jref.ref_pq_adc_select(jnp.asarray(codes, jnp.int32),
                                  jnp.asarray(luts), jnp.asarray(ids), kk)
    assert float(np.asarray(want[0]).min()) < 0
    got = ops.pq_adc_select(torch.as_tensor(codes), torch.as_tensor(luts),
                            torch.as_tensor(ids), kk)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("oracle", ["coop_score_select", "pq_adc_select"])
def test_select_oracles_rebuilt_on_ref_lex_select_equal_the_reference(
        oracle):
    """ref_coop_score_select and ref_pq_adc_select are now "score, then
    ref_lex_select"; on integer inputs (exact arithmetic in both
    packages) they equal the reference's oracles and its Pallas kernels
    bit for bit, ties and masked slots included."""
    rng = np.random.default_rng(12)
    b, r, kk = 6, 260, 120
    ids = rng.permutation(1000)[:r].astype(np.int32)
    ids[::5] = -1
    if oracle == "coop_score_select":
        q = rng.integers(-2, 3, (b, 12)).astype(np.float32)
        rows = rng.integers(-2, 3, (r, 12)).astype(np.float32)
        norms = (rows * rows).sum(-1).astype(np.float32)
        got = ref.ref_coop_score_select(*map(torch.as_tensor,
                                             (q, rows, norms, ids)), kk)
        jargs = [jnp.asarray(a) for a in (q, rows, norms, ids)]
        wants = (jref.ref_coop_score_select(*jargs, kk),
                 jops.coop_score_select(*jargs, kk, force_pallas=True,
                                        tile_b=8, tile_r=32))
    else:
        luts = np.floor(rng.random((b, 16, 256), dtype=np.float32) * 3)
        codes = rng.integers(0, 256, (r, 16)).astype(np.uint8)
        got = ref.ref_pq_adc_select(torch.as_tensor(codes),
                                    torch.as_tensor(luts),
                                    torch.as_tensor(ids), kk)
        wants = (jref.ref_pq_adc_select(jnp.asarray(codes, jnp.int32),
                                        jnp.asarray(luts), jnp.asarray(ids),
                                        kk),
                 jops.pq_adc_select(jnp.asarray(codes), jnp.asarray(luts),
                                    jnp.asarray(ids), kk))
    for want in wants:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
