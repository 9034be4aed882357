"""The exact (d, id) selection shared by K4 and K6: the port's plain
version ``ref.ref_lex_select`` against the JAX package's in-kernel
selection ``lex_min_select`` and its jnp oracle, bit for bit (ties
decided by id, masked slots as (inf, -1)), and the two score + select
oracles rebuilt on it against the reference's oracles. The wrapper's
split path (a lane cut into chunks, each chunk's kk smallest, then the
kk smallest of those) is modelled in plain torch and held to the plain
version at the chunks' edges; the path a shape takes and the calls'
counter are the wrapper's own. The CUDA kernel is held against the
plain version on the card by tests/test_torch_gpu.py and
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lex_cases import LEX_CASES, lex_case
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.topk import lex_min_select
from repro_torch import obs
from repro_torch.kernels import lex_select as L
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


def _split_model(d, ids, kk, chunk, bounded=True):
    """The split path in plain torch, lane by lane: the first chunk of
    ``chunk`` slots keeps its kk smallest keys (ref_lex_select over the
    chunk: masked slots as (inf, id)), and the distance of the kk-th is
    the lane's bound; every other chunk keeps its slots at or below the
    bound (all of them when the first chunk is shorter than kk, or not
    ``bounded``) and of those the min(kk, kept) smallest; then the lane
    keeps the kk smallest of its chunks' keys. The kernel pads a chunk
    with fewer than kk with a key above every slot's, which the second
    select never keeps: here it is left out."""
    r = d.shape[1]
    inf = torch.tensor(float("inf"))
    out_d, out_i = [], []
    for b in range(d.shape[0]):
        lane = d[b:b + 1]
        first = ref.ref_lex_select(lane[:, :chunk], ids[:chunk],
                                   min(kk, chunk, r))
        bound = first[0][0, -1] if bounded and first[0].shape[1] == kk \
            else inf
        parts = [first]
        for c in range(chunk, r, chunk):
            sd, si = lane[:, c:c + chunk], ids[c:c + chunk]
            keep = torch.where(si < 0, inf, sd[0]) <= bound
            if keep.any():
                parts.append(ref.ref_lex_select(
                    sd[:, keep], si[keep], min(kk, int(keep.sum()))))
        cd = torch.cat([p[0] for p in parts], 1)
        ci = torch.cat([p[1] for p in parts], 1)
        o = ref.lex_order(cd, ci)[:, :kk]
        out_d.append(cd.gather(1, o))
        out_i.append(ci.gather(1, o))
    return torch.cat(out_d), torch.cat(out_i)


def _edge_case(name):
    """Scores [B, R], ids [R], kk and the chunk for the split model."""
    rng = np.random.default_rng(len(name))
    chunk = 64
    if name == "ragged":  # R not a multiple of the chunk, last one short
        r, kk = 5 * chunk + 17, 30
    elif name == "masked_chunk":  # one chunk all masked
        r, kk = 6 * chunk, 50
    elif name == "few_real":  # fewer than kk real keys in the lane
        r, kk = 4 * chunk + 9, 120
    elif name == "kk_eq_chunk":  # kk is every chunk's length
        r, kk = 5 * chunk, chunk
    elif name == "kk_eq_last":  # kk is the last chunk's length
        r, kk = 3 * chunk + 20, 20
    elif name == "ties":  # small integers: ids decide at the bound
        r, kk = 7 * chunk + 3, 40
    else:
        raise KeyError(name)
    d = rng.normal(size=(4, r)).astype(np.float32) * 10 + 40
    if name == "ties":
        d = rng.integers(0, 4, (4, r)).astype(np.float32)
    if name == "ragged":
        d[:, ::9] = -0.0
    ids = rng.permutation(3 * r)[:r].astype(np.int32)
    ids[rng.random(r) < 0.2] = -1
    if name == "masked_chunk":
        ids[2 * chunk:3 * chunk] = -1
        d[:, 2 * chunk:3 * chunk] = np.nan  # a masked score is never read
    if name == "few_real":
        ids[:] = -1
        ids[rng.choice(r, 40, replace=False)] = rng.permutation(500)[:40]
    return torch.as_tensor(d), torch.as_tensor(ids), kk, chunk


EDGES = ("ragged", "masked_chunk", "few_real", "kk_eq_chunk", "kk_eq_last",
         "ties")


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("case", EDGES)
def test_split_model_equals_the_plain_version_at_chunk_edges(case, bounded):
    d, ids, kk, chunk = _edge_case(case)
    got = _split_model(d, ids, kk, chunk, bounded)
    want = ref.ref_lex_select(d, ids, kk)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("case", LEX_CASES)
def test_split_model_equals_the_plain_version_on_the_shared_cases(
        case, bounded):
    """The selection cases the card's kernel is held to, cut into chunks
    of 37 slots (or 400 slots, so that the first chunk holds kk and
    bounds the others): ties across chunks, kk = R, every slot masked,
    kk = 1024, negative scores and -0 beside +0."""
    d, ids, kk = lex_case(case)
    d, ids = torch.as_tensor(d), torch.as_tensor(ids)
    got = _split_model(d, ids, kk, 37 if kk > 400 or not bounded else 400)
    want = ref.ref_lex_select(d, ids, kk)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_split_model_at_the_wrapper_s_chunk():
    """Two lanes just past the staged lane's limit, in the wrapper's own
    chunks (four, the last one slot long), a fifth of them masked."""
    rng = np.random.default_rng(35)
    r = L.STAGE_MAX + 1
    d = torch.as_tensor(rng.random((2, r), dtype=np.float32))
    ids = torch.as_tensor(rng.permutation(2 * r)[:r].astype(np.int32))
    ids[torch.as_tensor(rng.random(r) < 0.2)] = -1
    assert L.plan(r, 200) == ("split", 4)
    got = _split_model(d, ids, 200, L.CHUNK)
    want = ref.ref_lex_select(d, ids, 200)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("r, kk, path, chunks", [
    (1_001_472, 200, "split", 62),  # the search cell
    (25_600, 200, "lane", 1),       # the main path's B = 100
    (48 * 1024, 200, "lane", 1),    # the largest staged lane
    (48 * 1024 + 1, 200, "split", 4),
    (2 ** 20, 8, "split", 64),      # the HNSW build's block
    (1_001_472, 1024, "split", 62),
    (1_001_472, 1025, "lane", 1),   # sorts through device memory
    (25_600, 1200, "lane", 1),
])
def test_the_wrapper_plans_by_r_and_kk(r, kk, path, chunks):
    """The path and chunks a shape takes, and the scratch it asks for:
    the chunks' keys and a word a lane on the split path; two [B, kk]
    buffers past the shared-memory sort; else none."""
    b = 3
    assert L.plan(r, kk) == (path, chunks)
    want = {"split": b * chunks * kk + b,
            "lane": 2 * b * kk if kk > L.MAX_KK else 0}[path]
    assert L.scratch_keys(b, r, kk) == want


def _calls():
    return {p: L._CALLS[p].value for p in ("split", "lane")}


def test_calls_count_by_path_while_a_sink_is_on():
    """Each call counts once, under the path its shape takes, and only
    while a span sink is on."""
    rng = np.random.default_rng(7)
    big = torch.as_tensor(rng.random((2, L.STAGE_MAX + 5),
                                     dtype=np.float32))
    big_ids = torch.arange(L.STAGE_MAX + 5, dtype=torch.int32)
    small, small_ids = big[:, :300].contiguous(), big_ids[:300].contiguous()
    before = _calls()
    ops.lex_select(big, big_ids, 10)
    assert _calls() == before  # no sink on
    obs.enable()
    try:
        ops.lex_select(big, big_ids, 10)
        ops.lex_select(small, small_ids, 10)
        ops.lex_select(big, big_ids, 1025)
    finally:
        obs.disable()
    after = _calls()
    assert after["split"] - before["split"] == 1
    assert after["lane"] - before["lane"] == 2
