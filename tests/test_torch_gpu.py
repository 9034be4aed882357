"""repro_torch on the card: each CUDA kernel against its plain version,
the entry points' default device, one out-of-core search per codec and
each vector baseline against the CPU. Needs a CUDA device (skips
elsewhere) but not jax, so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from _lex_cases import LEX_CASES, lex_case
from repro_torch.core import guarantees as G
from repro_torch.core import search
from repro_torch.core.index import FrozenIndex
from repro_torch.core.indexes import (dstree, graph, imi, isax, qalsh, srs,
                                      vafile)
from repro_torch.data import queries, randomwalk
from repro_torch.device import to_device
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.gpu

TOL = dict(atol=1e-3, rtol=1e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("name", ["paa", "box_mindist", "l2",
                                  "coop_score_select"])
def test_kernel_matches_plain_version_on_card(cuda, name):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(300, 96, generator=g, device=cuda)
    before = getattr(ops, name).launches
    if name == "paa":
        torch.testing.assert_close(ops.paa(x, 8), ref.ref_paa(x, 8),
                                   atol=0, rtol=0)
    elif name == "box_mindist":
        q, lo = x[:7, :16].contiguous(), x[7:, :16] - 1.0
        hi, w = lo + x[7:, 16:32].abs(), x[0, :16].abs() + 0.5
        lo, hi = lo.contiguous(), hi.contiguous()
        torch.testing.assert_close(ops.box_mindist(q, lo, hi, w),
                                   ref.ref_box_mindist(q, lo, hi, w), **TOL)
    elif name == "l2":
        torch.testing.assert_close(ops.l2(x[:9], x), ref.ref_l2(x[:9], x),
                                   **TOL)
    else:
        ids = torch.arange(300, dtype=torch.int32, device=cuda)
        args = (x[:9].contiguous(), x, ops.row_sq_norms(x), ids, 40)
        got, want = ops.coop_score_select(*args), \
            ref.ref_coop_score_select(*args)
        torch.testing.assert_close(got[0], want[0], **TOL)
    assert getattr(ops, name).launches == before + 1


@pytest.mark.parametrize("builder,visit_batch", [(isax.build, 1),
                                                 (dstree.build, 1),
                                                 (vafile.build, 16)])
def test_entry_points_run_on_the_card_by_default(cuda, builder,
                                                 visit_batch):
    data = randomwalk.generate(seed=5, n_series=2048, series_len=64)
    q = queries.noisy_queries(data, 8)
    truth = search.brute_force(q, data, 10)
    index = builder(data, **({} if builder is vafile.build
                             else {"leaf_cap": 64}))
    res = search.search(index, q, 10, visit_batch=visit_batch)
    assert res.ids.is_cuda and index.data.is_cuda
    assert torch.equal(res.ids, truth.ids)


@pytest.mark.parametrize("name", ["pq_adc_batch", "pq_adc_select"])
def test_pq_kernels_match_plain_version_on_card(cuda, name):
    """K5 is bit-equal to its plain version (the same left-to-right sum);
    K6 too, ties decided by id, masked slots (inf, -1), kk up to 1200,
    past the selection's sort in shared memory."""
    g = torch.Generator(device=cuda).manual_seed(1)
    codes = torch.randint(0, 256, (3000, 16), generator=g, device=cuda,
                          dtype=torch.uint8)
    luts = torch.randint(0, 3, (9, 16, 256), generator=g,
                         device=cuda).float()
    before = getattr(ops, name).launches
    if name == "pq_adc_batch":
        for c in (codes, codes[:2700].reshape(9, 300, 16),
                  codes[:, :8].contiguous()):
            lt = luts[:, :c.shape[-1]]
            assert torch.equal(ops.pq_adc_batch(c, lt),
                               ref.ref_pq_adc_batch(c, lt))
        assert ops.pq_adc_batch.launches == before + 3
        return
    ids = torch.randperm(3000, generator=g, device=cuda).to(torch.int32)
    ids[::5] = -1
    for kk in (1, 40, 800, 1200):
        got = ops.pq_adc_select(codes, luts, ids, kk)
        want = ref.ref_pq_adc_select(codes, luts, ids, kk)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ops.pq_adc_select.launches == before + 4


@pytest.mark.parametrize("case", LEX_CASES)
def test_lex_select_matches_plain_version_on_card(cuda, case):
    """The radix select is exact: bit-equal to the plain version, ties
    decided by id, masked slots (inf, -1), -0 beside +0."""
    d, ids, kk = lex_case(case)
    d, ids = torch.as_tensor(d, device=cuda), torch.as_tensor(ids,
                                                              device=cuda)
    before = ops.lex_select.launches
    got, want = ops.lex_select(d, ids, kk), ref.ref_lex_select(d, ids, kk)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ops.lex_select.launches == before + 1


@pytest.mark.parametrize("kk", [256, 1024, 2000])
def test_coop_score_select_large_kk_on_card(cuda, kk):
    """K4 at large kk (2000 sorts through device memory), on small
    integers (exact distances, so bit-equal to the plain version, ties
    decided by id)."""
    rng = np.random.default_rng(kk)
    q = torch.as_tensor(rng.integers(-2, 3, (20, 16)).astype(np.float32),
                        device=cuda)
    rows = torch.as_tensor(rng.integers(-2, 3, (3000, 16)).astype(
        np.float32), device=cuda)
    ids = torch.as_tensor(rng.permutation(3000).astype(np.int32),
                          device=cuda)
    ids[::7] = -1
    args = (q, rows, ops.row_sq_norms(rows), ids, kk)
    got, want = ops.coop_score_select(*args), ref.ref_coop_score_select(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


K4_PASS_CASES = {
    # the reference's main path: 100 lanes, one 104-lane tile
    "b100": (100, 25_600),
    # the search cell's size: 256 lanes x 8 leaf windows of 512 slots,
    # ~20% of the slots in whole masked leaves; two 128-lane tiles
    "b256": (256, 1 << 20),
    # one lane past two 128-lane tiles (so three of 104) and a ragged
    # last row tile
    "b257": (257, 30_001),
}


def _k4_pool(cuda, case, kind):
    """K4's inputs as the cooperative step makes them: the slots' rows are
    leaves of up to 512 rows (the leaf's tail masked) read through an
    index into a source of 300,000 rows, every fifth leaf masked whole
    (a copy of a leaf another lane pooled); "normal" values, or small
    integers, whose every sum is exact in f32."""
    b, r = K4_PASS_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(r)
    n_src, n = 300_000, 256
    if kind == "integer":
        q = torch.randint(-2, 3, (b, n), generator=g, device=cuda).float()
        src = torch.randint(-2, 3, (n_src, n), generator=g,
                            device=cuda).float()
    else:
        q = torch.randn(b, n, generator=g, device=cuda)
        src = torch.randn(n_src, n, generator=g, device=cuda)
    leaves = -(-r // 512)
    start = torch.randint(0, n_src - 512, (leaves,), generator=g,
                          device=cuda)
    size = torch.randint(440, 513, (leaves,), generator=g, device=cuda)
    pos = torch.arange(512, device=cuda)
    index = (start[:, None] + pos).reshape(-1)[:r].contiguous()
    keep = ((pos[None, :] < size[:, None])
            & (torch.arange(leaves, device=cuda) % 5 != 3)[:, None])
    ids = torch.randperm(r, generator=g, device=cuda).to(torch.int32)
    ids = torch.where(keep.reshape(-1)[:r], ids, -1)
    norms = ops.row_sq_norms(src)[index]
    return q, src, index, norms, ids


@pytest.mark.parametrize("kind", ["normal", "integer"])
@pytest.mark.parametrize("case", sorted(K4_PASS_CASES))
def test_k4_index_pass_equals_the_dense_pass_on_card(cuda, case, kind):
    """K4 reading its rows through the index, skipping the masked tiles,
    with the lane tile of the batch: every kept slot's score is
    bit-identical to the dense formulation's (the gathered pool passed
    as rows, the call the cooperative step made before), and so is the
    selection. On small integers both are exact, so they also equal the
    plain version bit for bit."""
    from repro_torch.kernels import topk

    q, src, index, norms, ids = _k4_pool(cuda, case, kind)
    dense = src[index]
    kept = ids >= 0
    got = topk.score_pass(q, src, norms, ids, index)
    want = topk.score_pass(q, dense, norms, ids)
    assert torch.equal(got[:, kept], want[:, kept])
    kk = 200
    before = ops.coop_score_select.launches
    out = ops.coop_score_select(q, src, norms, ids, kk, index=index)
    old = ops.coop_score_select(q, dense, norms, ids, kk)
    assert ops.coop_score_select.launches == before + 2
    assert torch.equal(out[0], old[0]) and torch.equal(out[1], old[1])
    plain = ref.ref_coop_scores(q, dense, norms)
    if kind == "integer":
        assert torch.equal(got[:, kept], plain[:, kept])
        want = ref.ref_coop_score_select(q, dense, norms, ids, kk)
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
    else:
        torch.testing.assert_close(got[:, kept], plain[:, kept], **TOL)
    if case == "b256":
        assert 0.21 <= 1 - kept.float().mean().item() <= 0.30


def test_k4_library_tile_is_the_one_counted_on_card(cuda):
    """kernels.k4_tiles counts by topk.ROW_TILE and LANE_TILES: the
    library's own tile (coop_score_tile) is the same."""
    from repro_torch.kernels import build, topk

    lib = build.library("topk")
    assert (tuple(lib.coop_score_tile(i) for i in range(3))
            == (topk.ROW_TILE,) + topk.LANE_TILES)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_index_pass_bf16_and_fully_masked_on_card(cuda, dtype):
    """bf16 rows through the index give the dense pass's kept scores bit
    for bit; a fully masked pool returns only (inf, -1)."""
    from repro_torch.kernels import topk

    q, src, index, norms, ids = _k4_pool(cuda, "b257", "normal")
    src = src.to(dtype)
    kept = ids >= 0
    got = topk.score_pass(q, src, norms, ids, index)
    want = topk.score_pass(q, src[index], norms, ids)
    assert torch.equal(got[:, kept], want[:, kept])
    ids[:] = -1
    d, i = ops.coop_score_select(q, src, norms, ids, 300, index=index)
    assert bool((i == -1).all()) and bool(torch.isinf(d).all())


def test_k3_exact_at_the_brute_force_shape_on_card(cuda):
    """K3 at the main path's brute-force shape (100 x 2^20 x 256), on
    small integers: exact, so bit-equal to the plain version."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randint(-2, 3, (100, 256), generator=g, device=cuda).float()
    x = torch.randint(-2, 3, (1 << 20, 256), generator=g,
                      device=cuda).float()
    assert torch.equal(ops.l2(q, x), ref.ref_l2(q, x))


def test_pq_adc_select_negative_tables_on_card(cuda):
    rng = np.random.default_rng(11)
    luts = torch.as_tensor(rng.random((9, 16, 256), dtype=np.float32) * 4
                           - 2, device=cuda)
    codes = torch.as_tensor(rng.integers(0, 256, (3000, 16)).astype(
        np.uint8), device=cuda)
    ids = torch.as_tensor(rng.permutation(3000).astype(np.int32),
                          device=cuda)
    ids[::5] = -1
    got = ops.pq_adc_select(codes, luts, ids, 800)
    want = ref.ref_pq_adc_select(codes, luts, ids, 800)
    assert float(want[0].min()) < 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("codec", ["f32", "bf16", "pq"])
def test_ooc_search_on_the_card(cuda, tmp_path, codec):
    data = randomwalk.generate(seed=6, n_series=4096, series_len=128)
    q = queries.noisy_queries(data, 16)
    index = dstree.build(data, leaf_cap=64)
    d = index.save(str(tmp_path / codec), codec=codec)
    store = FrozenIndex.load(d, resident="summaries")
    g = G.epsilon(1.0)
    for share in (False, True):
        out = search.search_ooc(store, q, 10, g, share_gathers=share)
        assert out.result.ids.is_cuda and out.stats.bytes_h2d > 0
        if codec == "pq":
            bf = search.brute_force(q, data, 10)
            assert bool((out.result.dists
                         <= 2.0 * bf.dists * (1 + 1e-4) + 1e-4).all())
        else:
            want = search.search(FrozenIndex.load(d), q, 10, g,
                                 share_gathers=share)
            assert torch.equal(out.result.ids, want.ids)
            assert torch.equal(out.result.rows_scanned, want.rows_scanned)


@pytest.mark.parametrize("kk", [1025, 4096, 20000])
def test_lex_select_past_shared_memory_on_card(cuda, kk):
    """kk > 1024 sorts through device memory (20000 spans three runs of
    the merge sort): bit-equal to the plain version, ties decided by id,
    masked slots (inf, -1), -0 beside +0 and negative scores."""
    rng = np.random.default_rng(kk)
    r = kk + 3000
    d = rng.integers(-4, 5, (3, r)).astype(np.float32)
    d[0] = rng.normal(size=r).astype(np.float32)
    d[0, ::11] = -0.0
    ids = rng.permutation(2 * r)[:r].astype(np.int32)
    ids[::7] = -1
    d, ids = torch.as_tensor(d, device=cuda), torch.as_tensor(ids,
                                                              device=cuda)
    before = ops.lex_select.launches
    got, want = ops.lex_select(d, ids, kk), ref.ref_lex_select(d, ids, kk)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ops.lex_select.launches == before + 1


@pytest.mark.parametrize("dims", [33, 64, 100])
def test_box_mindist_any_width_on_card(cuda, dims):
    """Boxes wider than 32 dims run in chunks of 32, the sum still left
    to right: bit-equal to the plain version."""
    g = torch.Generator(device=cuda).manual_seed(dims)
    q = torch.randn(131, dims, generator=g, device=cuda)
    lo = torch.randn(517, dims, generator=g, device=cuda) - 1.0
    hi = lo + torch.rand(517, dims, generator=g, device=cuda) * 2.0
    w = torch.rand(dims, generator=g, device=cuda) + 0.5
    before = ops.box_mindist.launches
    assert torch.equal(ops.box_mindist(q, lo, hi, w),
                       ref.ref_box_mindist(q, lo, hi, w))
    assert ops.box_mindist.launches == before + 1


def test_share_gathers_at_k600_on_card(cuda):
    """share_gathers at k = 600 asks the selection for kk = 1200: the
    card answers as the CPU does (ids equal apart from swaps between
    ties, squared distances within 1e-3: a query that is a row of the
    collection sits at 0, where a square root magnifies rounding)."""
    data = randomwalk.generate(seed=8, n_series=4096, series_len=64)
    q = queries.noisy_queries(data, 16)
    want = search.search(isax.build(data, leaf_cap=64, device="cpu"), q,
                         600, visit_batch=4, share_gathers=True,
                         device="cpu")
    before = ops.lex_select.launches
    got = search.search(isax.build(data, leaf_cap=64), q, 600,
                        visit_batch=4, share_gathers=True)
    assert ops.lex_select.launches > before
    torch.testing.assert_close(got.dists.cpu() ** 2, want.dists ** 2, **TOL)
    diff = got.ids.cpu() != want.ids
    x = torch.as_tensor(data).double()
    qd = torch.as_tensor(q).double()

    def dist(ids):
        return ((x[ids.long()] - qd[:, None, :]) ** 2).sum(-1)

    assert bool(((dist(got.ids.cpu()) - dist(want.ids)).abs()[diff]
                 <= 1e-3).all())


BASELINES = {
    "graph": (lambda x, d: graph.build(x, m_links=8, device=d),
              lambda i, q, d: graph.query(i, q, 10, efs=32, device=d)),
    "imi": (lambda x, d: imi.build(x, kc=8, m=16, kmeans_iters=5, device=d),
            lambda i, q, d: imi.query(i, q, 10, G.ng(8), device=d)),
    "srs": (lambda x, d: srs.build(x, m=16, device=d),
            lambda i, q, d: srs.query(i, q, 10, G.delta_epsilon(0.9, 0.0),
                                      device=d)),
    "qalsh": (lambda x, d: qalsh.build(x, device=d),
              lambda i, q, d: qalsh.query(i, q, 10, device=d)),
}


@pytest.mark.parametrize("name", sorted(BASELINES))
def test_baseline_on_the_card_matches_the_cpu(cuda, name):
    """One index built on the card and copied to the CPU: the card's
    query (K3, K5, lex_select) answers as the plain versions do. rows
    and leaves equal, squared distances within 1e-3, and an id may
    differ only where the CPU's distances tie at that rank. QALSH's rows
    may differ: a query's rank on each line comes from a projection the
    card's GEMM rounds otherwise, and a query that is a row of the
    collection can land a rank apart."""
    data = randomwalk.generate(seed=9, n_series=4096, series_len=128)
    q = queries.noisy_queries(data, 16)
    make, ask = BASELINES[name]
    card = make(data, "cuda")
    cpu = to_device(card, "cpu")
    got, want = ask(card, q, "cuda"), ask(cpu, q, "cpu")
    assert got.ids.is_cuda
    for f in ("rows_scanned", "leaves_visited"):
        if name != "qalsh":
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    wd = want.dists.double() ** 2
    torch.testing.assert_close(got.dists.cpu().double() ** 2, wd, **TOL)
    near = (wd[:, 1:] - wd[:, :-1]).abs() <= 1e-3
    tie = torch.zeros_like(wd, dtype=torch.bool)
    tie[:, 1:] |= near
    tie[:, :-1] |= near
    assert not bool(((got.ids.cpu() != want.ids) & ~tie).any())


def _ties_only(got, want, data, q):
    """ids [B, k] of the card against the CPU's: equal, apart from swaps
    between ids at true squared distances within 1e-3."""
    diff = got.cpu() != want
    x = torch.as_tensor(data).double()
    qd = torch.as_tensor(q).double()

    def dist(ids):
        return ((x[ids.long()] - qd[:, None, :]) ** 2).sum(-1)

    assert bool(((dist(got.cpu()) - dist(want)).abs()[diff] <= 1e-3).all())


@pytest.mark.parametrize("ooc", [False, True])
def test_engine_on_the_card_matches_the_cpu(cuda, tmp_path, ooc):
    """The sharded engine (4 DSTree shards, replicas=2) built on the card
    answers as the same engine on the CPU, resident and spilled."""
    from repro_torch.core.engine import DistributedEngine
    from repro_torch.core.spec import IndexSpec, StoreSpec

    data = randomwalk.generate(seed=3, n_series=4096, series_len=256)
    q = queries.noisy_queries(data, 16)
    res = {}
    for dev in ("cuda", "cpu"):
        eng = DistributedEngine(shards=4, device=dev).build(
            data, index=IndexSpec("dstree", leaf_cap=64),
            store=StoreSpec(spill_dir=str(tmp_path / dev), replicas=2))
        try:
            res[dev] = eng.query(q, 10, G.exact(), ooc=ooc)
        finally:
            eng.close()
    got, want = res["cuda"], res["cpu"]
    assert got.ids.is_cuda and (got.stats is not None) == ooc
    torch.testing.assert_close(got.dists.cpu() ** 2, want.dists ** 2, **TOL)
    _ties_only(got.ids, want.ids, data, q)


def test_engine_owner_kill_fails_over_on_the_card(cuda, tmp_path):
    from repro_torch.core.engine import DistributedEngine
    from repro_torch.core.spec import IndexSpec, StoreSpec
    from repro_torch.fault import FaultInjector
    from repro_torch.serve.fault import RetryPolicy

    data = randomwalk.generate(seed=3, n_series=4096, series_len=256)
    q = queries.noisy_queries(data, 16)
    DistributedEngine(shards=4).build(
        data, index=IndexSpec("dstree", leaf_cap=64),
        store=StoreSpec(spill_dir=str(tmp_path), keep_resident=False,
                        replicas=2))
    eng = DistributedEngine.open_spill(StoreSpec(spill_dir=str(tmp_path),
                                                 keep_resident=False))
    try:
        clean = eng.query(q, 10, G.exact())
        res = eng.query(q, 10, G.exact(), ooc_opts={
            "fault": FaultInjector().kill_shard(1, replica=0),
            "retry": RetryPolicy(max_attempts=2, backoff_base_s=0.0)})
    finally:
        eng.close()
    st = clean.stats
    assert st.retries == st.failovers == st.shards_lost == 0
    assert res.stats.failovers == 1 and not res.stats.degraded
    assert torch.equal(res.ids, clean.ids)
    assert torch.equal(res.dists, clean.dists)


def _tombstoned_step(pattern, pq):
    """One iteration's inputs to refine_step at the card's scale: 16 lanes
    each pooling two leaves of 32 rows of length 256 (distinct rows), a
    tombstone mask either killing lane 1's first leaf whole (``leaf``) or
    all but 5 of the pool's 1024 rows (``sparse``: every lane has fewer
    live slots than kk = 2k), and a running top-k with one entry."""
    rng = np.random.default_rng(4)
    b, m, n, k = 16, 32, 256, 10
    r = b * 2 * m
    rows = rng.normal(size=(r, n)).astype(np.float32)
    ids = (rng.permutation(r) + 100).astype(np.int32)
    ids[r - 3:] = -1
    dead = np.zeros(r, bool)
    if pattern == "leaf":
        dead[2 * m:3 * m] = True
    else:
        dead[:] = True
        dead[rng.choice(r, 5, replace=False)] = False
    width = 2 * k if pq else k
    top_d = np.full((b, width), np.inf, np.float32)
    top_d[:, 0] = 0.5
    top_i = np.full((b, width), -1, np.int32)
    top_i[:, 0] = 50_000 + np.arange(b)
    row_idx = np.arange(r).reshape(b, 2 * m)
    pool = rng.integers(0, 256, size=(r, 16)).astype(np.uint8) if pq \
        else rows
    return dict(
        q=rng.normal(size=(b, n)).astype(np.float32), ids=ids,
        norms=(rows.astype(np.float64) ** 2).sum(1).astype(np.float32),
        luts=rng.random(size=(b, 16, 256)).astype(np.float32) if pq
        else None, dead=dead, pool=pool, row_idx=row_idx,
        valid=ids[row_idx] >= 0, top_d=top_d, top_i=top_i)


@pytest.mark.parametrize("pattern", ["leaf", "sparse"])
@pytest.mark.parametrize("corner", ["coop_raw", "coop_pq", "solo_pq"])
def test_tombstoned_refine_step_on_card(cuda, corner, pattern):
    """refine_step with ScoreCtx.dead on the card (K4, K6, K5) against the
    CPU's plain versions: a whole dead leaf and lanes with fewer live
    slots than kk; no dead row surfaces and the (inf, -1) tail matches."""
    from repro_torch.core import refine

    pq = corner.endswith("pq")
    share = corner.startswith("coop")
    x = _tombstoned_step(pattern, pq)
    kernel = {"coop_raw": ops.coop_score_select,
              "coop_pq": ops.pq_adc_select,
              "solo_pq": ops.pq_adc_batch}[corner]
    out = {}
    for dev in ("cuda", "cpu"):
        t = {key: None if v is None else torch.as_tensor(v, device=dev)
             for key, v in x.items()}
        ctx = refine.ScoreCtx(qf=t["q"], ids=t["ids"],
                              norms=None if pq else t["norms"],
                              luts=t["luts"], dead=t["dead"])
        before = kernel.launches
        out[dev] = refine.refine_step(
            ctx, t["pool"], t["row_idx"], t["row_idx"], t["valid"],
            t["top_d"], t["top_i"], share=share, pq=pq)
        assert kernel.launches == before + (dev == "cuda")
    (gd, gi), (wd, wi) = out["cuda"], out["cpu"]
    if pq:  # ADC sums run left to right on both: bit-equal
        assert torch.equal(gd.cpu(), wd) and torch.equal(gi.cpu(), wi)
    else:
        torch.testing.assert_close(gd.cpu(), wd, **TOL)
        rows = torch.as_tensor(x["pool"]).double()
        pos = torch.full((int(x["ids"].max()) + 1,), -1, dtype=torch.long)
        real = x["ids"] >= 0
        pos[torch.as_tensor(x["ids"][real]).long()] = torch.as_tensor(
            np.flatnonzero(real))
        qd = torch.as_tensor(x["q"]).double()

        def dist(i):
            p = pos[i.long().clamp(0, pos.shape[0] - 1)]
            d = ((rows[p.clamp_min(0)] - qd[:, None, :]) ** 2).sum(-1)
            return torch.where((i >= 0) & (i < 50_000) & (p >= 0), d,
                               torch.zeros_like(d))

        diff = gi.cpu() != wi
        assert bool(((dist(gi.cpu()) - dist(wi)).abs()[diff]
                     <= 1e-3).all())
    dead_cand = x["row_idx"][x["dead"][x["row_idx"]]] if pq \
        else x["ids"][x["dead"] & (x["ids"] >= 0)]
    assert not np.isin(gi.cpu().numpy(), dead_cand).any()
    if pattern == "sparse":
        assert bool((gi[:, -1] == -1).all())
        assert bool(torch.isinf(gd[:, -1]).all())


@pytest.mark.parametrize("ooc", [False, True])
def test_engine_with_writes_on_the_card_matches_the_cpu(cuda, tmp_path,
                                                        ooc):
    """The engine's write tier on the card answers as on the CPU, resident
    and spilled: inserts, a whole leaf's worth of deletes, a reinsert, a
    compaction into a segment, then more writes in the memtable."""
    from repro_torch.core.engine import DistributedEngine
    from repro_torch.core.spec import IndexSpec, StoreSpec

    data = randomwalk.generate(seed=3, n_series=4096, series_len=256)
    fresh = randomwalk.generate(seed=5, n_series=600, series_len=256)
    q = queries.noisy_queries(data, 16)
    res = {}
    for dev in ("cuda", "cpu"):
        eng = DistributedEngine(shards=4, device=dev).build(
            data, index=IndexSpec("dstree", leaf_cap=64),
            store=StoreSpec(spill_dir=str(tmp_path / dev)))
        try:
            new = eng.insert(fresh[:400])
            eng.delete(np.r_[np.arange(64), new[:7]])
            eng.insert(fresh[400:401], ids=[100])
            assert eng.compact()
            eng.insert(fresh[401:])
            eng.delete([200, int(new[300])])
            res[dev] = eng.query(q, 10, G.exact(), ooc=ooc)
        finally:
            eng.close()
    got, want = res["cuda"], res["cpu"]
    # rows by global id: the base, then the inserts in id order
    live = np.concatenate([data, fresh[:400], fresh[401:]])
    live[100] = fresh[400]
    torch.testing.assert_close(got.dists.cpu() ** 2, want.dists ** 2, **TOL)
    _ties_only(got.ids, want.ids, live, q)
    assert not np.isin(got.ids.cpu().numpy(),
                       np.r_[np.arange(64), 200]).any()


@pytest.mark.parametrize("ooc", [False, True])
def test_serve_front_on_the_card_matches_the_cpu(cuda, tmp_path, ooc):
    """The serving front over an engine on the card answers no-deadline
    requests (the exact tier) as the same front over the engine on the
    CPU, with a write applied through the write lane first."""
    from repro_torch.core.engine import DistributedEngine
    from repro_torch.core.spec import IndexSpec, StoreSpec
    from repro_torch.serve import AdmissionController, Request, ServeFront

    data = randomwalk.generate(seed=3, n_series=4096, series_len=256)
    fresh = randomwalk.generate(seed=5, n_series=64, series_len=256)
    q = queries.noisy_queries(data, 16)
    outs = {}
    for dev in ("cuda", "cpu"):
        eng = DistributedEngine(shards=4, device=dev).build(
            data, index=IndexSpec("dstree", leaf_cap=64),
            store=StoreSpec(spill_dir=str(tmp_path / dev),
                            keep_resident=not ooc))
        try:
            with ServeFront(eng, 10, max_batch=4,
                            admission=AdmissionController(64)) as front:
                front.submit_write("insert", rows=fresh).result(120)
                front.submit_write("delete", ids=np.arange(32)).result(120)
                ts = [front.submit(Request(
                    uid=i, prompt=np.zeros(2, np.int32), series=q[i]))
                      for i in range(len(q))]
                outs[dev] = [t.result(300) for t in ts]
            assert front.admission.depth == 0
        finally:
            eng.close()
    live = np.concatenate([data, fresh])
    got = torch.as_tensor(np.stack([o["ids"] for o in outs["cuda"]]))
    want = torch.as_tensor(np.stack([o["ids"] for o in outs["cpu"]]))
    gd = np.stack([o["dists"] for o in outs["cuda"]])
    wd = np.stack([o["dists"] for o in outs["cpu"]])
    assert all(o["kind"] == "exact" for o in outs["cuda"] + outs["cpu"])
    torch.testing.assert_close(torch.as_tensor(gd) ** 2,
                               torch.as_tensor(wd) ** 2, **TOL)
    _ties_only(got, want, live, q)
    assert not np.isin(got.numpy(), np.arange(32)).any()


def test_concurrent_queries_equal_serial_on_the_card(cuda, tmp_path):
    """engine.query from 6 threads on one card, resident and spilled,
    returns what serial calls return, bit for bit."""
    import threading

    from repro_torch.core.engine import DistributedEngine
    from repro_torch.core.spec import IndexSpec, StoreSpec

    data = randomwalk.generate(seed=3, n_series=4096, series_len=256)
    q = queries.noisy_queries(data, 16)
    plans = [(q[0:4], G.exact()), (q[4:8], G.epsilon(1.0)),
             (q[8:12], G.delta_epsilon(0.99, 1.0)), (q[12:16], G.ng(8)),
             (q[2:6], G.exact()), (q[6:10], G.ng(4))]
    eng = DistributedEngine(shards=4, device="cuda").build(
        data, index=IndexSpec("dstree", leaf_cap=64),
        store=StoreSpec(spill_dir=str(tmp_path / "spill")))
    try:
        for ooc in (False, True):
            serial = [eng.query(x, 10, g, ooc=ooc) for x, g in plans]
            for _round in range(2):
                out, err = [None] * len(plans), []

                def run(i, ooc=ooc, out=out, err=err):
                    try:
                        out[i] = eng.query(plans[i][0], 10, plans[i][1],
                                           ooc=ooc)
                    except BaseException as e:  # re-raised on the main thread below
                        err.append(e)

                ts = [threading.Thread(target=run, args=(i,))
                      for i in range(len(plans))]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(timeout=300)
                assert not any(t.is_alive() for t in ts)
                assert not err, err
                for got, want in zip(out, serial):
                    assert torch.equal(got.ids, want.ids)
                    assert torch.equal(got.dists, want.dists)
    finally:
        eng.close()


def _tree_to(tree, dev):
    return {k: _tree_to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["gemma2-2b", "minitron-8b"])
def test_model_on_the_card_matches_the_cpu(cuda, arch):
    """The smoke config in f32 (TF32 off), one set of weights: prefill
    logits, its cache and one decode step on the card equal the CPU's
    within atol = rtol = 1e-4."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.models import params as P

    cfg = dataclasses.replace(get_smoke_config(arch),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    tree = P.initialize(M.model_specs(cfg), 0, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for dev in ("cpu", cuda):
            model = M.Model(cfg, _tree_to(tree, dev))
            lg, cache = M.prefill(model, {"tokens": toks.to(dev)}, cfg,
                                  capacity=17)
            dl, _ = M.decode_step(model, toks[:, :1].to(dev), cache, 16,
                                  cfg)
            out[str(dev)] = (lg.cpu(), cache["blocks"]["sub0"]["k"].cpu(),
                             dl.cpu())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_generate_on_the_card(cuda):
    """generate with the entry point's default device: greedy tokens in
    f32 equal the CPU's; bf16 tokens are in range, the cache on the
    card."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.models import params as P
    from repro_torch.serve.serve_step import generate

    cfg = get_smoke_config("gemma2-2b")
    model = M.Model.init(cfg, 0)
    assert model.device.type == "cuda"
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (3, 6)).astype(np.int32)
    toks, aux = generate(model, cfg, prompt, 8)
    assert toks.device.type == "cuda" and toks.shape == (3, 8)
    assert bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    assert aux["cache"]["blocks"]["sub0"]["k"].shape[2] == 14
    f32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    tree = P.initialize(M.model_specs(f32), 0, "cpu")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got, _ = generate(M.Model(f32, _tree_to(tree, cuda)), f32, prompt, 8)
        want, _ = generate(M.Model(f32, tree), f32, prompt, 8)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert torch.equal(got.cpu(), want)


def _no_tf32(fn):
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("b,s", [(2, 48), (4, 1)])
def test_moe_apply_on_the_card_matches_the_cpu(cuda, b, s):
    """f32 (TF32 off), prefill and a decode step's t = B: the routed ids
    and the dispatch rows equal the CPU's, the output and the aux values
    within atol = rtol = 1e-4."""
    from repro_torch.models import moe
    from repro_torch.models import params as P

    cfg = moe.MoEConfig(num_experts=8, top_k=2, d_ff_expert=48,
                        num_shared=1, capacity_factor=1.0)
    tree = P.initialize(moe.moe_specs(32, cfg, torch.float32), 0, "cpu")
    x = torch.randn(b, s, 32, generator=torch.Generator().manual_seed(3))

    def run(dev):
        p = _tree_to(tree, dev)
        xd = x.to(dev)
        _, idx, _ = moe._route(torch.matmul(xd.reshape(b * s, 32),
                                            p["router"]), cfg)
        out, aux = moe.moe_apply(p, xd, cfg)
        dest = moe.dispatch(idx, 8, moe.capacity(b * s, cfg))[2]
        return (idx.cpu(), dest.cpu(), out.cpu(),
                {k: float(v) for k, v in aux.items()})

    gi, gd, go, ga = _no_tf32(lambda: run(cuda))
    ci, cd, co, ca = run("cpu")
    assert torch.equal(gi, ci) and torch.equal(gd, cd)
    torch.testing.assert_close(go, co, atol=1e-4, rtol=1e-4)
    for k in ca:
        assert abs(ga[k] - ca[k]) <= 1e-4 + 1e-4 * abs(ca[k])


def test_ssm_on_the_card_matches_the_cpu(cuda):
    """ssm_apply with its cache at a length the chunk does not divide, then
    two decode steps, two groups, f32 (TF32 off)."""
    from repro_torch.models import params as P
    from repro_torch.models import ssm

    cfg = ssm.SSMConfig(d_model=32, d_state=8, head_dim=8, n_groups=2,
                        chunk=16)
    tree = P.initialize(ssm.ssm_specs(cfg, torch.float32), 0, "cpu")
    tree["A_log"] = torch.linspace(-1, 1, cfg.n_heads)
    u = torch.randn(2, 26, 32, generator=torch.Generator().manual_seed(4))

    def run(dev):
        p = _tree_to(tree, dev)
        out, cache = ssm.ssm_apply(p, u[:, :24].to(dev), cfg,
                                   return_cache=True)
        outs = [out]
        for t in (24, 25):
            o, cache = ssm.ssm_decode_step(p, u[:, t:t + 1].to(dev), cache,
                                           cfg)
            outs.append(o)
        return [o.cpu() for o in outs] + [cache[k].cpu() for k in
                                          sorted(cache)]

    for got, want in zip(_no_tf32(lambda: run(cuda)), run("cpu")):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_hybrid_model_on_the_card_matches_the_cpu(cuda):
    """jamba's smoke config (mamba, attention, dense and MoE sub-layers) in
    f32 (TF32 off): prefill logits, every cache entry and two decode steps
    on the card equal the CPU's within atol = rtol = 1e-4."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.models import params as P

    cfg = dataclasses.replace(get_smoke_config("jamba-v0.1-52b"),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    tree = P.initialize(M.model_specs(cfg), 0, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 24),
                         generator=torch.Generator().manual_seed(1))

    def run(dev):
        model = M.Model(cfg, _tree_to(tree, dev))
        lg, cache = M.prefill(model, {"tokens": toks.to(dev)}, cfg,
                              capacity=26)
        outs = [lg]
        for pos in (24, 25):
            lg, cache = M.decode_step(model, toks[:, pos - 24:pos - 23].to(
                dev), cache, pos, cfg)
            outs.append(lg)
        outs += [t for e in cache["blocks"].values() for t in e.values()]
        return [t.cpu() for t in outs]

    for got, want in zip(_no_tf32(lambda: run(cuda)), run("cpu")):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_seamless_decoder_layer_on_the_card_matches_the_cpu(cuda):
    """seamless's smoke config in f32 (TF32 off): encode, one decoder
    layer with its real cross cache, prefill at a capacity past S and a
    decode step on the card equal the CPU's within atol = rtol = 1e-4."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import encdec as E
    from repro_torch.models import model as M
    from repro_torch.models import params as P

    cfg = dataclasses.replace(get_smoke_config("seamless-m4t-medium"),
                              num_layers=1, param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    tree = P.initialize(M.model_specs(cfg), 0, "cpu")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=g)
    frames = torch.randn(2, 10, cfg.d_model, generator=g)

    def run(dev):
        model = M.Model(cfg, _tree_to(tree, dev))
        enc = E.encode(model["encdec"], frames.to(dev), cfg)
        lg, cache = M.prefill(model, {"tokens": toks.to(dev),
                                      "frames": frames.to(dev)}, cfg,
                              capacity=13)
        dl, _ = M.decode_step(model, toks[:, :1].to(dev), cache, 12, cfg)
        return [t.cpu() for t in (enc, lg, cache["ck"], cache["k"], dl)]

    got = _no_tf32(lambda: run(cuda))
    for a, b in zip(got, run("cpu")):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["minitron-8b", "deepseek-moe-16b",
                                  "seamless-m4t-medium"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """One loss_and_grads in f32 (TF32 off): the loss and every gradient
    leaf within atol = rtol = 1e-4 of the leaf's largest magnitude; then
    optimizer.apply given the CPU's gradients within 1e-6."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.data.tokens import batch_at_step
    from repro_torch.models import model as M
    from repro_torch.models import params as P
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_step import loss_and_grads

    cfg = dataclasses.replace(get_smoke_config(arch),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    tree = P.initialize(M.model_specs(cfg), 0, "cpu")
    batch = batch_at_step(0, 0, 2, 16, cfg.vocab_size)
    if cfg.is_encdec:
        batch["frames"] = torch.randn(
            2, cfg.encoder_frames, cfg.d_model,
            generator=torch.Generator().manual_seed(2))

    def run(dev):
        model = M.Model(cfg, _tree_to(tree, dev))
        loss, _, grads = loss_and_grads(
            model, {k: v.to(dev) for k, v in batch.items()}, cfg)
        return model, loss.cpu(), {k: g.cpu() for k, g in grads.items()}

    card, loss_g, grads_g = _no_tf32(lambda: run(cuda))
    cpu, loss_c, grads_c = run("cpu")
    torch.testing.assert_close(loss_g, loss_c, atol=1e-4, rtol=1e-4)
    for k, want in grads_c.items():
        scale = float(want.abs().max())
        torch.testing.assert_close(grads_g[k], want, rtol=1e-4,
                                   atol=1e-4 * max(scale, 1e-30), msg=k)
    ocfg = O.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    O.apply(ocfg, card, {k: g.to(cuda) for k, g in grads_c.items()},
            O.init(ocfg, card))
    O.apply(ocfg, cpu, grads_c, O.init(ocfg, cpu))
    for k, want in cpu.reference_leaves().items():
        torch.testing.assert_close(card.reference_leaves()[k].cpu(), want,
                                   atol=1e-6, rtol=1e-6, msg=k)


def test_search_cell_measured_on_card(cuda):
    """lower_search's measured half on a 4096-row DSTree: the profiler
    sees the search's kernels, and the device is busy no longer than the
    step takes."""
    from repro_torch.launch import dryrun_search

    data = randomwalk.generate(seed=11, n_series=4096, series_len=64)
    idx = dstree.build(data, leaf_cap=64, device=cuda)
    q = torch.as_tensor(queries.noisy_queries(data, 16, seed=11),
                        device=cuda)
    for coop in (False, True):
        rep = dryrun_search.lower_search(
            n_per_shard=4096, series_len=64, leaf_cap=64, batch=16, k=10,
            nprobe=8, visit_batch=2, coop=coop, index=idx, queries=q)
        assert rep["kernels"] > 0
        assert 0 < rep["busy_seconds"] <= rep["measured_seconds"]
        assert rep["roofline_share"] > 0 and rep["device"]
        assert rep["search"]["loop_iterations"] >= 1


def test_decode_cell_measured_on_card(cuda):
    """A smoke-config decode step measured on the card and joined to its
    dry-run report (meta) as phase 15 of chip_smoke.py joins them."""
    from unittest import mock

    from repro_torch import configs
    from repro_torch.launch import dryrun, roofline
    from repro_torch.models import model as M

    cfg = configs.get_smoke_config("gemma2-2b")
    with mock.patch.object(dryrun, "get_config", configs.get_smoke_config):
        rep = dryrun.lower_cell("gemma2-2b", "decode_32k")
    model = M.Model.init(cfg, 0, cuda)
    cache = M.alloc_cache(cfg, 2, 64, cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 1), device=cuda)

    def step():
        M.decode_step(model, toks, cache, 63, cfg)

    with torch.no_grad():
        measured = roofline.profile_device(step, 3, inputs=(toks,))
    roofline.add_measured(rep, measured)
    assert rep["kernels"] > 0
    assert 0 < rep["busy_seconds"] <= rep["measured_seconds"]
    assert rep["roofline_bound"] in ("compute", "memory")
    assert rep["peak_bytes"] > 0
    with pytest.raises(ValueError, match="on the card"):
        roofline.profile_device(step, 1, inputs=(toks.cpu(),))


def test_fit_on_a_mesh_of_one_equals_the_one_card_fit(cuda):
    """fit(mesh=) at world 1 over NCCL on a (1, 1) mesh, the smoke config
    of minitron-8b in bf16: its parameters DTensors, its losses and
    parameters the one-card fit's bit for bit (deterministic algorithms
    on for both: the embedding's backward otherwise adds atomically)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import mesh as M
    from repro_torch.launch.train import fit

    cfg = get_smoke_config("minitron-8b")
    kw = dict(steps=3, batch=2, seq=32, seed=4, device="cuda")
    saved = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    M.init_world("cuda")
    try:
        mesh = M.make_mesh((1, 1), ("data", "model"), "cuda")
        got = fit(cfg, mesh=mesh, **kw)
        want = fit(cfg, **kw)
        assert got["losses"] == want["losses"]
        mine = got["params"].reference_leaves()
        for k, v in want["params"].reference_leaves().items():
            assert isinstance(mine[k], DTensor)
            assert torch.equal(mine[k].to_local(), v), k
    finally:
        torch.use_deterministic_algorithms(saved)
        M.destroy_world()
