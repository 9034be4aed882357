"""repro_torch's write tier against the JAX package's, on the CPU, on
identical inputs: the delta tier itself, the memtable's scoring, the
tombstone fold in all four corners of refine_step, the searches' dead /
n_override hooks, the joint N, and one mutation script run on both
engines (at tests/test_delta.py's size: 256 random walks of length 64,
two DSTree shards with leaf_cap 32, k = 5).

Distances follow the engine rule of the port's other parity tests: the
port scores q.q - 2 q.x + x.x with torch's f32 arithmetic, in another
order than XLA's, so they are held to rtol 1e-5, atol 1e-4; ids and the
visit counts are equal.
"""

import os
import shutil
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import IndexSpec as JIndexSpec
from repro.core import StoreSpec as JStoreSpec
from repro.core import guarantees as JG
from repro.core import refine as jrefine
from repro.core import search as JS
from repro.core.engine import DistributedEngine as JEngine
from repro.core.indexes import dstree as jdstree
from repro.store import layout as jlayout
from repro.store import ooc as jooc
from repro.store.delta import DeltaTier as JDeltaTier
from repro.store.delta import search_snapshot as j_search_snapshot
from repro_torch.core import guarantees as G
from repro_torch.core import refine
from repro_torch.core import search as S
from repro_torch.core.engine import DistributedEngine, _pad_shard
from repro_torch.core.spec import IndexSpec, StoreSpec
from repro_torch.store import load_index, search_ooc
from repro_torch.store.delta import DeltaTier, search_snapshot

N, L, K, SHARDS = 256, 64, 5, 2
DIST_TOL = dict(rtol=1e-5, atol=1e-4)
GUARANTEES = {
    "exact": (JG.exact(), G.exact()),
    "eps": (JG.epsilon(1.0), G.epsilon(1.0)),
    "delta_eps": (JG.delta_epsilon(0.99, 0.5), G.delta_epsilon(0.99, 0.5)),
    "ng": (JG.ng(4), G.ng(4)),
}
# a delta loose enough that r_delta stops lanes on this walk, and moves
# with the row count
DELTA_HALF = (JG.delta_epsilon(0.5), G.delta_epsilon(0.5))
PQ_GUARANTEES = ("eps", "delta_eps", "ng")


def _znorm(x):
    return ((x - x.mean(1, keepdims=True))
            / (x.std(1, keepdims=True) + 1e-9)).astype(np.float32)


@pytest.fixture(scope="module")
def walk():
    rng = np.random.default_rng(7)
    base = _znorm(np.cumsum(rng.normal(size=(N, L)), axis=1))
    q = _znorm(base[rng.choice(N, 6, replace=False)]
               + 0.05 * rng.normal(size=(6, L)))
    fresh = _znorm(np.cumsum(rng.normal(size=(24, L)), axis=1))
    return base, q, fresh


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DIST_TOL)


# ----------------------------------------------------------- the tier
def _tier_script(tier_cls, fresh):
    """A seeded write sequence; returns every snapshot and freeze batch
    it produced, and the tier."""
    rng = np.random.default_rng(5)
    tier = tier_cls(L, start_id=N)
    seen = []
    new = tier.insert(fresh[:6])
    tier.delete([3, int(new[1]), 10_000])          # base, delta, unknown
    tier.insert(fresh[6:8], ids=[42, int(new[0])])  # reinsert base, delta
    seen.append(tier.snapshot())
    batch = tier.begin_freeze()
    seen.append(batch)
    seen.append(tier.begin_freeze())               # one freeze at a time
    tier.insert(fresh[8:11])
    tier.delete([int(new[2]), int(new[4])])         # kills in the frozen batch
    seen.append(tier.snapshot())
    tier.publish_segment("seg_a")
    seen.append(tier.snapshot())
    tier.insert(fresh[11:14], ids=rng.choice(N, 3, replace=False))
    seen.append(tier.begin_freeze())
    tier.insert(fresh[14:16], ids=[int(new[3]), N + 100])
    tier.abort_freeze()                            # folds back, newest wins
    seen.append(tier.snapshot())
    tier.delete(tier.snapshot().ids[:2])
    seen.append(tier.begin_freeze())
    tier.publish_segment("seg_b")
    seen.append(tier.snapshot())
    return seen, tier


@pytest.fixture(scope="module")
def tiers(walk):
    _, _, fresh = walk
    return _tier_script(JDeltaTier, fresh), _tier_script(DeltaTier, fresh)


def test_delta_tier_matches_reference_step_by_step(tiers):
    (want, jtier), (got, tier) = tiers
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert type(a).__name__ == type(b).__name__, i
        if b is None:
            continue
        np.testing.assert_array_equal(a.ids, b.ids)
        assert a.ids.dtype == b.ids.dtype == np.int32
        np.testing.assert_array_equal(a.rows, b.rows)
        if hasattr(b, "born_seq"):
            assert a.born_seq == b.born_seq, i
        else:
            assert a.kills == b.kills, i
            assert a.kills_version == b.kills_version, i
            assert a.live_rows == b.live_rows, i
            assert a.segments == b.segments, i
            for born in (0, 5, 12):
                np.testing.assert_array_equal(
                    a.dead_mask(np.arange(-1, N + 40), born, pad_to=400),
                    b.dead_mask(np.arange(-1, N + 40), born, pad_to=400))
    assert tier.kills_version == jtier.kills_version
    assert tier.segments() == jtier.segments() == ("seg_a", "seg_b")
    assert tier.live_rows() == jtier.live_rows()


@pytest.mark.parametrize("codec", ["f32", "bf16", "pq"])
def test_search_snapshot_matches_reference(tiers, walk, codec):
    (want, _), (got, _) = tiers
    _, q, _ = walk
    for a, b in ((got[0], want[0]), (got[-1], want[-1])):
        wd, wi = j_search_snapshot(b, jnp.asarray(q), K, codec=codec)
        gd, gi = search_snapshot(a, torch.as_tensor(q), K, codec=codec)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        _close(gd, wd)
    empty = DeltaTier(L).snapshot()
    gd, gi = search_snapshot(empty, torch.as_tensor(q), K, codec=codec)
    assert bool((gi == -1).all()) and bool(torch.isinf(gd).all())


def test_joint_n_total_matches_reference():
    for base_n, dead, live in [(256, 0, 0), (256, 40, 10), (256, 3, 90),
                               (0, 0, 0), (1000, 1000, 0), (5, 2, 1)]:
        assert G.joint_n_total(base_n, dead, live) \
            == JG.joint_n_total(base_n, dead, live)


# ------------------------------------------ refine_step with tombstones
def _step_inputs(pattern: str):
    """One iteration's candidates over a pool of 12 leaves of 8 rows: lane
    b visits leaves 2b and 2b + 1 (distinct rows across lanes, as the
    cooperative precondition needs), the last row of leaf 7 is padding.
    ``leaf``: leaf 2, lane 1's first, is dead whole; ``sparse``: all but
    three rows of the pool are dead, so every lane has fewer live slots
    than the selection's kk = 2k, and with one entry in its running top-k
    fewer than k."""
    rng = np.random.default_rng(11)
    b, m, n, r = 4, 8, 16, 96
    rows = rng.normal(size=(r, n)).astype(np.float32)
    q = rng.normal(size=(b, n)).astype(np.float32)
    ids = rng.permutation(r).astype(np.int32) + 500
    ids[7 * m + m - 1] = -1
    row_idx = np.stack([np.arange(2 * lane * m, (2 * lane + 2) * m)
                        for lane in range(b)])
    valid = ids[row_idx] >= 0
    dead = np.zeros(r, bool)
    if pattern == "leaf":
        dead[2 * m:3 * m] = True
    else:
        dead[:] = True
        dead[[0, 9, 50]] = False
    codes = rng.integers(0, 256, size=(r, 4)).astype(np.uint8)
    luts = rng.random(size=(b, 4, 256)).astype(np.float32)
    # running top-k from an earlier iteration: one real entry, then
    # (inf, -1)
    top_d = np.sort(rng.random(size=(b, 2 * K)).astype(np.float32) * 40,
                    1)
    top_d[:, 1:] = np.inf
    top_i = np.where(np.isfinite(top_d),
                     np.arange(2 * K)[None] + 1000 + 100 * np.arange(b)[:, None],
                     -1).astype(np.int32)
    return dict(rows=rows, q=q, ids=ids, row_idx=row_idx, valid=valid,
                dead=dead, codes=codes, luts=luts, top_d=top_d, top_i=top_i)


@pytest.mark.parametrize("pattern", ["leaf", "sparse"])
@pytest.mark.parametrize("share", [False, True], ids=["solo", "coop"])
@pytest.mark.parametrize("pq", [False, True], ids=["raw", "pq"])
def test_refine_step_folds_tombstones_like_reference(pattern, share, pq):
    x = _step_inputs(pattern)
    norms = (x["rows"].astype(np.float64) ** 2).sum(1).astype(np.float32)
    width = 2 * K if pq else K
    pool = x["codes"] if pq else x["rows"]
    jctx = jrefine.ScoreCtx(qf=jnp.asarray(x["q"]),
                            ids=jnp.asarray(x["ids"]),
                            norms=None if pq else jnp.asarray(norms),
                            luts=jnp.asarray(x["luts"]) if pq else None,
                            dead=jnp.asarray(x["dead"]))
    ctx = refine.ScoreCtx(qf=torch.as_tensor(x["q"]),
                          ids=torch.as_tensor(x["ids"]),
                          norms=None if pq else torch.as_tensor(norms),
                          luts=torch.as_tensor(x["luts"]) if pq else None,
                          dead=torch.as_tensor(x["dead"]))
    top_d, top_i = x["top_d"][:, :width], x["top_i"][:, :width]
    ri = x["row_idx"]
    wd, wi = jrefine.refine_step(
        jctx, jnp.asarray(pool), jnp.asarray(ri, jnp.int32),
        jnp.asarray(ri, jnp.int32), jnp.asarray(x["valid"]),
        jnp.asarray(top_d), jnp.asarray(top_i), share=share, pq=pq)
    gd, gi = refine.refine_step(
        ctx, torch.as_tensor(pool), torch.as_tensor(ri),
        torch.as_tensor(ri), torch.as_tensor(x["valid"]),
        torch.as_tensor(top_d), torch.as_tensor(top_i), share=share, pq=pq)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    _close(gd, wd)
    # no dead row surfaces: raw candidates are ids, pq ones row positions
    dead_cand = x["row_idx"][x["dead"][x["row_idx"]]] if pq \
        else x["ids"][x["dead"] & (x["ids"] >= 0)]
    assert not np.isin(gi.numpy(), dead_cand).any()
    if pattern == "sparse":
        # the (inf, -1) tail, in the reference's order (checked above)
        assert bool((gi[:, -1] == -1).all())
        assert bool(torch.isinf(gd[:, -1]).all())


# --------------------------------------- the searches' write-tier hooks
@pytest.fixture(scope="module")
def ref_index(walk, tmp_path_factory):
    base, _, _ = walk
    index = jdstree.build(base, leaf_cap=32)
    root = tmp_path_factory.mktemp("delta_parity_store")
    path = jlayout.save_index(index, str(root / "f32"), codec="f32")
    ids = np.asarray(index.ids)
    dead = np.isin(ids, np.r_[np.arange(32), 77, 150])
    return index, path, dead


@pytest.mark.parametrize("gname", ["exact", "delta_half"])
def test_search_with_dead_and_n_override_matches_reference(walk, ref_index,
                                                           gname):
    _, q, _ = walk
    index, path, dead = ref_index
    jg, g = GUARANTEES[gname] if gname != "delta_half" else DELTA_HALF
    mine = load_index(path, device="cpu")
    leaves = {}
    for n_over in (None, 8, 40 * N):
        want = JS.search(index, jnp.asarray(q), K, jg,
                         dead=jnp.asarray(dead), n_override=n_over)
        got = S.search(mine, q, K, g, dead=dead, n_override=n_over,
                       device="cpu")
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
        np.testing.assert_array_equal(got.leaves_visited.numpy(),
                                      np.asarray(want.leaves_visited))
        np.testing.assert_array_equal(got.rows_scanned.numpy(),
                                      np.asarray(want.rows_scanned))
        _close(got.dists, want.dists)
        assert not np.isin(got.ids.numpy(),
                           np.asarray(index.ids)[dead]).any()
        leaves[n_over] = got.leaves_visited.tolist()
    if gname == "delta_half":
        # r_delta grows as N falls: the override reached the stop test
        assert leaves[8] != leaves[None]


@pytest.mark.parametrize("share", [False, True])
def test_search_ooc_with_dead_and_n_override_matches_reference(
        walk, ref_index, share):
    _, q, _ = walk
    _, path, dead = ref_index
    jg, g = DELTA_HALF
    jstore = jlayout.load_index(path, resident="summaries")
    store = load_index(path, resident="summaries", device="cpu")
    want = jooc.search_ooc(jstore, jnp.asarray(q), K, jg, cache_leaves=4,
                           share_gathers=share, dead=dead,
                           n_override=8)
    # the port pads a short mask to the store's padded rows with False
    assert not dead[N - 3:].any()
    got = search_ooc(store, q, K, g, cache_leaves=4, share_gathers=share,
                     dead=dead[:N - 3], n_override=8)
    np.testing.assert_array_equal(got.result.ids.numpy(),
                                  np.asarray(want.result.ids))
    np.testing.assert_array_equal(got.result.leaves_visited.numpy(),
                                  np.asarray(want.result.leaves_visited))
    np.testing.assert_array_equal(got.result.rows_scanned.numpy(),
                                  np.asarray(want.result.rows_scanned))
    _close(got.result.dists, want.result.dists)
    assert got.stats.iterations == want.stats.iterations


# --------------------------------------------------- the engines
def _mutations(eng, fresh):
    """The mutation script, run on either engine: a generator that stops
    after each of its two phases."""
    new = np.asarray(eng.insert(fresh[:12]))
    eng.delete(np.r_[np.arange(32), 77, new[2]])   # a whole leaf and more
    eng.insert(fresh[12:13], ids=[150])            # a base id, new row
    yield
    assert eng.compact()
    eng.insert(fresh[13:20])
    eng.delete([int(new[5]), 100, int(new[0])])
    yield


def _run_script(eng, fresh, q, gnames, side):
    """Each phase's answers by guarantee name; ``side`` 0 runs the
    reference's guarantees, 1 the port's."""
    answers = []
    for _ in _mutations(eng, fresh):
        phase = {}
        for gname in gnames:
            g = GUARANTEES[gname][side]
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                phase[gname] = eng.query(jnp.asarray(q) if side == 0 else q,
                                         K, g)
        answers.append(phase)
    return answers


@pytest.fixture(scope="module")
def engines(walk, tmp_path_factory):
    """The reference engine's spills (f32, pq) and its answers to the
    mutation script; a copy of each spill for the port, whose segments
    must not land beside the reference's."""
    base, q, fresh = walk
    out = {}
    for codec in ("f32", "pq"):
        root = tmp_path_factory.mktemp(f"delta_parity_{codec}")
        spill = str(root / "ref")
        # pq trains its codebook on one shard's rows: 256 needed
        eng = JEngine(mesh=None, method="dstree",
                      shards=SHARDS if codec == "f32" else 1)
        eng.build(base, index=JIndexSpec("dstree", leaf_cap=32),
                  store=JStoreSpec(spill_dir=spill, codec=codec,
                                   keep_resident=False))
        mine = str(root / "port")
        shutil.copytree(spill, mine)
        gnames = sorted(GUARANTEES) if codec == "f32" else PQ_GUARANTEES
        try:
            want = _run_script(eng, fresh, q, gnames, 0)
        finally:
            eng.close()
        out[codec] = (mine, want, gnames)
    return out


def _assert_engine_same(got, want, *, lb_extra=0):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.leaves_visited.numpy(),
                                  np.asarray(want.leaves_visited))
    np.testing.assert_array_equal(got.rows_scanned.numpy(),
                                  np.asarray(want.rows_scanned))
    assert got.lb_computed == int(want.lb_computed) + lb_extra
    _close(got.dists, want.dists)


@pytest.mark.parametrize("codec", ["f32", "pq"])
def test_engine_mutation_script_matches_reference_spilled(walk, engines,
                                                          codec):
    """The port opens the reference's spill and runs the script: equal
    answers before and after compaction (f32); for pq only before it,
    since the segments' codebooks come from other seeds."""
    _, q, fresh = walk
    mine, want, gnames = engines[codec]
    eng = DistributedEngine.open_spill(
        StoreSpec(spill_dir=mine, keep_resident=False), device="cpu")
    try:
        got = _run_script(eng, fresh, q, gnames, 1)
    finally:
        eng.close()
    phases = 2 if codec == "f32" else 1
    for p in range(phases):
        for gname in gnames:
            _assert_engine_same(got[p][gname], want[p][gname])
    writers = os.listdir(os.path.join(mine, "segments"))
    assert len(writers) == 1
    assert os.listdir(os.path.join(mine, "segments", writers[0])) == [
        "seg_0000"]


def test_engine_mutation_script_matches_reference_resident(walk, engines,
                                                           tmp_path):
    """Resident shards made from the reference's arrays run the script
    and answer as the reference's out-of-core engine does. lb_computed
    counts each shard padded to the widest shard's leaves."""
    _, q, fresh = walk
    mine, want, gnames = engines["f32"]
    shards = [load_index(os.path.join(mine, f"shard_{si:04d}"),
                         device="cpu") for si in range(SHARDS)]
    n_leaves = max(sh.num_leaves for sh in shards)
    n_rows = max(sh.data.shape[0] for sh in shards)
    eng = DistributedEngine(
        shards=SHARDS, device="cpu",
        resident=tuple(_pad_shard(sh, n_leaves, n_rows) for sh in shards),
        index_spec=IndexSpec("dstree", leaf_cap=32),
        store_spec=StoreSpec(spill_dir=str(tmp_path)))
    try:
        got = _run_script(eng, fresh, q, gnames, 1)
    finally:
        eng.close()
    pad = SHARDS * n_leaves - sum(sh.num_leaves for sh in shards)
    for p in range(2):
        for gname in gnames:
            _assert_engine_same(got[p][gname], want[p][gname], lb_extra=pad)
