"""repro_torch's write tier against its own rebuild: the cases of the
reference's tests/test_delta.py, on the CPU at that file's size (256
random walks of length 64, 6 queries, k = 5, DSTree with leaf_cap 32,
two shards served out of core).

Frozen+delta serving must equal an engine rebuilt from scratch over the
same live rows: ids, and distances bit for bit on the f32 legs (within 4
ulp on bf16 and pq, as the reference allows), before and after
compaction. The oracle is a second port engine whose array-order ids are
mapped to global ids; live ids are kept ascending so that the rebuild's
(distance, id) tie order is the mutated engine's. The f32 legs run on
resident shards too, which the reference tests only through its mesh.
"""

import threading

import numpy as np
import pytest
import torch

from repro_torch.core import guarantees as G
from repro_torch.core.engine import DistributedEngine
from repro_torch.core.spec import IndexSpec, StoreSpec
from repro_torch.obs import LockOrderRecorder
from repro_torch.store.delta import DeltaTier

N, L, K = 256, 64, 5

# exact, epsilon, delta-epsilon and ng; ng at a saturating nprobe (every
# leaf visited), since the rebuild's tree has another shape
TAXONOMY = (G.exact(), G.epsilon(1.0), G.delta_epsilon(0.99, 0.5),
            G.ng(64))


def _znorm(x):
    return ((x - x.mean(1, keepdims=True))
            / (x.std(1, keepdims=True) + 1e-9)).astype(np.float32)


def _dataset(seed=7, n=N):
    rng = np.random.default_rng(seed)
    base = _znorm(np.cumsum(rng.normal(size=(n, L)), axis=1))
    q = _znorm(base[rng.choice(n, 6, replace=False)]
               + 0.05 * rng.normal(size=(6, L)))
    fresh = _znorm(np.cumsum(rng.normal(size=(16, L)), axis=1))
    return base, q, fresh


def _build(rows, spill, *, codec="f32", shards=2, resident=False,
           **store_kw):
    return DistributedEngine(shards=shards, device="cpu").build(
        rows, index=IndexSpec("dstree", leaf_cap=32),
        store=StoreSpec(spill_dir=spill, codec=codec,
                        keep_resident=resident, **store_kw))


def _assert_parity(eng, live_rows, live_ids, queries, spill, tag, *,
                   codec="f32", shards=2, resident=False,
                   guarantees=TAXONOMY, ooc_opts=None, ulp=0):
    """eng's answers equal a rebuild's: ids, and distances within ``ulp``
    units in the last place (0: bit for bit)."""
    assert np.all(np.diff(live_ids) > 0), "the oracle needs ascending ids"
    oracle = _build(live_rows, spill, codec=codec, shards=shards,
                    resident=resident)
    try:
        for g in guarantees:
            r = eng.query(queries, K, g, ooc_opts=ooc_opts)
            o = oracle.query(queries, K, g, ooc_opts=ooc_opts)
            oi = live_ids[o.ids.numpy()]
            assert np.array_equal(r.ids.numpy(), oi), \
                f"{tag} [{g.kind}]: ids diverge from the rebuild"
            rd, od = r.dists.numpy(), o.dists.numpy()
            tol = ulp * np.spacing(np.maximum(np.abs(rd), np.abs(od)))
            assert np.all(np.abs(rd - od) <= tol), \
                f"{tag} [{g.kind}]: dists diverge from the rebuild " \
                f"(max {np.abs(rd - od).max()}, tol {ulp} ulp)"
    finally:
        oracle.close()


# ----------------------------------------------------- codec x taxonomy
@pytest.mark.parametrize("codec,resident", [
    ("f32", False), ("bf16", False), ("pq", False), ("f32", True)],
    ids=["f32", "bf16", "pq", "f32-resident"])
def test_mutation_parity_across_codecs_and_taxonomy(tmp_path, codec,
                                                    resident):
    """Insert and delete, parity over the taxonomy, then compact and check
    again: the published segment moves no bit. pq runs one shard (its
    codebook needs 256 rows) with a re-rank wide enough to cover every
    candidate, and only delta-epsilon and saturating ng: the codebooks
    of the engine and of the rebuild differ, and pq cannot honour exact."""
    shards = 1 if codec == "pq" else 2
    opts = {"rerank": 64} if codec == "pq" else None
    ulp = 0 if codec == "f32" else 4
    gs = TAXONOMY if codec != "pq" else (G.delta_epsilon(0.99, 0.5),
                                         G.ng(64))
    base, q, fresh = _dataset()
    eng = _build(base, str(tmp_path / "sp"), codec=codec, shards=shards,
                 resident=resident)
    kw = dict(codec=codec, shards=shards, resident=resident, ooc_opts=opts,
              ulp=ulp, guarantees=gs)
    try:
        new_ids = np.asarray(eng.insert(fresh))
        eng.delete([3, 77, int(new_ids[2])])
        live_rows = np.concatenate([np.delete(base, [3, 77], axis=0),
                                    np.delete(fresh, [2], axis=0)])
        live_ids = np.concatenate([np.delete(np.arange(N), [3, 77]),
                                   np.delete(new_ids, [2])]).astype(np.int64)
        _assert_parity(eng, live_rows, live_ids, q, str(tmp_path / "o1"),
                       "pre-compact", **kw)
        assert eng.compact()
        _assert_parity(eng, live_rows, live_ids, q, str(tmp_path / "o2"),
                       "post-compact", **kw)
    finally:
        eng.close()


# ------------------------------------------------- delete-then-reinsert
def test_delete_then_reinsert_same_id(tmp_path):
    """The reinsert's kill masks the frozen copy and the new row is the
    newest by construction: parity holds with the row replaced in the
    oracle (ids unchanged, still ascending)."""
    base, q, fresh = _dataset()
    rid = 42
    eng = _build(base, str(tmp_path / "sp"))
    try:
        eng.delete([rid])
        gone = eng.query(base[rid:rid + 1], K, G.exact())
        assert rid not in gone.ids.numpy()

        replacement = fresh[0]
        got = np.asarray(eng.insert(replacement, ids=[rid]))
        assert got.tolist() == [rid]
        hit = eng.query(replacement[None], 1, G.exact())
        assert int(hit.ids[0, 0]) == rid
        assert float(hit.dists[0, 0]) == 0.0

        live_rows = base.copy()
        live_rows[rid] = replacement
        live_ids = np.arange(N, dtype=np.int64)
        _assert_parity(eng, live_rows, live_ids, q, str(tmp_path / "o1"),
                       "reinserted")
        # the old bytes stay dead after the memtable freezes
        assert eng.compact()
        _assert_parity(eng, live_rows, live_ids, q, str(tmp_path / "o2"),
                       "reinserted+compacted")
    finally:
        eng.close()


# --------------------------------------------------- delete out of a top-k
def test_delete_of_row_in_running_topk(tmp_path):
    """Every lane's rank-1 id tombstoned between queries: the next query
    surfaces none of them, and the refilled top-k equals a rebuild's
    without those rows."""
    base, q, _ = _dataset()
    eng = _build(base, str(tmp_path / "sp"))
    try:
        first = eng.query(q, K, G.exact())
        victims = sorted(set(first.ids.numpy()[:, 0].tolist()))
        eng.delete(victims)
        second = eng.query(q, K, G.exact())
        assert not np.isin(second.ids.numpy(), victims).any()
        keep = ~np.isin(np.arange(N), victims)
        _assert_parity(eng, base[keep], np.arange(N, dtype=np.int64)[keep],
                       q, str(tmp_path / "o"), "topk-delete")
    finally:
        eng.close()


# --------------------------------------------- compaction vs queries
def test_compaction_racing_concurrent_query(tmp_path):
    """A writer streams inserts past the daemon's threshold while readers
    keep queries in flight: every answer in the race is well formed, at
    least one background compaction lands, the lock-order recorder's
    graph is acyclic, and the final state equals a rebuild."""
    base, q, _ = _dataset()
    rng = np.random.default_rng(13)
    stream = _znorm(np.cumsum(rng.normal(size=(96, L)), axis=1))
    eng = _build(base, str(tmp_path / "sp"), delta_max_rows=16,
                 auto_compact=True, compact_interval_s=0.005)
    rec = LockOrderRecorder()
    eng._write_lock = rec.wrap(eng._write_lock, "engine._write_lock")
    eng.enable_writes()
    eng._delta._lock = rec.wrap(eng._delta._lock, "delta._lock")
    errors = []

    def reader():
        try:
            for _ in range(8):
                ids = eng.query(q, K, G.exact()).ids.numpy()
                assert ids.shape == (len(q), K)
                assert (ids >= 0).all(), "padding surfaced mid-race"
        except BaseException as e:  # noqa: BLE001 re-raised on the main thread below: a thread swallows its exception and the test would pass vacuously
            errors.append(e)

    def writer():
        try:
            for i in range(0, len(stream), 8):
                eng.insert(stream[i:i + 8])
        except BaseException as e:  # noqa: BLE001 re-raised on the main thread below, as in reader
            errors.append(e)

    threads = [threading.Thread(target=f) for f in (writer, reader, reader)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    # one manual compact() takes what the daemon's last tick left
    eng.compact()
    rec.assert_acyclic()
    assert len(eng._delta.segments()) >= 1
    live_rows = np.concatenate([base, stream])
    live_ids = np.arange(N + len(stream), dtype=np.int64)
    # 96 streamed rows reshape the rebuild's tree, so the early-stop
    # regimes answer differently (each within its bound on its own
    # tree): the check runs the tree-shape-free regimes
    _assert_parity(eng, live_rows, live_ids, q, str(tmp_path / "o"),
                   "post-race", ulp=4, guarantees=(G.exact(), G.ng(64)))
    eng.close()


# ----------------------------------------------------------- the corners
def test_empty_delta_is_invisible(tmp_path):
    """Arming the write path without writing changes no answer bit, and
    compact() does nothing."""
    base, q, _ = _dataset()
    eng = _build(base, str(tmp_path / "sp"))
    try:
        before = eng.query(q, K, G.exact())
        eng.enable_writes()
        assert eng.compact() is False
        after = eng.query(q, K, G.exact())
        assert torch.equal(before.ids, after.ids)
        assert torch.equal(before.dists, after.dists)
    finally:
        eng.close()


def test_insert_then_delete_all_never_freezes(tmp_path):
    """A memtable whose every row is killed has nothing to compact
    (begin_freeze gives None) and serves exactly the frozen base."""
    base, q, fresh = _dataset()
    eng = _build(base, str(tmp_path / "sp"))
    try:
        ids = np.asarray(eng.insert(fresh))
        eng.delete(ids)
        assert eng.compact() is False
        _assert_parity(eng, base, np.arange(N, dtype=np.int64), q,
                       str(tmp_path / "o"), "all-deleted-delta")
    finally:
        eng.close()


@pytest.mark.parametrize("resident", [False, True],
                         ids=["spilled", "resident"])
def test_all_deleted_leaf(tmp_path, resident):
    """A leaf's worth of contiguous ids tombstoned: the dead leaf gives
    nothing (no padding id, no dead id) and the rest of the answer equals
    a rebuild's without those rows."""
    base, q, _ = _dataset()
    dead = np.arange(32)  # leaf_cap ids off the front of shard 0
    eng = _build(base, str(tmp_path / "sp"), resident=resident)
    try:
        eng.delete(dead)
        ids = eng.query(q, K, G.exact()).ids.numpy()
        assert (ids >= 0).all()
        assert not np.isin(ids, dead).any()
        keep = ~np.isin(np.arange(N), dead)
        _assert_parity(eng, base[keep], np.arange(N, dtype=np.int64)[keep],
                       q, str(tmp_path / "o"), "dead-leaf", ulp=4,
                       resident=resident)
    finally:
        eng.close()


# --------------------------------------------------- the tier's own law
def test_kill_seq_rule_on_the_tier_itself():
    """At most one live copy of any id across active and immutable, and a
    unit's copy is dead iff a kill outruns its birth."""
    tier = DeltaTier(4, start_id=100)
    ids = tier.insert(np.zeros((2, 4), np.float32))
    assert ids.tolist() == [100, 101]
    tier.delete([100])
    snap = tier.snapshot()
    assert snap.ids.tolist() == [101]
    # a frozen copy born at sequence 0 is masked; one born after the kill
    # (a compacted segment) is not
    assert snap.dead_mask(np.asarray([100]), born_seq=0).tolist() == [True]
    assert snap.dead_mask(np.asarray([100]),
                          born_seq=snap.kills[100]).tolist() == [False]
    # reinsert: the id is live again, the old frozen copy stays dead
    tier.insert(np.ones((1, 4), np.float32), ids=[100])
    snap = tier.snapshot()
    assert sorted(snap.ids.tolist()) == [100, 101]
    assert snap.dead_mask(np.asarray([100]), born_seq=0).tolist() == [True]


# ----------------------------------------------------- failed compaction
def test_failed_compaction_loses_no_write(tmp_path, monkeypatch):
    """A segment build that raises folds the frozen batch back into the
    memtable (abort_freeze): every write is still served, and the next
    compaction publishes it."""
    base, q, fresh = _dataset()
    eng = _build(base, str(tmp_path / "sp"))
    try:
        new = np.asarray(eng.insert(fresh))
        eng.delete([int(new[0])])
        want = eng.query(q, K, G.exact())

        def broken(batch):
            raise OSError("disk full")

        monkeypatch.setattr(eng, "_build_segment", broken)
        with pytest.raises(OSError, match="disk full"):
            eng.compact()
        assert eng._delta.snapshot().live_rows == len(fresh) - 1
        got = eng.query(q, K, G.exact())
        assert torch.equal(got.ids, want.ids)
        assert torch.equal(got.dists, want.dists)
        monkeypatch.undo()
        assert eng.compact()
        assert eng._delta.snapshot().live_rows == 0
        got = eng.query(q, K, G.exact())
        assert torch.equal(got.ids, want.ids)
    finally:
        eng.close()


def test_daemon_outlives_a_failed_compaction(tmp_path, monkeypatch):
    """The daemon counts a failed compaction in delta.compaction_errors,
    keeps polling, and compacts once the build works again."""
    from repro_torch.obs import REGISTRY

    base, _, fresh = _dataset()
    eng = _build(base, str(tmp_path / "sp"), delta_max_rows=8,
                 auto_compact=True, compact_interval_s=0.005)
    errors = REGISTRY.counter("delta.compaction_errors")
    errors.mark()
    real = eng._build_segment
    fails = threading.Event()

    def flaky(batch):
        if not fails.is_set():
            fails.set()
            raise OSError("transient")
        return real(batch)

    monkeypatch.setattr(eng, "_build_segment", flaky)
    try:
        eng.insert(fresh)
        for _ in range(2000):
            if eng._delta.segments():
                break
            threading.Event().wait(0.005)
        assert errors.since_mark == 1
        assert len(eng._delta.segments()) == 1
        assert eng._delta.snapshot().live_rows == 0
        assert eng._compactor.is_alive()
    finally:
        eng.close()
    assert eng._compactor is None


def test_write_tier_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    """The engine's device defaults to the card: writes on an engine that
    was not asked for the CPU raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    base, _, fresh = _dataset()
    _build(base, str(tmp_path / "sp")).close()
    eng = DistributedEngine(shards=2, shard_dirs=tuple(
        str(tmp_path / "sp" / f"shard_{si:04d}") for si in range(2)))
    with pytest.raises(RuntimeError, match="CUDA"):
        eng.insert(fresh)
    assert eng._delta is None
