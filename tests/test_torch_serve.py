"""repro_torch's serving front: admission, the scheduler, the lanes and
the engine under concurrent lanes. The cases of tests/test_serve_loop.py
(all but the LLM decode one, which needs the model substrate) and the
scheduler cases of tests/test_data_and_serve.py, on the port:

  admission  the depth cap and its reject reason, the serve.queue_depth
             gauge, the accept/reject/shed counters, hysteresis, the
             degrade_tier ladder.
  scheduler  bucketing and padding, oldest-head-first draining, the
             deadline -> guarantee ladder, the remaining-budget remap,
             one engine call per guarantee group.
  front      ServeFront over a stub engine: routing, rejection,
             shedding, stop(drain=...), error isolation, a request with
             no series; the write lane.
  stress     concurrent engine.query calls over a spilled port engine
             return what serial calls return, bit for bit; 4 submitter
             threads through the lanes, every answer the serial oracle's,
             no uid dropped or answered twice, and the lock graph (the
             front's condition, the engine's copy and bookkeeping locks,
             every cache and prefetcher lock) acyclic.

Time-dependent tiers pass ``at=`` explicitly or use no deadline; the
stub engine's delays only keep a lane busy. CPU only, jax-free.
"""

import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import clock, obs
from repro_torch.core.engine import DistributedEngine, QueryResult
from repro_torch.core.guarantees import Guarantee
from repro_torch.core.spec import IndexSpec, StoreSpec
from repro_torch.serve.admission import AdmissionController, degrade_tier
from repro_torch.serve.batching import (Request, Scheduler, bucket_of,
                                        guarantee_for_deadline,
                                        remaining_budget_ms,
                                        retrieval_groups)
from repro_torch.serve.loop import (LANES, WRITE_LANE, Rejected,
                                    ServeFront, lane_of)

N, DIM, SHARDS, K = 512, 32, 4, 5


# ------------------------------------------------------------ admission
def test_admission_cap_rejects_with_reason():
    a = AdmissionController(max_depth=3)
    c_acc = obs.REGISTRY.counter("serve.admission.accepted",
                                 kind="epsilon")
    c_rej = obs.REGISTRY.counter("serve.admission.rejected",
                                 reason="queue_full")
    c_acc.mark()
    c_rej.mark()
    assert [a.try_admit("epsilon") for _ in range(3)] == [None] * 3
    assert a.depth == 3
    assert a.try_admit("epsilon") == "queue_full"
    assert a.depth == 3
    assert c_acc.since_mark == 3 and c_rej.since_mark == 1
    a.release(2)
    assert a.depth == 1 and a.try_admit("epsilon") is None


def test_admission_gauge_tracks_depth():
    a = AdmissionController(max_depth=8)
    g = obs.REGISTRY.gauge("serve.queue_depth")
    a.try_admit()
    a.try_admit()
    assert g.value == 2
    a.release()
    assert g.value == 1
    a.release(5)  # clamps at zero, never negative
    assert g.value == 0 and a.depth == 0


def test_admission_shedding_hysteresis():
    a = AdmissionController(max_depth=8, shed_high_frac=0.75,
                            shed_low_frac=0.25)
    for _ in range(5):
        a.try_admit()
    assert not a.shedding()          # 5 < shed_high = 6
    a.try_admit()
    assert a.shedding()              # latched at 6
    a.release(3)
    assert a.shedding()              # 3 is inside the band: sticky
    a.release(1)
    assert not a.shedding()          # 2 <= shed_low = 2: cleared
    a.try_admit()
    assert not a.shedding()          # latching again needs shed_high


@pytest.mark.parametrize("kw", [dict(max_depth=0),
                                dict(max_depth=8, shed_low_frac=0.8,
                                     shed_high_frac=0.2),
                                dict(max_depth=8, shed_high_frac=1.5)])
def test_admission_validates_construction(kw):
    with pytest.raises(ValueError):
        AdmissionController(**kw)


def test_degrade_tier_ladder():
    eps = Guarantee(epsilon=0.5)
    de = degrade_tier(eps)
    assert de.kind == "delta-epsilon"
    assert de.delta == 0.99 and de.epsilon >= 1.0
    assert degrade_tier(Guarantee()).kind == "delta-epsilon"
    ng = degrade_tier(de)
    assert ng.kind == "ng" and ng.nprobe == 16
    assert degrade_tier(ng).nprobe == 8
    assert degrade_tier(Guarantee(nprobe=1)).nprobe == 1  # floor


def test_shed_counts_against_original_kind():
    a = AdmissionController(max_depth=8)
    c = obs.REGISTRY.counter("serve.admission.shed", kind="epsilon")
    c.mark()
    out = a.shed(Guarantee(epsilon=0.5))
    assert out.kind == "delta-epsilon" and c.since_mark == 1
    # a bottomed-out tier: no change, no count
    c2 = obs.REGISTRY.counter("serve.admission.shed", kind="ng")
    c2.mark()
    assert a.shed(Guarantee(nprobe=1)) == Guarantee(nprobe=1)
    assert c2.since_mark == 0


# ------------------------------------------------------------ scheduler
def test_scheduler_buckets_and_padding():
    s = Scheduler(max_batch=2, min_bucket=8)
    for uid, ln in [(0, 5), (1, 7), (2, 20), (3, 6)]:
        s.submit(Request(uid=uid, prompt=np.arange(ln, dtype=np.int32)))
    bucket, reqs = s.next_batch()
    assert bucket == 8 and [r.uid for r in reqs] == [0, 1]
    padded = s.pad_prompts(bucket, reqs)
    assert padded.shape == (2, 8)
    assert padded[0, :3].sum() == 0  # left-padded
    # oldest head first across buckets: uid 2 (bucket 32) was submitted
    # before uid 3 (bucket 8)
    bucket2, reqs2 = s.next_batch()
    assert bucket2 == 32 and [r.uid for r in reqs2] == [2]
    bucket3, reqs3 = s.next_batch()
    assert bucket3 == 8 and [r.uid for r in reqs3] == [3]
    assert s.next_batch() is None


def test_next_batch_no_starvation_under_small_request_load():
    """One large request behind sustained small-prompt load drains as
    soon as its head is the longest waiting."""
    s = Scheduler(max_batch=4, min_bucket=8)
    s.submit(Request(uid=100, prompt=np.arange(20, dtype=np.int32)))
    for uid in range(8):  # sustained small load after the big request
        s.submit(Request(uid=uid, prompt=np.arange(4, dtype=np.int32)))
    bucket, batch = s.next_batch()
    assert bucket == 32 and [r.uid for r in batch] == [100]
    drained = []
    while True:
        nb = s.next_batch()
        if nb is None:
            break
        drained.extend(r.uid for r in nb[1])
    assert drained == list(range(8))


def test_bucket_of_powers():
    assert bucket_of(1) == 16
    assert bucket_of(16) == 16
    assert bucket_of(17) == 32
    assert [bucket_of(n, 1) for n in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]


def test_deadline_maps_to_guarantee():
    """The ladder: relaxed -> epsilon, moderate -> delta-epsilon, tight
    -> ng(nprobe) with nprobe shrinking with the budget."""
    g = guarantee_for_deadline(None)
    assert g.kind in ("epsilon", "exact")
    assert guarantee_for_deadline(60.0, full_budget_ms=50.0).kind == g.kind
    mid = guarantee_for_deadline(40.0, full_budget_ms=50.0)
    assert mid.kind == "delta-epsilon" and mid.delta < 1.0
    tight = guarantee_for_deadline(12.0, full_budget_ms=50.0)
    assert tight.kind == "ng" and tight.nprobe >= 1
    tighter = guarantee_for_deadline(2.0, full_budget_ms=50.0)
    assert tighter.kind == "ng" and tighter.nprobe <= tight.nprobe


def test_remaining_budget_ms():
    t0 = clock.now()
    r = Request(uid=0, prompt=np.zeros(2, np.int32), deadline_ms=50.0)
    assert remaining_budget_ms(r, r.submitted_at) == pytest.approx(50.0)
    assert remaining_budget_ms(r, r.submitted_at + 0.040) \
        == pytest.approx(10.0, abs=1e-6)
    # spent budgets clamp to ~0, never negative
    assert remaining_budget_ms(r, r.submitted_at + 9.9) == 1e-3
    no_dl = Request(uid=1, prompt=np.zeros(2, np.int32))
    assert remaining_budget_ms(no_dl, t0) is None


def test_retrieval_groups_mixed_deadlines():
    """A drained batch with mixed deadlines partitions into one group per
    mapped guarantee, in order, each request placed once."""
    reqs = [Request(uid=u, prompt=np.arange(4, dtype=np.int32),
                    deadline_ms=dl, series=np.zeros(8, np.float32))
            for u, dl in enumerate([None, 40.0, 2.0, 60.0, 40.0, 2.0])]
    groups = retrieval_groups(reqs, full_budget_ms=50.0, epsilon=0.1)
    assert [g.kind for g, _ in groups] == ["epsilon", "delta-epsilon",
                                           "ng"]
    assert sorted(r.uid for _, rs in groups for r in rs) == list(range(6))
    by_kind = {g.kind: sorted(r.uid for r in rs) for g, rs in groups}
    assert by_kind == {"epsilon": [0, 3], "delta-epsilon": [1, 4],
                       "ng": [2, 5]}


def test_retrieval_groups_remap_from_remaining_budget():
    """A 50 ms request that already waited 40 ms drains at the tier
    10 ms affords (ng), not the one its submitted deadline bought; an
    unwaited twin keeps the full tier."""
    fresh = Request(uid=0, prompt=np.zeros(2, np.int32),
                    deadline_ms=50.0, series=np.zeros(8, np.float32))
    stale = Request(uid=1, prompt=np.zeros(2, np.int32),
                    deadline_ms=50.0, series=np.zeros(8, np.float32))
    at = max(fresh.submitted_at, stale.submitted_at)
    fresh.submitted_at = at                # no wait: 50 ms left
    stale.submitted_at = at - 0.040        # 40 ms already queued
    by_kind = {g.kind: [r.uid for r in rs]
               for g, rs in retrieval_groups([fresh, stale], at=at)}
    assert by_kind == {"exact": [0], "ng": [1]}
    # at=None keeps the submitted-deadline mapping: both full tier
    pure = retrieval_groups([fresh, stale], at=None)
    assert len(pure) == 1 and pure[0][0] == guarantee_for_deadline(50.0)


class _StubEngine:
    """A deterministic engine: lane i's ids are 10 * its series value +
    0..k-1; stats None (resident style). ``delay_s`` keeps a lane busy."""

    def __init__(self, delay_s: float = 0.0):
        self.delay_s = delay_s
        self.calls = []
        self.writes = []
        self._lock = threading.Lock()

    def query(self, qs, k, g):
        with self._lock:
            self.calls.append((int(qs.shape[0]), g))
        if self.delay_s:
            time.sleep(self.delay_s)
        q = torch.as_tensor(qs)
        b = q.shape[0]
        ids = q[:, :1].to(torch.int32) * 10 + torch.arange(
            k, dtype=torch.int32)
        return QueryResult(dists=torch.zeros(b, k), ids=ids,
                           leaves_visited=torch.zeros(b, dtype=torch.int32),
                           rows_scanned=torch.zeros(b, dtype=torch.int32),
                           lb_computed=0)

    def insert(self, rows, ids=None):
        with self._lock:
            self.writes.append(("insert", len(rows)))
        return np.arange(len(rows), dtype=np.int64) + 1000

    def delete(self, ids):
        with self._lock:
            self.writes.append(("delete", len(ids)))
        return len(ids)


def test_run_retrieval_mixed_batch_drives_engine_per_group():
    """run_retrieval: one engine.query per guarantee group, padded to a
    power-of-two lane bucket, answers scattered back per uid."""
    eng = _StubEngine()
    reqs = [Request(uid=u, prompt=np.arange(4, dtype=np.int32),
                    deadline_ms=dl, series=np.full(8, u, np.float32))
            for u, dl in enumerate([None, 2.0, 40.0, None, None])]
    # one request opts out of retrieval
    reqs.append(Request(uid=9, prompt=np.arange(4, dtype=np.int32)))
    out = Scheduler().run_retrieval(eng, reqs, k=3, full_budget_ms=50.0,
                                    epsilon=0.1)
    assert sorted(out) == [0, 1, 2, 3, 4]        # uid 9 skipped
    assert len(eng.calls) == 3                   # one per group
    sizes = {g.kind: b for b, g in eng.calls}
    # the epsilon group of 3 is padded to 4 lanes
    assert sizes == {"epsilon": 4, "ng": 1, "delta-epsilon": 1}
    assert out[1]["kind"] == "ng" and out[2]["kind"] == "delta-epsilon"
    assert out[0]["ids"].shape == (3,)
    for u in (0, 3, 4):
        assert np.array_equal(out[u]["ids"], u * 10 + np.arange(3))


# ---------------------------------------------------------------- front
def _req(uid, dl=None, val=None):
    return Request(uid=uid, prompt=np.zeros(2, np.int32), deadline_ms=dl,
                   series=np.full(8, val if val is not None else uid,
                                  np.float32))


def test_lane_of_routing():
    assert lane_of("exact") == "epsilon"
    assert lane_of("epsilon") == "epsilon"
    assert lane_of("delta-epsilon") == "delta-epsilon"
    assert lane_of("ng") == "ng"
    assert set(LANES) == {"epsilon", "delta-epsilon", "ng"}
    assert WRITE_LANE not in LANES


def test_front_answers_and_releases_admission():
    eng = _StubEngine()
    with ServeFront(eng, k=3, max_batch=4) as front:
        tickets = [front.submit(_req(u, dl)) for u, dl in
                   [(0, None), (1, 30.0), (2, 5.0), (3, None)]]
        outs = {t.uid: t.result(timeout=10.0) for t in tickets}
    assert sorted(outs) == [0, 1, 2, 3]
    for u, o in outs.items():
        assert np.array_equal(o["ids"], u * 10 + np.arange(3)), o
        assert o["latency_ms"] >= o["queue_wait_ms"] >= 0.0
    assert outs[0]["kind"] == "exact"
    assert outs[2]["kind"] == "ng"
    assert front.admission.depth == 0


def test_front_rejects_past_cap():
    # a stalled engine keeps the lane busy while submits pile up
    eng = _StubEngine(delay_s=0.2)
    adm = AdmissionController(max_depth=2)
    front = ServeFront(eng, k=3, max_batch=1, admission=adm).start()
    try:
        t0 = front.submit(_req(0))
        t1 = front.submit(_req(1))
        with pytest.raises(Rejected) as ei:
            front.submit(_req(2))
        assert ei.value.reason == "queue_full"
        assert t0.result(10.0)["ids"] is not None
        assert t1.result(10.0)["ids"] is not None
    finally:
        front.stop()
    # the slots are free again
    assert adm.try_admit() is None


def test_front_sheds_one_tier_under_pressure():
    """With shedding latched, a drained exact request is degraded one
    tier (delta-epsilon), flagged on its entry and counted against its
    original kind."""
    adm = AdmissionController(max_depth=8, shed_high_frac=0.25,
                              shed_low_frac=0.0)
    # latch shedding with depth the front never releases
    adm.try_admit()
    adm.try_admit()
    assert adm.shedding()
    c = obs.REGISTRY.counter("serve.admission.shed", kind="exact")
    c.mark()
    eng = _StubEngine()
    with ServeFront(eng, k=3, admission=adm) as front:
        out = front.submit(_req(0, dl=None)).result(timeout=10.0)
    assert out["shed"] is True
    assert out["nominal_kind"] == "exact"
    assert out["kind"] == "delta-epsilon"
    assert c.since_mark >= 1
    assert all(g.kind == "delta-epsilon" for _b, g in eng.calls)


def test_front_stop_drain_false_fails_pending():
    eng = _StubEngine(delay_s=0.15)
    front = ServeFront(eng, k=3, max_batch=1).start()
    tickets = [front.submit(_req(u)) for u in range(4)]
    front.stop(drain=False)
    outs = [t.result(timeout=10.0) for t in tickets]
    # the batch in flight completes; the rest fail at once with a reason
    assert any("error" in o for o in outs)
    assert all(o.get("error", "stopped") == "stopped" for o in outs)
    assert front.admission.depth == 0
    with pytest.raises(Rejected):
        front.submit(_req(9))


def test_front_worker_survives_engine_error():
    class Boom(_StubEngine):
        def query(self, qs, k, g):
            if int(qs[0, 0]) == 7:
                raise RuntimeError("kaboom")
            return super().query(qs, k, g)

    c = obs.REGISTRY.counter("serve.loop.errors", lane="epsilon")
    c.mark()
    with ServeFront(Boom(), k=3, max_batch=1) as front:
        bad = front.submit(_req(7)).result(timeout=10.0)
        good = front.submit(_req(1)).result(timeout=10.0)
    assert "kaboom" in bad["error"]
    assert np.array_equal(good["ids"], 10 + np.arange(3))
    assert c.since_mark == 1
    assert front.admission.depth == 0


def test_front_no_series_request_completes():
    with ServeFront(_StubEngine(), k=3) as front:
        out = front.submit(Request(
            uid=0, prompt=np.zeros(2, np.int32))).result(timeout=10.0)
    assert out["ids"] is None and out["kind"] == "exact"
    assert out["retrieval_ms"] == 0.0


def test_front_write_lane_applies_in_order_without_admission():
    eng = _StubEngine()
    adm = AdmissionController(max_depth=1)
    c = obs.REGISTRY.counter("serve.writes", op="insert")
    c.mark()
    with ServeFront(eng, k=3, admission=adm) as front:
        t_ins = front.submit_write("insert", rows=np.zeros((3, 8)))
        t_del = front.submit_write("delete", ids=[1, 2])
        ins, dele = t_ins.result(10.0), t_del.result(10.0)
        with pytest.raises(ValueError):
            front.submit_write("upsert", rows=np.zeros((1, 8)))
        with pytest.raises(ValueError):
            front.submit_write("delete")
    assert eng.writes == [("insert", 3), ("delete", 2)]
    assert np.array_equal(ins["ids"], [1000, 1001, 1002])
    assert np.array_equal(dele["ids"], [1, 2])
    assert ins["applied_at"] <= dele["applied_at"]
    assert ins["latency_ms"] >= ins["queue_wait_ms"] >= 0.0
    assert c.since_mark == 3 and adm.depth == 0


# --------------------------------------------------------------- stress
@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    data = np.cumsum(rng.normal(size=(N, DIM)), axis=1)
    data = ((data - data.mean(1, keepdims=True))
            / (data.std(1, keepdims=True) + 1e-9)).astype(np.float32)
    queries = (data[rng.choice(N, 16, replace=False)]
               + 0.05 * rng.normal(size=(16, DIM))).astype(np.float32)
    return data, queries


def _spilled(data, tmp):
    return DistributedEngine(shards=SHARDS, device="cpu").build(
        data, index=IndexSpec("dstree", leaf_cap=16),
        store=StoreSpec(spill_dir=tmp, keep_resident=False))


@pytest.fixture(scope="module")
def spilled_engine(tmp_path_factory, corpus):
    eng = _spilled(corpus[0], str(tmp_path_factory.mktemp("serve_spill")))
    yield eng
    eng.close()


def test_concurrent_queries_bit_exact_vs_serial(spilled_engine, corpus):
    """Concurrent query() calls (mixed guarantees, shared warm caches)
    return exactly what serial calls return: ids and distances."""
    _, queries = corpus
    eng = spilled_engine
    plans = [(queries[i:i + 4], g)
             for i, g in [(0, Guarantee()),
                          (4, Guarantee(epsilon=1.0)),
                          (8, Guarantee(delta=0.99, epsilon=1.0)),
                          (12, Guarantee(nprobe=8)),
                          (2, Guarantee()),
                          (6, Guarantee(nprobe=4))]]
    serial = [eng.query(q, K, g) for q, g in plans]
    for _round in range(3):  # interleavings differ per round
        results = [None] * len(plans)
        errs = []

        def worker(i, q, g):
            try:
                results[i] = eng.query(q, K, g)
            except Exception as e:  # noqa: BLE001 surfaces a thread's failure in the main thread's assert instead of losing it
                errs.append(e)

        ts = [threading.Thread(target=worker, args=(i, q, g))
              for i, (q, g) in enumerate(plans)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
        assert not errs, errs
        for i, res in enumerate(results):
            assert torch.equal(res.ids, serial[i].ids), i
            assert torch.equal(res.dists, serial[i].dists), i
            # the stats rode the result, one schema per shard
            assert res.stats is not None
            assert len(res.stats.shards) == SHARDS


def test_front_stress_bit_exact_no_drops_lockorder(corpus,
                                                   tmp_path_factory):
    """4 submitter threads x 6 requests through the lanes over a spilled
    4-shard engine, with the front's condition, the engine's copy locks
    and bookkeeping lock, and every cache and prefetcher lock wrapped in
    one recorder: every answer the serial oracle's for its tier, no uid
    dropped or answered twice, the lock graph acyclic."""
    data, queries = corpus
    eng = _spilled(data, str(tmp_path_factory.mktemp("stress_spill")))
    rec = obs.LockOrderRecorder()
    try:
        # no deadlines: every answer is the exact tier, so the serial
        # oracle is one engine call over every query row
        n_sub, per = 4, 6
        serial = eng.query(queries, K, Guarantee())
        s_ids, s_dists = serial.ids.numpy(), serial.dists.numpy()

        # wrap the whole lock surface after the serial warmup built the
        # caches and prefetchers
        eng._ooc_lock = rec.wrap(eng._ooc_lock, "engine._ooc_lock")
        for d in list(eng._copy_locks):
            eng._copy_locks[d] = rec.wrap(eng._copy_locks[d],
                                          f"engine.copy:{d[-8:]}")
        for d, cache in eng._shard_caches.items():
            cache._lock = rec.wrap(cache._lock, f"cache:{d[-8:]}")
            if cache.prefetcher is not None:
                cache.prefetcher._lock = rec.wrap(
                    cache.prefetcher._lock, f"prefetch:{d[-8:]}")

        front = ServeFront(eng, K, max_batch=4,
                           admission=AdmissionController(max_depth=64),
                           lock_recorder=rec).start()
        answers: dict = {}
        answers_lock = threading.Lock()
        errs: list = []

        def submitter(s):
            try:
                tickets = []
                for j in range(per):
                    uid = s * 100 + j
                    qi = (s * per + j) % len(queries)
                    tickets.append((uid, qi, front.submit(Request(
                        uid=uid, prompt=np.zeros(2, np.int32),
                        series=queries[qi]))))
                for uid, qi, t in tickets:
                    out = t.result(timeout=120.0)
                    with answers_lock:
                        assert uid not in answers, f"dup {uid}"
                        answers[uid] = (qi, out)
            except Exception as e:  # noqa: BLE001 surfaces a thread's failure in the main thread's assert instead of losing it
                errs.append(e)

        subs = [threading.Thread(target=submitter, args=(s,))
                for s in range(n_sub)]
        for t in subs:
            t.start()
        for t in subs:
            t.join(timeout=300)
        front.stop()
        assert not any(t.is_alive() for t in subs)
        assert not errs, errs
        assert len(answers) == n_sub * per, "dropped uids"
        for uid, (qi, out) in answers.items():
            assert "error" not in out, out
            assert out["kind"] == "exact"
            assert np.array_equal(out["ids"], s_ids[qi]), uid
            assert np.array_equal(out["dists"], s_dists[qi]), uid
        rec.assert_acyclic()
        assert rec.edges(), "recorder saw no lock activity"
        assert front.admission.depth == 0
    finally:
        eng.close()


def test_front_writes_are_seen_by_later_queries(corpus, tmp_path):
    """The write lane over a real engine: a probe submitted after an
    insert's ticket returned finds the inserted row first at distance 0;
    an id deleted before a request's submit never shows in its answer."""
    data, queries = corpus
    eng = DistributedEngine(shards=SHARDS, device="cpu").build(
        data, index=IndexSpec("dstree", leaf_cap=16))
    rng = np.random.default_rng(3)
    fresh = np.cumsum(rng.normal(size=(4, DIM)), axis=1)
    fresh = ((fresh - fresh.mean(1, keepdims=True))
             / fresh.std(1, keepdims=True)).astype(np.float32)
    try:
        with ServeFront(eng, K, max_batch=4) as front:
            before = front.submit(Request(
                uid=0, prompt=np.zeros(2, np.int32),
                series=queries[0])).result(60.0)
            gone = before["ids"][:2]
            ins = front.submit_write("insert", rows=fresh).result(60.0)
            dele = front.submit_write("delete", ids=gone).result(60.0)
            probes = [front.submit(Request(uid=10 + i,
                                           prompt=np.zeros(2, np.int32),
                                           series=fresh[i]))
                      for i in range(4)]
            after = front.submit(Request(
                uid=1, prompt=np.zeros(2, np.int32),
                series=queries[0])).result(60.0)
            outs = [p.result(60.0) for p in probes]
        for i, o in enumerate(outs):
            assert o["ids"][0] == ins["ids"][i]
            # squared: the expanded form leaves a few ulps of |x|^2
            assert o["dists"][0] ** 2 <= 1e-3
            assert o["done_at"] > ins["applied_at"]
        assert not np.isin(after["ids"], gone).any()
        assert after["done_at"] > dele["applied_at"]
    finally:
        eng.close()
