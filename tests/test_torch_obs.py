"""repro_torch's observability (repro_torch.obs): the tracer, the metrics
registry with its histograms, the span sites of the search stack, and
the one clock the serving front stamps with.

The cases of tests/test_obs.py on the port, plus what
scripts/obs_smoke.py checks: a traced out-of-core query's span tree
carries the OocStats the caller gets, with ``bytes_read`` equal to the
cache and prefetcher counters exactly. The histogram's quantile is
within one log bucket (GROWTH) of numpy's at the same rank convention
(``method="lower"``) and inside [min, max]. The registry's reset and
accessor and OocStats' mapping view against the reference's
(``repro.obs``, which imports no jax). CPU only, jax-free.
"""

import json
import subprocess
import threading
import time

import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro_torch import clock, obs
from repro_torch.core import guarantees as G
from repro_torch.core import search as S
from repro_torch.core.engine import DistributedEngine, QueryResult
from repro_torch.core.index import FrozenIndex
from repro_torch.core.indexes import dstree
from repro_torch.core.spec import IndexSpec, StoreSpec
from repro_torch.fault import FaultInjector
from repro_torch.obs import GROWTH, Histogram, MetricsRegistry
from repro_torch.serve.batching import Request, Scheduler
from repro_torch.serve.fault import RetryPolicy
from repro_torch.store import DeviceLeafCache, LeafPrefetcher, search_ooc

SETTINGS = dict(max_examples=40, deadline=None)


@pytest.fixture
def traced():
    """Tracing on for one test, off and cleared after it."""
    obs.clear()
    obs.enable()
    yield obs.tracer()
    obs.disable()
    obs.clear()


@pytest.fixture(scope="module")
def store(walk_data, tmp_path_factory):
    ix = dstree.build(walk_data, leaf_cap=32, device="cpu")
    d = ix.save(str(tmp_path_factory.mktemp("obs_store") / "idx"))
    return FrozenIndex.load(d, resident="summaries", device="cpu")


# ------------------------------------------------------------- tracer
def test_clock_is_the_tracer_and_front_clock():
    assert obs.now is clock.now
    t0 = clock.now()
    assert clock.now() >= t0


def test_disabled_span_is_shared_noop():
    assert not obs.enabled()
    sp = obs.span("x", a=1)
    assert sp is obs.NULL_SPAN
    with sp as s:
        s.set(bytes_read=5)
        s.add("bytes_read", 5)
    assert obs.tracer().spans() == []


def test_span_nesting_and_profile(traced):
    with obs.span("root", k=5) as root:
        with obs.span("filter"):
            time.sleep(0.001)
        for i in range(3):
            with obs.span("iter", n=i) as it:
                it.set(bytes=10 * (i + 1))
    spans = traced.spans()
    # completion order: children land before their parent
    assert [s.name for s in spans] == ["filter", "iter", "iter", "iter",
                                       "root"]
    assert all(s.parent == root.id for s in spans[:-1])
    assert root.parent == -1
    prof = obs.last_profile("root")
    assert prof.attrs == {"k": 5}
    assert prof.count("iter") == 3
    assert prof.total("bytes") == 60
    assert set(prof.phase_ms) == {"filter", "iter"}
    assert prof.phase_ms["filter"] >= 1.0
    assert prof.duration_ms >= prof.phase_ms["filter"]


def test_subtree_isolates_concurrent_roots(traced):
    with obs.span("query") as q1:
        with obs.span("gather") as g1:
            pass
    with obs.span("query"):
        with obs.span("gather"):
            pass
    assert {s.id for s in traced.subtree(q1)} == {q1.id, g1.id}


def test_threads_build_independent_subtrees(traced):
    barrier = threading.Barrier(2)
    roots = {}

    def work(tag):
        barrier.wait(timeout=10)
        with obs.span("troot", tag=tag) as r:
            with obs.span("tchild", tag=tag):
                pass
        roots[tag] = r

    ts = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in ts)
    for tag in ("a", "b"):
        assert roots[tag].parent == -1
        (child,) = [s for s in traced.find("tchild")
                    if s.attrs["tag"] == tag]
        assert child.parent == roots[tag].id
        assert child.tid == roots[tag].tid


def test_chrome_events_structure(tmp_path, traced):
    with obs.span("outer", codec="f32"):
        with obs.span("inner") as sp:
            sp.set(n=np.int64(7), m=torch.tensor(3))  # scalars JSON-ify
    path = obs.dump_chrome_trace(str(tmp_path / "t.json"))
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    assert len(evs) == 2
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in evs)
    inner = next(e for e in evs if e["name"] == "inner")
    outer = next(e for e in evs if e["name"] == "outer")
    assert inner["args"]["n"] == 7 and inner["args"]["m"] == 3
    assert outer["args"]["codec"] == "f32"
    # the child nests inside its parent on the one clock
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1


# ----------------------------------------------------------- registry
def test_registry_reset_and_accessor_match_reference():
    from repro.obs import metrics as jmetrics

    from repro_torch.obs import metrics as tmetrics

    assert obs.registry() is obs.REGISTRY is tmetrics.registry()
    snaps = []
    for mod in (tmetrics, jmetrics):
        assert mod.registry() is mod.REGISTRY
        reg = mod.MetricsRegistry()
        reg.counter("q.count", lane="eps").inc(3)
        reg.gauge("q.depth").set(7)
        reg.histogram("q.ms").record(2.5)
        snap = reg.snapshot()
        reg.reset()
        assert reg.snapshot() == {} and reg.collect() == []
        reg.counter("q.count", lane="eps").inc()
        snaps.append((snap, reg.snapshot()))
    (t_before, t_after), (j_before, j_after) = snaps
    assert t_after == j_after == {"q.count{lane=eps}": 1}
    assert {k: v for k, v in t_before.items() if k != "q.ms"} \
        == {k: v for k, v in j_before.items() if k != "q.ms"}


def test_ooc_stats_mapping_view_matches_reference():
    from repro.obs.stats import OocStats as JStats

    got, want = obs.OocStats(bytes_read=4096, hits=3), \
        JStats(bytes_read=4096, hits=3)
    assert got.keys() == want.keys()
    assert list(got) == list(want) == got.keys()
    assert got.items() == want.items()
    for key in ("bytes_read", "hits", "effective_delta", "nope"):
        assert got.get(key) == want.get(key)
        assert got.get(key, 7) == want.get(key, 7)
        assert (key in got) == (key in want)
    assert (5 in got) == (5 in want) is False


def test_registry_label_keying_and_kind_conflict():
    reg = MetricsRegistry()
    a = reg.counter("reads", shard="0", codec="pq")
    b = reg.counter("reads", codec="pq", shard="0")  # order-insensitive
    c = reg.counter("reads", shard="1", codec="pq")
    assert a is b and a is not c
    a.inc(3)
    assert b.value == 3 and c.value == 0
    with pytest.raises(TypeError):
        reg.histogram("reads", shard="0", codec="pq")
    reg.gauge("depth").set(4)
    reg.histogram("lat", kind="exact").record(2.0)
    snap = reg.snapshot()
    assert snap["reads{codec=pq,shard=0}"] == 3
    assert snap["depth"] == 4
    assert snap["lat{kind=exact}"]["count"] == 1
    assert snap["lat{kind=exact}"]["p99"] == 2.0
    assert len(reg.collect("reads")) == 2


def test_counter_window_marks_keep_lifetime_total():
    ctr = MetricsRegistry().counter("bytes")
    ctr.inc(100)
    ctr.mark()
    ctr.inc(7)
    assert ctr.since_mark == 7
    assert ctr.value == 107  # the registry never forgets


# ---------------------------------------------------------- histogram
def test_histogram_empty_and_singleton():
    h = Histogram("h", ())
    assert np.isnan(h.quantile(0.5)) and np.isnan(h.mean)
    h.record(3.7)
    for q in (0.0, 0.5, 0.99, 1.0):
        assert h.quantile(q) == 3.7  # clamped to [min, max] = the point
    snap = h.snapshot()
    assert snap["count"] == 1 and snap["p50"] == 3.7 and snap["mean"] == 3.7


@given(st.lists(st.floats(1e-6, 1e6), min_size=1, max_size=100),
       st.floats(0.0, 1.0))
@settings(**SETTINGS)
def test_histogram_quantile_vs_numpy(xs, q):
    h = Histogram("h", ())
    for v in xs:
        h.record(v)
    got = h.quantile(q)
    x = np.asarray(xs, np.float64)
    # the histogram's rank convention: the value at floor(q*(n-1))
    ref = float(np.quantile(x, q, method="lower"))
    tol = GROWTH * (1 + 1e-9)
    assert ref / tol <= got <= ref * tol
    assert x.min() <= got <= x.max()


@given(st.lists(st.floats(1e-6, 1e6), min_size=2, max_size=60))
@settings(**SETTINGS)
def test_histogram_quantiles_monotone(xs):
    h = Histogram("h", ())
    for v in xs:
        h.record(v)
    qs = [h.quantile(q) for q in (0.0, 0.25, 0.5, 0.75, 0.95, 1.0)]
    assert all(a <= b for a, b in zip(qs, qs[1:]))
    assert h.count == len(xs)
    np.testing.assert_allclose(h.sum, sum(xs), rtol=1e-9)


def test_histogram_records_from_many_threads():
    h = Histogram("h", ())
    vals = np.arange(1, 4001, dtype=np.float64)

    def work(part):
        for v in part:
            h.record(v)

    ts = [threading.Thread(target=work, args=(p,))
          for p in np.array_split(vals, 8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    snap = h.snapshot()
    assert snap["count"] == 4000 and snap["sum"] == vals.sum()
    assert snap["min"] == 1.0 and snap["max"] == 4000.0


# ------------------------------------------ the span sites of the stack
def test_span_attrs_match_stats_on_real_query(store, walk_queries,
                                              traced):
    out = search_ooc(store, walk_queries, 5, G.epsilon(1.0),
                     cache_leaves=6)
    st_ = out.stats
    prof = obs.last_profile("ooc.query")
    assert prof is not None
    # the span attrs are the OocStats fields: one schema, two views
    for field in ("bytes_read", "bytes_h2d", "iterations",
                  "leaves_visited", "rows_scanned", "frontier_refills",
                  "stop_delta", "stop_epsilon", "stop_exhausted"):
        assert prof.attrs[field] == st_[field], field
    assert prof.attrs["guarantee"] == "epsilon"
    assert prof.count("ooc.iteration") == st_.iterations
    assert prof.count("ooc.gather") == prof.count("ooc.score") \
        == st_.iterations
    assert {"ooc.filter", "ooc.iteration",
            "ooc.finalize"} <= set(prof.phase_ms)
    assert (st_.stop_delta + st_.stop_epsilon
            + st_.stop_exhausted) == walk_queries.shape[0]
    # per-iteration demand reads fold up to the sync-read total
    assert prof.total("bytes_read_sync") == st_.bytes_read_sync
    assert prof.total("bytes_read") == st_.bytes_read


def test_span_bytes_equal_the_cache_and_prefetcher_counters(store,
                                                            walk_queries):
    """scripts/obs_smoke.py on the port: the root's bytes_read equals the
    cache's demand reads plus the prefetcher's, exactly, on a part-warm
    cache; an untraced query records no span."""
    rng = np.random.default_rng(7)
    q = walk_queries[rng.permutation(walk_queries.shape[0])]
    pf = LeafPrefetcher(store, depth=3)
    cache = DeviceLeafCache(store, capacity_leaves=8, prefetcher=pf)
    try:
        obs.clear()
        out = search_ooc(store, q, 5, G.epsilon(0.5), cache=cache,
                         prefetch_depth=2)
        assert not obs.tracer().spans()
        assert out.stats.bytes_read > 0
        cache.reset_counters()
        obs.enable()
        try:
            out = search_ooc(store, q, 5, G.epsilon(0.5), cache=cache,
                             prefetch_depth=2)
        finally:
            obs.disable()
        counter_bytes = cache.stats().bytes_read_sync + pf.bytes_read
        prof = obs.last_profile("ooc.query")
        assert out.stats.bytes_read_rerank == 0
        assert prof.attrs["bytes_read"] == counter_bytes \
            == out.stats.bytes_read
        assert prof.total("bytes_read_sync") \
            == cache.stats().bytes_read_sync
    finally:
        pf.close()
        obs.clear()


def test_tracing_does_not_change_answers(store, walk_queries):
    plain = search_ooc(store, walk_queries, 5, G.epsilon(1.0),
                       cache_leaves=6)
    obs.enable()
    try:
        traced = search_ooc(store, walk_queries, 5, G.epsilon(1.0),
                            cache_leaves=6)
        assert obs.last_profile("ooc.query") is not None
    finally:
        obs.disable()
        obs.clear()
    assert torch.equal(plain.result.ids, traced.result.ids)
    assert torch.equal(plain.result.dists, traced.result.dists)
    assert plain.stats.leaves_visited == traced.stats.leaves_visited


def test_core_search_span(walk_data, walk_queries, traced):
    ix = dstree.build(walk_data, leaf_cap=32, device="cpu")
    res = S.search(ix, walk_queries, 5, G.exact(), device="cpu")
    (sp,) = traced.find("core.search")
    assert sp.attrs["lanes"] == walk_queries.shape[0]
    assert sp.attrs["leaves"] == ix.num_leaves
    assert sp.attrs["leaves_visited"] == int(res.leaves_visited.sum())
    assert sp.attrs["rows_scanned"] == int(res.rows_scanned.sum())


def test_engine_span_tree(walk_data, walk_queries, tmp_path, traced):
    """engine.query over the spilled shards holds one engine.shard per
    shard, each holding that shard's ooc.query; the write tier adds
    delta.compact and delta.search; a resident query is one
    engine.query with its visit totals."""
    spill = str(tmp_path / "spill")
    eng = DistributedEngine(shards=2, device="cpu").build(
        walk_data, index=IndexSpec("dstree", leaf_cap=32),
        store=StoreSpec(spill_dir=spill, keep_resident=False))
    try:
        res = eng.query(walk_queries, 5, G.exact())
        prof = obs.last_profile("engine.query")
        assert prof.attrs["path"] == "ooc" and prof.attrs["shards"] == 2
        assert prof.attrs["bytes_read_total"] == res.stats.bytes_read
        assert prof.count("engine.shard") == 2
        assert prof.count("ooc.query") == 2
        assert prof.total("bytes_read") == res.stats.bytes_read
        shard_ids = {sp.id: sp.attrs["shard"] for sp in prof.spans
                     if sp.name == "engine.shard"}
        roots = [sp for sp in prof.spans if sp.name == "ooc.query"]
        assert sorted(shard_ids[sp.parent] for sp in roots) == [0, 1]

        obs.clear()
        eng.insert(walk_data[:40] + 0.01)
        assert eng.compact()
        eng.insert(walk_data[40:50] + 0.01)
        eng.query(walk_queries, 5, G.exact())
        (comp,) = traced.find("delta.compact")
        assert comp.attrs["rows"] == 40
        (ds,) = traced.find("delta.search")
        assert ds.attrs["rows"] == 10 and ds.attrs["lanes"] == len(
            walk_queries)
    finally:
        eng.close()
    res_eng = DistributedEngine(shards=2, device="cpu").build(
        walk_data, index=IndexSpec("dstree", leaf_cap=32))
    obs.clear()
    res = res_eng.query(walk_queries, 5, G.exact())
    (sp,) = traced.find("engine.query")
    assert sp.attrs["path"] == "resident"
    assert sp.attrs["leaves_visited"] == int(res.leaves_visited.sum())
    res_eng.insert(walk_data[:4] + 0.01)
    obs.clear()
    res_eng.query(walk_queries, 5, G.exact())
    (sp,) = traced.find("engine.query")
    assert sp.attrs["path"] == "resident+delta"
    assert sp.attrs["delta_rows"] == 4 and sp.attrs["segments"] == 0


def test_failover_latency_histogram(walk_data, walk_queries, tmp_path):
    """A failure on the owner copy of shard 1 records one
    fault.failover_latency_ms sample: first failure to the replica's
    answer, on the port's clock."""
    spill = str(tmp_path / "spill")
    eng = DistributedEngine(shards=2, device="cpu").build(
        walk_data, index=IndexSpec("dstree", leaf_cap=32),
        store=StoreSpec(spill_dir=spill, keep_resident=False, replicas=2))
    h = obs.REGISTRY.histogram("fault.failover_latency_ms", shard="1")
    h0 = obs.REGISTRY.histogram("fault.failover_latency_ms", shard="0")
    before, before0 = h.count, h0.count
    try:
        t0 = clock.now()
        res = eng.query(walk_queries, 5, G.ng(4), ooc_opts=dict(
            fault=FaultInjector().kill_shard(1, replica=0),
            retry=RetryPolicy(max_attempts=2, backoff_base_s=0.0)))
        elapsed_ms = (clock.now() - t0) * 1e3
    finally:
        eng.close()
    assert res.stats.failovers == 1 and not res.stats.degraded
    assert h.count == before + 1
    assert 0.0 <= h.max <= elapsed_ms
    assert h0.count == before0  # shard 0 served at its first attempt


# ------------------------------------------------- serve-side plumbing
def test_request_submitted_at_on_the_shared_clock():
    t0 = clock.now()
    r = Request(uid=0, prompt=np.arange(4, dtype=np.int32))
    t1 = clock.now()
    assert t0 <= r.submitted_at <= t1


def test_run_retrieval_attributes_time_per_group(traced):
    """A request is charged its own guarantee group's retrieval time, not
    the whole batch's."""

    class SleepyEngine:
        def query(self, q, k, g):
            if g.kind == "ng":
                time.sleep(0.05)  # only the degraded tier is slow
            b = q.shape[0]
            return QueryResult(
                dists=torch.zeros(b, k),
                ids=torch.arange(k, dtype=torch.int32).repeat(b, 1),
                leaves_visited=torch.zeros(b, dtype=torch.int32),
                rows_scanned=torch.zeros(b, dtype=torch.int32),
                lb_computed=0)

    reqs = [Request(uid=0, prompt=np.arange(4, dtype=np.int32),
                    series=np.zeros(8, np.float32)),
            Request(uid=1, prompt=np.arange(4, dtype=np.int32),
                    deadline_ms=2.0, series=np.zeros(8, np.float32))]
    out = Scheduler().run_retrieval(SleepyEngine(), reqs, k=3)
    assert out[1]["kind"] == "ng" and out[0]["kind"] == "exact"
    assert out[1]["retrieval_ms"] >= 50.0
    # the exact-group request is not charged for the ng group's sleep
    assert out[0]["retrieval_ms"] < out[1]["retrieval_ms"]
    kinds = {sp.attrs["kind"] for sp in
             traced.find("serve.retrieval_group")}
    assert kinds == {"exact", "ng"}


# ------------------------------ the resident search's spans and counters
def _reads() -> dict:
    """search.host_reads by site, and search.iterations, as they stand."""
    snap = obs.REGISTRY.snapshot("search.")
    return {k: v for k, v in snap.items()
            if k.startswith("search.host_reads") or k == "search.iterations"}


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


MODES = {"solo": {}, "coop": {"share_gathers": True},
         "sync_bsf": {"sync_bsf": True}}


@pytest.fixture(scope="module")
def two_shards(walk_data):
    return DistributedEngine(shards=2, device="cpu").build(
        walk_data, index=IndexSpec("dstree", leaf_cap=32))


@pytest.mark.parametrize("mode", list(MODES))
def test_a_traced_resident_query_waits_as_an_untraced_one(
        two_shards, walk_queries, mode):
    """Tracing on changes neither the answer nor the host's waits on the
    device, site by site; the loop is one search.advance an iteration,
    and engine.query's visit totals are numbers once read."""
    kw = dict(visit_batch=2, **MODES[mode])
    before = _reads()
    plain = two_shards.query(walk_queries, 5, G.ng(6), **kw)
    untraced = _delta(before, _reads())
    obs.clear()
    obs.enable()
    try:
        before = _reads()
        traced = two_shards.query(walk_queries, 5, G.ng(6), **kw)
        traced_reads = _delta(before, _reads())
        spans = obs.tracer().spans()
    finally:
        obs.disable()
        obs.clear()
    for a, b in zip(plain[:4], traced[:4]):
        assert torch.equal(a, b)
    assert plain.iterations == traced.iterations
    assert traced_reads == untraced
    names = [sp.name for sp in spans]
    assert names.count("search.advance") == sum(traced.iterations) \
        == names.count("search.settle")
    assert names.count("search.filter") == names.count("search.finish") == 2
    assert names.count("engine.merge") == 1
    (root,) = [sp for sp in spans if sp.name == "engine.query"]
    assert root.attrs["leaves_visited"] == int(traced.leaves_visited.sum())
    assert root.attrs["rows_scanned"] == int(traced.rows_scanned.sum())
    assert isinstance(root.attrs["rows_scanned"], int)


@pytest.mark.parametrize("mode", list(MODES))
def test_host_reads_are_two_an_iteration_and_two_a_shard(
        two_shards, walk_queries, mode):
    """The loop waits twice an iteration (the refill test, settle's
    flag) and twice a shard a batch (epsilon's and r_delta's scalars
    copied up), and nowhere else on the resident path."""
    before = _reads()
    out = two_shards.query(walk_queries, 5, G.ng(6), visit_batch=2,
                           **MODES[mode])
    its = sum(out.iterations)
    assert _delta(before, _reads()) == {
        "search.iterations": its,
        "search.host_reads{site=refill}": its,
        "search.host_reads{site=settle}": its,
        "search.host_reads{site=eps_mult}": 2,
        "search.host_reads{site=r_delta}": 2}


@pytest.mark.parametrize("fold", [S.POOL_FOLD, 2])
def test_pooled_rows_count_the_coop_mask(walk_data, walk_queries,
                                         monkeypatch, fold):
    """search.pooled_rows is the coop mask's true slots summed over the
    iterations, search.pooled_pairs those times the lanes still active,
    however many iterations are held before they count; counted only
    while a span sink is on."""
    monkeypatch.setattr(S, "POOL_FOLD", fold)
    ix = dstree.build(walk_data, leaf_cap=32, device="cpu")
    q = torch.as_tensor(walk_queries)
    seen = []
    real = S.refine.coop_mask

    def spy(leaf, ok, valid):
        m = real(leaf, ok, valid)
        seen.append(int(m.sum()))
        return m

    monkeypatch.setattr(S.refine, "coop_mask", spy)
    rows = obs.REGISTRY.counter("search.pooled_rows")
    pairs = obs.REGISTRY.counter("search.pooled_pairs")
    r0, p0 = rows.value, pairs.value
    S.refine_loop(S.refine.ResidentSource(ix), q, 5, nprobe=5,
                  visit_batch=2, share_gathers=True)
    assert seen and (rows.value, pairs.value) == (r0, p0)  # no sink on
    seen.clear()
    obs.enable()
    try:
        run = S.Refinement(S.refine.ResidentSource(ix), q, 5, nprobe=5,
                           visit_batch=2, share_gathers=True)
        lanes = []
        while run.go:
            lanes.append(int(run.active.sum()))
            run.step()
        run.finish()
    finally:
        obs.disable()
        obs.clear()
    assert len(seen) == len(lanes) == run.iterations > 1
    assert rows.value - r0 == sum(seen)
    assert pairs.value - p0 == sum(s * a for s, a in zip(seen, lanes))


def test_a_counter_sums_device_increments_and_reads_them_once():
    c = MetricsRegistry().counter("pool")
    c.inc(2)
    c.inc(torch.tensor(3))
    c.inc(torch.tensor(4))
    assert c.value == 9 and isinstance(c.value, int)
    c.mark()
    c.inc(torch.tensor(1))
    assert c.since_mark == 1


def test_a_span_site_under_the_profiler_alone(traced):
    """With only a profiler recording, a site is the profiler's
    annotation and records nothing in memory; with neither on, the
    shared no-op; with both, the span lands in both."""
    from torch.profiler import ProfilerActivity, profile

    obs.disable()
    assert obs.span("x") is obs.NULL_SPAN and not obs.sink_on()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert obs.sink_on()
        with obs.span("search.only_profiler") as sp:
            sp.set(n=1)
            torch.ones(3).sum()
        obs.enable()
        with obs.span("search.both"):
            torch.ones(3).sum()
    assert [s.name for s in traced.spans()] == ["search.both"]
    names = {e.name for e in prof.events()}
    assert {"search.only_profiler", "search.both"} <= names


def test_device_attributes_are_read_when_the_spans_are(traced):
    with obs.span("outer") as sp:
        sp.set(rows=torch.tensor([1, 2, 3]), ms=torch.tensor(0.5))
        assert isinstance(traced.current().attrs["rows"], torch.Tensor)
    (got,) = traced.spans()
    assert got.attrs == {"rows": 6, "ms": 0.5}
    json.dumps(obs.chrome_events(traced.spans()))


def test_a_build_is_a_span_tree_with_its_phase_seconds(walk_data, traced):
    eng = DistributedEngine(shards=2, device="cpu").build(
        walk_data, index=IndexSpec("dstree", leaf_cap=32))
    prof = obs.last_profile("engine.build")
    assert set(prof.phase_ms) == {"engine.histogram", "index.build",
                                  "engine.pad"}
    snap = obs.REGISTRY.snapshot("engine.build_s")
    phases = {k[len("engine.build_s{phase="):-1]: v for k, v in snap.items()}
    assert set(phases) == {"histogram", "index", "pad", "total"}
    assert 0 < phases["index"] <= phases["total"]
    assert phases["total"] >= sum(phases[p] for p in
                                  ("histogram", "index", "pad"))
    assert eng.resident is not None


def test_kernels_compiles_counts_an_nvcc_run(tmp_path, monkeypatch,
                                             traced):
    """A kernel built again counts once under kernels.compiles and is a
    kernels.compile span; a build found on disk counts nothing."""
    from repro_torch.kernels import build

    def fake_nvcc(cmd, **kw):
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", fake_nvcc)
    c = obs.REGISTRY.counter("kernels.compiles", kernel="paa")
    n0 = c.value
    path = build._compile("paa")
    assert path.exists() and c.value == n0 + 1
    build._compile("paa")
    assert c.value == n0 + 1
    (sp,) = traced.find("kernels.compile")
    assert sp.attrs["kernel"] == "paa"
