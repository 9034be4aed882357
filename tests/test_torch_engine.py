"""repro_torch's sharded engine against the JAX package's, on the
reference's own fault corpus (tests/test_fault.py): 512 random walks of
length 32, 4 queries, k = 5, 4 shards, DSTree with leaf_cap 16. The
reference is the mesh-free ``repro.core.engine.DistributedEngine``.

- Out of core, the port serves the reference's spill with its ids,
  bit-equal distances and its leaves_visited, rows_scanned and
  lb_computed, under exact, epsilon, delta-epsilon and ng(4); its own
  build writes the reference's artifacts, which the reference reads.
- Resident, the port's engine equals its own out-of-core answers (the
  reference asserts the same of itself), and sync_bsf returns the same
  answer with no more leaves visited, the reference's count.
- Faults through the engine: failover, honest degradation with the
  reference's effective_delta, deadlines, close() while a query runs.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import IndexSpec as JIndexSpec
from repro.core import StoreSpec as JStoreSpec
from repro.core import guarantees as JG
from repro.core.engine import DistributedEngine as JEngine
from repro.core.guarantees import \
    effective_delta_after_loss as j_effective_delta
from repro.fault import FaultInjector as JFaultInjector
from repro.serve.fault import RetryPolicy as JRetryPolicy
from repro.store import load_index as jload
from repro_torch.core import guarantees as G
from repro_torch.core import search as S
from repro_torch.core.engine import DistributedEngine
from repro_torch.core.spec import IndexSpec, StoreSpec
from repro_torch.fault import FaultInjector
from repro_torch.obs import REGISTRY
from repro_torch.serve.fault import RetryPolicy, ShardLost
from repro_torch.store import DeviceLeafCache, LeafPrefetcher, load_index

N, DIM, SHARDS, K = 512, 32, 4, 5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GUARANTEES = {
    "exact": (JG.exact(), G.exact()),
    "eps": (JG.epsilon(1.0), G.epsilon(1.0)),
    "delta_eps": (JG.delta_epsilon(0.99, 0.5), G.delta_epsilon(0.99, 0.5)),
    "ng": (JG.ng(4), G.ng(4)),
}
FAST = RetryPolicy(max_attempts=2, backoff_base_s=0.0)
# distances: the port scores q.q - 2 q.x + x.x with its own f32 matmul and
# norms, whose sums run in another order than XLA's (~1e-5 apart here)
DIST_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    data = np.cumsum(rng.normal(size=(N, DIM)), axis=1)
    data = ((data - data.mean(1, keepdims=True))
            / (data.std(1, keepdims=True) + 1e-9)).astype(np.float32)
    queries = (data[rng.choice(N, 4, replace=False)]
               + 0.05 * rng.normal(size=(4, DIM))).astype(np.float32)
    return data, queries


@pytest.fixture(scope="module")
def ref_spill(tmp_path_factory, corpus):
    """The reference's 4-shard f32 spill with replicas=2."""
    data, _ = corpus
    tmp = str(tmp_path_factory.mktemp("ref_spill"))
    eng = JEngine(mesh=None, method="dstree", shards=SHARDS)
    eng.build(data, index=JIndexSpec("dstree", leaf_cap=16),
              store=JStoreSpec(spill_dir=tmp, codec="f32",
                               keep_resident=False, replicas=2))
    eng.close()
    return tmp


@pytest.fixture(scope="module")
def ref_engine(ref_spill):
    eng = JEngine.open_spill(JStoreSpec(spill_dir=ref_spill,
                                        keep_resident=False))
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def port_built(tmp_path_factory, corpus):
    """The port's own build: resident shards and a spill with
    replicas=2, on the CPU."""
    data, _ = corpus
    tmp = str(tmp_path_factory.mktemp("port_spill"))
    eng = DistributedEngine(shards=SHARDS, device="cpu")
    eng.build(data, index=IndexSpec("dstree", leaf_cap=16),
              store=StoreSpec(spill_dir=tmp, replicas=2))
    yield eng, tmp
    eng.close()


@pytest.fixture(scope="module")
def engine(ref_spill):
    """The port serving the reference's spill."""
    eng = DistributedEngine.open_spill(
        StoreSpec(spill_dir=ref_spill, keep_resident=False), device="cpu")
    yield eng
    eng.close()


def surviving_oracle(data, queries, lost):
    """Brute force over the rows of the shards not lost, ids global."""
    bounds = np.linspace(0, N, SHARDS + 1).astype(np.int64)
    mask = np.ones(N, bool)
    for si in lost:
        mask[bounds[si]:bounds[si + 1]] = False
    ids_map = np.where(mask)[0]
    bf = S.brute_force(queries, data[mask], K, device="cpu")
    return ids_map[bf.ids.numpy()], bf.dists.numpy()


def assert_same(got, want):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               **DIST_TOL)
    np.testing.assert_array_equal(got.leaves_visited.numpy(),
                                  np.asarray(want.leaves_visited))
    np.testing.assert_array_equal(got.rows_scanned.numpy(),
                                  np.asarray(want.rows_scanned))
    assert got.lb_computed == int(want.lb_computed)


# ------------------------------------------------------------ parity
@pytest.mark.parametrize("gname", sorted(GUARANTEES))
def test_port_serves_the_reference_spill(corpus, ref_engine, engine,
                                         gname):
    _, queries = corpus
    jg, g = GUARANTEES[gname]
    want = ref_engine.query(jnp.asarray(queries), K, jg)
    got = engine.query(queries, K, g)
    assert_same(got, want)
    assert got.stats.iterations == want.stats.iterations
    assert got.stats.leaves_visited == want.stats.leaves_visited
    assert len(got.stats.shards) == SHARDS
    assert not got.stats.degraded and got.stats.effective_delta == g.delta
    assert sum(got.iterations) == got.stats.iterations


def test_port_build_writes_the_reference_artifacts(ref_spill, port_built):
    eng, tmp = port_built
    assert eng.shard_dirs == tuple(
        os.path.join(tmp, f"shard_{si:04d}") for si in range(SHARDS))
    for si in range(SHARDS):
        name = f"shard_{si:04d}"
        mine = load_index(os.path.join(tmp, name), device="cpu")
        ref = load_index(os.path.join(ref_spill, name), device="cpu")
        for f in ("box_lo", "box_hi", "offsets", "ids", "data"):
            assert torch.equal(getattr(mine, f), getattr(ref, f)), (si, f)
        assert torch.equal(mine.hist.edges, ref.hist.edges)
        assert torch.equal(mine.hist.cdf, ref.hist.cdf)
        assert mine.n_total == ref.n_total == N
        assert eng.shard_replica_dirs[si] == (
            os.path.join(tmp, name),
            os.path.join(tmp, "replicas", "r1", name))


def test_reference_reads_the_port_spill(corpus, port_built, ref_engine):
    _, queries = corpus
    _, tmp = port_built
    ref = JEngine.open_spill(JStoreSpec(spill_dir=tmp, keep_resident=False))
    try:
        assert [len(c) for c in ref.shard_replica_dirs] == [2] * SHARDS
        for gname in ("exact", "delta_eps"):
            jg = GUARANTEES[gname][0]
            got = ref.query(jnp.asarray(queries), K, jg)
            want = ref_engine.query(jnp.asarray(queries), K, jg)
            np.testing.assert_array_equal(np.asarray(got.ids),
                                          np.asarray(want.ids))
            # the port's spill carries the port's row norms
            np.testing.assert_allclose(np.asarray(got.dists),
                                       np.asarray(want.dists), **DIST_TOL)
    finally:
        ref.close()


@pytest.mark.parametrize("gname", sorted(GUARANTEES))
def test_resident_engine_equals_its_out_of_core_answers(corpus, port_built,
                                                        gname):
    _, queries = corpus
    eng, _ = port_built
    g = GUARANTEES[gname][1]
    res = eng.query(queries, K, g)
    ooc = eng.query(queries, K, g, ooc=True)
    assert res.stats is None and ooc.stats is not None
    for f in ("ids", "dists", "leaves_visited", "rows_scanned"):
        assert torch.equal(getattr(res, f), getattr(ooc, f)), f
    assert res.iterations == ooc.iterations
    max_leaves = max(load_index(d, resident="summaries",
                                device="cpu").num_leaves
                     for d in eng.shard_dirs)
    assert res.lb_computed == SHARDS * max_leaves
    assert {sh.num_leaves for sh in eng.resident} == {max_leaves}


def test_share_gathers_keeps_the_exact_answer(corpus, port_built):
    data, queries = corpus
    eng, _ = port_built
    bf = S.brute_force(queries, data, K, device="cpu")
    for ooc in (False, True):
        res = eng.query(queries, K, G.exact(), share_gathers=True, ooc=ooc)
        assert torch.equal(res.ids, bf.ids)
        if ooc:
            assert res.stats.share_gathers


def test_sync_bsf_keeps_the_answer_and_visits_no_more(corpus, port_built):
    _, queries = corpus
    eng, _ = port_built
    plain = eng.query(queries, K, G.exact())
    sync = eng.query(queries, K, G.exact(), sync_bsf=True)
    assert torch.equal(sync.ids, plain.ids)
    assert torch.equal(sync.dists, plain.dists)
    assert bool((sync.leaves_visited <= plain.leaves_visited).all())
    assert int(sync.leaves_visited.sum()) < int(plain.leaves_visited.sum())
    with pytest.warns(UserWarning, match="sync_bsf is not supported"):
        ooc = eng.query(queries, K, G.exact(), sync_bsf=True, ooc=True)
    assert torch.equal(ooc.ids, plain.ids)


def test_sync_bsf_visits_what_the_reference_visits(corpus, port_built):
    """The reference's resident sync_bsf (shard_map over 4 host devices,
    in a subprocess) visits the leaves the port's lockstep visits."""
    _, queries = corpus
    eng, _ = port_built
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    code = textwrap.dedent(f"""
        import json, numpy as np, jax, jax.numpy as jnp
        from repro.core.engine import DistributedEngine
        from repro.core.guarantees import Guarantee
        from repro.core import IndexSpec
        rng = np.random.default_rng(0)
        data = np.cumsum(rng.normal(size=({N}, {DIM})), axis=1)
        data = ((data - data.mean(1, keepdims=True))
                / (data.std(1, keepdims=True) + 1e-9)).astype(np.float32)
        q = (data[rng.choice({N}, 4, replace=False)]
             + 0.05 * rng.normal(size=(4, {DIM}))).astype(np.float32)
        eng = DistributedEngine(jax.make_mesh((4,), ("data",)),
                                axes=("data",), method="dstree")
        eng.build(data, index=IndexSpec("dstree", leaf_cap=16))
        r = eng.query(jnp.asarray(q), {K}, Guarantee(), sync_bsf=True)
        print("RESULT", json.dumps([np.asarray(r.ids).tolist(),
                                    np.asarray(r.leaves_visited).tolist(),
                                    int(r.lb_computed)]))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("RESULT")][0]
    ids, leaves, lbs = json.loads(line[len("RESULT"):])
    sync = eng.query(queries, K, G.exact(), sync_bsf=True)
    assert sync.ids.tolist() == ids
    assert sync.leaves_visited.tolist() == leaves
    assert sync.lb_computed == lbs


# ------------------------------------------------------------ faults
def test_concurrent_queries_equal_a_serial_query(corpus, engine):
    """Queries from several threads share the copies' warm caches under
    their locks and return what a serial query returns, with no fault
    counted."""
    data, queries = corpus
    bf = S.brute_force(queries, data, K, device="cpu")
    serial = engine.query(queries, K, G.exact())
    out, err = [None] * 3, []

    def run(i):
        try:
            out[i] = engine.query(queries, K, G.exact())
        except BaseException as e:  # re-raised on the main thread below
            err.append(e)

    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(out))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert not err, err
    assert torch.equal(serial.ids, bf.ids)
    for res in out + [serial]:
        assert torch.equal(res.ids, serial.ids)
        assert torch.equal(res.dists, serial.dists)
        assert torch.equal(res.leaves_visited, serial.leaves_visited)
        st = res.stats
        assert not st.degraded and st.shards_lost == 0
        assert st.retries == st.failovers == 0


def test_owner_kill_fails_over_to_replica_full_answer(corpus, engine):
    _, queries = corpus
    clean = engine.query(queries, K, G.exact())
    inj = FaultInjector().kill_shard(1, replica=0)  # the owner copy only
    c_over = REGISTRY.counter("fault.failovers", shard="1")
    c_over.mark()
    res = engine.query(queries, K, G.exact(),
                       ooc_opts={"fault": inj, "retry": FAST})
    st = res.stats
    assert not st.degraded and st.shards_lost == 0
    assert st.failovers == 1 and st.retries == 1
    assert c_over.since_mark == 1
    assert torch.equal(res.ids, clean.ids)
    assert torch.equal(res.dists, clean.dists)


def test_shard_killed_past_replicas_degrades(corpus, engine, ref_engine):
    data, queries = corpus
    inj = FaultInjector().kill_shard(1)  # every copy, for good
    c_deg = REGISTRY.counter("engine.degraded_queries")
    c_lost = REGISTRY.counter("engine.shards_lost")
    c_deg.mark()
    c_lost.mark()
    with pytest.warns(UserWarning, match="lost past retries"):
        res = engine.query(queries, K, G.exact(),
                           ooc_opts={"fault": inj, "retry": FAST})
    st = res.stats
    assert st.degraded and st.shards_lost == 1
    assert res.iterations[1] == 0 and len(st.shards) == SHARDS - 1
    o_ids, o_dists = surviving_oracle(data, queries, [1])
    np.testing.assert_array_equal(res.ids.numpy(), o_ids)
    np.testing.assert_allclose(res.dists.numpy(), o_dists, rtol=1e-4,
                               atol=1e-4)
    assert 0.0 <= st.effective_delta < 1.0
    assert c_deg.since_mark == 1 and c_lost.since_mark == 1
    # the reference, under the same loss, reports the same delta
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        want = ref_engine.query(
            jnp.asarray(queries), K, JG.exact(),
            ooc_opts={"fault": JFaultInjector().kill_shard(1),
                      "retry": JRetryPolicy(max_attempts=2,
                                            backoff_base_s=0.0)})
    assert want.stats.degraded and want.stats.shards_lost == 1
    np.testing.assert_array_equal(res.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(res.dists.numpy(), np.asarray(want.dists),
                               **DIST_TOL)
    # the same function of the same loss: exactly the reference's at the
    # port's kth distances, and within their rounding of its own answer
    jhist = jload(engine.shard_dirs[0], resident="summaries").resident.hist
    exact = j_effective_delta(jhist, res.dists[:, K - 1].numpy(), N // 4,
                              delta=1.0, epsilon=0.0)
    assert abs(st.effective_delta - exact) <= 1e-12 * exact
    np.testing.assert_allclose(st.effective_delta,
                               want.stats.effective_delta, rtol=1e-3)


def test_slow_owner_deadline_fails_over(corpus, engine):
    _, queries = corpus
    clean = engine.query(queries, K, G.exact())
    # one stall on the owner copy's first gather, past the deadline,
    # which healthy attempts (milliseconds here) never reach
    inj = FaultInjector().delay("gather", shard=2, replica=0, seconds=2.5,
                                times=1)
    res = engine.query(
        queries, K, G.exact(),
        ooc_opts={"fault": inj,
                  "retry": RetryPolicy(max_attempts=2, backoff_base_s=0.0,
                                       attempt_deadline_s=2.0)})
    st = res.stats
    assert not st.degraded and st.failovers == 1
    assert st.shards[[s.failovers for s in st.shards].index(1)].iterations
    assert torch.equal(res.ids, clean.ids)


def test_mid_query_kill_degrades(corpus, engine):
    data, queries = corpus
    inj = FaultInjector().fail("gather", shard=2, after=1, times=np.inf)
    with pytest.warns(UserWarning, match="lost past retries"):
        res = engine.query(queries, K, G.exact(),
                           ooc_opts={"fault": inj, "retry": FAST})
    assert res.stats.degraded and res.stats.shards_lost == 1
    o_ids, _ = surviving_oracle(data, queries, [2])
    np.testing.assert_array_equal(res.ids.numpy(), o_ids)


def test_all_shards_lost_raises(corpus, engine):
    _, queries = corpus
    inj = FaultInjector()
    for si in range(SHARDS):
        inj.kill_shard(si)
    with pytest.raises(ShardLost, match="every shard"):
        engine.query(queries, K, G.exact(),
                     ooc_opts={"fault": inj, "retry": FAST})


def test_cache_and_prefetcher_survive_an_injected_fault(corpus, ref_spill):
    """A fault raised mid-iteration leaves a persistent cache and its
    prefetcher usable: the next search on them is the clean answer."""
    from repro_torch.serve.fault import FaultContext
    from repro_torch.store import search_ooc

    _, queries = corpus
    store = load_index(os.path.join(ref_spill, "shard_0002"),
                       resident="summaries", device="cpu")
    clean = search_ooc(store, queries, K, G.exact(), cache_leaves=4)
    cache = DeviceLeafCache(store, 4)
    cache.prefetcher = LeafPrefetcher(store, depth=3)
    try:
        for point, after in (("score", 2), ("gather", 3)):
            ctx = FaultContext(
                shard=2, injector=FaultInjector().fail(point, after=after))
            with pytest.raises(Exception, match="injected fault"):
                search_ooc(store, queries, K, G.exact(), cache=cache,
                           fault=ctx)
            assert cache.prefetcher._thread.is_alive()
            cache.reset_counters()
            again = search_ooc(store, queries, K, G.exact(), cache=cache)
            for f in ("ids", "dists", "leaves_visited", "rows_scanned"):
                assert torch.equal(getattr(again.result, f),
                                   getattr(clean.result, f)), (point, f)
            assert again.stats.hits + again.stats.misses == \
                clean.stats.hits + clean.stats.misses
    finally:
        cache.prefetcher.close()


# --------------------------------------------------------- lifecycle
def test_close_idempotent_and_rebuild_bit_exact(corpus, ref_spill,
                                                engine):
    _, queries = corpus
    first = engine.query(queries, K, G.exact())
    engine.close()
    engine.close()
    again = engine.query(queries, K, G.exact())
    assert torch.equal(first.ids, again.ids)
    fresh = DistributedEngine.open_spill(
        StoreSpec(spill_dir=ref_spill, keep_resident=False), device="cpu")
    try:
        re = fresh.query(queries, K, G.exact())
        assert torch.equal(first.ids, re.ids)
        assert torch.equal(first.dists, re.dists)
    finally:
        fresh.close()


def test_close_racing_inflight_query(corpus, engine):
    data, queries = corpus
    bf = S.brute_force(queries, data, K, device="cpu")
    inj = FaultInjector().delay("score", seconds=0.005)  # slow it down
    out, err = [], []

    def run():
        try:
            out.append(engine.query(queries, K, G.exact(),
                                    ooc_opts={"fault": inj}))
        except BaseException as e:  # re-raised on the main thread below
            err.append(e)

    th = threading.Thread(target=run)
    th.start()
    time.sleep(0.01)
    engine.close()  # lands mid-query (or harmlessly after)
    th.join(timeout=60)
    assert not th.is_alive()
    assert not err, err
    assert torch.equal(out[0].ids, bf.ids)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(ref_spill):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        DistributedEngine.open_spill(StoreSpec(spill_dir=ref_spill,
                                               keep_resident=False))
    with pytest.raises(RuntimeError, match="CUDA"):
        DistributedEngine(shards=2).build(np.zeros((16, 8), np.float32))


def test_launch_counts_survive_concurrent_threads():
    """Concurrent queries count kernel launches from several threads: no
    increment may be lost (a bare ``+= 1`` on the attribute can lose
    some under a short switch interval)."""
    from repro_torch.kernels import build, ops

    fn, threads, per = ops.lex_select, 16, 2000
    before = fn.launches
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [build.count_launch(fn)
                                               for _ in range(per)])
              for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert fn.launches == before + threads * per
    fn.launches = before
