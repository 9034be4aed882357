"""repro_torch's serving front against the JAX package's, on the CPU, on
identical inputs: the pure functions of repro.serve.batching and
repro.serve.admission, the scheduler's drain order, the histogram's
quantiles (bit-equal: the same bucket constants), and a port ServeFront
over the port's open_spill of the reference's spilled f32 stores against
the reference's ServeFront over the reference engine (no-deadline
requests; ids equal, distances within Queue 3's engine rule: rtol 1e-5,
atol 1e-4, since the port's f32 sums run in another order than XLA's).
"""

import numpy as np
import pytest

from repro.core import IndexSpec as JIndexSpec
from repro.core import StoreSpec as JStoreSpec
from repro.core.engine import DistributedEngine as JEngine
from repro.core.guarantees import Guarantee as JGuarantee
from repro.obs.metrics import Histogram as JHistogram
from repro.serve import admission as jadm
from repro.serve import batching as jbat
from repro.serve.loop import ServeFront as JServeFront
from repro_torch.core.engine import DistributedEngine
from repro_torch.core.guarantees import Guarantee
from repro_torch.core.spec import StoreSpec
from repro_torch.obs import Histogram
from repro_torch.serve import admission as adm
from repro_torch.serve import batching as bat
from repro_torch.serve.loop import ServeFront

N, DIM, SHARDS, K = 512, 32, 4, 5
DIST_TOL = dict(rtol=1e-5, atol=1e-4)
DEADLINES = [None, 0.0, 1e-4, 0.5, 1.0, 2.0, 5.0, 12.0, 12.5, 24.9, 25.0,
             25.1, 30.0, 40.0, 49.99, 50.0, 60.0, 1e6]
GKWS = [{}, dict(full_budget_ms=50.0, epsilon=0.1),
        dict(full_budget_ms=3.0, delta_budget_frac=0.25, nprobe_floor=2,
             nprobe_ceil=26),
        dict(full_budget_ms=1000.0, degraded_delta=0.9,
             degraded_epsilon=0.5, epsilon=2.0)]
LATTICE = ([Guarantee(), Guarantee(epsilon=0.1), Guarantee(epsilon=1.0),
            Guarantee(epsilon=3.0), Guarantee(delta=0.99, epsilon=1.0),
            Guarantee(delta=0.5, epsilon=0.0),
            Guarantee(delta=0.9, epsilon=2.0)]
           + [Guarantee(nprobe=p) for p in (1, 2, 3, 16, 26, 64)])


def _both(fn_name, *args, **kw):
    return (tuple(getattr(bat, fn_name)(*args, **kw)),
            tuple(getattr(jbat, fn_name)(*args, **kw)))


@pytest.mark.parametrize("gkw", GKWS, ids=range(len(GKWS)))
def test_guarantee_for_deadline_matches_reference(gkw):
    for dl in DEADLINES:
        got, want = _both("guarantee_for_deadline", dl, **gkw)
        assert got == want, (dl, got, want)


def test_degrade_tier_matches_reference_over_the_lattice():
    for g in LATTICE:
        cur, jcur = g, JGuarantee(*g)
        for _ in range(8):  # down the ladder to the floor
            cur, jcur = adm.degrade_tier(cur), jadm.degrade_tier(jcur)
            assert tuple(cur) == tuple(jcur), (g, cur, jcur)
            assert cur.kind == jcur.kind


def _request_pairs(deadlines, waits_ms, at):
    """The same requests for both packages, submitted waits_ms before
    ``at``."""
    ours, theirs = [], []
    for uid, (dl, w) in enumerate(zip(deadlines, waits_ms)):
        series = np.full(8, uid, np.float32)
        for mod, out in ((bat, ours), (jbat, theirs)):
            r = mod.Request(uid=uid, prompt=np.arange(4, dtype=np.int32),
                            deadline_ms=dl, series=series)
            r.submitted_at = at - w * 1e-3
            out.append(r)
    return ours, theirs


@pytest.mark.parametrize("gkw", GKWS[:3], ids=range(3))
def test_retrieval_groups_and_budget_match_reference(gkw):
    rng = np.random.default_rng(1)
    dls = [DEADLINES[i] for i in rng.integers(0, len(DEADLINES), 40)]
    waits = rng.uniform(0.0, 60.0, 40).tolist()
    at = 1000.0
    ours, theirs = _request_pairs(dls, waits, at)
    for r, jr in zip(ours, theirs):
        assert bat.remaining_budget_ms(r, at) \
            == jbat.remaining_budget_ms(jr, at)
    for when in (None, at):
        got = bat.retrieval_groups(ours, at=when, **gkw)
        want = jbat.retrieval_groups(theirs, at=when, **gkw)
        assert [(tuple(g), [r.uid for r in rs]) for g, rs in got] \
            == [(tuple(g), [r.uid for r in rs]) for g, rs in want]


def test_scheduler_drain_order_matches_reference():
    rng = np.random.default_rng(2)
    lens = rng.integers(1, 70, 60)
    stamps = np.cumsum(rng.uniform(0.0, 1.0, 60))
    rng.shuffle(stamps)  # submission order is not stamp order
    s, js = bat.Scheduler(max_batch=3, min_bucket=8), \
        jbat.Scheduler(max_batch=3, min_bucket=8)
    for uid, (ln, t) in enumerate(zip(lens, stamps)):
        for mod, sched in ((bat, s), (jbat, js)):
            r = mod.Request(uid=uid, prompt=np.arange(ln, dtype=np.int32))
            r.submitted_at = float(t)
            sched.submit(r)
    while True:
        got, want = s.next_batch(), js.next_batch()
        if want is None:
            assert got is None
            break
        assert got[0] == want[0]
        assert [r.uid for r in got[1]] == [r.uid for r in want[1]]
        assert np.array_equal(s.pad_prompts(*got), js.pad_prompts(*want))


def test_admission_trace_matches_reference():
    rng = np.random.default_rng(3)
    a = adm.AdmissionController(max_depth=10, shed_high_frac=0.7,
                                shed_low_frac=0.2)
    ja = jadm.AdmissionController(max_depth=10, shed_high_frac=0.7,
                                  shed_low_frac=0.2)
    assert (a.shed_high, a.shed_low) == (ja.shed_high, ja.shed_low)
    for op in rng.integers(0, 3, 300):
        if op:
            assert a.try_admit("exact") == ja.try_admit("exact")
        else:
            n = int(rng.integers(1, 4))
            a.release(n)
            ja.release(n)
        assert (a.depth, a.shedding()) == (ja.depth, ja.shedding())


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_histogram_quantiles_bit_equal_to_reference(scale):
    rng = np.random.default_rng(4)
    vals = (rng.lognormal(0.0, 2.0, 500) * scale).tolist() + [0.0, 1e-12]
    h, jh = Histogram("h", ()), JHistogram("h", ())
    for v in vals:
        h.record(v)
        jh.record(v)
    for q in np.linspace(0.0, 1.0, 41):
        assert h.quantile(q) == jh.quantile(q), q
    assert h.quantiles() == jh.quantiles()
    assert h.snapshot() == jh.snapshot()


# --------------------------------------------- the front over the engine
@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    data = np.cumsum(rng.normal(size=(N, DIM)), axis=1)
    data = ((data - data.mean(1, keepdims=True))
            / (data.std(1, keepdims=True) + 1e-9)).astype(np.float32)
    queries = (data[rng.choice(N, 8, replace=False)]
               + 0.05 * rng.normal(size=(8, DIM))).astype(np.float32)
    return data, queries


@pytest.fixture(scope="module")
def ref_spill(tmp_path_factory, corpus):
    data, _ = corpus
    tmp = str(tmp_path_factory.mktemp("serve_ref_spill"))
    eng = JEngine(mesh=None, method="dstree", shards=SHARDS)
    eng.build(data, index=JIndexSpec("dstree", leaf_cap=16),
              store=JStoreSpec(spill_dir=tmp, codec="f32",
                               keep_resident=False))
    eng.close()
    return tmp


def _serve(front_cls, engine, mod, queries):
    """Every query as a no-deadline request, all queued before the lanes
    start (two drains of 4: one lane bucket)."""
    front = front_cls(engine, K, max_batch=4)
    tickets = [front.submit(mod.Request(uid=i,
                                        prompt=np.zeros(2, np.int32),
                                        series=q))
               for i, q in enumerate(queries)]
    front.start()
    try:
        return [t.result(timeout=300) for t in tickets]
    finally:
        front.stop()


def test_front_over_reference_spill_matches_reference_front(corpus,
                                                            ref_spill):
    _, queries = corpus
    jeng = JEngine.open_spill(JStoreSpec(spill_dir=ref_spill,
                                         keep_resident=False))
    eng = DistributedEngine.open_spill(
        StoreSpec(spill_dir=ref_spill, keep_resident=False), device="cpu")
    try:
        want = _serve(JServeFront, jeng, jbat, queries)
        got = _serve(ServeFront, eng, bat, queries)
    finally:
        jeng.close()
        eng.close()
    for g, w in zip(got, want):
        assert "error" not in g and "error" not in w, (g, w)
        assert g["kind"] == w["kind"] == "exact"
        assert g["nominal_kind"] == w["nominal_kind"]
        np.testing.assert_array_equal(g["ids"], np.asarray(w["ids"]))
        np.testing.assert_allclose(g["dists"], np.asarray(w["dists"]),
                                   **DIST_TOL)
        assert g["stats"].leaves_visited == w["stats"].leaves_visited
