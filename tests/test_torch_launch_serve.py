"""repro_torch's serving loop (launch/serve.py): both fronts decode every
request and merge its retrieval back by uid, with the reference's latency
breakdown, histograms, counters and spans. Against the JAX package's
fronts on the tests' walk: the reference's weights carried over in f32,
the reference engine beside the port's, no-deadline requests (the exact
tier) — equal tokens, equal ids and kinds.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.core import IndexSpec as JIndexSpec
from repro.core import StoreSpec as JStoreSpec
from repro.core.engine import DistributedEngine as JEngine
from repro.launch import serve as jserve
from repro.models import model as JM
from repro.models.params import initialize as jinitialize
from repro.serve import batching as jbat
from repro_torch import obs
from repro_torch.configs import get_smoke_config
from repro_torch.core.engine import DistributedEngine, QueryResult
from repro_torch.core.spec import StoreSpec
from repro_torch.launch.serve import serve_requests, serve_requests_continuous
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import AdmissionController, Request
from repro_torch.serve import batching as bat


class _StubEngine:
    """Lane i's ids are 10 * its series value + 0..k-1; stats None
    (resident style). ``delay_s`` keeps a lane busy."""

    def __init__(self, delay_s: float = 0.0):
        self.delay_s = delay_s
        self.calls = []
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


@pytest.fixture(scope="module")
def smoke_model():
    cfg = get_smoke_config("gemma2-2b")
    return cfg, M.Model.init(cfg, 0, "cpu")


def _mk(cfg, rng):
    def mk(uid, dl, series):
        return Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab_size, size=6).astype(np.int32), max_new_tokens=3,
            deadline_ms=dl, series=series)

    return mk


def test_serve_requests_continuous_end_to_end(smoke_model):
    """serve_requests_continuous: decode batches overlap continuous
    retrieval, ticket results merge back per uid, a no-series request
    decodes without a retrieval entry, and an admission-rejected request
    still decodes and surfaces the reason."""
    cfg, model = smoke_model
    mk = _mk(cfg, np.random.default_rng(0))
    reqs = [mk(0, None, np.full(8, 0, np.float32)),
            mk(1, 30.0, np.full(8, 1, np.float32)),
            mk(2, None, None),                      # decode-only
            mk(3, 5.0, np.full(8, 3, np.float32))]
    out = serve_requests_continuous(model, cfg, reqs, engine=_StubEngine(),
                                    retrieval_k=3, max_batch=2)
    assert sorted(out) == [0, 1, 2, 3]
    for r in out.values():
        assert r["tokens"].shape == (3,)
        assert r["latency_ms"] >= r["queue_wait_ms"] >= 0.0
    assert np.array_equal(out[0]["retrieval"]["ids"], np.arange(3))
    assert out[0]["retrieval"]["nominal_kind"] == "exact"
    assert "retrieval" not in out[2] and out[2]["guarantee"] == "exact"
    assert out[3]["retrieval"]["kind"] == "ng"
    assert out[1]["guarantee"] == out[1]["retrieval"]["kind"]
    assert "deadline_hit" in out[1] and "deadline_hit" in out[3]

    # past the admission cap the request still decodes; the entry carries
    # the reject reason instead of a retrieval block (the stalled stub
    # keeps the first request in-system so the second submit hits the cap)
    reqs2 = [mk(10, None, np.full(8, 10, np.float32)),
             mk(11, None, np.full(8, 11, np.float32))]
    out2 = serve_requests_continuous(
        model, cfg, reqs2, engine=_StubEngine(delay_s=0.3), retrieval_k=3,
        max_batch=1, admission=AdmissionController(max_depth=1))
    assert out2[11]["retrieval_rejected"] == "queue_full"
    assert out2[11]["tokens"].shape == (3,)
    assert np.array_equal(out2[10]["retrieval"]["ids"], 100 + np.arange(3))


def test_serve_requests_static_breakdown_metrics_and_spans(smoke_model):
    """The static front: latency is the sum of its components, each
    request's retrieval its own group's time; the registry records the
    reference's histograms and counters; tracing gives one serve.batch
    span per drained batch, each with one serve.generate under it."""
    cfg, model = smoke_model
    mk = _mk(cfg, np.random.default_rng(1))
    reqs = [mk(0, None, np.full(8, 0, np.float32)),
            mk(1, 2.0, np.full(8, 1, np.float32)),
            mk(2, None, None),
            mk(3, 1e6, np.full(8, 3, np.float32))]
    reg = obs.REGISTRY
    before = reg.histogram("serve.generate_ms").count
    hits = sum(c.value for c in reg.collect("serve.deadline."))
    obs.clear()
    obs.enable()
    try:
        out = serve_requests(model, cfg, reqs, engine=_StubEngine(),
                             retrieval_k=3, max_batch=2,
                             guarantee_kw={"full_budget_ms": 50.0})
    finally:
        obs.disable()
    assert sorted(out) == [0, 1, 2, 3]
    for r in out.values():
        assert r["tokens"].shape == (3,)
        assert r["latency_ms"] == pytest.approx(
            r["queue_wait_ms"] + r["generate_ms"] + r["retrieval_ms"])
    assert out[1]["guarantee"] == "ng" and out[0]["guarantee"] == "exact"
    assert "retrieval" not in out[2] and out[2]["retrieval_ms"] == 0.0
    assert np.array_equal(out[3]["retrieval"]["ids"], 30 + np.arange(3))
    assert reg.histogram("serve.generate_ms").count == before + 4
    assert sum(c.value for c in reg.collect("serve.deadline.")) == hits + 2
    spans = obs.tracer().spans()
    by_id = {sp.id: sp for sp in spans}
    batches = [sp for sp in spans if sp.name == "serve.batch"]
    gens = [sp for sp in spans if sp.name == "serve.generate"]
    assert len(batches) == len(gens) == 2
    assert all(by_id[sp.parent].name == "serve.batch" for sp in gens)
    assert all(sp.attrs["tokens"] == 3 for sp in gens)
    obs.clear()


# ------------------------------------------- against the reference's fronts
@pytest.fixture(scope="module")
def pair(walk_data, tmp_path_factory):
    """Both models on the reference's f32 weights; the reference's
    mesh-free engine spills the tests' walk (4 DSTree shards, leaf_cap 16)
    and the port's engine opens that spill."""
    jcfg = dataclasses.replace(jget_smoke("gemma2-2b"),
                               param_dtype=jnp.float32,
                               compute_dtype=jnp.float32)
    cfg = dataclasses.replace(get_smoke_config("gemma2-2b"),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    jp = jinitialize(JM.model_specs(jcfg), jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg,
                            "cpu")
    spill = str(tmp_path_factory.mktemp("launch_serve_spill"))
    jeng = JEngine(mesh=None, method="dstree", shards=4)
    jeng.build(walk_data, index=JIndexSpec("dstree", leaf_cap=16),
               store=JStoreSpec(spill_dir=spill, keep_resident=False))
    eng = DistributedEngine.open_spill(
        StoreSpec(spill_dir=spill, keep_resident=False), device="cpu")
    yield (jcfg, jp, jeng), (cfg, model, eng)
    jeng.close()
    eng.close()


@pytest.mark.parametrize("front", ["static", "continuous"])
def test_fronts_match_the_reference(pair, walk_queries, front):
    """Prompts of 3 to 20 tokens (two buckets), 3 new tokens, max batch 2,
    one request without a series."""
    (jcfg, jp, jeng), (cfg, model, eng) = pair
    rng = np.random.default_rng(2)
    lens = [3, 20, 7, 18]
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lens]
    series = [walk_queries[i] for i in range(3)] + [None]

    def reqs(mod):
        return [mod.Request(uid=i, prompt=prompts[i], max_new_tokens=3,
                            series=series[i]) for i in range(len(lens))]

    fn, jfn = {"static": (serve_requests, jserve.serve_requests),
               "continuous": (serve_requests_continuous,
                              jserve.serve_requests_continuous)}[front]
    got = fn(model, cfg, reqs(bat), engine=eng, retrieval_k=5, max_batch=2)
    want = jfn(jp, jcfg, reqs(jbat), engine=jeng, retrieval_k=5,
               max_batch=2)
    assert sorted(got) == sorted(want) == list(range(len(lens)))
    for uid in got:
        g, w = got[uid], want[uid]
        np.testing.assert_array_equal(g["tokens"], np.asarray(w["tokens"]))
        assert g["guarantee"] == w["guarantee"] == "exact"
        assert ("retrieval" in g) == ("retrieval" in w) == (uid != 3)
        if uid != 3:
            assert g["retrieval"]["kind"] == w["retrieval"]["kind"]
            np.testing.assert_array_equal(
                g["retrieval"]["ids"], np.asarray(w["retrieval"]["ids"]))
            np.testing.assert_allclose(
                g["retrieval"]["dists"], np.asarray(w["retrieval"]["dists"]),
                rtol=1e-5, atol=1e-4)
