"""repro_torch's fault-tolerance units against the JAX package's
semantics (tests/test_fault.py): the injector's rules, the retry
policy's backoff, the circuit breaker's states, the attempt deadline,
the failover loop, and the degraded answer's delta against the
reference's on the same histogram.

The port reads no clock: a deadline and a breaker's cooldown are timers
(serve.fault.Expiry), and these tests replace the timer factory with one
they fire by hand."""

import os

import numpy as np
import pytest

from repro.core import IndexSpec as JIndexSpec
from repro.core import StoreSpec as JStoreSpec
from repro.core.engine import DistributedEngine as JEngine
from repro.core.guarantees import \
    effective_delta_after_loss as j_effective_delta
from repro.store import load_index as j_load_index
from repro_torch.core.guarantees import effective_delta_after_loss
from repro_torch.fault import FaultInjected, FaultInjector
from repro_torch.obs import REGISTRY
from repro_torch.serve import fault as sfault
from repro_torch.serve.fault import (CircuitBreaker, Expiry, FaultContext,
                                     RetryPolicy, ShardLost, ShardTimeout,
                                     serve_shard_with_failover)
from repro_torch.store import load_index

N, DIM, SHARDS = 512, 32, 4


class HandTimer:
    """A timer that fires only when the test says so."""

    made = []

    def __init__(self, seconds, fn):
        self.seconds, self.fn = seconds, fn
        self.cancelled = False
        HandTimer.made.append(self)

    def start(self):
        pass

    def cancel(self):
        self.cancelled = True

    def fire(self):
        if not self.cancelled:
            self.fn()


@pytest.fixture
def hand_timers(monkeypatch):
    HandTimer.made = []
    monkeypatch.setattr(sfault, "TIMER", HandTimer)
    return HandTimer.made


# ------------------------------------------------------- injector units
def test_injector_times_and_after():
    inj = FaultInjector().fail("gather", shard=1, times=2, after=1)
    inj.check("gather", shard=1)  # 'after' swallows the first match
    for _ in range(2):
        with pytest.raises(FaultInjected):
            inj.check("gather", shard=1)
    inj.check("gather", shard=1)  # times exhausted
    inj.check("gather", shard=0)  # other shard never matched
    inj.check("score", shard=1)   # other point never matched


def test_injector_wildcard_and_replica_position():
    inj = FaultInjector().kill_shard(2, replica=0)
    with pytest.raises(FaultInjected):
        inj.check("shard", shard=2, replica=0)
    with pytest.raises(FaultInjected):  # for good: fires again
        inj.check("gather", shard=2, replica=0)
    inj.check("gather", shard=2, replica=1)  # a non-owner copy lives
    inj.clear()
    inj.check("shard", shard=2, replica=0)


def test_injector_delay_sleeps_instead_of_raising(monkeypatch):
    import repro_torch.fault as fault_mod

    slept = []
    monkeypatch.setattr(fault_mod.time, "sleep", slept.append)
    c = REGISTRY.counter("fault.delayed", point="gather", shard="3")
    c.mark()
    inj = FaultInjector().delay("gather", shard=3, seconds=0.002, times=1)
    inj.check("gather", shard=3)  # sleeps, does not raise
    assert slept == [0.002]
    assert c.since_mark == 1
    inj.check("gather", shard=3)  # times exhausted: no sleep
    assert slept == [0.002]


def test_injector_counts_firings_and_training_contract():
    c = REGISTRY.counter("fault.injected", point="score", shard="6")
    c.mark()
    inj = FaultInjector(fail_at=[12]).fail("score", shard=6)
    with pytest.raises(FaultInjected, match="shard=6"):
        inj.check("score", shard=6)
    assert c.since_mark == 1
    inj.maybe_fail(11)
    with pytest.raises(RuntimeError, match="step 12"):
        inj.maybe_fail(12)
    inj.maybe_fail(12)  # once per step


# ------------------------------------------------ policy/breaker units
def test_circuit_breaker_is_open_matches_reference(hand_timers):
    from repro.serve.fault import CircuitBreaker as JBreaker

    key = (1, "copyB")
    got, want = CircuitBreaker(threshold=2, cooldown_s=1000.0), \
        JBreaker(threshold=2, cooldown_s=1000.0)
    for step in ("fail", "fail", "fail", "ok", "fail"):
        for br in (got, want):
            if step == "fail":
                br.record_failure(key)
            else:
                br.record_success(key)
        assert got.is_open(key) == want.is_open(key), step
        assert got.is_open(key) != got.allow(key)
    assert not got.is_open((9, "never-failed"))
    assert got.is_open(key) is False
    got.record_failure(key)
    assert got.is_open(key)
    hand_timers[-1].fire()          # cooldown over: half-open
    assert not got.is_open(key)


def test_retry_policy_backoff_caps():
    p = RetryPolicy(backoff_base_s=0.01, backoff_cap_s=0.04)
    assert p.backoff_s(0) == 0.01
    assert p.backoff_s(1) == 0.02
    assert p.backoff_s(10) == 0.04  # capped


def test_circuit_breaker_opens_half_opens_reopens(hand_timers):
    br = CircuitBreaker(threshold=2, cooldown_s=10.0)
    key = (0, "copyA")
    br.record_failure(key)
    assert br.allow(key)          # below threshold
    br.record_failure(key)
    assert not br.allow(key)      # open
    assert hand_timers[-1].seconds == 10.0
    hand_timers[-1].fire()        # cooldown over: half-open probe
    assert br.allow(key)
    br.record_failure(key)        # a failed probe re-opens at once
    assert not br.allow(key)
    hand_timers[-1].fire()
    assert br.allow(key)
    br.record_success(key)        # a good probe resets fully
    br.record_failure(key)
    assert br.allow(key)          # needs threshold failures again
    assert len(hand_timers) == 2


def test_fault_context_deadline_raises_shard_timeout(hand_timers):
    deadline = Expiry(5.0)
    ctx = FaultContext(shard=0, deadline=deadline)
    ctx.check("gather")           # not expired yet
    hand_timers[-1].fire()
    with pytest.raises(ShardTimeout, match="overran its deadline"):
        ctx.check("gather")


def test_expiry_with_a_real_timer_cancels():
    e = Expiry(60.0)
    assert not e.expired()
    e.cancel()
    e._timer.join(timeout=5)
    assert not e._timer.is_alive() and not e.expired()


def test_deadline_fails_over_and_is_cancelled(hand_timers):
    """An attempt whose deadline expires mid-attempt fails at its next
    check and the next copy serves; every deadline timer is cancelled
    when its attempt ends."""
    calls = []

    def attempt(d, ctx):
        calls.append(d)
        ctx.check("gather")
        if ctx.replica == 0:
            hand_timers[-1].fire()  # the owner overruns its deadline
        ctx.check("score")
        return d

    out, info = serve_shard_with_failover(
        attempt, shard=4, replica_dirs=("a", "b"),
        policy=RetryPolicy(max_attempts=2, backoff_base_s=0.0,
                           attempt_deadline_s=0.3))
    assert out == "b" and calls == ["a", "b"]
    assert (info.retries, info.failovers) == (1, 1)
    assert [t.seconds for t in hand_timers] == [0.3, 0.3]
    assert all(t.cancelled for t in hand_timers)


# --------------------------------------------- failover-loop units
def test_failover_retries_then_serves_replica():
    calls = []

    def attempt(d, ctx):
        calls.append((d, ctx.replica))
        if ctx.replica == 0:
            raise RuntimeError("owner down")
        return f"served:{d}"

    c_fail = REGISTRY.counter("fault.attempt_failed", shard="7")
    c_over = REGISTRY.counter("fault.failovers", shard="7")
    c_retry = REGISTRY.counter("fault.retries", shard="7")
    for c in (c_fail, c_over, c_retry):
        c.mark()
    out, info = serve_shard_with_failover(
        attempt, shard=7, replica_dirs=("a", "b"),
        policy=RetryPolicy(max_attempts=2, backoff_base_s=0.0))
    assert out == "served:b"
    assert (info.retries, info.failovers, info.served_replica,
            info.served_dir, info.attempts) == (1, 1, 1, "b", 2)
    assert calls == [("a", 0), ("b", 1)]
    assert c_fail.since_mark == 1 and c_over.since_mark == 1
    assert c_retry.since_mark == 1


def test_failover_exhaustion_raises_shard_lost():
    c = REGISTRY.counter("fault.shard_lost", shard="9")
    c.mark()

    def attempt(d, ctx):
        raise ValueError("always")

    with pytest.raises(ShardLost) as exc:
        serve_shard_with_failover(
            attempt, shard=9, replica_dirs=("only",),
            policy=RetryPolicy(max_attempts=2, backoff_base_s=0.0))
    assert exc.value.shard == 9
    assert isinstance(exc.value.cause, ValueError)
    assert c.since_mark == 1


def test_failover_skips_open_circuit(hand_timers):
    br = CircuitBreaker(threshold=1, cooldown_s=1000.0)
    br.record_failure((5, "a"))  # the owner copy's circuit is open
    c = REGISTRY.counter("fault.breaker_skip", shard="5")
    c.mark()
    served = []

    def attempt(d, ctx):
        served.append(d)
        return d

    out, info = serve_shard_with_failover(
        attempt, shard=5, replica_dirs=("a", "b"), breaker=br,
        policy=RetryPolicy(max_attempts=2, backoff_base_s=0.0))
    assert out == "b" and served == ["b"]
    assert info.failovers == 1
    assert c.since_mark == 1


def test_every_attempt_budget_covers_all_replicas():
    seen = []

    def attempt(d, ctx):
        seen.append(d)
        if len(seen) < 3:
            raise RuntimeError("nope")
        return d

    out, _ = serve_shard_with_failover(
        attempt, shard=0, replica_dirs=("a", "b", "c"),
        policy=RetryPolicy(max_attempts=1, backoff_base_s=0.0))
    assert out == "c" and seen == ["a", "b", "c"]


def test_shard_kill_gate_runs_before_the_attempt():
    inj = FaultInjector().kill_shard(3, replica=0)
    seen = []

    def attempt(d, ctx):
        seen.append(d)
        return d

    out, info = serve_shard_with_failover(
        attempt, shard=3, replica_dirs=("a", "b"), injector=inj,
        policy=RetryPolicy(max_attempts=2, backoff_base_s=0.0))
    assert out == "b" and seen == ["b"] and info.retries == 1


# ------------------------------------------------- degradation math
@pytest.fixture(scope="module")
def ref_store_dir(tmp_path_factory):
    """Shard 0 of a reference spill (the global histogram)."""
    rng = np.random.default_rng(0)
    data = np.cumsum(rng.normal(size=(N, DIM)), axis=1)
    data = ((data - data.mean(1, keepdims=True))
            / (data.std(1, keepdims=True) + 1e-9)).astype(np.float32)
    tmp = str(tmp_path_factory.mktemp("fault_math"))
    eng = JEngine(mesh=None, method="dstree", shards=SHARDS)
    eng.build(data, index=JIndexSpec("dstree", leaf_cap=16),
              store=JStoreSpec(spill_dir=tmp, codec="f32",
                               keep_resident=False))
    eng.close()
    return os.path.join(tmp, "shard_0000")


@pytest.mark.parametrize("kth,n_lost,delta,eps", [
    ([0.5, 1.0, 2.0], 128, 0.9, 0.5),
    ([3.1, 4.7, 6.25, 5.5], 128, 1.0, 0.0),
    ([7.0, 7.5], 384, 0.99, 1.0),
    ([0.5, np.inf], 1, 0.9, 0.0),
    ([0.5, 1.0], 0, 0.9, 0.0),
])
def test_effective_delta_after_loss_matches_reference(ref_store_dir, kth,
                                                      n_lost, delta, eps):
    jhist = j_load_index(ref_store_dir, resident="summaries").resident.hist
    hist = load_index(ref_store_dir, resident="summaries",
                      device="cpu").resident.hist
    np.testing.assert_array_equal(hist.edges.numpy(),
                                  np.asarray(jhist.edges))
    kth = np.asarray(kth, np.float64)
    want = j_effective_delta(jhist, kth, n_lost, delta=delta, epsilon=eps)
    got = effective_delta_after_loss(hist, kth, n_lost, delta=delta,
                                     epsilon=eps)
    assert abs(got - want) <= 1e-12 * max(abs(want), 1e-300)
    assert 0.0 <= got <= delta


# ------------------------------------------ registry, stats, specs
def test_registry_matches_reference_metrics():
    """Counters of the port's registry, with their windows, equal the
    reference's on the same updates."""
    from repro.obs.metrics import MetricsRegistry as JRegistry
    from repro_torch.obs.metrics import MetricsRegistry

    regs = (MetricsRegistry(), JRegistry())
    for reg in regs:
        c = reg.counter("x.count", shard="1")
        c.inc(3)
        c.mark()
        c.inc()
        reg.counter("x.count", shard="2").inc(7)
        reg.counter("y.count").inc()
    got, want = (r.snapshot() for r in regs)
    assert got == want
    assert regs[0].snapshot("x.") == regs[1].snapshot("x.")
    assert regs[0].counter("x.count", shard="1").since_mark == 1


def test_stats_aggregate_matches_reference():
    from repro.obs import OocStats as JOocStats
    from repro_torch.obs import OocStats

    shards = [dict(codec="f32", share_gathers=True, prefetch_depth=1,
                   capacity_leaves=8, hits=30, hits_distinct=10, misses=6,
                   bytes_read=4096, bytes_h2d=2048, iterations=7,
                   leaves_visited=20, rows_scanned=300, pruning_ratio=0.5,
                   stop_delta=2, stop_epsilon=1, delta_slack=0.5,
                   eps_slack=1.5, retries=1, failovers=1),
              dict(codec="f32", share_gathers=True, prefetch_depth=1,
                   capacity_leaves=8, hits=10, hits_distinct=2, misses=9,
                   bytes_read=8192, iterations=9, leaves_visited=25,
                   rows_scanned=410, pruning_ratio=0.25, stop_delta=1,
                   stop_epsilon=3, delta_slack=2.0, eps_slack=0.5)]
    got = OocStats.aggregate([OocStats(**s) for s in shards]).as_dict()
    want = JOocStats.aggregate([JOocStats(**s) for s in shards]).as_dict()
    assert got == want
    assert len(got["shards"]) == 2 and got["shards"][1]["iterations"] == 9
    assert OocStats.aggregate([]).as_dict() == JOocStats().as_dict()


STORE_SPECS = [dict(), dict(spill_dir="s", replicas=2),
               dict(spill_dir="s", keep_resident=False, codec="pq"),
               dict(replicas=0), dict(replicas=2),
               dict(keep_resident=False)]


@pytest.mark.parametrize("kw", STORE_SPECS,
                         ids=[str(sorted(kw.items())) for kw in STORE_SPECS])
def test_store_spec_validates_as_the_reference(kw):
    """StoreSpec.validate accepts and rejects what the reference's does,
    with the same message."""
    from repro_torch.core.spec import StoreSpec

    def outcome(spec):
        try:
            spec.validate()
        except ValueError as e:
            return str(e)
        return None

    assert outcome(StoreSpec(**kw)) == outcome(JStoreSpec(**kw))


def test_index_spec_is_frozen_hashable_and_sorted():
    from repro_torch.core.spec import IndexSpec

    a = IndexSpec("dstree", {"leaf_cap": 16}, split="mean")
    b = IndexSpec("dstree", split="mean", leaf_cap=16)
    assert a == b and hash(a) == hash(b)
    assert a.params == JIndexSpec("dstree", {"leaf_cap": 16},
                                  split="mean").params
    assert a.build_params == {"leaf_cap": 16, "split": "mean"}
    with pytest.raises(AttributeError):
        a.method = "isax2+"
