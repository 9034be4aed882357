"""The program's own spans and counters as the benchmark sees them, on
the CPU: the program's spans land in the profiler's trace inside the
harness's entry span and leave every reduced reading as it was; the
readers of the program's counters read them, and read nothing from a
program that lacks them; a traced tiny run drives the counters."""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.bench import devtrace
from portbench.bench.harness import Record, run_cell
from portbench.bench.spec import Spec
from portbench.tests import tiny
from repro_torch import obs
from repro_torch.core.engine import DistributedEngine
from repro_torch.core.guarantees import ng
from repro_torch.core.spec import IndexSpec

LOOP = ("search.filter", "search.advance", "search.frontier",
        "search.gather", "search.score", "search.settle", "search.finish",
        "engine.merge")
NEW = ("loop.host_reads_per_iteration", "k4.pool_roofline",
       "setup.index_build_s")


def test_program_spans_nest_inside_the_entry_span(tmp_path):
    """Under torch.profiler alone (no obs.enable()), the engine's and the
    loop's spans are user annotations inside portbench.entry."""
    rng = np.random.default_rng(3)
    data = np.cumsum(rng.normal(size=(1024, 64)), 1).astype(np.float32)
    eng = DistributedEngine(shards=1, device="cpu").build(
        data, index=IndexSpec("dstree", leaf_cap=32))
    q = torch.as_tensor(data[:4] + 0.01)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with devtrace.span("batch"), devtrace.span("entry"):
            eng.query(q, 5, ng(6), visit_batch=2, share_gathers=True)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = [e for e in json.loads(path.read_text())["traceEvents"]
          if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    (entry,) = [e for e in ev if e["name"] == devtrace.ENTRY]
    lo, hi = entry["ts"], entry["ts"] + entry["dur"]
    inside = {e["name"] for e in ev
              if lo <= e["ts"] and e["ts"] + e["dur"] <= hi}
    assert {"engine.query", *LOOP} <= inside
    assert all(e["name"] in inside for e in ev
               if e["name"].startswith(("search.", "engine.query")))


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_program_spans_leave_the_reduction_as_it_was():
    """devtrace.reduce over a fixed event list gives every key, number
    and breakdown name it gave before the program annotated its phases."""
    ev = [_x("user_annotation", devtrace.BATCH, 100, 200),
          _x("user_annotation", devtrace.ENTRY, 105, 150),
          _x("cpu_op", "aten::add", 110, 30),
          _x("cuda_runtime", "cudaLaunchKernel", 112, 3, 1),
          _x("cpu_op", "aten::index", 150, 40),
          _x("cuda_runtime", "cudaLaunchKernel", 152, 3, 2),
          _x("cuda_runtime", "cudaStreamSynchronize", 200, 30),
          _x("kernel", "l2_tile_kernel<float, true>", 120, 20, 1),
          _x("kernel", "gather", 160, 60, 2),
          _x("gpu_memcpy", "DtoH", 260, 5)]
    spans = [_x("user_annotation", "engine.query", 106, 148),
             _x("user_annotation", "search.advance", 108, 90),
             _x("user_annotation", "search.score", 109, 50),
             _x("user_annotation", "search.settle", 199, 40)]
    plain = devtrace.reduce(ev)
    assert devtrace.reduce(ev + spans) == plain
    assert set(plain) == {"window_s", "busy_s", "entry_ops", "entry_syncs",
                          "device_s_by_name", "breakdown"}
    assert plain["entry_ops"] == 2 and plain["entry_syncs"] == 1
    # idle 100-120 under aten::add, 140-160 under aten::index, 220-300
    # under no host operation (the program's spans are not host ops)
    assert plain["breakdown"]["idle_gaps"] == [
        ["(no host op)", pytest.approx(75e-6)],
        ["aten::add", pytest.approx(20e-6)],
        ["aten::index", pytest.approx(20e-6)]]


def _rec(busy=1.0):
    """A reduced profiled stretch: K4 took 0.5 s of it, or, with no device
    busy (a CPU run), no device operation ran."""
    facts = {"series_len": 256, "bytes_per_value": 4, "k": 100,
             "leaves": 8, "box_dims": 16}
    by_name = {"void gemm::l2_tile_kernel<float, true>(float const*)": 0.5,
               "other": 1.0} if busy else {}
    trace = {"busy_s": busy, "window_s": 2.0, "iterations": 32,
             "device_s_by_name": by_name, "counters": {}}
    return Record({}, {}, {}, facts, 1.0, [], [], {}, trace)


@pytest.fixture
def registry(monkeypatch):
    """A private registry in the program's place."""
    reg = obs.MetricsRegistry()
    monkeypatch.setattr(obs, "REGISTRY", reg)
    return reg


def test_the_readers_of_the_program_counters(registry):
    reg, spec = registry, Spec()
    reg.counter("search.host_reads", site="refill").inc(32)
    reg.counter("search.host_reads", site="settle").inc(32)
    reg.counter("search.host_reads", site="eps_mult").inc(2)
    reg.counter("search.host_reads", site="r_delta").inc(2)
    reg.counter("search.iterations").inc(32)
    reg.counter("search.pooled_rows").inc(torch.tensor(1000))
    reg.counter("search.pooled_pairs").inc(torch.tensor(256_000))
    reg.gauge("engine.build_s", phase="index").set(5.5)
    rec = _rec()
    assert spec.reader("loop.host_reads_per_iteration")(rec) == 2.125
    assert spec.reader("setup.index_build_s")(rec) == 5.5
    ops_s = 2 * 256 * 256_000 / 67e12
    assert spec.reader("k4.pool_roofline")(rec) == pytest.approx(
        100 * ops_s / 0.5)
    # a run that kept no device busy (the CPU) reads none of them
    for name in NEW:
        assert spec.reader(name)(_rec(busy=0.0)) is None


def test_the_readers_read_nothing_from_a_program_without_the_counters(
        registry):
    """The parent program has none of these counters: each reader gives
    no value (the line leaves the metric out) and raises nothing."""
    spec = Spec()
    for name in NEW:
        assert spec.reader(name)(_rec()) is None


def test_a_traced_tiny_run_drives_the_program_counters(tmp_path,
                                                       monkeypatch):
    """The CPU reads none of the new metrics (no device work), but the run
    moves the program's counters as the card's would, and the host-read
    reader, given the run's record as if a device had been busy, reads
    them: Σ ``search.host_reads`` over ``search.iterations`` of the same
    registry. How many reads an iteration takes is the program's to pin
    (``tests/test_torch_obs.py``), not the benchmark's. The pooled rows
    are counted in the profiled stretch of a cooperative cell."""
    root = tiny.make_root(tmp_path)
    tiny.short_trace(monkeypatch)
    tiny.long_window(monkeypatch)
    records = []
    reader = Spec.reader

    def recording(self, metric):
        read = reader(self, metric)

        def read_and_keep(rec):
            records.append(rec)
            return read(rec)
        return read_and_keep

    monkeypatch.setattr(Spec, "reader", recording)
    reg = obs.REGISTRY
    before = reg.snapshot("search.")
    out = run_cell(Spec(root), "search2m-coop.b256", 2 ** 31 + 5,
                   tiny.SECONDS, True, t0=time.perf_counter(), device="cpu")
    after = reg.snapshot("search.")
    assert out["correct"] is True
    assert not set(NEW) & set(out["metrics"])
    d = {k: after[k] - before.get(k, 0) for k in after}
    its = d["search.iterations"]
    reads = sum(v for k, v in d.items() if k.startswith("search.host_reads"))
    assert its > 0 and its % 4 == 0  # nprobe 8, visit_batch 2
    assert reads > 0
    busy = dataclasses.replace(records[0],
                               trace=dict(records[0].trace, busy_s=1.0))
    total = sum(v for k, v in after.items()
                if k.startswith("search.host_reads{"))
    assert reader(Spec(), "loop.host_reads_per_iteration")(busy) == \
        total / after["search.iterations"]
    assert d["search.pooled_rows"] > 0
    assert d["search.pooled_pairs"] == 8 * d["search.pooled_rows"]
