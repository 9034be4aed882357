"""The merge's per-layer metrics of the four-card cell
(``mesh.wait_share``, ``mesh.spread_ms_per_batch``): their readers over
the program's counters, nothing read from a program without them, and a
traced tiny run of the cell on four rank processes over gloo that reads
both."""

import json
import time

import pytest

from portbench.bench.harness import Record
from portbench.bench.launch import spawn
from portbench.bench.spec import Spec
from portbench.tests import tiny
from repro_torch import obs

CELL = "search8m-mesh4.b256"
MESH = ("mesh.wait_share", "mesh.spread_ms_per_batch")


def _rec():
    return Record({}, {}, {}, {}, 1.0, [], [], {},
                  {"busy_s": 1.0, "window_s": 2.0, "counters": {}})


@pytest.fixture
def registry(monkeypatch):
    """A private registry in the program's place."""
    reg = obs.MetricsRegistry()
    monkeypatch.setattr(obs, "REGISTRY", reg)
    return reg


def test_the_readers_of_the_merge_counters(registry):
    spec = Spec()
    registry.counter("engine.mesh_s", part="loop").inc(27.0)
    registry.counter("engine.mesh_s", part="gather").inc(3.0)
    registry.counter("engine.gathers").inc(250)
    registry.counter("engine.mesh_spread_s").inc(0.5)
    assert spec.reader("mesh.wait_share")(_rec()) == pytest.approx(0.1)
    assert spec.reader("mesh.spread_ms_per_batch")(_rec()) == \
        pytest.approx(2.0)


def test_the_mesh_readers_read_nothing_without_the_counters(registry):
    """The parent program, and a process that never gathered, have none
    of these counters: each reader gives no value and raises nothing."""
    spec = Spec()
    for name in MESH:
        assert spec.reader(name)(_rec()) is None
    registry.counter("engine.gathers")
    registry.counter("engine.mesh_s", part="loop")
    for name in MESH:
        assert spec.reader(name)(_rec()) is None


def test_the_cell_lists_them_alone():
    spec = Spec()
    for name in MESH:
        cells = [c["name"] for c in spec.bench["workloads"]
                 if name in {m["name"] for m in spec.metrics(c["name"],
                                                             True)}]
        assert cells == [CELL]


def test_a_traced_four_rank_run_reads_both(tmp_path):
    """The cell at its tiny cut on four gloo ranks, traced: rank 0's line
    holds both metrics, a share in (0, 1) and a spread of at least 0."""
    root = tiny.make_root(tmp_path)
    rc, line, err = spawn(root, dict(workload=CELL, seed=2 ** 31 + 17,
                                     seconds=tiny.SECONDS, trace=True,
                                     t0=time.perf_counter()),
                          4, "cpu", tiny.RANK_TIMEOUT)
    assert rc == 0 and line is not None, err
    out = json.loads(line)
    assert out["correct"] is True and out["device"]["count"] == 4
    share = out["metrics"]["mesh.wait_share"]
    assert share["unit"] == "1" and 0 < share["value"] < 1
    spread = out["metrics"]["mesh.spread_ms_per_batch"]
    assert spread["unit"] == "ms" and spread["value"] >= 0
