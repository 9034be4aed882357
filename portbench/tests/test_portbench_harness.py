"""The harness's pieces at a tiny size, with the port on the CPU: the
result line of every cell of BENCHMARK.json at its own rank count, the
traced run, the faults that ``correct`` has to catch, and ``run.py``'s
refusal without a card."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import faults
from portbench.bench import devtrace
from portbench.bench.harness import run_cell
from portbench.bench.launch import spawn
from portbench.bench.spec import PB, ROOT, Spec
from portbench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
CELLS = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
SEED = 2 ** 31 + 11


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("portbench"))


@pytest.fixture(autouse=True)
def window(monkeypatch):
    tiny.long_window(monkeypatch)


def _run(root, cell, trace=False, seed=SEED):
    return run_cell(Spec(root), cell, seed, tiny.SECONDS, trace,
                    t0=time.perf_counter(), device="cpu")


@pytest.mark.parametrize("cell", CELLS, ids=[w["name"] for w in CELLS])
def test_the_last_line_of_an_untraced_run(root, cell):
    """Each cell as BENCHMARK.json has it, on as many ranks as it asks
    for: one in this process, more as rank processes over gloo
    (``bench/launch.py``), whose timed window is ``tiny.SECONDS`` long."""
    name, chips = cell["name"], cell["chips"]
    assert name in tiny.cells(root), \
        f"{name} has no tiny cut (test_every_configuration_and_traffic_" \
        "has_a_tiny_cut names the file)"
    batch = Spec(root).traffic(cell["traffic"])["batch"]
    if chips == 1:
        out = _run(root, name)
        assert out["attempted"] >= batch * tiny.MIN_BATCHES
    else:
        rc, line, err = spawn(root, dict(workload=name, seed=SEED,
                                         seconds=tiny.SECONDS, trace=False,
                                         t0=time.perf_counter()),
                              chips, "cpu", tiny.RANK_TIMEOUT)
        assert rc == 0 and line is not None, err
        out = json.loads(line)
    assert out["device"]["count"] == chips
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= batch and out["attempted"] % batch == 0
    end_to_end = Spec(root).metrics(name, False)
    assert set(out["metrics"]) == {m["name"] for m in end_to_end}
    for m in end_to_end:
        got = out["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    assert 0 < out["metrics"]["map"]["value"] <= 1
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert out["checks"]["bad_lanes"] == {"value": 0, "limit": 0}
    assert list(out["checks"]) == ["bad_lanes", "sq_dist_gap",
                                   "map_shortfall"]
    json.dumps(out)


def test_a_traced_run_reads_per_layer_metrics(root, monkeypatch):
    tiny.short_trace(monkeypatch)
    out = _run(root, "search2m-solo.b256", trace=True)
    assert out["correct"] is True
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(out["breakdown"]["idle_gaps"]) <= 10
    bench = json.loads((root / "BENCHMARK.json").read_text())
    per_layer = {m["name"] for m in bench["per_layer"]}
    # the CPU runs no device operation: only the host-timed share reads
    assert set(out["metrics"]) == {"search.batch_roofline"} <= per_layer
    assert 0 < out["metrics"]["search.batch_roofline"]["value"] <= 100


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_the_trace_counts_only_what_the_entry_launched_and_waited_on():
    """Launches and waits are the host's calls inside an entry span (the
    device operations they started, wherever those ran); the query draw,
    the harness's wait and its copies of the answer lie outside it."""
    ev = [_x("user_annotation", devtrace.BATCH, 100, 100),
          _x("user_annotation", devtrace.ENTRY, 110, 60),
          _x("user_annotation", devtrace.BATCH, 300, 100),
          _x("user_annotation", devtrace.ENTRY, 310, 60),
          _x("cuda_runtime", "cudaLaunchKernel", 90, 2, 1),     # query draw
          _x("cuda_runtime", "cudaDeviceSynchronize", 95, 4),   # the wait
          _x("cuda_runtime", "cudaLaunchKernel", 120, 2, 2),
          _x("cuda_driver", "cuLaunchKernel", 130, 2, 3),
          _x("cuda_runtime", "cudaStreamSynchronize", 140, 5),
          _x("cuda_runtime", "cudaMemcpyAsync", 175, 2, 4),     # answer
          _x("cuda_runtime", "cudaStreamSynchronize", 178, 5),
          _x("cuda_runtime", "cudaLaunchKernel", 320, 2, 5),
          _x("kernel", "draw", 92, 5, 1),
          _x("kernel", "k", 125, 20, 2),
          _x("kernel", "k", 200, 150, 3),     # runs past its batch
          _x("gpu_memcpy", "DtoH", 176, 2, 4),
          _x("kernel", "k", 330, 10, 5)]
    r = devtrace.reduce(ev)
    assert r["entry_ops"] == 3 and r["entry_syncs"] == 1
    assert r["window_s"] == pytest.approx(300e-6)
    # device busy in [100, 400]: 125-145, 176-178, 200-350
    assert r["busy_s"] == pytest.approx(172e-6)


CELL_FAULTS = [(cell, f) for cell in ("search2m-coop.b256",
                                       "search2m-solo.b256")
               for f in faults.FAULTS
               if not (f == "largest_kept" and cell.startswith("search2m-solo"))]


@pytest.mark.parametrize("cell,fault", CELL_FAULTS,
                         ids=[f"{c}-{f}" for c, f in CELL_FAULTS])
def test_a_broken_timed_path_is_not_correct(root, cell, fault):
    """The timed path broken underneath (``faults.py``): a step that
    returns its state unchanged, half of each batch left out, an answer
    altered where it is produced, and the filter or the selection
    keeping other rows with their true distances. (One card: there is
    no exchange between cards.)"""
    with faults.planted(fault):
        out = _run(root, cell)
    assert out["correct"] is False and out["failed"] > 0
    assert list(out)[-1] == "checks"


def _refuses(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "search2m-coop.b256", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=120)
    assert r.returncode != 0 and r.stdout.strip() == ""
    return r


def test_run_py_refuses_without_a_card():
    r = _refuses(ROOT)
    assert r.returncode == 2 and "nothing measured" in r.stderr


def test_run_py_refuses_with_only_the_benchmark_files(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(PB, tmp_path / PB.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    _refuses(tmp_path)
