"""A configuration, a traffic mix, a cell and a per-layer metric are
added as files and entries in a copy of the benchmark, with no file of
the harness edited, and the harness finds and runs them."""

import json
import time

import pytest

from portbench.bench.harness import run_cell
from portbench.bench.spec import PB, Spec
from portbench.tests import tiny


def test_added_files_and_entries_are_found_and_run(tmp_path, monkeypatch):
    root = tiny.make_root(tmp_path)
    pb = root / PB.name
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}

    cfg = json.loads((pb / "configs/search2m-solo.json").read_text())
    cfg["collection"]["n_series"] = 1024
    (pb / "configs/search-other.json").write_text(json.dumps(cfg))
    t = json.loads((pb / "traffic/b256.json").read_text())
    t["batch"] = 4
    (pb / "traffic/b4.json").write_text(json.dumps(t))
    (pb / "metrics/loop.batches.py").write_text(
        "def read(rec):\n    return float(len(rec.window))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="search-other",
                                 file="portbench/configs/search-other.json"))
    bench["workloads"].append({"name": "search-other.b4",
                               "config": "search-other", "traffic": "b4",
                               "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({
        "name": "loop.batches", "unit": "batches", "better": "higher",
        "source": "program_counter", "layer": "search loop",
        "moves": "queries_per_s", "workloads": ["search-other.b4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = Spec(root)
    assert spec.cell("search-other.b4")["traffic"] == "b4"
    assert spec.config("search-other")["collection"]["n_series"] == 1024
    assert spec.traffic("b4")["batch"] == 4
    assert "loop.batches" in {m["name"]
                              for m in spec.metrics("search-other.b4", True)}
    assert "loop.batches" not in {
        m["name"] for m in spec.metrics("search2m-solo.b256", True)}

    tiny.short_trace(monkeypatch)
    tiny.long_window(monkeypatch)
    out = run_cell(spec, "search-other.b4", 7, tiny.SECONDS, True,
                   t0=time.perf_counter(), device="cpu")
    assert out["correct"] is True and out["attempted"] % 4 == 0
    assert out["metrics"]["loop.batches"]["value"] >= 1
    for p, b in before.items():
        assert p.read_bytes() == b, f"{p} was edited"


def test_a_per_layer_metric_names_its_cells(tmp_path):
    """Every per-layer entry lists the cells that report it; one that
    lists none is refused, and every end-to-end metric is every cell's."""
    root = tiny.make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for cell in tiny.cells(root):
        assert Spec(root).metrics(cell, False) == bench["end_to_end"]
    bench["per_layer"].append({
        "name": "everywhere", "unit": "1", "better": "lower",
        "source": "device_trace", "layer": "device",
        "moves": "queries_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(KeyError):
        Spec(root).metrics(tiny.cells(root)[0], True)
