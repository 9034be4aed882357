"""A configuration, a traffic mix, a cell and a per-layer metric are
added as files and entries in a copy of the benchmark, with no file of
the harness edited, and the harness finds and runs them; so does the
tiny copy of the tests, on as many ranks as the cell asks for, given
the configuration's cut under ``tests/tiny/``."""

import json
import shutil
import time

import pytest

from portbench.bench.harness import run_cell
from portbench.bench.launch import spawn
from portbench.bench.spec import PB, ROOT, Spec
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


def test_every_configuration_and_traffic_has_a_tiny_cut():
    """Each configuration of BENCHMARK.json and each traffic mix has its
    cut under ``tests/tiny/``; without one the tiny copy leaves it and
    its cells out."""
    missing = [str(p.relative_to(ROOT)) for p in tiny.missing_cuts()]
    assert not missing, "add the tiny cut " + ", ".join(missing)


def test_a_four_rank_configuration_is_added_as_files_and_entries(tmp_path):
    """What adding the four-card search cell takes: a configuration of
    four shards' worth of series, its tiny cut, a ``chips: 4`` cell over
    an existing traffic mix and a per-layer metric of that cell alone,
    all new files and entries; the tiny copy of that checkout runs the
    cell on four ranks over gloo."""
    src = tmp_path / "src"   # this checkout's benchmark, tests and cuts
    src.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", src / "BENCHMARK.json")
    shutil.copytree(PB, src / PB.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = src / PB.name
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    old = json.loads((src / "BENCHMARK.json").read_text())

    name, cell = "rehearsal-mesh4", "rehearsal-mesh4.b256"
    cfg = json.loads((pb / "configs/search2m-coop.json").read_text())
    cfg["collection"]["n_series"] = 4 * cfg["collection"]["n_series"]
    cfg["chips"] = 4
    (pb / f"configs/{name}.json").write_text(json.dumps(cfg))
    coop_cut = tiny.cut_dir(src) / "configs/search2m-coop.json"
    cut = json.loads(coop_cut.read_text())
    cut["collection"]["n_series"] *= 4
    (tiny.cut_dir(src) / f"configs/{name}.json").write_text(json.dumps(cut))
    (pb / "metrics/mesh.batches.py").write_text(
        "def read(rec):\n    return float(len(rec.window))\n")
    bench = json.loads((src / "BENCHMARK.json").read_text())
    coop = next(c for c in bench["configs"] if c["name"] == "search2m-coop")
    bench["configs"].append(dict(coop, name=name,
                                 file=f"portbench/configs/{name}.json"))
    bench["workloads"].append({"name": cell, "config": name,
                               "traffic": "b256", "chips": 4,
                               "why": "a test cell on four ranks"})
    bench["per_layer"].append({
        "name": "mesh.batches", "unit": "batches", "better": "higher",
        "source": "program_counter", "layer": "engine",
        "moves": "queries_per_s", "workloads": [cell]})
    (src / "BENCHMARK.json").write_text(json.dumps(bench))
    assert not set(tiny.missing_cuts(src)) & {
        tiny.cut_dir(src) / f"configs/{name}.json",
        tiny.cut_dir(src) / "traffic/b256.json"}

    root = tiny.make_root(tmp_path, src)
    spec = Spec(root)
    assert spec.cell(cell)["chips"] == 4
    assert spec.config(name)["collection"]["n_series"] == \
        cut["collection"]["n_series"]
    assert [m["name"] for m in spec.metrics(cell, True)][-1] == \
        "mesh.batches"
    assert not any(m["name"] == "mesh.batches"
                   for c in tiny.cells(root) if c != cell
                   for m in spec.metrics(c, True))
    copied = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    rc, line, err = spawn(root, dict(workload=cell, seed=2 ** 31 + 3,
                                     seconds=tiny.SECONDS, trace=False,
                                     t0=time.perf_counter()),
                          4, "cpu", tiny.RANK_TIMEOUT)
    assert rc == 0 and line is not None, err
    out = json.loads(line)
    assert out["correct"] is True and out["device"]["count"] == 4
    for p, b in [*before.items(), *copied.items()]:
        assert p.read_bytes() == b, f"{p} was edited"
    for key in ("configs", "workloads", "per_layer", "end_to_end"):
        assert bench[key][:len(old[key])] == old[key], key
