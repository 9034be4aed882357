"""A copy of the benchmark at a tiny size, for the CPU tests: the same
BENCHMARK.json and files, each configuration and traffic mix cut by a
file of its own, found by name as the harness finds everything else.
A cell of one card runs in the test's process with a timed window of
at least 12 batches; a cell of more runs on as many rank processes over
gloo (``bench/launch.py``), whose windows last ``SECONDS``.

    tests/tiny/configs/<config>.json    the cut of a configuration
    tests/tiny/traffic/<traffic>.json   the cut of a traffic mix

A cut is a partial object, merged key by key over the copied file
(:func:`merge`). A configuration or traffic mix without a cut is left
out of the copy, with its entries and its cells in BENCHMARK.json;
``test_every_configuration_and_traffic_has_a_tiny_cut`` names the file
to add. So a new configuration, traffic mix, cell or metric is new
files and entries alone, here as in the harness.

The cuts of today: each search configuration's collection cut to 2,048
series of the published length 256 in leaves of at most 64, and the
traffic to batches of 8 queries (ng nprobe 8, visit_batch 2, one warm
batch). At that size ng visits 8 of some 40 leaves, so its answers fall
further short of the exact k nearest than the cell's do, and each
configuration takes a ``map_shortfall`` limit of the tiny size's own:
over ten seeds sound runs read at most 0.024 (coop) and 0.121 (solo),
and the faults that keep distances true to their ids (``faults.py``:
wrong_leaves, half_probes, half_pool) at least 0.073 and 0.319, so the
cuts hold coop to 0.045 and solo to 0.2."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.bench import harness
from portbench.bench.spec import PB, ROOT

SECONDS = 0.2
MIN_BATCHES = 12
RANK_TIMEOUT = 240.0   # seconds the rank processes of a tiny cell may run


def cut_dir(src: Path = ROOT) -> Path:
    """The cut files of the benchmark checked out at ``src``."""
    return src / PB.name / "tests" / "tiny"


def merge(base: dict, cut: dict) -> dict:
    """``base`` with every key of ``cut``: an object merged key by key,
    anything else put in its place."""
    out = dict(base)
    for k, v in cut.items():
        out[k] = (merge(out[k], v)
                  if isinstance(v, dict) and isinstance(out.get(k), dict)
                  else v)
    return out


def missing_cuts(src: Path = ROOT) -> list:
    """The cut files that the configurations of ``src``'s BENCHMARK.json
    and its traffic mixes lack."""
    bench = json.loads((src / "BENCHMARK.json").read_text())
    want = [cut_dir(src) / "configs" / f"{c['name']}.json"
            for c in bench["configs"]]
    want += [cut_dir(src) / "traffic" / p.name
             for p in sorted((src / PB.name / "traffic").glob("*.json"))]
    return [p for p in want if not p.is_file()]


def make_root(tmp: Path, src: Path = ROOT) -> Path:
    """A checkout-like directory under ``tmp``: the BENCHMARK.json and a
    copy of the benchmark's directory of the checkout at ``src``, cut to
    the tiny size."""
    root = tmp / "root"
    root.mkdir()
    shutil.copytree(src / PB.name, root / PB.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((src / "BENCHMARK.json").read_text())
    cuts = cut_dir(src)

    def cut(path: Path, cut_file: Path) -> bool:
        if not cut_file.is_file():
            path.unlink()
            return False
        path.write_text(json.dumps(merge(json.loads(path.read_text()),
                                         json.loads(cut_file.read_text()))))
        return True

    bench["configs"] = [c for c in bench["configs"]
                        if cut(root / c["file"],
                               cuts / "configs" / f"{c['name']}.json")]
    traffic = {p.stem for p in (root / PB.name / "traffic").glob("*.json")
               if cut(p, cuts / "traffic" / p.name)}
    configs = {c["name"] for c in bench["configs"]}
    bench["workloads"] = [w for w in bench["workloads"]
                          if w["config"] in configs
                          and w["traffic"] in traffic]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def cells(root: Path) -> list:
    return [w["name"] for w in
            json.loads((root / "BENCHMARK.json").read_text())["workloads"]]


def short_trace(monkeypatch) -> None:
    """A profiled stretch of a fraction of a second."""
    monkeypatch.setattr(harness, "TRACE_SECONDS", SECONDS)


def long_window(monkeypatch) -> None:
    """A timed window of at least :data:`MIN_BATCHES` batches, so that
    the MAP is read over as many lanes however busy the CPU is."""
    monkeypatch.setattr(harness, "WINDOW_MIN_BATCHES", MIN_BATCHES)
