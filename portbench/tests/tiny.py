"""A copy of the benchmark at a tiny size, for the CPU tests: the same
BENCHMARK.json and files, with each configuration's collection cut to
2,048 series of the published length 256 and the traffic to batches of
8 queries (ng nprobe 8, visit_batch 2, one warm batch), and a timed
window of at least 12 batches.

At that size ng visits 8 of some 40 leaves, so its answers fall further
short of the exact k nearest than the cell's do, and each configuration
takes a ``map_shortfall`` limit of the tiny size's own: over ten seeds
sound runs read at most 0.024 (coop) and 0.121 (solo), and the faults
that keep distances true to their ids (``faults.py``: wrong_leaves,
half_probes, half_pool) at least 0.073 and 0.319."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.bench import harness
from portbench.bench.spec import PB, ROOT

N_SERIES = 2048
SECONDS = 0.2
MIN_BATCHES = 12
MAP_SHORTFALL = {"search2m-coop": 0.045, "search2m-solo": 0.2}


def make_root(tmp: Path) -> Path:
    """A checkout-like directory under ``tmp``: BENCHMARK.json and a copy
    of the benchmark's directory, cut to the tiny size."""
    root = tmp / "root"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(PB, root / PB.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        p = root / c["file"]
        cfg = json.loads(p.read_text())
        cfg["collection"]["n_series"] = N_SERIES
        cfg["index"]["leaf_cap"] = 64
        cfg["limits"]["map_shortfall"] = MAP_SHORTFALL[c["name"]]
        p.write_text(json.dumps(cfg))
    for p in (root / PB.name / "traffic").glob("*.json"):
        t = json.loads(p.read_text())
        t.update(batch=8, visit_batch=2, warm_batches=1)
        t["guarantee"]["nprobe"] = 8
        p.write_text(json.dumps(t))
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
