"""Finds everything a cell needs by the names in ``BENCHMARK.json``.

    BENCHMARK.json              the cells, configurations and metrics
    <config file>               a configuration, at its entry's ``file``
    traffic/<traffic>.json      a traffic mix: parameters for a generator
    generators/<generator>.py   a traffic generator, named by the mix
    systems/<system>.py         a system under test, named by the config
    metrics/<metric>.py         one metric's reader, ``read(record)``

A new cell, configuration, traffic mix or metric is a new entry and new
files; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

PB = Path(__file__).resolve().parents[1]   # the benchmark's directory
ROOT = PB.parent                           # the checkout


class Spec:
    """``BENCHMARK.json`` under ``root`` and the files it names, under
    ``root``'s copy of the benchmark's directory."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.pb = self.root / PB.name
        with open(self.root / "BENCHMARK.json") as f:
            self.bench = json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(self.root / c["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(self.pb / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def metrics(self, cell: str, trace: bool) -> list:
        """Every end-to-end metric, or with ``trace`` the per-layer ones
        whose ``workloads`` list the cell."""
        if not trace:
            return self.bench["end_to_end"]
        return [m for m in self.bench["per_layer"]
                if cell in m["workloads"]]

    def reader(self, metric: str):
        return plugin(self.pb / "metrics" / f"{metric}.py").read

    def generator(self, name: str):
        return plugin(self.pb / "generators" / f"{name}.py")

    def system(self, name: str):
        return plugin(self.pb / "systems" / f"{name}.py")


def plugin(path: Path):
    """The module in the file ``path``, loaded once per process under a
    name made from its path."""
    key = f"portbench_plugin:{path}"
    mod = sys.modules.get(key)
    if mod is None:
        if not path.is_file():
            raise FileNotFoundError(f"no file {path}")
        sp = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(sp)
        sys.modules[key] = mod
        sp.loader.exec_module(mod)
    return mod
