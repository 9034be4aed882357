"""One run of one cell: set up, warm, the measured window, the plain
reference, the result line.

    1. the system under test is set up from the seed and warmed on the
       cell's own shapes (``setup_s`` runs from the process's start to
       the first timed batch's send);
    2. the traffic's generator drives it for ``seconds``; with
       ``trace`` a short profiled stretch of whole batches follows;
    3. the device's peak memory over both stretches is read, less the
       harness's own copy of the collection, which it keeps for the
       reference (the set-up's peak, the index build's, is not the
       serving deployment's); the program's state is freed, and the
       plain reference judges every answer of both stretches;
    4. the metrics' readers read the record (:class:`Record`).

:func:`run_cell` takes the device as an argument so that the tests can
drive it on the CPU at a tiny size; ``run.py`` refuses to run without a
card.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import List, Optional

import torch

from portbench.bench import devtrace
from portbench.bench.spec import Spec
from portbench.bench.world import World
from portbench.reference import judge as judge_mod
from portbench.reference.knn import knn

TRACE_SECONDS = 1.0      # the profiled stretch after the window
TRACE_MIN_BATCHES = 2
WINDOW_MIN_BATCHES = 1   # the timed window's least batches (a tiny CPU run
                         # raises it, to read its MAP over enough lanes)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Record:
    """What a metric's reader reads."""
    cell: dict
    config: dict
    traffic: dict
    facts: dict                 # the system's sizes (leaves, widths, k)
    setup_s: float
    window: list                # the timed window's batches
    window_rows: list           # rows scanned a batch, summed over lanes
    accuracy: dict              # map and recall over every answer
    trace: Optional[dict] = None  # the profiled stretch (devtrace.reduce)

    @property
    def window_s(self) -> float:
        return self.window[-1].done - self.window[0].sent


def say(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(spec: Spec, cell_name: str, seed: int, seconds: float,
             trace: bool, *, t0: float, device="cuda",
             world: Optional[World] = None) -> Optional[dict]:
    """The result line's object on rank 0 (None on other ranks), with
    the compared numbers last, under ``checks``."""
    world = world or World(device)
    cell = spec.cell(cell_name)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = world.device
    t_sys = time.perf_counter()
    system = spec.system(cfg["system"]).setup(cfg, traffic, seed, world)
    loop = spec.generator(traffic["generator"]).Loop(system, traffic, seed,
                                                     world)
    t_warm = time.perf_counter()
    loop.warm()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    window = loop.run(seconds, WINDOW_MIN_BATCHES)
    setup_s = window[0].sent - t0
    batches = list(window)
    tr = None
    if trace:
        before = system.counters()
        t_tr = time.perf_counter()
        traced, tr = devtrace.profile(
            lambda: loop.run(TRACE_SECONDS, TRACE_MIN_BATCHES,
                             mark=devtrace.span), dev)
        tr["took_s"] = time.perf_counter() - t_tr
        after = system.counters()
        tr["counters"] = {n: after[n] - before[n] for n in after}
        tr["iterations"] = sum(b.iterations for b in traced)
        tr["busy_s"] = world.reduce(tr["busy_s"], "mean")
        batches += traced
    peak = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = (torch.cuda.max_memory_allocated(dev)
                - system.collection.numel()
                * system.collection.element_size())
    peak = int(world.reduce(peak, "max"))
    window_rows = [int(b.rows_scanned.sum()) for b in window]
    facts = dict(system.facts)
    system.close()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if world.rank != 0:
        return None
    lat = sorted((b.done - b.sent) * 1e3 for b in window)
    say(f"set-up {setup_s:.3f} s: before the system {t_sys - t0:.3f}, "
        + ", ".join(f"{k} {v:.3f}" for k, v in system.timings.items())
        + f", warm-up {window[0].sent - t_warm:.3f}; window "
        f"{len(window)} batches in {window[-1].done - window[0].sent:.3f} s,"
        f" batch ms: first {(window[0].done - window[0].sent) * 1e3:.3f}, "
        f"min {lat[0]:.3f}, median {lat[len(lat) // 2]:.3f}, "
        f"max {lat[-1]:.3f}; the system: "
        + ", ".join(f"{k} {v}" for k, v in facts.items()))
    if tr is not None:
        say(f"profiled stretch: {len(batches) - len(window)} batches, "
            f"{tr['window_s']:.3f} s traced, {tr['took_s']:.3f} s with "
            "the trace's reduction")
    t_ref = time.perf_counter()

    # the plain reference, over every answer of both stretches
    q = torch.cat([b.queries for b in batches])
    ids = torch.cat([b.ids for b in batches])
    dists = torch.cat([b.dists for b in batches])
    _, true_i = knn(system.collection, q, facts["k"])
    readings = judge_mod.judge(system.collection, q, ids, dists, true_i)
    acc = {"map": readings["map"], "recall": readings["recall"]}
    say(f"reference and comparison over {len(ids)} queries: "
        f"{time.perf_counter() - t_ref:.3f} s; map {acc['map']!r}, "
        f"recall {acc['recall']!r}")
    limits = cfg["limits"]
    rec = Record(cell, cfg, traffic, facts, setup_s, window, window_rows,
                 acc, tr)
    metrics = {}
    for m in spec.metrics(cell["name"], trace):
        v = spec.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {
        "correct": judge_mod.passed(readings, limits),
        "attempted": int(ids.shape[0]),
        "failed": judge_mod.failed(readings, limits),
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": world.size, "memory_peak_bytes": peak},
    }
    if tr is not None:
        out["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = tr["breakdown"]
    out["accuracy"] = acc
    out["checks"] = judge_mod.checks(readings, limits)
    return out
