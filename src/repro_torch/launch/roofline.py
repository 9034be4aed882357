"""Roofline terms for one H100, from the dry run and the profiler.

The port's counterpart of ``src/repro/launch/roofline.py``. Three terms
per (arch x shape) cell, in seconds a step on one card:

    compute    = flops_per_device / PEAK_FLOPS
    memory     = bytes_per_device / HBM_BW
    collective = wire_bytes_per_device / NVLINK_BW   (0 at world 1)

The compute and memory numerators are the analytic models
(``launch/analytic.py``); the operations ``FlopCounterMode`` counted over
the dry run's ``meta`` pass stay beside them as
``raw_counted_flops_per_device``. Nothing counts bytes in an eager run,
so ``raw_counted_bytes_per_device`` is None. There is no compiled
program to read collectives from: on one card there are none, and the
multi-GPU slice will read NCCL events (ROADMAP Queue 1).

Where the reference has only the compiled artifact, the port also
measures: :func:`profile_device` times a step on the card by CUDA
events and reads one profiled step's kernels and copies from
``torch.profiler`` (the device's busy time, its idle share, the kernels
that take longest), and :func:`roofline_report` turns that into the
share of the roofline the step reached. A measurement needs the card;
there is no CPU path.

MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference) with N = active params
audits how much of the analytic compute is "useful" (catches remat
waste).
"""

from __future__ import annotations

import subprocess
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

__all__ = ["HBM_BW", "HBM_BYTES", "NVLINK_BW", "PEAK_F32_FLOPS",
           "PEAK_FLOPS", "add_measured", "card", "device_busy",
           "model_flops", "parse_collectives", "profile_device",
           "roofline_report", "tensors"]

# --- target hardware: one H100 SXM, dense rates (NVIDIA data sheet) ---
PEAK_FLOPS = 989e12       # bf16 on the tensor cores
PEAK_F32_FLOPS = 67e12    # f32 outside the tensor cores; an FMA is 2
HBM_BW = 3.35e12          # bytes/s
# NVLink 4, bytes/s each way per card: the collective term's rate once a
# cell spans cards; unused at world 1, where no collective runs
NVLINK_BW = 450e9
# torch.cuda.get_device_properties(0).total_memory as an NVIDIA H100 80GB
# HBM3 (torch 2.11, CUDA 12.8) reports it
HBM_BYTES = 85_017_493_504

# the kernels a report lists by device time
TOP_KERNELS = 8


def _wire_bytes(op: str, result_bytes: int, g: int) -> float:
    if g <= 1:
        return 0.0
    frac = (g - 1) / g
    if op == "all-reduce":
        return 2.0 * result_bytes * frac
    if op == "all-gather":
        return result_bytes * frac
    if op == "reduce-scatter":
        return result_bytes * (g - 1)
    if op == "all-to-all":
        return result_bytes * frac
    if op == "collective-permute":
        return float(result_bytes)
    return float(result_bytes)


def parse_collectives(*_args, **_kw) -> List[Any]:
    raise NotImplementedError("collectives come from NCCL events across "
                              "cards: ROADMAP Queue 1, the multi-GPU item")


# ---------------------------------------------------------------------------
# Measurement on the card
# ---------------------------------------------------------------------------

def card() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def tensors(tree):
    """The tensors of a tree of dicts, lists, tuples, dataclasses (an
    index) and modules (their parameters)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors(v)
    elif hasattr(tree, "__dataclass_fields__"):
        for name in tree.__dataclass_fields__:
            yield from tensors(getattr(tree, name))


def _require_card(inputs) -> None:
    for t in tensors(inputs):
        if t.device.type != "cuda":
            raise ValueError(f"a measurement runs on the card: an input "
                             f"lies on {t.device}")
    if not torch.cuda.is_available():
        raise RuntimeError("a measurement runs on the card: no CUDA device")


def _device_events(fn: Callable[[], Any]) -> list:
    """The CUDA activity of one call of fn (kernels and copies) from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.events()
            if str(e.device_type).rsplit(".", 1)[-1] == "CUDA"]


def device_busy(fn: Callable[[], Any]) -> Tuple[float, int]:
    """(device-busy ms, kernels) of one call of fn, warm: the sum of its
    kernels' and copies' durations (one stream: they do not overlap)."""
    fn()
    torch.cuda.synchronize()
    evs = _device_events(fn)
    return sum(e.time_range.elapsed_us() for e in evs) / 1e3, len(evs)


def profile_device(fn: Callable[[], Any], reps: int = 3, *,
                   inputs=()) -> Dict[str, Any]:
    """The measured half of a roofline report for fn, a step on the card
    (``inputs``: the tensors it reads, which must lie on the card): one
    warm call, ``reps`` calls timed by CUDA events (their mean is
    ``measured_seconds``; the host's launches are inside the window), and
    one profiled call whose kernels and copies give ``busy_seconds``,
    ``kernels`` and the longest ones by name. ``idle_share`` is the part
    of a timed step in which the device ran nothing; ``peak_bytes`` is
    ``max_memory_allocated`` over the calls. Raises without a card."""
    _require_card(inputs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    measured = start.elapsed_time(end) / 1e3 / reps
    evs = _device_events(fn)
    busy = sum(e.time_range.elapsed_us() for e in evs) / 1e6
    by_name: Dict[str, list] = {}
    for e in evs:
        slot = by_name.setdefault(e.name, [0.0, 0])
        slot[0] += e.time_range.elapsed_us() / 1e6
        slot[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]
    return {
        "measured_seconds": measured,
        "reps": reps,
        "busy_seconds": busy,
        "idle_share": 1.0 - busy / measured,
        "kernels": len(evs),
        "top_kernels": [{"name": n, "seconds": s, "count": c}
                        for n, (s, c) in top],
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "device": card(),
    }


# ---------------------------------------------------------------------------
# The report
# ---------------------------------------------------------------------------

def roofline_report(
    *,
    world: int,
    model_flops_global: float,
    analytic_flops_global: Optional[float],
    analytic_bytes_global: Optional[float],
    memory: Dict[str, Any],
    raw_flops: Optional[float] = None,
    measured: Optional[Dict[str, Any]] = None,
    steps_hint: str = "",
) -> Dict[str, Any]:
    """The three-term report of a cell, with the reference's keys.

    ``raw_flops``: the operations counted over the dry run (global).
    ``memory``: ``argument_bytes``, ``output_bytes`` and ``temp_bytes``
    (None where nothing ran) of the dry run; ``live_bytes``, ``fits_hbm``
    and ``hbm_frac`` are derived here. ``measured``: a
    :func:`profile_device` record, joined by :func:`add_measured`."""
    raw_flops_dev = raw_flops / world if raw_flops is not None else None
    flops_dev = (analytic_flops_global / world
                 if analytic_flops_global else (raw_flops_dev or 0.0))
    bytes_dev = (analytic_bytes_global / world
                 if analytic_bytes_global else 0.0)

    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": 0.0}
    bottleneck = max(terms, key=terms.get)
    model_flops_dev = model_flops_global / world
    useful = model_flops_dev / flops_dev if flops_dev else 0.0

    mem = dict(memory)
    live = (mem["argument_bytes"] + mem["output_bytes"]
            + (mem["temp_bytes"] or 0))
    mem["live_bytes"] = live
    mem["fits_hbm"] = bool(live <= HBM_BYTES)
    mem["hbm_frac"] = live / HBM_BYTES

    report = {
        "world": world,
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "raw_counted_flops_per_device": raw_flops_dev,
        "raw_counted_bytes_per_device": None,
        "wire_bytes_per_device": 0.0,
        "wire_bytes_by_kind": {},
        "terms_seconds": terms,
        "bottleneck": bottleneck,
        "model_flops_global": model_flops_global,
        "useful_flops_ratio": useful,
        "n_collectives": 0,
        "top_collectives": [],
        "memory_analysis": mem,
        "note": steps_hint,
    }
    if measured is not None:
        add_measured(report, measured)
    return report


def add_measured(report: Dict[str, Any],
                 measured: Dict[str, Any]) -> Dict[str, Any]:
    """A :func:`profile_device` record joined to a report (in place):
    its keys, ``roofline_share`` (the larger of the compute and memory
    terms over the measured step) and ``roofline_bound`` (which of the
    two)."""
    t = report["terms_seconds"]
    bound = "compute" if t["compute"] >= t["memory"] else "memory"
    report.update(measured)
    report["roofline_share"] = t[bound] / measured["measured_seconds"]
    report["roofline_bound"] = bound
    return report


def model_flops(cfg, shape, active_params: int) -> float:
    """MODEL_FLOPS for the cell: 6ND train, 2ND prefill, 2N·B decode."""
    if shape.kind == "train":
        tokens = shape.batch * shape.seq
        return 6.0 * active_params * tokens
    if shape.kind == "prefill":
        tokens = shape.batch * shape.seq
        return 2.0 * active_params * tokens
    # decode: one token per sequence (+ attention over the cache, which
    # is O(cache) and not captured by 2ND — reported separately)
    return 2.0 * active_params * shape.batch
