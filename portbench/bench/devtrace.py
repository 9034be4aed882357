"""One ``torch.profiler`` window over whole batches, reduced to what the
per-layer metrics and the result's ``breakdown`` read.

The profiler's Chrome trace is written to a temporary file (under
``TMPDIR``), read back and deleted. Its events carry their kind:
``kernel``, ``gpu_memcpy`` and ``gpu_memset`` ran on the device,
``cuda_runtime`` and ``cuda_driver`` are the host's calls into CUDA,
``cpu_op`` the host's operators and ``user_annotation`` the harness's
own spans (:func:`span`): one around each batch, from its send to its
answer on the host, and one inside it around the system's entry alone.
The window runs from the first batch span's start to the last one's
end; the counts of launches and waits take only the host's calls made
inside an entry span, so the harness's own query draws, copies and
waits between them are not counted.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Tuple

import torch

BATCH = "portbench.batch"
ENTRY = "portbench.entry"
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME = ("cuda_runtime", "cuda_driver")
HOST = ("cpu_op", "cuda_runtime", "cuda_driver")
TOP = 10
NAME = 160  # characters of an operation's name kept in the breakdown


def span(name: str):
    """The profiler's annotation ``portbench.<name>`` (``batch`` or
    ``entry``)."""
    return torch.profiler.record_function(f"portbench.{name}")


def profile(fn: Callable, device) -> Tuple[object, dict]:
    """(fn(), the reduced trace of its run)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof_ctx

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with prof_ctx(activities=acts) as prof:
        out = fn()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return out, reduce(events)


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _spans(xs: list, name: str) -> list:
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in xs if e.get("cat") == "user_annotation"
                  and e["name"] == name)


def _inside(spans: list, t: float) -> bool:
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and spans[i][0] <= t < spans[i][1]


def reduce(events: list) -> dict:
    """From the trace's complete events: the window (s), the device's
    busy time in it (the union of its kernels', copies' and sets'
    intervals, s), the device operations launched by host calls inside
    the entry spans and the host's calls there that waited on the device
    (``*Synchronize``), the device time by operation name, and the
    breakdown: the ten operations that took the most device time, and
    the ten host operations under which the device idled longest."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    spans = _spans(xs, BATCH)
    if not spans:
        raise ValueError("the trace holds no batch span")
    entries = _spans(xs, ENTRY)
    t0, t1 = spans[0][0], max(e for _, e in spans)
    calls = [e for e in xs if e.get("cat") in RUNTIME
             and _inside(entries, float(e["ts"]))]
    launched = {e.get("args", {}).get("correlation") for e in calls}
    launched.discard(None)
    dev, by_name, entry_ops = [], defaultdict(float), 0
    for e in xs:
        if e.get("cat") not in DEVICE:
            continue
        entry_ops += e.get("args", {}).get("correlation") in launched
        s, d = float(e["ts"]), float(e["dur"])
        if s + d <= t0 or s >= t1:
            continue
        dev.append((max(s, t0), min(s + d, t1)))
        by_name[e["name"]] += d / 1e6
    busy = _union(dev)
    syncs = sum(1 for e in calls if "Synchronize" in e["name"])
    host = sorted((float(e["ts"]), float(e["dur"]), e["name"]) for e in xs
                  if e.get("cat") in HOST)
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    edge = t0
    for s, e in busy + [[t1, t1]]:
        if s > edge:
            gaps[_host_at(host, starts, (edge + s) / 2)] += (s - edge) / 1e6
        edge = max(edge, e)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (t1 - t0) / 1e6,
            "busy_s": sum(e - s for s, e in busy) / 1e6,
            "entry_ops": entry_ops, "entry_syncs": syncs,
            "device_s_by_name": dict(by_name),
            "breakdown": {"device_ops": [[n[:NAME], v] for n, v in top],
                          "idle_gaps": [[n[:NAME], v] for n, v in idle]}}


def _host_at(host, starts, t: float, look: int = 256) -> str:
    """The innermost host event running at ``t`` (the shortest of those
    among the ``look`` that started last before it)."""
    i = bisect.bisect_right(starts, t)
    best = None
    for s, d, name in host[max(i - look, 0):i]:
        if s + d >= t and (best is None or d < best[0]):
            best = (d, name)
    return best[1] if best else "(no host op)"
