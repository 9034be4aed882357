"""Roofline terms for one H100, from the dry run and the profiler.

The port's counterpart of ``src/repro/launch/roofline.py``. Three terms
per (arch x shape) cell, in seconds a step on one card:

    compute    = flops_per_device / PEAK_FLOPS
    memory     = bytes_per_device / HBM_BW
    collective = wire_bytes_per_device / NVLINK_BW   (0 on one card)

The compute and memory numerators are the analytic models
(``launch/analytic.py``); the operations counted over the dry run's
``meta`` pass stay beside them as ``raw_counted_flops_per_device``.
Nothing counts bytes in an eager run, so ``raw_counted_bytes_per_device``
is None. There is no compiled program to read collectives from: the run
itself issues them, and :class:`CollectiveRecorder` records each with
its kind, local result bytes and group size as it runs (on one card
there are none). :func:`parse_collectives` prices them with the
reference's ring estimates:

    all-reduce      2 * S * (g-1)/g      (reduce-scatter + all-gather)
    all-gather      R * (g-1)/g          (R = gathered result)
    reduce-scatter  R * (g-1)            (R = scattered result, in = R*g)
    all-to-all      S * (g-1)/g
    collective-permute  S

One rate, ``NVLINK_BW``, serves every mesh axis, as the reference's one
``ICI_BW`` does: optimistic for a 16-rank 'model' group, which spans two
8-card nodes joined by InfiniBand.

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

import dataclasses
import subprocess
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["ALLTOALL_NOTE", "CollectiveOp", "CollectiveRecorder",
           "HBM_BW", "HBM_BYTES", "KINDS", "NVLINK_BW", "PEAK_F32_FLOPS",
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


@dataclasses.dataclass
class CollectiveOp:
    op: str
    bytes_result: int
    group_size: int
    wire_bytes: float
    line: str


# the reference's kind of each collective op (torch.distributed's c10d
# ops, the functional ones DTensor issues, DTensor's own all-to-all)
KINDS = {
    "all-gather": (
        "_c10d_functional.all_gather_into_tensor",
        "_c10d_functional.all_gather_into_tensor_out",
        "_c10d_functional.all_gather_into_tensor_coalesced",
        "c10d.allgather_", "c10d._allgather_base_",
        "c10d.allgather_coalesced_",
        "c10d.allgather_into_tensor_coalesced_"),
    "all-reduce": (
        "_c10d_functional.all_reduce", "_c10d_functional.all_reduce_",
        "_c10d_functional.all_reduce_coalesced",
        "_c10d_functional.all_reduce_coalesced_",
        "c10d.allreduce_", "c10d.allreduce_coalesced_"),
    "reduce-scatter": (
        "_c10d_functional.reduce_scatter_tensor",
        "_c10d_functional.reduce_scatter_tensor_coalesced",
        "c10d.reduce_scatter_", "c10d._reduce_scatter_base_",
        "c10d.reduce_scatter_tensor_coalesced_"),
    "all-to-all": (
        "_c10d_functional.all_to_all_single", "_dtensor.shard_dim_alltoall",
        "c10d.alltoall_", "c10d.alltoall_base_"),
    "collective-permute": ("c10d.send", "c10d.recv_"),
}
_KIND_OF = {name: kind for kind, names in KINDS.items() for name in names}
# the collective ops of no reference kind, priced at their result bytes
_OTHER = ("_c10d_functional.broadcast", "_c10d_functional.broadcast_",
          "c10d.broadcast_", "c10d.reduce_", "c10d.gather_",
          "c10d.scatter_")

# where a CPU mesh gathers in place of an all-to-all
ALLTOALL_NOTE = ("DTensor ran {n} all-to-all(s) as all-gather + chunk on "
                 "the CPU mesh; counted as the all-to-all NCCL runs, at "
                 "its result bytes")


def _group_size(args) -> int:
    import torch.distributed as dist

    for a in args:
        if isinstance(a, torch.ScriptObject):  # a c10d op's group
            return dist.ProcessGroup.unbox(a).size()
    name = next((a for a in reversed(args) if isinstance(a, str)), None)
    if name is not None:  # a functional op's group name
        return torch._C._distributed_c10d._resolve_process_group(name).size()
    return 1


def _result_bytes(kind: str, out, args) -> int:
    """The local bytes of a collective's result: the gathered output of an
    all-gather, the scattered one of a reduce-scatter, the reduced tensor
    of an all-reduce; a c10d op writes its outputs in place (its first
    argument)."""
    where = out
    if isinstance(out, tuple) or out is None:  # c10d: (outputs, work)
        where = args[0]
    return sum(t.numel() * t.element_size() for t in tensors(where))


class CollectiveRecorder(TorchDispatchMode):
    """Every collective a run issues, from the run itself: a dispatch mode
    that lets DTensor desugar first (it returns ``NotImplemented`` for
    DTensor operands, as torch's ``CommDebugMode`` does) and so sees the
    collectives DTensor issues inside an op beside those the caller
    issues. ``records`` holds (kind, local result bytes, group size, op
    name) in order.

    On a CPU mesh DTensor runs a shard-to-shard all-to-all as an
    all-gather and a chunk (gloo has no all-to-all); NCCL runs it as one
    all-to-all, which is what is recorded, at the chunk's bytes, and
    ``cpu_alltoalls`` counts them."""

    def __init__(self):
        super().__init__()
        self.records: List[Tuple[str, int, int, str]] = []
        self.cpu_alltoalls = 0
        self._inside = 0
        self._patched = None

    def __enter__(self):
        from torch.distributed.tensor import placement_types

        orig = getattr(placement_types, "shard_dim_alltoall", None)
        if orig is not None:
            def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
                if mesh.device_type != "cpu":
                    return orig(input, gather_dim, shard_dim, mesh, mesh_dim)
                self._inside += 1
                try:
                    out = orig(input, gather_dim, shard_dim, mesh, mesh_dim)
                finally:
                    self._inside -= 1
                self.cpu_alltoalls += 1
                self.records.append(("all-to-all", out.numel()
                                     * out.element_size(),
                                     mesh.size(mesh_dim),
                                     "all_gather + chunk on the CPU"))
                return out

            placement_types.shard_dim_alltoall = alltoall
            self._patched = (placement_types, orig)
        return super().__enter__()

    def __exit__(self, *exc):
        if self._patched is not None:
            mod, orig = self._patched
            mod.shard_dim_alltoall = orig
            self._patched = None
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(getattr(t, "__name__", "") == "DTensor" for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        name = str(func._overloadpacket)
        name = name.removeprefix("torch.ops.")
        kind = _KIND_OF.get(name, name if name in _OTHER else None)
        if kind is not None and not self._inside:
            self.records.append((kind, _result_bytes(kind, out, args),
                                 _group_size(args), name))
        return out


def parse_collectives(records, world: int) -> List[CollectiveOp]:
    """The reference's :class:`CollectiveOp` of every recorded collective
    (``CollectiveRecorder.records``, or (kind, bytes, group) tuples), its
    wire bytes by the reference's ring estimates (:func:`_wire_bytes`);
    a group of no recorded size spans the world. ``line`` names the op
    and its position in the run, as the reference's names the HLO
    line."""
    out = []
    for i, rec in enumerate(records):
        kind, rb, g = rec[:3]
        g = g or world
        name = rec[3] if len(rec) > 3 else kind
        out.append(CollectiveOp(op=kind, bytes_result=int(rb),
                                group_size=int(g),
                                wire_bytes=_wire_bytes(kind, int(rb), int(g)),
                                line=f"#{i} {name} group={g} bytes={rb}"))
    return out


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
    collectives: Optional[List[CollectiveOp]] = None,
    steps_hint: str = "",
) -> Dict[str, Any]:
    """The three-term report of a cell, with the reference's keys.

    ``collectives``: :func:`parse_collectives` of the run's records; the
    collective term is their wire bytes a device over ``NVLINK_BW``, one
    rate for every mesh axis as the reference has one ``ICI_BW``. A
    16-rank 'model' group spans two 8-card nodes, whose links between
    them (InfiniBand) are slower than NVLink: there the term is
    optimistic.
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

    colls = list(collectives or ())
    wire_dev = sum(c.wire_bytes for c in colls)
    by_kind: Dict[str, float] = {}
    for c in colls:
        by_kind[c.op] = by_kind.get(c.op, 0.0) + c.wire_bytes

    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": wire_dev / NVLINK_BW}
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
        "wire_bytes_per_device": wire_dev,
        "wire_bytes_by_kind": by_kind,
        "terms_seconds": terms,
        "bottleneck": bottleneck,
        "model_flops_global": model_flops_global,
        "useful_flops_ratio": useful,
        "n_collectives": len(colls),
        "top_collectives": [
            {"op": c.op, "wire_bytes": c.wire_bytes, "group": c.group_size}
            for c in sorted(colls, key=lambda c: -c.wire_bytes)[:8]],
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
