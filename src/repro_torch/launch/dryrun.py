"""Dry run of every (architecture x input shape) cell on one H100, at full
width and depth, with no allocation.

The port's counterpart of ``src/repro/launch/dryrun.py``. Where the
reference lowers and compiles the real entry point against
ShapeDtypeStruct stand-ins, the port runs it eagerly on ``meta`` tensors
(``params.abstract``): the parameters of ``model_specs(cfg)`` and the
inputs of ``input_specs(cfg, shape)`` have shapes and dtypes and no
storage, and every op computes only its output's shape. Around that run:

* ``torch.utils.flop_counter.FlopCounterMode`` counts the operations
  the run executes (the report's ``raw_counted_flops_per_device``);
* :class:`LiveBytes`, the port's own ``TorchDispatchMode``, counts the
  bytes of every storage an op creates, from its creation to its
  release, and keeps the peak: the ``temp_bytes`` and ``output_bytes``
  of ``memory_analysis`` (torch's ``MemTracker`` reports by module and
  device; one peak beside the arguments is what the report needs).

The roofline terms come from the analytic models (``launch/analytic.py``)
with the reference's inputs. ``lower_seconds`` is the meta run's host
time; the port compiles nothing, so there is no ``compile_seconds``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch gemma2-2b --shape decode_32k

Not ported (ROADMAP Queue 1, the multi-GPU item): the 256/512-chip
meshes, ``parallelism="fsdp"``, ``rules_overrides`` and donation.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.clock import now
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.launch import analytic
from repro_torch.launch import roofline as roof
from repro_torch.models import model as model_mod
from repro_torch.models import params as params_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_step import build_train_step

__all__ = ["GRAD_ACCUM", "LiveBytes", "OPT_DTYPE", "PastLimit", "fits_hbm",
           "lower_cell", "main"]

# per-arch microbatching for the train shape: keeps the remat carry
# (num_blocks x microbatch x seq x d_model) within HBM (DESIGN.md §5.4)
GRAD_ACCUM = {
    "llama3-405b": 8,
    "qwen1.5-110b": 8,
    "chameleon-34b": 8,
    "dbrx-132b": 8,
    "jamba-v0.1-52b": 4,
    "minitron-8b": 4,
    "deepseek-moe-16b": 4,
    "gemma2-2b": 4,
    "seamless-m4t-medium": 1,
    "mamba2-370m": 8,
}

# optimizer-state dtype: bf16 halves moments for the giants (§Dry-run
# memory table discusses the f32 alternative)
OPT_DTYPE = {
    "llama3-405b": torch.bfloat16,
    "qwen1.5-110b": torch.bfloat16,
    "dbrx-132b": torch.bfloat16,
}

OUT_DIR = "single_h100"


def _opt_cfg(arch: str) -> opt_mod.OptConfig:
    return opt_mod.OptConfig(state_dtype=OPT_DTYPE.get(arch, torch.float32))


def _storages(tree):
    for t in roof.tensors(tree):
        yield t.untyped_storage()


class LiveBytes(TorchDispatchMode):
    """Bytes alive during a run, beyond its arguments: every storage an op
    returns that is not an argument's and not counted yet is counted from
    then until it is released (a weak reference to the storage; views
    share their base's). ``peak`` is the most held at once, ``now`` what
    is held at the moment; past ``limit`` bytes it raises
    :class:`PastLimit`. Works on ``meta`` tensors, whose storages have
    sizes but no memory."""

    def __init__(self, arguments, limit: Optional[int] = None):
        super().__init__()
        self._arguments = {st._cdata for st in _storages(arguments)}
        self._live: Dict[int, Any] = {}
        self.now = self.peak = 0
        self.limit = limit

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for st in _storages(out):
            self._track(st)
        return out

    def _track(self, st) -> None:
        key = st._cdata
        if key in self._arguments or key in self._live:
            return
        n = st.nbytes()
        self._live[key] = weakref.ref(
            st, functools.partial(self._release, key, n))
        self.now += n
        self.peak = max(self.peak, self.now)
        if self.limit is not None and self.now > self.limit:
            raise PastLimit(self.now)

    def _release(self, key: int, n: int, _ref) -> None:
        if self._live.pop(key, None) is not None:
            self.now -= n

    def new_bytes(self, tree) -> int:
        """Bytes of the storages of ``tree`` that the run created and that
        are still alive (an output that is not an argument updated in
        place)."""
        seen = set()
        total = 0
        for st in _storages(tree):
            if st._cdata in self._live and st._cdata not in seen:
                seen.add(st._cdata)
                total += st.nbytes()
        return total


def _tree_bytes(tree) -> int:
    seen, total = set(), 0
    for st in _storages(tree):
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


class PastLimit(Exception):
    """Raised by a :class:`LiveBytes` with a limit once the live bytes
    pass it."""


@dataclasses.dataclass
class _Cell:
    cfg: Any
    shape: Any
    accum: int
    ocfg: opt_mod.OptConfig
    arguments: list            # params, inputs (and the OptState to train)
    argument_bytes: int
    acc_bytes: int             # the accumulated step's f32 gradient sum

    def run(self):
        """The cell's entry point on its arguments."""
        params, inputs = self.arguments[:2]
        cfg, shape = self.cfg, self.shape
        if shape.kind == "train":
            micro = {k: v[: shape.batch // self.accum]
                     for k, v in inputs.items()}
            step_fn = build_train_step(cfg, self.ocfg, grad_accum=1)
            return step_fn(params, self.arguments[2], micro)
        if shape.kind == "prefill":
            return model_mod.prefill(params, inputs, cfg)
        return model_mod.decode_step(params, inputs["tokens"],
                                     inputs["cache"], shape.seq - 1, cfg)


def _cell(arch: str, shape_name: str, grad_accum: Optional[int],
          arch_overrides):
    """The cell's abstract arguments, or its skip report."""
    cfg = get_config(arch)
    if arch_overrides:
        cfg = dataclasses.replace(cfg, **arch_overrides)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": reason}
    accum = (grad_accum if grad_accum is not None
             else GRAD_ACCUM.get(arch, 1))
    ocfg = _opt_cfg(arch)
    params = model_mod.Model(
        cfg, params_mod.abstract(model_mod.model_specs(cfg)))
    arguments = [params,
                 params_mod.abstract(model_mod.input_specs(cfg, shape))]
    acc_bytes = 0
    if shape.kind == "train":
        arguments.append(opt_mod.init(ocfg, params))
        if accum > 1:
            acc_bytes = 4 * cfg.param_count()
    return _Cell(cfg, shape, accum, ocfg, arguments,
                 _tree_bytes(arguments), acc_bytes)


def lower_cell(arch: str, shape_name: str, *,
               grad_accum: Optional[int] = None,
               arch_overrides=None) -> Dict[str, Any]:
    """Run the cell's entry point on ``meta`` and return its roofline
    report: ``prefill``; ``decode_step`` at ``pos = seq - 1`` over the
    abstract cache; or for ``train`` one microbatch of B / grad_accum
    through ``build_train_step(cfg, ocfg, grad_accum=1)``, which ends in
    ``optimizer.apply`` on an abstract OptState, its counted operations
    scaled by grad_accum (``note`` says so). With grad_accum > 1 the
    accumulated step's f32 gradient sum (4 bytes a parameter) is added
    to ``temp_bytes``. A cell that ``shape_applicable`` refuses is
    skipped with its reason."""
    cell = _cell(arch, shape_name, grad_accum, arch_overrides)
    if isinstance(cell, dict):
        return cell
    cfg, shape, accum = cell.cfg, cell.shape, cell.accum
    world = 1
    flops = FlopCounterMode(display=False)
    live = LiveBytes(cell.arguments)
    t0 = now()
    with flops, live:
        out = cell.run()
        output_bytes = live.new_bytes(out)
    t_lower = now() - t0
    del out
    raw = float(flops.get_total_flops())
    if shape.kind == "train":
        raw *= accum

    mf = roof.model_flops(cfg, shape, cfg.active_param_count())
    remat = (shape.kind == "train"
             and cfg.remat_policy == "nothing_saveable")
    af = analytic.flops_model(cfg, shape, grad_accum=accum, remat=remat)
    opt_bpp = 2 * cell.ocfg.state_dtype.itemsize
    ab = analytic.bytes_model(
        cfg, shape, param_count=cfg.param_count(), grad_accum=accum,
        opt_bytes_per_param=opt_bpp, remat=remat)
    report = roof.roofline_report(
        world=world, model_flops_global=mf,
        analytic_flops_global=af["flops_global"],
        analytic_bytes_global=ab["bytes_global"],
        memory={"argument_bytes": cell.argument_bytes,
                "output_bytes": output_bytes,
                "temp_bytes": live.peak - output_bytes + cell.acc_bytes},
        raw_flops=raw,
        steps_hint=f"grad_accum={accum}; counted over one microbatch "
                   f"x {accum}" if shape.kind == "train" else shape.kind,
    )
    report.update({
        "arch": arch, "shape": shape_name, "status": "ok",
        "mesh": [world], "mesh_axes": [],
        "lower_seconds": round(t_lower, 1),
        "total_params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    })
    return report


def fits_hbm(arch: str, shape_name: str) -> Dict[str, Any]:
    """The memory half of :func:`lower_cell` alone, stopped as soon as
    the live bytes pass ``HBM_BYTES``: ``{"fits_hbm": bool, "live_bytes":
    int}``, the live bytes of the whole run when it fits (then equal to
    ``lower_cell``'s) and where it stopped when it does not. A skipped
    cell does not fit and carries its reason."""
    cell = _cell(arch, shape_name, None, None)
    if isinstance(cell, dict):
        return {"fits_hbm": False, "live_bytes": 0,
                "reason": cell["reason"]}
    held = cell.argument_bytes + cell.acc_bytes
    if held > roof.HBM_BYTES:
        return {"fits_hbm": False, "live_bytes": held}
    live = LiveBytes(cell.arguments, limit=roof.HBM_BYTES - held)
    try:
        with live:
            out = cell.run()
    except PastLimit:
        return {"fits_hbm": False, "live_bytes": held + live.peak}
    del out
    return {"fits_hbm": True, "live_bytes": held + live.peak}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES),
                    help="one shape (default all)")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--grad-accum", type=int, default=None)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)

    outdir = os.path.join(args.out, OUT_DIR)
    os.makedirs(outdir, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            tag = f"{arch}__{shape}"
            print(f"=== {OUT_DIR} :: {tag} ===", flush=True)
            try:
                rep = lower_cell(arch, shape, grad_accum=args.grad_accum)
            except Exception as e:  # noqa: BLE001 — sweep must survive any one cell's meta-run failure; the error lands in its report JSON
                failures += 1
                rep = {"arch": arch, "shape": shape,
                       "status": "failed", "error": str(e)[-2000:],
                       "traceback": traceback.format_exc()[-4000:]}
                print(f"FAILED: {e}", flush=True)
            with open(os.path.join(outdir, tag + ".json"), "w") as f:
                json.dump(rep, f, indent=2, default=str)
            if rep.get("status") == "ok":
                t = rep["terms_seconds"]
                m = rep["memory_analysis"]
                print(f"memory {m}; counted flops "
                      f"{rep['raw_counted_flops_per_device']}")
                print(
                    f"ok lower={rep['lower_seconds']}s "
                    f"compute={t['compute']:.4f}s "
                    f"memory={t['memory']:.4f}s "
                    f"coll={t['collective']:.4f}s "
                    f"bottleneck={rep['bottleneck']} "
                    f"useful={rep['useful_flops_ratio']:.2f} "
                    f"live={m['live_bytes'] / 2 ** 30:.1f}GiB "
                    f"fits={m['fits_hbm']}",
                    flush=True)
            elif rep.get("status") == "skipped":
                print(f"skipped: {rep['reason']}", flush=True)
    print(f"done, failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
