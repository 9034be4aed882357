"""Dry run of every (architecture x input shape) cell, at full width and
depth, with no allocation: on one H100, or on the production meshes of
256 and 512 ranks.

The port's counterpart of ``src/repro/launch/dryrun.py``. Where the
reference lowers and compiles the real entry point against
ShapeDtypeStruct stand-ins, the port runs it eagerly on ``meta`` tensors
(``params.abstract``): the parameters of ``model_specs(cfg)`` and the
inputs of ``input_specs(cfg, shape)`` have shapes and dtypes and no
storage, and every op computes only its output's shape. Around that run:

* :class:`OpCount` counts the operations the run executes (the report's
  ``raw_counted_flops_per_device``) by ``FlopCounterMode``'s formulas;
* :class:`LiveBytes` counts the bytes of every storage an op creates,
  from its creation to its release, and keeps the peak: the
  ``temp_bytes`` and ``output_bytes`` of ``memory_analysis`` (torch's
  ``MemTracker`` reports by module and device; one peak beside the
  arguments is what the report needs);
* on a mesh, ``roofline.CollectiveRecorder`` records every collective.

On a mesh (``launch/mesh.make_production_mesh(dry=True)``: a dry world
of torch's ``fake`` backend, this process its rank 0) the parameters,
the optimizer state and the inputs are laid out as DTensors by the
mesh's rules before anything counts, and the entry point runs on them
under ``sharding_utils.use_mesh``. DTensor runs each op as its local ops
and collectives; all three counters let it do so first and count those,
so every number is rank 0's: per device (torch's ``Shard`` gives a
remainder to the first ranks, so rank 0's shard is the largest).

The roofline terms come from the analytic models (``launch/analytic.py``)
with the reference's inputs at ``world`` = the mesh's size, the
collective term from the recorded collectives. ``lower_seconds`` is the
meta run's host time; the port compiles nothing, so there is no
``compile_seconds``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch gemma2-2b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both \\
        --arch gemma2-2b --shape decode_32k

Donation has no torch counterpart: the optimizer and a decode step
update the parameters, the state and the cache in place, which is what
``donate=True`` (the default) describes; with ``donate=False`` the
step's new parameters and state (train) or cache (decode) are counted
in ``output_bytes``, as an undonated step must hold them beside the old.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
from torch._guards import detect_fake_mode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.clock import now
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.launch import analytic
from repro_torch.launch import roofline as roof
from repro_torch.launch import sharding as shard_mod
from repro_torch.launch.mesh import destroy_world, make_production_mesh
from repro_torch.models import model as model_mod
from repro_torch.models import params as params_mod
from repro_torch.models import sharding_utils as su
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_step import build_train_step

__all__ = ["GRAD_ACCUM", "LiveBytes", "MESHES", "OPT_DTYPE", "OpCount",
           "PastLimit", "fits_hbm", "lower_cell", "main"]

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
# --mesh: the report directory of each mesh, and the production mesh
# (multi_pod) it runs on; None for one card
MESHES = {"h100": (OUT_DIR, None), "single": ("single_pod_16x16", False),
          "multi": ("multi_pod_2x16x16", True)}


def _opt_cfg(arch: str) -> opt_mod.OptConfig:
    return opt_mod.OptConfig(state_dtype=OPT_DTYPE.get(arch, torch.float32))


def _storages(tree):
    """The storages of a tree's tensors; a DTensor's are its local
    shard's (its own reports the whole tensor's size)."""
    for t in roof.tensors(tree):
        if su.is_dtensor(t):
            t = t.to_local()
        yield t.untyped_storage()


def _dtensor_op(types) -> bool:
    """Whether DTensor should run the op first: a DTensor operand."""
    return any(getattr(t, "__name__", "") == "DTensor" for t in types)


def _propagating() -> bool:
    """Whether DTensor runs the op to find an output's shape: on fake
    tensors at the global shape, which no rank computes or holds."""
    return detect_fake_mode() is not None


class OpCount(TorchDispatchMode):
    """The operations a run executes, by ``FlopCounterMode``'s formulas
    (``flop_registry``), in ``total``. On DTensors it counts the local ops
    DTensor runs them as (it returns ``NotImplemented`` for a DTensor op
    and sees what DTensor makes of it): one rank's operations, where
    ``FlopCounterMode`` counts a sharded op at its global size."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self._registry = FlopCounterMode(display=False).flop_registry

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _dtensor_op(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _propagating():
            return out
        count = self._registry.get(func._overloadpacket)
        if count is not None:
            self.total += count(*args, **kwargs, out_val=out)
        return out


class LiveBytes(TorchDispatchMode):
    """Bytes alive during a run, beyond its arguments: every storage an op
    returns that is not an argument's and not counted yet is counted from
    then until it is released (a weak reference to the storage; views
    share their base's). ``peak`` is the most held at once, ``now`` what
    is held at the moment; past ``limit`` bytes it raises
    :class:`PastLimit`. Works on ``meta`` tensors, whose storages have
    sizes but no memory. On DTensors it counts the local tensors of the
    local ops DTensor runs (``NotImplemented`` for a DTensor op, as
    :class:`OpCount`): one rank's bytes."""

    def __init__(self, arguments, limit: Optional[int] = None):
        super().__init__()
        self._arguments = {st._cdata for st in _storages(arguments)}
        self._live: Dict[int, Any] = {}
        self.now = self.peak = 0
        self.limit = limit

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _dtensor_op(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if _propagating():
            return out
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


# parallelism="fsdp": the reference's rules and activation overrides
# (every mesh axis a data axis; weights gathered at use)
_FSDP_RULES = ("heads", "kv_heads", "head_dim", "mlp", "vocab", "experts",
               "ssm_inner")
_FSDP_ACTS = ("heads", "kv_heads", "head_dim", "mlp", "experts",
              "ssm_inner", "vocab", "seq_model")


def _parallelism(mesh, parallelism: str, rules_overrides):
    """(the rules' overrides, the activation map's) of ``parallelism``:
    'tp' keeps the caller's rules; 'fsdp' shards the batch and the fsdp
    dims over every mesh axis and nothing over 'model'."""
    if parallelism == "tp":
        return rules_overrides, None
    if parallelism != "fsdp":
        raise ValueError(f"parallelism {parallelism!r}: 'tp' or 'fsdp'")
    all_axes = tuple(mesh.mesh_dim_names)
    rules = dict(rules_overrides or {})
    rules.update({"batch": all_axes, "fsdp": all_axes})
    rules.update({k: None for k in _FSDP_RULES})
    acts = {"batch": all_axes}
    acts.update({k: () for k in _FSDP_ACTS})
    return rules, acts


def _lay_out(tree, placements, mesh):
    """A tree of tensors as DTensors by a tree of placements of its
    nesting; each rank keeps its shards (``sharding_utils._distribute``:
    no collective)."""
    if isinstance(tree, dict):
        return {k: _lay_out(v, placements[k], mesh) for k, v in tree.items()}
    return su._distribute(tree, mesh, placements)


@dataclasses.dataclass
class _Cell:
    cfg: Any
    shape: Any
    accum: int
    ocfg: opt_mod.OptConfig
    arguments: list            # params, inputs (and the OptState to train)
    argument_bytes: int
    acc_bytes: int             # the accumulated step's f32 gradient sum
    mesh: Any = None
    acts: Optional[dict] = None

    def run(self):
        """The cell's entry point on its arguments."""
        params, inputs = self.arguments[:2]
        cfg, shape = self.cfg, self.shape
        if shape.kind == "train":
            if self.mesh is not None:  # the accumulated step, whole
                step_fn = build_train_step(cfg, self.ocfg,
                                           grad_accum=self.accum)
                return step_fn(params, self.arguments[2], inputs)
            micro = {k: v[: shape.batch // self.accum]
                     for k, v in inputs.items()}
            step_fn = build_train_step(cfg, self.ocfg, grad_accum=1)
            return step_fn(params, self.arguments[2], micro)
        if shape.kind == "prefill":
            return model_mod.prefill(params, inputs, cfg)
        return model_mod.decode_step(params, inputs["tokens"],
                                     inputs["cache"], shape.seq - 1, cfg)

    @contextlib.contextmanager
    def context(self):
        """The mesh and the activation map the run sees."""
        with su.use_act_map(self.acts or {}), su.use_mesh(self.mesh):
            yield

    def donated(self) -> int:
        """The bytes a step that may not update its arguments in place
        holds anew: the parameters and the optimizer state (train), the
        cache (decode)."""
        if self.shape.kind == "train":
            return _tree_bytes([self.arguments[0], self.arguments[2]])
        if self.shape.kind == "decode":
            return _tree_bytes(self.arguments[1]["cache"])
        return 0


def _cell(arch: str, shape_name: str, grad_accum: Optional[int],
          arch_overrides, mesh=None, rules_overrides=None,
          parallelism: str = "tp"):
    """The cell's abstract arguments, laid out over ``mesh`` when there
    is one, or its skip report."""
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
    inputs = params_mod.abstract(model_mod.input_specs(cfg, shape))
    inputs.pop("pos", None)  # decode_step takes it as an int
    acts = None
    if mesh is not None:
        rules_overrides, acts = _parallelism(mesh, parallelism,
                                             rules_overrides)
        rules = shard_mod.mesh_rules(mesh, rules_overrides)
        shard_mod.distribute_params(
            params, mesh, shard_mod.param_shardings(cfg, mesh, rules))
        inputs = _lay_out(inputs, shard_mod.input_shardings(
            cfg, shape, mesh, rules), mesh)
    arguments = [params, inputs]
    acc_bytes = 0
    if shape.kind == "train":
        # the moments take their parameters' placements (opt_shardings)
        arguments.append(opt_mod.init(ocfg, params))
        if accum > 1 and mesh is None:
            acc_bytes = 4 * cfg.param_count()
    return _Cell(cfg, shape, accum, ocfg, arguments,
                 _tree_bytes(arguments), acc_bytes, mesh, acts)


def lower_cell(arch: str, shape_name: str, mesh=None, *,
               rules_overrides=None, grad_accum: Optional[int] = None,
               donate: bool = True, arch_overrides=None,
               parallelism: str = "tp") -> Dict[str, Any]:
    """Run the cell's entry point on ``meta`` and return its roofline
    report: ``prefill``; ``decode_step`` at ``pos = seq - 1`` over the
    abstract cache; or ``train``.

    On one card (``mesh`` None) a train cell runs one microbatch of B /
    grad_accum through ``build_train_step(cfg, ocfg, grad_accum=1)``,
    which ends in ``optimizer.apply`` on an abstract OptState, its
    counted operations scaled by grad_accum, and with grad_accum > 1 the
    accumulated step's f32 gradient sum (4 bytes a parameter) is added to
    ``temp_bytes`` (``note`` says so).

    On a ``mesh`` (a DeviceMesh of a dry world) the parameters, the
    optimizer state and the inputs are laid out by ``mesh_rules(mesh,
    rules_overrides)`` first; a train cell runs the accumulated step
    whole (``build_train_step(..., grad_accum=A)``), so that every
    collective counts as often as it runs. ``parallelism="fsdp"`` applies
    the reference's pure-FSDP rules and activation map. Every byte and
    operation is rank 0's, ``world`` the mesh's size, and the collectives
    recorded in the run fill ``n_collectives``, ``wire_bytes_*`` and the
    collective term.

    ``donate=False`` counts the step's new parameters and optimizer state
    (train) or cache (decode) as ``output_bytes`` (the module docstring).
    A cell that ``shape_applicable`` refuses is skipped with its
    reason."""
    cell = _cell(arch, shape_name, grad_accum, arch_overrides, mesh,
                 rules_overrides, parallelism)
    if isinstance(cell, dict):
        return cell
    cfg, shape, accum = cell.cfg, cell.shape, cell.accum
    world = 1 if mesh is None else mesh.size()
    flops = OpCount()
    live = LiveBytes(cell.arguments)
    rec = roof.CollectiveRecorder()
    t0 = now()
    with cell.context(), flops, live, rec:
        out = cell.run()
        new_bytes = live.new_bytes(out)
    t_lower = now() - t0
    del out
    output_bytes = new_bytes + (0 if donate else cell.donated())
    raw = float(flops.total) * world
    if shape.kind == "train" and mesh is None:
        raw *= accum

    mf = roof.model_flops(cfg, shape, cfg.active_param_count())
    remat = (shape.kind == "train"
             and cfg.remat_policy == "nothing_saveable")
    af = analytic.flops_model(cfg, shape, grad_accum=accum, remat=remat)
    opt_bpp = 2 * cell.ocfg.state_dtype.itemsize
    ab = analytic.bytes_model(
        cfg, shape, param_count=cfg.param_count(), grad_accum=accum,
        opt_bytes_per_param=opt_bpp, remat=remat)
    if shape.kind != "train":
        hint = shape.kind
    elif mesh is None:
        hint = (f"grad_accum={accum}; counted over one microbatch "
                f"x {accum}")
    else:
        hint = (f"grad_accum={accum}; counted over the accumulated step "
                f"whole")
    if rec.cpu_alltoalls:
        hint += "; " + roof.ALLTOALL_NOTE.format(n=rec.cpu_alltoalls)
    report = roof.roofline_report(
        world=world, model_flops_global=mf,
        analytic_flops_global=af["flops_global"],
        analytic_bytes_global=ab["bytes_global"],
        memory={"argument_bytes": cell.argument_bytes,
                "output_bytes": output_bytes,
                "temp_bytes": live.peak - new_bytes + cell.acc_bytes},
        raw_flops=raw,
        collectives=roof.parse_collectives(rec.records, world),
        steps_hint=hint,
    )
    report.update({
        "arch": arch, "shape": shape_name, "status": "ok",
        "mesh": [world] if mesh is None else [int(n) for n in
                                             mesh.mesh.shape],
        "mesh_axes": [] if mesh is None else list(mesh.mesh_dim_names),
        "parallelism": parallelism,
        "lower_seconds": round(t_lower, 1),
        "total_params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    })
    return report


def fits_hbm(arch: str, shape_name: str, mesh=None) -> Dict[str, Any]:
    """The memory half of :func:`lower_cell` alone (on ``mesh``, one
    rank's), stopped as soon as the live bytes pass ``HBM_BYTES``:
    ``{"fits_hbm": bool, "live_bytes": int}``, the live bytes of the
    whole run when it fits (then equal to ``lower_cell``'s) and where it
    stopped when it does not. A skipped cell does not fit and carries
    its reason."""
    cell = _cell(arch, shape_name, None, None, mesh)
    if isinstance(cell, dict):
        return {"fits_hbm": False, "live_bytes": 0,
                "reason": cell["reason"]}
    held = cell.argument_bytes + cell.acc_bytes
    if held > roof.HBM_BYTES:
        return {"fits_hbm": False, "live_bytes": held}
    live = LiveBytes(cell.arguments, limit=roof.HBM_BYTES - held)
    try:
        with cell.context(), live:
            out = cell.run()
    except PastLimit:
        return {"fits_hbm": False, "live_bytes": held + live.peak}
    del out
    return {"fits_hbm": True, "live_bytes": held + live.peak}


def _print(rep: Dict[str, Any]) -> None:
    if rep.get("status") == "ok":
        t = rep["terms_seconds"]
        m = rep["memory_analysis"]
        print(f"memory {m}; counted flops "
              f"{rep['raw_counted_flops_per_device']}; collectives "
              f"{rep['n_collectives']} {rep['wire_bytes_by_kind']}")
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES),
                    help="one shape (default all)")
    ap.add_argument("--mesh", default="h100",
                    choices=["h100", "single", "multi", "both"],
                    help="one H100, or the 16 x 16 / 2 x 16 x 16 dry "
                         "meshes")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--grad-accum", type=int, default=None)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    names = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = 0
    for name in names:
        out_dir, multi = MESHES[name]
        mesh = (None if multi is None
                else make_production_mesh(multi_pod=multi, dry=True))
        outdir = os.path.join(args.out, out_dir)
        os.makedirs(outdir, exist_ok=True)
        try:
            for arch in archs:
                for shape in shapes:
                    tag = f"{arch}__{shape}"
                    print(f"=== {out_dir} :: {tag} ===", flush=True)
                    try:
                        rep = lower_cell(arch, shape, mesh,
                                         grad_accum=args.grad_accum)
                    except Exception as e:  # noqa: BLE001 — sweep must survive any one cell's meta-run failure; the error lands in its report JSON
                        failures += 1
                        rep = {"arch": arch, "shape": shape,
                               "status": "failed", "error": str(e)[-2000:],
                               "traceback": traceback.format_exc()[-4000:]}
                        print(f"FAILED: {e}", flush=True)
                    with open(os.path.join(outdir, tag + ".json"), "w") as f:
                        json.dump(rep, f, indent=2, default=str)
                    _print(rep)
        finally:
            if mesh is not None:
                destroy_world()
    print(f"done, failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
