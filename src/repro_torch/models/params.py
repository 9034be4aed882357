"""Parameter specifications and their initialization.

The port's copy of the spec half of ``src/repro/models/params.py``. Every
model declares its parameters as a tree (nested dicts) of
:class:`ParamSpec` (shape, logical axis names, init rule). From that one
declaration come the parameter count and bytes (no allocation),
:func:`abstract` (``meta`` tensors of the specs' shapes and dtypes, for
dry runs) and :func:`initialize`, which draws every tensor on the device
from one ``torch.Generator``. The reference draws from jax keys, which torch
cannot reproduce: parity with it carries the weights across
(``repro_torch.models.convert``).

The logical axes resolve onto a mesh as the reference's do:
:func:`resolve_pspec` gives each dim's entry (None, a mesh axis name or a
tuple of names; the counterpart of a ``PartitionSpec``), and
:func:`placements` turns the entries into DTensor placements over the
mesh's dims, the counterpart of ``NamedSharding(mesh, P(...))``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import device as device_mod

Axis = Optional[str]
MeshAxes = Union[None, str, Tuple[str, ...]]
# one tensor dim's entry of a partition spec: unsharded, one mesh axis, or
# several (the first the major)
Entry = Union[None, str, Tuple[str, ...]]

__all__ = ["DEFAULT_RULES", "LogicalSDS", "ParamSpec", "Params", "abstract",
           "initialize", "is_spec", "logical_sds", "mesh_axis_sizes",
           "param_bytes", "param_count", "partition_specs", "placements",
           "resolve_pspec", "shardings", "spec_leaves", "tree_map_specs",
           "unstack"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative description of one parameter tensor."""

    shape: Tuple[int, ...]
    logical: Tuple[Axis, ...]
    dtype: Any = torch.float32
    init: str = "normal"  # normal | zeros | ones | embed | scaled | constant
    scale: Optional[float] = None  # stddev (normal/scaled) or constant value
    fan_in_axes: Tuple[int, ...] = ()  # dims treated as fan-in for 'scaled'

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(
                f"shape {self.shape} and logical {self.logical} rank mismatch"
            )

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map_specs(fn: Callable[[ParamSpec], Any], tree):
    """``fn`` over every spec of a tree of dicts; the dicts are rebuilt."""
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v) for k, v in tree.items()}
    return fn(tree) if is_spec(tree) else tree


def spec_leaves(tree, prefix: str = ""):
    """(dotted path, spec) for every spec of a tree, in sorted key order
    (the order of jax's flatten of a dict)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from spec_leaves(tree[k], f"{prefix}{k}.")
    elif is_spec(tree):
        yield prefix[:-1], tree


def abstract(tree):
    """The spec tree as ``meta`` tensors of its shapes and dtypes: no
    storage behind them, the counterpart of the reference's
    ShapeDtypeStruct tree. ``Model(cfg, abstract(model_specs(cfg)))`` is
    a full-size model that allocates nothing."""
    return tree_map_specs(
        lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), tree)


def param_count(tree) -> int:
    return sum(s.size for _, s in spec_leaves(tree))


def param_bytes(tree) -> int:
    return sum(s.size * s.dtype.itemsize for _, s in spec_leaves(tree))


def _init_one(spec: ParamSpec, g: torch.Generator,
              dev: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == "constant":
        return torch.full(spec.shape, spec.scale or 0.0, dtype=spec.dtype,
                          device=dev)
    if spec.init == "embed":
        std = spec.scale if spec.scale is not None else 1.0
    elif spec.init in ("normal", "scaled"):
        if spec.scale is not None and spec.init == "normal":
            std = spec.scale
        else:
            fan_axes = spec.fan_in_axes or (0,)
            fan_in = max(1, int(np.prod([spec.shape[a] for a in fan_axes])))
            std = (spec.scale or 1.0) / math.sqrt(fan_in)
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    # scaled in place: 4 + itemsize bytes per element at the peak, not 10
    x = torch.randn(spec.shape, generator=g, dtype=torch.float32, device=dev)
    return x.mul_(std).to(spec.dtype)


def initialize(tree, seed: int = 0, device=device_mod.DEFAULT):
    """Materialize a ParamSpec tree into tensors on ``device``, drawn from
    one generator seeded with ``seed``, leaf after leaf in sorted key
    order. Init rules as the reference's: zeros for norms, std ``scale``
    (1.0) for ``embed``, 1/sqrt(fan_in) over ``fan_in_axes`` for
    ``scaled``."""
    dev = device_mod.resolve(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for path, spec in spec_leaves(tree):
        node = out
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = _init_one(spec, g, dev)
    return out


class Params(torch.nn.Module):
    """A tree of tensors as modules: a dict becomes a submodule, a tensor
    a frozen parameter under the same key, so the state's names are the
    reference's pytree paths. ``p[key]``, ``key in p`` and ``p.get`` read
    it as the reference reads its pytree. The tensors are taken as they
    are (views stay views): no copy."""

    def __init__(self, tree):
        super().__init__()
        for key, v in tree.items():
            if isinstance(v, torch.nn.Module):
                self.add_module(key, v)
            elif isinstance(v, dict):
                self.add_module(key, Params(v))
            else:
                self.register_parameter(
                    key, torch.nn.Parameter(v, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._modules or key in self._parameters

    def get(self, key: str, default=None):
        return self[key] if key in self else default

    def items(self):
        return [*self._modules.items(), *self._parameters.items()]


def unstack(tree) -> list:
    """A stacked subtree (every leaf [L, ...]) as L per-layer trees of
    views, one ``unbind`` per leaf: its backward stacks the L layers'
    gradients into the leaf's one [L, ...] gradient (zeros for a layer
    that gave none)."""
    cols = {k: unstack(v) if isinstance(v, (dict, Params)) else v.unbind(0)
            for k, v in tree.items()}
    n = len(next(iter(cols.values())))
    return [{k: c[l] for k, c in cols.items()} for l in range(n)]


# ---------------------------------------------------------------------------
# Logical -> physical sharding resolution
# ---------------------------------------------------------------------------

def _as_tuple(mx: MeshAxes) -> Tuple[str, ...]:
    if mx is None:
        return ()
    if isinstance(mx, str):
        return (mx,)
    return tuple(mx)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh, or the dict itself (a mesh's
    shape by name, for resolving specs without a world)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.mesh.shape)))


def resolve_pspec(logical: Sequence[Axis], shape: Sequence[int],
                  rules: Dict[str, MeshAxes], mesh_shape: Dict[str, int]
                  ) -> Tuple[Entry, ...]:
    """Resolve logical axes to a partition spec under divisibility
    constraints: one entry per dim, trailing Nones stripped.

    Later dims never reuse a mesh axis consumed by an earlier dim; a rule
    that does not divide the dimension evenly is skipped (partial
    prefixes of a multi-axis rule are allowed, e.g. ('data','model')
    degrades to ('data',) when only the data factor divides)."""
    used: set = set()
    out = []
    for dim, name in zip(shape, logical):
        entry: Tuple[str, ...] = ()
        if name is not None and name in rules:
            cand = [a for a in _as_tuple(rules[name]) if a not in used]
            # greedy prefix that divides the dim
            acc: list = []
            prod = 1
            for a in cand:
                if dim % (prod * mesh_shape.get(a, 1)) == 0:
                    acc.append(a)
                    prod *= mesh_shape.get(a, 1)
            entry = tuple(acc)
        used.update(entry)
        if len(entry) == 0:
            out.append(None)
        elif len(entry) == 1:
            out.append(entry[0])
        else:
            out.append(entry)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements(spec: Sequence[Entry], mesh) -> tuple:
    """A partition spec's DTensor placements over ``mesh``'s dims (a
    DeviceMesh, or a dict of axis sizes in the mesh's order):
    ``Shard(d)`` on each mesh dim of more than one rank that tensor dim
    d's entry names, ``Replicate()`` on the others (a split in one is the
    whole tensor, and DTensor cannot reshape a dim of size 1 sharded so).
    A dim split over several mesh axes is split by them in the mesh's
    order, the first the major, as jax splits it when the entry lists
    them in that order (every rule does)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_axis_sizes(mesh)
    names = list(sizes)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        for a in _as_tuple(entry):
            if sizes[a] > 1:
                out[names.index(a)] = Shard(d)
    return tuple(out)


def partition_specs(tree, rules: Dict[str, MeshAxes], mesh):
    """Every spec's partition spec on ``mesh`` (a DeviceMesh or a dict of
    axis sizes)."""
    mesh_shape = mesh_axis_sizes(mesh)
    return tree_map_specs(
        lambda s: resolve_pspec(s.logical, s.shape, rules, mesh_shape), tree)


def shardings(tree, rules: Dict[str, MeshAxes], mesh):
    """Every spec's DTensor placements on ``mesh``."""
    mesh_shape = mesh_axis_sizes(mesh)
    return tree_map_specs(
        lambda s: placements(resolve_pspec(s.logical, s.shape, rules,
                                           mesh_shape), mesh), tree)


# Default rule set shared by all architectures. 'fsdp' behaviour comes from
# mapping the embed/mlp fan dims onto the data axis *after* model axes; the
# resolver guarantees no axis is double-booked within a tensor.
DEFAULT_RULES: Dict[str, MeshAxes] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    # params: tensor parallel first, then fsdp over data
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": "model",
    "mlp": "model",
    "experts": "model",
    "ssm_inner": "model",
    "ssm_state": None,
    "fsdp": ("pod", "data"),  # fan-in dim of big matrices
    "layers": None,  # scan axis, never sharded
    "conv": None,
}


@dataclasses.dataclass(frozen=True)
class LogicalSDS:
    """A tensor's shape and dtype with its resolved sharding: the
    counterpart of the reference's ShapeDtypeStruct carrying a
    NamedSharding (for dry-run inputs)."""

    shape: Tuple[int, ...]
    dtype: Any
    spec: Tuple[Entry, ...]
    placements: tuple


def logical_sds(shape: Sequence[int], logical: Sequence[Axis], dtype,
                rules: Dict[str, MeshAxes], mesh) -> LogicalSDS:
    spec = resolve_pspec(logical, shape, rules, mesh_axis_sizes(mesh))
    return LogicalSDS(tuple(shape), dtype, spec, placements(spec, mesh))
