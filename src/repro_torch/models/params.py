"""Parameter specifications and their initialization.

The port's copy of the spec half of ``src/repro/models/params.py``. Every
model declares its parameters as a tree (nested dicts) of
:class:`ParamSpec` (shape, logical axis names, init rule). From that one
declaration come the parameter count and bytes (no allocation),
:func:`abstract` (``meta`` tensors of the specs' shapes and dtypes, for
dry runs) and :func:`initialize`, which draws every tensor on the device
from one ``torch.Generator``. The reference draws from jax keys, which torch
cannot reproduce: parity with it carries the weights across
(``repro_torch.models.convert``). Resolving the logical axes onto a mesh
waits for the multi-GPU slice (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod

Axis = Optional[str]

__all__ = ["ParamSpec", "Params", "abstract", "initialize", "is_spec",
           "param_bytes", "param_count", "spec_leaves", "tree_map_specs",
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
