"""Ambient-mesh-aware activation sharding constraints.

The port's copy of ``src/repro/models/sharding_utils.py``. The reference
pins a handful of activations (``with_sharding_constraint``) so that
GSPMD's propagation through heterogeneous layers (SSD's multi-operand
einsums, the MoE scatter and gather) keeps large intermediates sharded.
Here the model runs on DTensors and a pin is a ``redistribute`` to the
placements the logical names resolve to on the ambient mesh.

torch has no ambient mesh: :class:`use_mesh` sets one, the counterpart of
``jax.set_mesh`` (or the legacy ``with mesh:``). Without one, or on a
plain tensor, :func:`constrain` and :func:`unshard_fsdp` return their
input unchanged, as the reference's do without a mesh, so the same model
code runs on one card and across ranks.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Optional, Tuple

import torch

from .params import mesh_axis_sizes, placements, resolve_pspec

__all__ = ["ACT_MAP", "ambient_axis_sizes", "ambient_mesh", "by_path",
           "constrain",
           "distribute_opt_state", "distribute_params", "flat_group",
           "is_dtensor", "unshard_fsdp", "use_act_map", "use_mesh"]

# logical activation axis -> preferred mesh axes (first that divides)
ACT_MAP = {
    "batch": ("pod", "data"),
    "seq_model": ("model",),  # sequence parallelism (residual stream)
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "ssm_inner": ("model",),
    "vocab": ("model",),
    "embed": (),
    "fsdp": (),  # at USE time fsdp dims are gathered (see unshard_fsdp)
    None: (),
}


_ACT_OVERRIDES: dict = {}
_AMBIENT: list = []  # the use_mesh stack, innermost last


class use_act_map:
    """Temporarily override ACT_MAP entries (parallelism policies):
    e.g. pure-FSDP lowers with heads/mlp unmapped and batch spanning
    every mesh axis."""

    def __init__(self, overrides: dict):
        self.overrides = overrides
        self.saved: dict = {}

    def __enter__(self):
        self.saved = dict(_ACT_OVERRIDES)
        _ACT_OVERRIDES.update(self.overrides)
        return self

    def __exit__(self, *exc):
        _ACT_OVERRIDES.clear()
        _ACT_OVERRIDES.update(self.saved)
        return False


class use_mesh:
    """Make ``mesh`` (a DeviceMesh, or None for none) the ambient mesh for
    the ``with`` block; blocks nest. Process-wide, not per thread: the
    backward pass (and the blocks it recomputes) may run on autograd's
    device threads. Inside a block with a mesh a plain tensor that meets a
    DTensor (a position range, a mask, a zero buffer: the same on every
    rank) counts as replicated (DTensor's ``implicit_replication``)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._implicit = None

    def __enter__(self):
        _AMBIENT.append(self.mesh)
        if self.mesh is not None:
            from torch.distributed.tensor.experimental import (
                implicit_replication)

            self._implicit = implicit_replication()
            self._implicit.__enter__()
        return self.mesh

    def __exit__(self, *exc):
        if self._implicit is not None:
            self._implicit.__exit__(*exc)
            self._implicit = None
        _AMBIENT.pop()
        return False


def ambient_mesh():
    """The mesh of the innermost :class:`use_mesh` block, or None."""
    return _AMBIENT[-1] if _AMBIENT else None


def _act_axes(name):
    if name in _ACT_OVERRIDES:
        return _ACT_OVERRIDES[name]
    return ACT_MAP.get(name, ())


def ambient_axis_sizes() -> dict:
    mesh = ambient_mesh()
    return {} if mesh is None else mesh_axis_sizes(mesh)


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor, without importing DTensor's module (a
    second and more) where none can exist yet."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Redistribute a DTensor to the placements its logical axis names
    resolve to on the ambient mesh; a plain tensor, or any tensor without
    an ambient mesh, is returned as it is.

    The names resolve by ``params.resolve_pspec`` with ACT_MAP (its
    overrides, the mesh's axes) as the rules: divisibility is checked per
    dim, and no mesh axis serves two dims of one constraint."""
    mesh = ambient_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    if len(logical) != x.ndim:
        raise ValueError(f"constrain: {len(logical)} names for a tensor of "
                         f"shape {tuple(x.shape)}")
    sizes = mesh_axis_sizes(mesh)
    rules = {n: tuple(a for a in _act_axes(n) if a in sizes)
             for n in logical if n is not None}
    want = placements(resolve_pspec(logical, x.shape, rules, sizes), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def unshard_fsdp(w: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Weight-gather FSDP: at rest, parameters are additionally sharded
    over the data axes on their 'fsdp' dim (ZeRO-3); at use they are
    gathered (the 'fsdp' name maps to no axis), so that the matmul does
    not contract a sharded dim and all-reduce activation-sized partials
    over the data axes. Tensor-parallel ('model') dims are kept."""
    return constrain(w, *logical)


def flat_group(mesh, names: Optional[Tuple[str, ...]] = None):
    """The process group over ``mesh``'s dims ``names`` (all of them by
    default) taken as one: one collective reduces across all of them, so
    that every rank of the group receives the same sum, where two
    collectives in sequence (one a dim) could round differently."""
    names = tuple(mesh.mesh_dim_names if names is None else names)
    if len(names) == 1:
        return mesh.get_group(names[0])
    return mesh[names]._flatten().get_group()


def by_path(tree, prefix: str = "") -> Dict[str, Any]:
    """{dotted path: leaf} of a tree of dicts, in sorted key order."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k in sorted(tree):
        out.update(by_path(tree[k], f"{prefix}{k}."))
    return out


def _distribute(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """``t`` (whole, the same on every rank) as a DTensor of which this
    rank keeps only its shards: no collective, since every rank holds the
    whole tensor already. A shard that is a view of the whole is copied
    out, so that the whole can be freed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    dt = distribute_tensor(t, mesh, placements, src_data_rank=None)
    loc = dt.to_local()
    if loc.untyped_storage().nbytes() == loc.numel() * loc.element_size():
        return dt
    return DTensor.from_local(loc.clone(), mesh, placements,
                              run_check=False, shape=dt.shape,
                              stride=dt.stride())


@torch.no_grad()
def distribute_params(model, mesh, shardings) -> Any:
    """Replace every parameter of ``model`` by a DTensor laid out by
    ``shardings`` (a tree of placements with the specs' nesting, as
    ``launch/sharding.param_shardings`` gives); returns the model. The
    whole tensors are freed as their shards are taken."""
    sh = by_path(shardings)
    for path in list(model.reference_leaves()):
        *parents, name = path.split(".")
        mod = model
        for p in parents:
            mod = getattr(mod, p)
        whole = getattr(mod, name)
        setattr(mod, name, torch.nn.Parameter(
            _distribute(whole.data, mesh, sh[path]), requires_grad=False))
        del whole
    return model


@torch.no_grad()
def distribute_opt_state(state, mesh, shardings):
    """An optimizer state (``step``, ``mu``, ``nu``) laid out by
    ``shardings``, a state of placements as
    ``launch/sharding.opt_shardings`` gives."""
    return state._replace(
        step=_distribute(state.step, mesh, shardings.step),
        mu={k: _distribute(v, mesh, shardings.mu[k])
            for k, v in state.mu.items()},
        nu={k: _distribute(v, mesh, shardings.nu[k])
            for k, v in state.nu.items()})
