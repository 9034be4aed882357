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
           "constrain", "distribute_opt_state", "distribute_params",
           "einsum", "flat_group", "is_dtensor", "unshard_fsdp",
           "use_act_map", "use_mesh", "viewable", "zeros"]

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
    want = _act_placements(logical, x.shape, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def _act_placements(logical, shape, mesh) -> tuple:
    """The placements logical axis names resolve to on ``mesh`` by the
    activation map."""
    if len(logical) != len(shape):
        raise ValueError(f"{len(logical)} logical names for a tensor of "
                         f"shape {tuple(shape)}")
    sizes = mesh_axis_sizes(mesh)
    rules = {n: tuple(a for a in _act_axes(n) if a in sizes)
             for n in logical if n is not None}
    return placements(resolve_pspec(logical, shape, rules, sizes), mesh)


def zeros(shape, logical, dtype, device) -> torch.Tensor:
    """``torch.zeros(shape)``; on an ambient mesh a DTensor laid out as
    :func:`constrain` lays out ``logical``, of which this rank allocates
    only its shard (torch's ``Shard`` sizes: the first ranks take a
    remainder)."""
    mesh = ambient_mesh()
    if mesh is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor

    shape = torch.Size(shape)
    want = _act_placements(logical, shape, mesh)
    local = list(shape)
    for i, (p, c) in enumerate(zip(want, mesh.get_coordinate())):
        if p.is_shard():
            n, m = local[p.dim], mesh.size(i)
            full = -(-n // m)
            local[p.dim] = max(0, min(full, n - c * full))
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(
        torch.zeros(local, dtype=dtype, device=device), mesh, want,
        run_check=False, shape=shape, stride=tuple(reversed(stride)))


def einsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum``, run on each rank's shards when the operands are
    DTensors on the ambient mesh that split each mesh dim along at most
    one letter: each shard's product is the product's shard where that
    letter is in the output, and a partial sum of it where it is
    contracted, with no collective here. A mesh dim on which one operand
    is a partial sum and the others are whole gives a partial sum too
    (the product is linear in each operand); a partial sum on a mesh dim
    that another operand splits, or a second one, is summed first (an
    all-reduce), and where two operands split a mesh dim along different
    letters the smaller is gathered there (an all-gather).

    DTensor's own einsum flattens letters into one dim for its ``bmm`` or
    ``mm``; a letter split over 'pod' and 'data' beside one split over
    'model', or a split letter inside a flattened pair, becomes a strided
    shard, whose plan DTensor searches for minutes on a three-axis mesh.
    An operand replicated on a mesh dim where a letter it holds is split
    is sliced to its shard there (no collective); a strided shard or a
    reduction other than a sum takes ``torch.einsum`` on the DTensors. Without a mesh,
    or on plain tensors, this is ``torch.einsum``."""
    mesh = ambient_mesh()
    if mesh is None or not any(is_dtensor(t) for t in operands):
        return torch.einsum(equation, *operands)
    out = _einsum_on_shards(equation, operands, mesh)
    return torch.einsum(equation, *operands) if out is None else out


_PARTIAL = object()


def _einsum_on_shards(equation: str, operands, mesh):
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    lhs, out_letters = equation.replace(" ", "").split("->")
    ins = lhs.split(",")
    if len(ins) != len(operands) or "." in equation:
        return None
    operands = list(operands)
    for t in operands:
        if is_dtensor(t) and t.device_mesh != mesh:
            return None
    # the letter each mesh dim splits, or _PARTIAL where one operand is a
    # partial sum there (the product is linear in it). Where operands
    # split a mesh dim along different letters the largest operand's
    # split stays and the others are gathered there; a partial sum beside
    # a split, or beside another partial sum, is summed first
    split: list = [None] * mesh.ndim
    for i in range(mesh.ndim):
        shards, partial, undo = [], [], []
        for j, (letters, t) in enumerate(zip(ins, operands)):
            p = t.placements[i] if is_dtensor(t) else Replicate()
            if isinstance(p, Replicate):
                continue
            if isinstance(p, Partial) and p.reduce_op == "sum":
                partial.append(j)
            elif type(p) is Shard:
                shards.append((t.numel(), j, letters[p.dim]))
            else:
                return None  # a strided shard, another reduction
        if shards:
            split[i] = max(shards)[2]
            undo = [j for _, j, letter in shards if letter != split[i]]
        elif partial:
            split[i] = _PARTIAL
            partial = partial[1:]
        for j in undo + partial:  # an all-gather, an all-reduce
            pl = list(operands[j].placements)
            pl[i] = Replicate()
            operands[j] = operands[j].redistribute(mesh, pl)
    local = []
    for letters, t in zip(ins, operands):
        want = tuple(
            Shard(letters.index(s)) if s not in (None, _PARTIAL)
            and s in letters else Replicate() for s in split)
        if is_dtensor(t):
            want = tuple(p if isinstance(p, Partial) else w
                         for p, w in zip(t.placements, want))
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        if tuple(t.placements) != want:
            if any(not isinstance(p, Replicate) for p, w in
                   zip(t.placements, want) if p != w):
                return None
            t = t.redistribute(mesh, want)  # a local slice
        # the gradient of a shard is the shard's; that of an operand every
        # rank uses whole beside a split or a partial sum is a partial sum
        # over the ranks; that of a partial sum is whole on every rank
        grad = tuple(
            Replicate() if isinstance(p, Partial)
            else Partial() if isinstance(p, Replicate) and s is not None
            else p for p, s in zip(want, split))
        local.append(t.to_local(grad_placements=grad))
    sizes = {}
    for letters, t in zip(ins, operands):
        sizes.update(zip(letters, t.shape))
    shape = torch.Size(sizes[c] for c in out_letters)
    # a split letter contracted, or a partial sum in, gives a partial sum
    placements = [Replicate() if s is None
                  else Shard(out_letters.index(s))
                  if s is not _PARTIAL and s in out_letters
                  else Partial() for s in split]
    res = torch.einsum(equation, *local)
    # the global strides lay the dims out in the order the local ones do
    stride, acc = [0] * len(shape), 1
    for d in sorted(range(len(shape)), key=lambda d: (res.stride(d), -d)):
        stride[d] = acc
        acc *= shape[d]
    return DTensor.from_local(res, mesh, placements, run_check=False,
                              shape=shape, stride=tuple(stride))


def viewable(x: torch.Tensor, dim: int, parts: int) -> torch.Tensor:
    """``x``, ready to have dim ``dim`` viewed as (parts, rest): a DTensor
    split there into a number of pieces that does not divide ``parts``
    (16 ranks over 8 kv heads) cannot be viewed so, and is gathered along
    it first (a pin); anything else is returned as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    dim = dim % x.ndim
    mesh = x.device_mesh
    pieces = 1
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            pieces *= mesh.size(i)
    if parts % pieces == 0:
        return x
    return x.redistribute(mesh, [Replicate() if p.is_shard(dim) else p
                                 for p in x.placements])


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
