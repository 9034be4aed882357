"""Integrity-checked checkpoints in the reference's on-disk format.

The port's copy of ``src/repro/train/checkpoint.py``; a checkpoint that
either package writes restores in the other. Layout::

    <dir>/step_<N:08d>/
        manifest.json   step, extra, and per group the file's sha256 and
                        each tensor's [shape, dtype name]
        <group>.npz     one file per top-level group (params, opt_state)

Tensors are keyed by the reference's pytree paths joined with ``/``
(``blocks/sub0/attn/wq``; an ``OptState`` contributes ``.step``,
``.mu/<path>`` and ``.nu/<path>``, jax's attribute keys), in the
reference's stacked layout (a model's reference leaves, as
``params_to_numpy`` gives them). npz cannot hold bfloat16: it is stored
as its raw uint16 bits with ``bfloat16`` in the manifest. A save
snapshots every tensor to the host on the caller's thread and writes on
a background thread; it becomes visible only when its directory is
renamed into place, and ``keep_last`` sweeps the older steps. ``restore`` checks each
file's sha256 and copies the tensors into the templates in place.

Across ranks (DTensor leaves) a save gathers every tensor whole, on every
rank and on the caller's thread, before anything reaches the writer (a
collective on the writer thread could deadlock); rank 0 alone writes,
and :meth:`Checkpointer.wait` holds every rank until the write is done.
A DTensor template takes its own shard of the saved array, by its own
placements: the layout of the current mesh, whatever the mesh that wrote
it (the reference's elastic reload). The files are the same either way,
so a checkpoint written on a mesh restores on one rank and in the
reference, and the other way round.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.convert import tensor_to_numpy
from repro_torch.models.sharding_utils import (distribute_opt_state,
                                               distribute_params, is_dtensor)

from .optimizer import OptState

__all__ = ["Checkpointer", "spans_ranks"]


def _group_tensors(tree) -> Dict[str, Any]:
    """A group's tensors by '/'-joined reference path (live tensors for
    a model, an OptState or a dict of tensors, numpy for a model's
    snapshot)."""
    if hasattr(tree, "reference_leaves"):
        return {k.replace(".", "/"): t
                for k, t in tree.reference_leaves().items()}
    if isinstance(tree, OptState):
        out = {".step": tree.step}
        for field in ("mu", "nu"):
            out.update({f".{field}/" + k.replace(".", "/"): t
                        for k, t in getattr(tree, field).items()})
        return out
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            sub = tree[k]
            if isinstance(sub, dict):
                out.update({f"{k}/{kk}": v
                            for kk, v in _group_tensors(sub).items()})
            else:
                out[k] = sub
        return out
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _snapshot(tree) -> Dict[str, Tuple[np.ndarray, str]]:
    """(host array, dtype name) per key; bfloat16 as its uint16 bits; a
    DTensor gathered whole first (a collective: every rank takes every
    snapshot, in the same order)."""
    out = {}
    for k, t in _group_tensors(tree).items():
        if isinstance(t, torch.Tensor):
            whole = t.full_tensor() if is_dtensor(t) else t
            out[k] = (tensor_to_numpy(whole, raw_bf16=True),
                      str(t.dtype).rsplit(".", 1)[-1])
            del whole
        else:
            a = np.asarray(t)
            out[k] = (a, a.dtype.name)
    return out


def _from_saved(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype.name != dtype_name:
        raise ValueError(f"stored {a.dtype.name}, the manifest says "
                         f"{dtype_name}")
    return torch.from_numpy(a)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def spans_ranks(state: Dict[str, Any]) -> bool:
    """Whether any tensor of ``state`` (top-level groups) is a DTensor:
    then every rank saves, restores and asks for the latest step
    together."""
    return any(is_dtensor(t) for g in state.values()
               for t in _group_tensors(g).values())


class Checkpointer:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._ranks_wait = False  # a save across ranks to wait for

    def save(self, step: int, state: Dict[str, Any],
             extra: Optional[Dict[str, Any]] = None, *,
             sync: bool = False) -> None:
        """state: top-level groups (a Model, an OptState, dicts of
        tensors). The tensors are copied to the host now; the files are
        written on a background thread unless ``sync``. With DTensors
        every rank must call it; rank 0 writes."""
        across = spans_ranks(state)
        snap = {g: _snapshot(t) for g, t in state.items()}
        self.wait()
        if across:
            import torch.distributed as dist

            self._ranks_wait = True
            if dist.get_rank() != 0:
                if sync:
                    self.wait()
                return

        def write():
            final = os.path.join(self.dir, f"step_{step:08d}")
            tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_")
            manifest = {"step": step, "extra": extra or {}, "files": {}}
            for group, tensors in snap.items():
                fpath = os.path.join(tmp, f"{group}.npz")
                np.savez(fpath, **{k: a for k, (a, _) in tensors.items()})
                manifest["files"][group] = {
                    "sha256": _sha256(fpath),
                    "tensors": {k: [list(a.shape), name]
                                for k, (a, name) in tensors.items()},
                }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._sweep()

        if sync:
            write()
            self.wait()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Until the last save is on disk: on every rank after a save
        across ranks (a barrier once rank 0's writer is done)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._ranks_wait:
            import torch.distributed as dist

            self._ranks_wait = False
            dist.barrier()

    def _sweep(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "manifest.json")):
                out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self, *, across: bool = False) -> Optional[int]:
        """The newest complete step, or None. ``across`` ranks (every rank
        calls it) rank 0's answer, broadcast, so that every rank restores
        the same step; raises where this rank cannot see that step (a
        directory that is not on storage every rank sees)."""
        steps = self.all_steps()
        latest = steps[-1] if steps else None
        if not across:
            return latest
        import torch.distributed as dist

        box = [latest]
        dist.broadcast_object_list(box, src=0)
        if box[0] is not None and box[0] not in steps:
            raise FileNotFoundError(
                f"rank {dist.get_rank()} cannot see step {box[0]} in "
                f"{self.dir}, rank 0's latest: checkpoints across ranks "
                f"need a directory every rank sees")
        return box[0]

    @torch.no_grad()
    def restore(self, templates: Dict[str, Any], step: Optional[int] = None,
                *, shardings: Optional[Dict[str, Any]] = None, mesh=None,
                validate: bool = True
                ) -> Tuple[int, Dict[str, Any], Dict[str, Any]]:
        """Copy the checkpoint of ``step`` (the latest by default) into the
        templates' tensors in place: (step, the templates, extra). Raises
        IOError when a file's sha256 is not the manifest's, and on a
        missing tensor or a shape or dtype that is not the template's.

        ``shardings`` (group -> the tree ``launch.sharding.param_shardings``
        gives for a Model, the OptState ``opt_shardings`` gives for an
        OptState) with ``mesh``: elastic reload from whole templates; each
        such group's template is first laid out on ``mesh`` by them, and
        the returned templates are the laid-out ones."""
        if shardings:
            templates = dict(templates)
            for group, sh in shardings.items():
                t = templates[group]
                templates[group] = (
                    distribute_opt_state(t, mesh, sh)
                    if isinstance(t, OptState)
                    else distribute_params(t, mesh, sh))
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        base = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(base, "manifest.json")) as f:
            manifest = json.load(f)
        for group, template in templates.items():
            fpath = os.path.join(base, f"{group}.npz")
            if validate:
                want = manifest["files"][group]["sha256"]
                got = _sha256(fpath)
                if want != got:
                    raise IOError(f"checkpoint corruption in {fpath}: "
                                  f"sha256 {got} != {want}")
            meta = manifest["files"][group]["tensors"]
            with np.load(fpath) as data:
                for key, t in _group_tensors(template).items():
                    src = _from_saved(data[key], meta[key][1])
                    if src.shape != t.shape or src.dtype != t.dtype:
                        raise ValueError(
                            f"{fpath}: {key} is {src.dtype}"
                            f"{list(src.shape)}, the template holds "
                            f"{t.dtype}{list(t.shape)}")
                    if is_dtensor(t):
                        from torch.distributed.tensor import (
                            distribute_tensor)

                        t.to_local().copy_(distribute_tensor(
                            src.to(t.device), t.device_mesh, t.placements,
                            src_data_rank=None).to_local())
                    else:
                        t.copy_(src)
        return step, templates, manifest.get("extra", {})
