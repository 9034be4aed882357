"""Carrying weights and caches between the reference and the port.

The reference draws its weights from jax keys, which torch cannot
reproduce; parity between the two packages therefore runs both on one
set of weights. :func:`params_from_jax` takes the reference's parameter
pytree as numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``:
nested dicts, layer leaves stacked ``[L, ...]``) and returns the port's
:class:`~repro_torch.models.model.Model`, which keeps the stacked
leaves. :func:`cache_from_jax` does the same for a prefill cache.
Both check every leaf's shape and dtype against the config's specs and
raise on a missing or extra leaf. :func:`params_to_numpy` is the inverse
of :func:`params_from_jax`: the model's parameters as numpy in the
reference's names and stacked layout (the checkpoint format's tensors).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelConfig

from .model import Model, decode_cache_specs, model_specs
from .params import spec_leaves

__all__ = ["cache_from_jax", "params_from_jax", "params_to_numpy",
           "tensor_to_numpy"]


def _flat(tree, prefix: str = "") -> Dict[str, Any]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # jax's arrays are read-only views
        a = a.copy()
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as jax gives it
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def _convert(tree, specs, what: str, dev: torch.device):
    """The tree as torch tensors on ``dev``, each leaf checked against its
    spec; nested dicts as the specs lay them out."""
    flat = _flat(tree)
    want = dict(spec_leaves(specs))
    missing, extra = sorted(set(want) - set(flat)), sorted(set(flat)
                                                           - set(want))
    if missing or extra:
        raise ValueError(f"{what}: missing leaves {missing}, extra leaves "
                         f"{extra}")
    out: Dict[str, Any] = {}
    for path, spec in want.items():
        a = np.asarray(flat[path])
        dtype = str(spec.dtype).rsplit(".", 1)[-1]
        if tuple(a.shape) != tuple(spec.shape) or a.dtype.name != dtype:
            raise ValueError(f"{what}: {path} is {a.dtype.name}"
                             f"{list(a.shape)}, the config wants {dtype}"
                             f"{list(spec.shape)}")
        node = out
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = _tensor(a, dev)
    return out


def params_from_jax(tree, cfg: ModelConfig,
                    device=device_mod.DEFAULT) -> Model:
    """The reference's parameters (numpy leaves) as the port's Model."""
    dev = device_mod.resolve(device)
    return Model(cfg, _convert(tree, model_specs(cfg), "params", dev))


def cache_from_jax(cache, cfg: ModelConfig, device=device_mod.DEFAULT):
    """The reference's prefill cache (numpy leaves stacked [L, ...]) in the
    port's layout, which is the same. Decoder stacks: per sub-layer, KV
    [G, B, S, Kv, D], mamba conv tails [G, B, W-1, C] and state [G, B, H,
    N, P]; the batch comes from any entry, the capacity from the first
    attention entry (a stack without attention has none). Encoder-decoder:
    ``k``/``v`` [L, B, S, Kv, D] and ``ck``/``cv`` [L, B, F, Kv, D], the
    frames' extent F read from ``ck``."""
    dev = device_mod.resolve(device)
    if cfg.is_encdec:
        _, batch, seq = np.shape(cache["k"])[:3]
        frames = np.shape(cache["ck"])[2]
        specs = decode_cache_specs(
            dataclasses.replace(cfg, encoder_frames=frames), batch, seq)
        return _convert(cache, specs, "cache", dev)
    blocks = cache["blocks"]
    batch = np.shape(next(iter(next(iter(blocks.values())).values())))[1]
    kv = [blocks[f"sub{i}"]["k"] for i, d in enumerate(cfg.pattern)
          if d.kind == "attn"]
    seq = np.shape(kv[0])[2] if kv else 0
    specs = decode_cache_specs(cfg, batch, seq)
    return _convert(cache, specs, "cache", dev)


def tensor_to_numpy(t: torch.Tensor, raw_bf16: bool = False) -> np.ndarray:
    """A host copy of ``t`` as numpy. bfloat16 becomes ml_dtypes'
    bfloat16 (the dtype jax's arrays carry), or its raw bits as uint16
    with ``raw_bf16``; no bit changes either way."""
    bf16 = t.dtype == torch.bfloat16
    t = t.detach().view(torch.int16) if bf16 else t.detach()
    # a copy on the CPU too, where .cpu() would share the live storage
    a = t.to("cpu", copy=True).numpy()
    if not bf16:
        return a
    bits = a.view(np.uint16)
    if raw_bf16:
        return bits
    import ml_dtypes  # numpy's bfloat16 type; imported only when asked

    return bits.view(ml_dtypes.bfloat16)


def params_to_numpy(model: Model):
    """The model's parameters as the reference's tree: nested dicts of
    numpy arrays by its names, layer leaves stacked [L, ...], bf16 as
    ml_dtypes' bfloat16."""
    out: Dict[str, Any] = {}
    for path, t in model.reference_leaves().items():
        node = out
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = tensor_to_numpy(t)
    return out
