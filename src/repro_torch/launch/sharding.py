"""Logical-axis -> mesh sharding for every entry point.

The port's copy of ``src/repro/launch/sharding.py``. One rule set
(``models/params.DEFAULT_RULES``) serves all ten architectures; the
resolver degrades gracefully (divisibility, axis reuse, missing mesh
axes), which is what makes e.g. GQA kv_heads=8 on a 16-way model axis
shard head_dim instead. A sharding here is a tuple of DTensor placements,
one per mesh dim (``params.placements``); a tree of them has the specs'
nesting, and an optimizer state's are keyed as its moments are, by
dotted reference path. ``distribute_params`` and ``distribute_opt_state``
(``models/sharding_utils``, re-exported here) lay a model and its
optimizer state out by them, each rank keeping only its shards.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import model as model_mod
from repro_torch.models import params as params_mod
from repro_torch.models.params import DEFAULT_RULES, mesh_axis_sizes
# re-exported: the layout of a model and its optimizer state lives below
# the train step, which lays out checkpoints it restores
from repro_torch.models.sharding_utils import (by_path,
                                               distribute_opt_state,
                                               distribute_params)
from repro_torch.train import optimizer as opt_mod

__all__ = ["DATA_AXES", "abstract_inputs", "abstract_opt_state",
           "abstract_params", "by_path", "distribute_opt_state",
           "distribute_params", "input_shardings", "mesh_rules",
           "opt_shardings", "param_pspecs", "param_shardings"]


# the mesh axes a batch is split over (the rules' 'batch')
DATA_AXES = ("pod", "data")


def mesh_rules(mesh, overrides: Optional[Dict[str, Any]] = None):
    """DEFAULT_RULES filtered to this mesh's axes (+ overrides); ``mesh``
    a DeviceMesh or a dict of axis sizes."""
    names = set(mesh_axis_sizes(mesh))
    rules = {}
    src = dict(DEFAULT_RULES)
    if overrides:
        src.update(overrides)
    for k, v in src.items():
        if v is None:
            rules[k] = None
        elif isinstance(v, str):
            rules[k] = v if v in names else None
        else:
            kept = tuple(a for a in v if a in names)
            rules[k] = kept if kept else None
    return rules


def param_shardings(cfg: ModelConfig, mesh, rules=None):
    rules = rules or mesh_rules(mesh)
    return params_mod.shardings(model_mod.model_specs(cfg), rules, mesh)


def param_pspecs(cfg: ModelConfig, mesh, rules=None):
    rules = rules or mesh_rules(mesh)
    return params_mod.partition_specs(model_mod.model_specs(cfg), rules,
                                      mesh)


def input_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh, rules=None):
    rules = rules or mesh_rules(mesh)
    return params_mod.shardings(model_mod.input_specs(cfg, shape), rules,
                                mesh)


def abstract_params(cfg: ModelConfig):
    return params_mod.abstract(model_mod.model_specs(cfg))


def abstract_inputs(cfg: ModelConfig, shape: ShapeSpec):
    return params_mod.abstract(model_mod.input_specs(cfg, shape))


def abstract_opt_state(cfg: ModelConfig, opt_cfg: opt_mod.OptConfig
                       ) -> opt_mod.OptState:
    """The optimizer state as ``meta`` tensors (no allocation), its
    moments keyed by dotted reference path."""
    specs = dict(params_mod.spec_leaves(model_mod.model_specs(cfg)))

    def moments():
        return {k: torch.empty(s.shape, dtype=opt_cfg.state_dtype,
                               device="meta") for k, s in specs.items()}

    return opt_mod.OptState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        mu=moments(), nu=moments())


def opt_shardings(cfg: ModelConfig, opt_cfg, mesh, rules=None
                  ) -> opt_mod.OptState:
    """The step replicated; each moment takes its parameter's
    placements."""
    rules = rules or mesh_rules(mesh)
    psh = by_path(param_shardings(cfg, mesh, rules))
    return opt_mod.OptState(step=params_mod.placements((), mesh),
                            mu=dict(psh), nu=dict(psh))
