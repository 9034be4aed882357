"""Mixture-of-experts FF: the config only.

The MoE layer itself (``src/repro/models/moe.py``) is not ported yet
(ROADMAP Queue 1); ``configs`` takes the config from here, where that
slice will add the layer.
"""

from __future__ import annotations

from typing import NamedTuple


class MoEConfig(NamedTuple):
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0  # shared experts (deepseek), each of d_ff_expert
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss_weight: float = 1e-2
