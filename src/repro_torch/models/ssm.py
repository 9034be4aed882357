"""Mamba-2 SSD mixer: the config only.

The SSD layer itself (``src/repro/models/ssm.py``) is not ported yet
(ROADMAP Queue 1); ``configs`` takes the config from here, where that
slice will add the layer.
"""

from __future__ import annotations

from typing import NamedTuple


class SSMConfig(NamedTuple):
    d_model: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1
