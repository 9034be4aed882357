"""The port's observability: the typed per-query out-of-core stats and
the process-wide metrics registry."""

from .metrics import REGISTRY
from .stats import OocStats

__all__ = ["OocStats", "REGISTRY"]
