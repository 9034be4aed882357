"""The port's observability: the typed per-query out-of-core stats."""

from .stats import OocStats

__all__ = ["OocStats"]
