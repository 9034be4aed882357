"""The port's observability: the typed per-query out-of-core stats, the
process-wide metrics registry and the lock-order recorder."""

from .lockorder import LockOrderRecorder
from .metrics import REGISTRY
from .stats import OocStats

__all__ = ["LockOrderRecorder", "OocStats", "REGISTRY"]
