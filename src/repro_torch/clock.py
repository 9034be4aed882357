"""The port's one clock.

``now`` (``time.perf_counter``: monotonic, sub-microsecond) stamps every
span of the tracer (``obs/trace.py``), every request the serving front
takes (``serve/batching.Request.submitted_at``), every wait and latency it
reports and the failover latency of ``serve/fault.py``. Stamps taken in
different modules are subtracted from one another, so they must come
from one clock: every other module of the port imports ``now`` from here
and reads no clock of its own.
"""

from __future__ import annotations

import time

__all__ = ["now"]

# repro: allow[clock-discipline] the port's single monotonic clock: the rule exempts only repro/obs/, which the port may not edit, so this is the one read every port module shares
now = time.perf_counter
