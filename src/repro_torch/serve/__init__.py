"""Serving: the retrieval front over the engine and the fault-tolerance
policy of its shard owners.

  batching   Request, the deadline -> guarantee mapping, the remaining
             budget remap and the static Scheduler front;
  admission  the depth cap that rejects and the hysteresis shedding that
             degrades a tier;
  loop       ServeFront: one lane per guarantee kind plus a write lane;
  fault      retries, deadlines, the circuit breaker and failover.
"""

from .admission import QUEUE_FULL, AdmissionController, degrade_tier
from .batching import (Request, Scheduler, bucket_of, degraded_entry,
                       guarantee_for_deadline, pad_lanes,
                       remaining_budget_ms, retrieval_groups)
from .loop import LANES, WRITE_LANE, Rejected, ServeFront, Ticket, lane_of

__all__ = [
    "QUEUE_FULL", "AdmissionController", "degrade_tier",
    "Request", "Scheduler", "bucket_of", "degraded_entry",
    "guarantee_for_deadline", "pad_lanes", "remaining_budget_ms",
    "retrieval_groups",
    "LANES", "WRITE_LANE", "Rejected", "ServeFront", "Ticket", "lane_of",
]
