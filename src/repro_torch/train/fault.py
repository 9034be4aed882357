"""Fault-tolerant training supervisor: checkpoint, restart, stragglers.

The port's copy of ``src/repro/train/fault.py``. The supervisor owns the
loop: it checkpoints every ``ckpt_every`` steps, catches a failed step
(an injected fault in tests, a lost device in production), restores the
last durable state and replays forward. The batches are a pure function
of the step, so a replay on a deterministic step gives the same losses
bit for bit. Across ranks a fault injected at step n fires on every
rank (the injector is a function of the step), every rank restores the
checkpoint of rank 0's latest step, and the replay is bit for bit there
too. A step slower
than ``straggler_factor`` times the running
mean (an EMA) counts as a straggler. Both counts land in the port's
registry (``train.stragglers``, ``train.restarts``). ``FaultInjector``
is the port's shared injector (``repro_torch.fault``), re-exported here
as the reference re-exports its own.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from repro_torch.clock import now
from repro_torch.fault import FaultInjector
from repro_torch.obs import REGISTRY

from .checkpoint import Checkpointer, spans_ranks

__all__ = ["FaultInjector", "Supervisor"]


@dataclasses.dataclass
class Supervisor:
    train_step: Callable  # (params, opt_state, batch) -> (p, o, metrics)
    make_batch: Callable  # step -> batch
    ckpt: Checkpointer
    ckpt_every: int = 50
    straggler_factor: float = 3.0
    injector: Optional[FaultInjector] = None
    max_restarts: int = 3

    def run(self, params, opt_state, start_step: int, num_steps: int,
            log_every: int = 10) -> Dict[str, Any]:
        step = start_step
        history: List[float] = []
        restarts = 0
        ema = None
        stragglers = 0
        while step < start_step + num_steps:
            try:
                if self.injector:
                    self.injector.maybe_fail(step)
                t0 = now()
                batch = self.make_batch(step)
                params, opt_state, metrics = self.train_step(
                    params, opt_state, batch)
                loss = float(metrics["loss"])
                dt = now() - t0
                if ema is None:
                    ema = dt
                else:
                    if dt > self.straggler_factor * ema:
                        stragglers += 1
                        REGISTRY.counter("train.stragglers").inc()
                    ema = 0.9 * ema + 0.1 * dt
                # replayed steps below start_step (a restore point older
                # than this run) are warm-up, not this run's history
                if step >= start_step:
                    history.append(loss)
                step += 1
                if step % self.ckpt_every == 0:
                    self.ckpt.save(
                        step, {"params": params, "opt_state": opt_state},
                        extra={"loss": loss})
            except Exception:  # noqa: BLE001 a failed step of any kind (an injected fault, a lost device) is what the supervisor restarts from the last checkpoint; past max_restarts it re-raises
                restarts += 1
                REGISTRY.counter("train.restarts").inc()
                if restarts > self.max_restarts:
                    raise
                # the save in flight first; across ranks every rank then
                # takes rank 0's latest step
                self.ckpt.wait()
                latest = self.ckpt.latest_step(
                    across=spans_ranks({"params": params}))
                if latest is None:
                    # no checkpoint yet: go on from the state at hand,
                    # counting from the start again, as the reference does
                    step = start_step
                    history = []
                    continue
                latest, state, _ = self.ckpt.restore(
                    {"params": params, "opt_state": opt_state}, latest)
                params = state["params"]
                opt_state = state["opt_state"]
                # history past the restore point goes; clamped at 0 for a
                # checkpoint older than start_step (left by an earlier run)
                history = history[:max(latest - start_step, 0)]
                step = latest
        self.ckpt.wait()
        return {
            "params": params,
            "opt_state": opt_state,
            "losses": history,
            "restarts": restarts,
            "stragglers": stragglers,
            "final_step": step,
        }
