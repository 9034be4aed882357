"""Host-side data pipeline: prefetch, skip-ahead, stragglers.

The port's copy of ``src/repro/data/pipeline.py``. A background thread
keeps ``prefetch`` batches ahead of the training loop, overlapping batch
generation with the device's work. The cursor is the step number, so a
restart is a seek. A generation slower than ``straggler_factor`` times
the running mean (an EMA on the port's clock) counts as a straggler;
since batches are stateless the pipeline could drop a late one and make
the next without a global resync.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import torch

from repro_torch.clock import now

__all__ = ["Prefetcher"]


class Prefetcher:
    def __init__(self, make_batch: Callable[[int], Dict[str, torch.Tensor]],
                 start_step: int = 0, prefetch: int = 2,
                 straggler_factor: float = 3.0):
        self.make_batch = make_batch
        self.step = start_step
        self.prefetch = prefetch
        self.straggler_factor = straggler_factor
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._ema: Optional[float] = None
        self.stragglers = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            t0 = now()
            try:
                batch = self.make_batch(step)
            except Exception as e:  # noqa: BLE001 a failed batch of any kind goes to the consumer, whose next() re-raises it; the worker stops
                self._q.put(e)
                return
            dt = now() - t0
            if self._ema is None:
                self._ema = dt
            else:
                if dt > self.straggler_factor * self._ema:
                    self.stragglers += 1
                self._ema = 0.9 * self._ema + 0.1 * dt
            self._q.put((step, batch))
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
