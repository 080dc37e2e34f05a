"""Host-side step timing.

Counterpart of generativemodels_tpu/utils/profiling.py (`StepTimer` only;
the trace helpers there wrap jax.profiler). On a CUDA device the caller
synchronises before `tick`, or the meter measures how fast steps are queued.
"""
from __future__ import annotations

import time


class StepTimer:
    """Host-side steps/sec meter with warmup exclusion."""

    def __init__(self, warmup: int = 2) -> None:
        self.warmup = warmup
        self._count = 0
        self._start = None

    def tick(self) -> None:
        self._count += 1
        if self._count == self.warmup:
            self._start = time.time()

    @property
    def steps_per_sec(self) -> float | None:
        measured = self._count - self.warmup
        if self._start is None or measured <= 0:
            return None
        return measured / (time.time() - self._start)
