"""Profiling helpers: `torch.profiler` traces around train and sample steps,
and host-side step timing.

Counterpart of generativemodels_tpu/utils/profiling.py. `trace` records
the host's activity, and the card's where there is one, and writes a Chrome
trace (viewable in Perfetto, chrome://tracing or TensorBoard) into its
directory; `annotate` names a region on that timeline. The kernels are
`torch.library` ops of the `gmtpu_torch` namespace, so a trace names them.
On a CUDA device the caller of `StepTimer` synchronises before `tick`, or
the meter measures how fast steps are queued.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a profiler trace into `log_dir/trace.json`; yields the
    profiler, whose `key_averages()` the caller may read after the block."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    with prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str) -> torch.profiler.record_function:
    """Named region that shows up on the trace's timeline."""
    return torch.profiler.record_function(name)


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
