"""Profiling helpers.

Port of `evstore_tpu/utils/profiling.py`.  Reference: torch.autograd.profiler
around the main loop with record_function spans and a Chrome trace
(dlrm_s_pytorch.py:132, 1567-1569, 1880-1890).  `profile_trace` runs
`torch.profiler` over its block, with the card's activity when there is a
card, and writes `trace.json` (Chrome trace format) into `log_dir`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """Trace everything inside the block (≙ --enable-profiling)."""
    if not enabled:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def span(name: str):
    """A named span in the trace (record_function)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock step timing, fenced by the card (≙ time_wrap's cuda
    sync, dlrm_s_pytorch.py:126-129)."""

    def __init__(self):
        self.times = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, *sync_tensors):
        """Ends a step once the card has finished its queued work, when any
        of `sync_tensors` lies on it."""
        if any(t.is_cuda for t in sync_tensors):
            torch.cuda.synchronize()
        self.times.append(time.perf_counter() - self._t0)

    def mean_ms(self) -> float:
        return (1000.0 * sum(self.times) / len(self.times)
                if self.times else 0.0)
