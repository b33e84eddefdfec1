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

import torch

_NO_SPAN = contextlib.nullcontext()


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
    """A named span in the trace (record_function) while a profiler runs;
    otherwise a shared null context, so an untraced step pays no
    `record_function` call."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN
