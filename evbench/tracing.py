"""The traced stretch of a `--trace 1` run, and its reduction.

A stretch is a run of consecutive train steps inside
the window.  It begins and ends at a pull from the feed, each time after
`torch.cuda.synchronize()`, so the device work it records is exactly that
of its steps, and its length on the host clock is `window_s`.  The
profiler (`torch.profiler`, CPU and CUDA activities) records it; its
Chrome trace is written to a temporary file, read back and deleted.

`reduce_trace` turns the trace into the record the per-layer readers take:

- `busy_s`: the union of the device's kernels, copies and sets;
- per kernel name: launches and device seconds;
- `device_ops`: the ten device operations that took most time;
- `idle_gaps`: the device's idle time inside the stretch, by the host span
  that covered the middle of each gap (the benchmark's `evbench.*` spans
  and the program's own, innermost first), the ten largest;
- per host span name: count and seconds.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
import warnings
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation",)


class Stretch:
    """Profiles the steps [first, first + count) of a feed: `on_pull(k)`
    is called at every pull with the step's index, `close()` after the
    window."""

    def __init__(self, first: int, count: int, device: torch.device):
        self.first, self.count, self.device = first, count, device
        self.prof = None
        self.t0 = self.t1 = None
        self.steps = 0
        # the profiler's first start initialises it (seconds on a card):
        # done here, in set-up, and not in the window
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with torch.profiler.profile(activities=self._activities()):
                torch.ones(8, device=device).sum()
                self._sync()

    def _activities(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def on_pull(self, k: int) -> None:
        if k == self.first:
            self._sync()
            self.prof = torch.profiler.profile(activities=self._activities())
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                self.prof.start()
            self.t0 = time.perf_counter()
        elif k == self.first + self.count and self.t1 is None:
            self._stop()

    def _stop(self):
        self._sync()
        self.t1 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            self.prof.stop()

    def close(self, pulls: int) -> Optional[dict]:
        """After the window: stop if the window ended inside the stretch,
        write and reduce the trace.  None if the stretch never began."""
        if self.prof is None:
            return None
        if self.t1 is None:
            self._stop()
        self.steps = min(pulls, self.first + self.count) - self.first
        fd, path = tempfile.mkstemp(suffix=".json", prefix="evbench-")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        rec = reduce_trace(events)
        rec["window_s"] = self.t1 - self.t0
        rec["steps"] = self.steps
        return rec


def short_name(name: str) -> str:
    """A kernel's function name without its return type, template
    arguments and parameters; other names as they are, cut to 80."""
    n = name
    if n.startswith("void "):
        n = n[5:]
    for stop in ("<", "("):
        i = n.find(stop)
        if i > 0:
            n = n[:i]
    return n[:80]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_trace(events: List[dict]) -> dict:
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((e.get("name", "?"), ts, dur, cat))
        elif cat in HOST_CATS and not e.get("name", "").startswith(
                "ProfilerStep"):
            host.append((e.get("name", "?"), ts, dur))
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for name, _, dur, cat in dev:
        k = kernels[short_name(name) if cat == "kernel" else cat]
        k[0] += 1
        k[1] += dur * 1e-6
    busy = _union([(ts, ts + dur) for _, ts, dur, _ in dev])
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    by_span: Dict[str, float] = defaultdict(float)
    # innermost host span at each gap's middle (the shortest that covers it)
    host_sorted = sorted(host, key=lambda h: h[2])
    for a, b in gaps:
        mid = 0.5 * (a + b)
        name = next((h[0] for h in host_sorted
                     if h[1] <= mid <= h[1] + h[2]), "host outside spans")
        by_span[name] += (b - a) * 1e-6
    spans: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for name, _, dur in host:
        spans[name][0] += 1
        spans[name][1] += dur * 1e-6
    ops = sorted(((n, v[1]) for n, v in kernels.items()),
                 key=lambda x: -x[1])
    return {
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "device_ops_n": len(dev),
        "kernels": {n: {"launches": v[0], "seconds": v[1]}
                    for n, v in kernels.items()},
        "spans": {n: {"count": v[0], "seconds": v[1]}
                  for n, v in spans.items()},
        "device_ops": [[n, s] for n, s in ops[:10]],
        "idle_gaps": [[n, s] for n, s in sorted(by_span.items(),
                                                key=lambda x: -x[1])[:10]],
    }


class HostSpan:
    """A `record_function` span opened and closed by hand, for a span
    that runs across a generator's yield."""

    def __init__(self):
        self._rf = None

    def open(self, name: str) -> None:
        self.close()
        self._rf = torch.profiler.record_function(name)
        self._rf.__enter__()

    def close(self) -> None:
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
