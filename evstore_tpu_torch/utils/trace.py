"""Per-request latency capture, the latency CDF file and workload traces.

A copy of `evstore_tpu/utils/trace.py`: per-request times, downsampled to a
1000-point CDF CSV as in the reference's calculate_and_write_cdf
(dlrm_s_pytorch_C1.py:299-330), and the reference's
--trace-inference-workload, one CSV of row ids per table for an external
cache simulator (dlrm_s_pytorch_C1.py:987-996, evstore_utils.py:54-73).
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence

import numpy as np


class LatencyRecorder:
    """Collects per-request latencies; writes a downsampled CDF CSV."""

    def __init__(self, n_points: int = 1000):
        self.n_points = n_points
        self.samples: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        self.samples.append(time.perf_counter() - self._t0)

    def record(self, seconds: float):
        self.samples.append(seconds)

    def cdf(self) -> np.ndarray:
        """[n_points, 2] of (latency_seconds, cumulative_fraction)."""
        if not self.samples:
            return np.zeros((0, 2))
        s = np.sort(np.asarray(self.samples))
        n = min(self.n_points, len(s))
        qs = np.linspace(0, 1, n, endpoint=True)
        lat = np.quantile(s, qs)
        return np.stack([lat, qs], axis=1)

    def percentile(self, q: float) -> float:
        if not self.samples:
            return float("nan")
        return float(np.percentile(np.asarray(self.samples), q))

    def write_cdf(self, path: str, method: str = None):
        """Writes the CDF CSV; `method` records HOW the samples were timed
        (e.g. "true-per-request" vs "batch-time/B approximation") as a
        leading comment so the artifact is self-describing."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        c = self.cdf()
        with open(path, "w") as f:
            if method:
                f.write(f"# method={method}\n")
            f.write("latency_s,cdf\n")
            for lat, q in c:
                f.write(f"{lat:.9f},{q:.6f}\n")

    def summary(self) -> dict:
        if not self.samples:
            return {}
        a = np.asarray(self.samples)
        return {"count": len(a), "mean_s": float(a.mean()),
                "p50_s": float(np.percentile(a, 50)),
                "p99_s": float(np.percentile(a, 99)),
                "max_s": float(a.max())}


class WorkloadTracer:
    """Writes the row ids of every inference request to per-table CSVs,
    `trace-table-<t + 1>.csv` (the reference's trace-inference-workload)."""

    def __init__(self, out_dir: str, n_tables: int):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.files = [open(os.path.join(out_dir, f"trace-table-{t + 1}.csv"),
                           "w") for t in range(n_tables)]

    def record(self, group_row_ids: Sequence[int]):
        for f, r in zip(self.files, group_row_ids):
            f.write(f"{int(r)}\n")

    def close(self):
        for f in self.files:
            f.close()
        self.files = []
