"""Per-request latency capture and the latency CDF file.

A copy of `LatencyRecorder` from `evstore_tpu/utils/trace.py`: per-request
times, downsampled to a 1000-point CDF CSV as in the reference's
calculate_and_write_cdf (dlrm_s_pytorch_C1.py:299-330).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np


class LatencyRecorder:
    """Collects per-request latencies; writes a downsampled CDF CSV."""

    def __init__(self, n_points: int = 1000):
        self.n_points = n_points
        self.samples: List[float] = []

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
