"""Latency-CDF plotting (reference: script/plot_cdf.py and the gnuplot
recipe script/gnuplot_graph/cdf_2_line.plt).  Port of
`evstore_tpu/tools/plot_cdf.py`.

Reads one or more CDF CSVs written by `utils/trace.py::LatencyRecorder.
write_cdf` (`latency_s,cdf` header) and renders a PNG comparing them;
without matplotlib it says so and prints an ASCII sparkline table instead.

Usage:
  python -m evstore_tpu_torch.tools.plot_cdf out/cdf_c1.csv out/cdf_c3.csv \
      --out cdf.png --unit ms
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import List, Tuple

import numpy as np


def read_cdf(path: str) -> Tuple[List[float], List[float]]:
    lats, qs = [], []
    with open(path) as f:
        rows = (ln for ln in f if not ln.startswith("#"))
        for row in csv.DictReader(rows):
            lats.append(float(row["latency_s"]))
            qs.append(float(row["cdf"]))
    return lats, qs


def _ascii(series, unit_scale, unit):
    blocks = " .:-=+*#%@"
    for name, (lats, qs) in series:
        a = np.asarray(lats) * unit_scale
        samp = np.interp(np.linspace(0, 1, 60), qs, a)
        lo, hi = samp.min(), samp.max()
        line = "".join(blocks[min(int((v - lo) / max(hi - lo, 1e-12) * 9), 9)]
                       for v in samp)
        p50 = float(np.interp(0.5, qs, a))
        p99 = float(np.interp(0.99, qs, a))
        print(f"{name:28s} |{line}| p50={p50:.3f}{unit} p99={p99:.3f}{unit}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("csvs", nargs="+")
    ap.add_argument("--out", default="cdf.png")
    ap.add_argument("--unit", default="ms", choices=["s", "ms", "us"])
    args = ap.parse_args(argv)
    scale = {"s": 1.0, "ms": 1e3, "us": 1e6}[args.unit]

    series = [(os.path.basename(p), read_cdf(p)) for p in args.csvs]
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print(f"matplotlib is not installed: no {args.out}, the ASCII "
              f"fallback instead")
        _ascii(series, scale, args.unit)
        return 0

    fig, ax = plt.subplots(figsize=(6, 4))
    for name, (lats, qs) in series:
        ax.plot([v * scale for v in lats], qs, label=name)
    ax.set_xlabel(f"latency ({args.unit})")
    ax.set_ylabel("CDF")
    ax.set_ylim(0, 1)
    ax.grid(True, alpha=0.3)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    plt.close(fig)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
