"""Runs one cell of `BENCHMARK.json` once and prints its result line.

    python3 -m evbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is found by name: `evbench/configs/<config>.json`,
`evbench/traffic/<mix>.json` (read by `traffic/streams.py` and run by
`kinds/<its "kind">.py`), `evbench/cells/<cell>.json` (the limits of the
check) and `evbench/metrics/<metric>.py` (a reader: `read(record)` returns
the metric's value, or None where the run has nothing to read).

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
`--trace 0`, its per-layer metrics with `--trace 1`), `device`, with
`--trace 1` `breakdown`, and last `checks`: each number compared, with its
limit.  The same numbers close standard error.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "evstore_tpu")


def manifest() -> Dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts) -> Dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def cell(bench: Dict, name: str) -> Dict:
    for wl in bench["workloads"]:
        if wl["name"] == name:
            return wl
    raise SystemExit(f"evbench: no workload {name!r} in BENCHMARK.json")


def config_of(bench: Dict, wl: Dict) -> Dict:
    for c in bench["configs"]:
        if c["name"] == wl["config"]:
            with open(os.path.join(ROOT, c["file"])) as f:
                return json.load(f)
    raise SystemExit(f"evbench: no configuration {wl['config']!r}")


def metrics_for(bench: Dict, wl_name: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics, or with `trace` its per-layer
    ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if wl_name in m.get("workloads", [wl_name])]


def reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"evbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def run_cell(wl: Dict, config: Dict, mix: Dict, limits: Dict, seed: int,
             seconds: float, trace: bool, device, t_start: float) -> Dict:
    """Runs the cell's kind once; returns its outcome (`kinds/*.run`) with
    `setup_s`, the seconds from `t_start` to the window's first pull."""
    ctx = SimpleNamespace(workload=wl["name"], config=config, mix=mix,
                          limits=limits, seed=seed, seconds=seconds,
                          trace=trace, device=device, setup_s=None)

    def window_began():
        ctx.setup_s = time.perf_counter() - t_start
        note(f"set-up {ctx.setup_s:.3f} s")

    def note(what: str):
        """A line of the run's own account on standard error."""
        print(f"evbench: {time.perf_counter() - t_start:9.3f} s {what}",
              file=sys.stderr, flush=True)

    ctx.window_began, ctx.note = window_began, note
    kind = importlib.import_module(f"evbench.kinds.{mix['kind']}")
    out = kind.run(ctx)
    out["e2e"]["setup_s"] = ctx.setup_s
    return out


def result_line(bench: Dict, wl: Dict, out: Dict, trace: bool,
                device_info: Dict) -> Dict:
    metrics = {}
    for m in metrics_for(bench, wl["name"], trace):
        if trace:
            v = reader(m["name"])(out["record"])
        else:
            v = out["e2e"].get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    line = {"correct": all(c["ok"] for c in out["checks"]),
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device_info}
    tr = out["record"].get("trace") if trace else None
    if tr is not None:
        line["device"] = {**device_info, "busy_s": tr["busy_s"],
                          "window_s": tr["window_s"]}
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in out["checks"]}
    return line


def main(argv: Optional[List[str]] = None, t_start: Optional[float] = None
         ) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="python3 -m evbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program under test: a checkout without it has nothing to measure
    importlib.import_module("evstore_tpu_torch")
    bench = manifest()
    wl = cell(bench, args.workload)
    config = config_of(bench, wl)
    mix = _json("traffic", f"{wl['traffic']}.json")
    limits = _json("cells", f"{wl['name']}.json")["limits"]

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(wl["chips"]):
        print(f"evbench: {wl['name']} needs {wl['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    from evbench.reference.dlrm import exact_float32
    exact_float32()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.zeros(1, device=device)
    print(f"evbench: {time.perf_counter() - t_start:9.3f} s CUDA ready",
          file=sys.stderr, flush=True)
    out = run_cell(wl, config, mix, limits, args.seed, args.seconds,
                   bool(args.trace), device, t_start)
    found = forbidden_modules()
    if found:
        print(f"evbench: the run loaded {found}", file=sys.stderr)
        return 4
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(wl["chips"]),
            "memory_peak_bytes": out["memory_peak_bytes"]}
    line = result_line(bench, wl, out, bool(args.trace), info)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
