"""Small versions of the cells for the CPU: the configurations' widths,
tables cut to a few thousand rows, small batches and short windows."""

import time

import torch

from evbench import harness

ROWS = 3000


def tiny(name: str, **mix_changes):
    """(manifest, workload, config, mix, limits) of cell `name`, cut to
    CPU size."""
    bench = harness.manifest()
    wl = harness.cell(bench, name)
    cfg = dict(harness.config_of(bench, wl))
    cfg["arch_embedding_size"] = [min(int(s), ROWS)
                                  for s in cfg["arch_embedding_size"]]
    mix = harness._json("traffic", f"{wl['traffic']}.json")
    mix.update(batch_size=256, pool_batches=8, warm_steps=1, trace_skip=1,
               trace_steps=2)
    mix.update(mix_changes)
    limits = harness._json("cells", f"{name}.json")["limits"]
    return bench, wl, cfg, mix, limits


def run(name: str, seed: int = 2 ** 31 + 7, seconds: float = 0.6,
        trace: bool = False, **mix_changes):
    """The result line of one small run of cell `name` on the CPU."""
    bench, wl, cfg, mix, limits = tiny(name, **mix_changes)
    out = harness.run_cell(wl, cfg, mix, limits, seed, seconds, trace,
                           torch.device("cpu"), time.perf_counter())
    return harness.result_line(bench, wl, out, trace, {"platform": "cpu"}), \
        out
