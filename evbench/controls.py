"""The readings that the limits of `cells/<cell>.json` are set from, on
the chip at the cell's own size; the benchmark's runs do not run this.

    python3 -m evbench.controls --workload <cell> --seeds 11,12,13

For each seed it draws the cell's inputs as a run does and puts the plain
reference, changed, in the program's place:

- the control: the reference with every matmul's operands in TF32, the
  precision below the configuration's float32 with TF32 off;
- the fault of half of each batch left out (the loss the mean over the
  rest).  A state left unchanged reads 1 on the
  gradient and the change by their measure, with no run.

It prints one JSON line a seed with each number a run compares.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from evbench import harness, inputs
from evbench.kinds import train as train_kind
from evbench.reference import dlrm as ref
from evbench.traffic import streams


def train_readings(config, mix, seed: int, device) -> dict:
    dims = inputs.model_dims(config)
    sizes, D = dims["table_sizes"], dims["dim"]
    lr = float(config["learning_rate"])
    n = train_kind.N_CHECKED
    batches = streams.make_batches(mix, sizes, dims["mlp_bot"][0], seed,
                                   int(mix["pool_batches"]), device)
    idx = batches[1]
    w = inputs.mlp_weights(seed, dims, device)
    touched = [torch.unique(torch.from_numpy(idx[:n, :, t].ravel()).to(
        device).long()) for t in range(len(sizes))]
    rows0 = []
    for t, rows in enumerate(sizes):
        tab = inputs.table(seed, t, rows, D, device)
        rows0.append(tab[touched[t]].clone())
        del tab
    out = {}
    for name, kw in (("control", {"tf32": True}),
                     ("half_batch", {"half_batch": True})):
        loss, grad, change = train_kind.readings(
            w, rows0, touched, batches, lr, None, None, None, device, **kw)
        out[name] = {"loss_gap": loss, "grad_gap": grad,
                     "change_gap": change}
    out["unchanged"] = {"grad_gap": 1.0, "change_gap": 1.0}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m evbench.controls")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    bench = harness.manifest()
    wl = harness.cell(bench, args.workload)
    config = harness.config_of(bench, wl)
    mix = harness._json("traffic", f"{wl['traffic']}.json")
    if not torch.cuda.is_available():
        print("evbench.controls: no CUDA device", file=sys.stderr)
        return 3
    ref.exact_float32()
    device = torch.device("cuda", 0)
    for s in args.seeds.split(","):
        r = train_readings(config, mix, int(s), device)
        print(json.dumps({"workload": wl["name"], "seed": int(s), **r}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
