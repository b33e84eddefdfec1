"""The readings that the limits of a row-wise cell's `cells/<cell>.json`
are set from, on the chip at the cell's own size; the benchmark's runs do
not run this.

    python3 -m evbench.rowwise_controls --workload <cell> --seeds 11,12,13

For each seed it draws the cell's inputs as a run of `kinds/train_rowwise.py`
does and puts the plain reference, changed, in the program's place: the
control (every matmul's operands in TF32, the precision below the
configuration's float32 with TF32 off) and each fault the cell can have
(`train_rowwise.faults_of`: half of each batch left out; each bag's last
slot dropped, with bags; the cross layers without their `+ x_l`, with the
cross network).  A state left unchanged reads 1 on the gradient and the
change by their measure, with no run.  It prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from evbench import harness, inputs
from evbench.kinds import train_rowwise as kind
from evbench.reference import dlrm as plain


def readings(config, mix, seed: int, device) -> dict:
    dims = kind.model_dims(config)
    lr = float(config["learning_rate"])
    # the whole pool, as a run draws it: its first batches depend on it
    batches = kind.draw_batches(mix, dims, seed, int(mix["pool_batches"]),
                                device)
    w = inputs.mlp_weights(seed, dims, device)
    w["cross"] = kind.cross_weights(seed, dims, device)
    touched = kind.touched_rows(batches[1][:kind.N_CHECKED],
                                dims["bag_sizes"], device)
    rows0 = []
    for t, n in enumerate(dims["table_sizes"]):
        tab = inputs.table(seed, t, n, dims["dim"], device)
        rows0.append(tab[touched[t]].clone())
        del tab
    out = {f: kind.readings(dims, w, rows0, touched, batches, lr, device,
                            None, fault=f) for f in kind.faults_of(dims)}
    out["unchanged"] = {"grad_gap": 1.0, "change_gap": 1.0}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m evbench.rowwise_controls")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    bench = harness.manifest()
    wl = harness.cell(bench, args.workload)
    config = harness.config_of(bench, wl)
    mix = harness._json("traffic", f"{wl['traffic']}.json")
    if not torch.cuda.is_available():
        print("evbench.rowwise_controls: no CUDA device", file=sys.stderr)
        return 3
    plain.exact_float32()
    device = torch.device("cuda", 0)
    for s in args.seeds.split(","):
        r = readings(config, mix, int(s), device)
        print(json.dumps({"workload": wl["name"], "seed": int(s), **r}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
