"""The program under test as the cells build it: the port's `DLRM` at a
configuration's widths, with the benchmark's MLPs."""

from __future__ import annotations

from typing import Dict

import torch


def build_model(dims: Dict, w: Dict, device, tables=False):
    """The program's `DLRM` of these widths with the benchmark's MLPs;
    `tables` as `DLRM` takes it."""
    from evstore_tpu_torch.config import make_dlrm_config
    from evstore_tpu_torch.models.dlrm import DLRM
    dcfg = make_dlrm_config(dims["dim"], dims["table_sizes"],
                            dims["mlp_bot"][1:-1], dims["mlp_top"][1:-1],
                            num_dense=dims["mlp_bot"][0])
    model = DLRM(dcfg, device=device, seed=0, tables=tables)
    with torch.no_grad():
        for part in ("bot", "top"):
            for lin, (W, b) in zip(getattr(model, part), w[part]):
                lin.weight.copy_(W)
                lin.bias.copy_(b)
    return dcfg, model
