"""Conversion between the JAX package's parameter pytree and the port's DLRM.

The JAX package keeps `DLRMParams(dense, sparse)`:
`dense = {"bot"|"top": {"layer_i": {"w": [in, out], "b": [out]}}}` and
`sparse = {"table_t": {"kind_plain": [n, D]}}`.  These functions take and
give that pytree as numpy arrays (`jax.tree_util.tree_map(np.asarray, p)` on
the JAX side), so the port never imports JAX.  Only plain tables are ported.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from evstore_tpu_torch.config import DLRMConfig
from evstore_tpu_torch.utils.device import resolve_device


def params_from_jax(dense: Dict, sparse: Dict, cfg: DLRMConfig,
                    device=None) -> Tuple[Dict[str, torch.Tensor],
                                          List[np.ndarray]]:
    """-> (state dict for `DLRM(cfg, tables=True)`, the plain tables as
    float32 numpy arrays for the port's store)."""
    dev = resolve_device(device)
    state: Dict[str, torch.Tensor] = {}
    for part, dims in (("bot", cfg.mlp_bot), ("top", cfg.mlp_top)):
        for i in range(len(dims) - 1):
            lyr = dense[part][f"layer_{i}"]
            state[f"{part}.{i}.weight"] = torch.from_numpy(
                np.array(np.asarray(lyr["w"]).T, order="C")).to(dev)
            state[f"{part}.{i}.bias"] = torch.from_numpy(
                np.array(lyr["b"])).to(dev)
    tables = []
    for t in range(cfg.num_tables):
        entry = sparse[f"table_{t}"]
        if set(entry) != {"kind_plain"}:
            raise NotImplementedError(
                f"table_{t} has {sorted(entry)}: only plain tables are "
                "ported")
        tab = np.array(entry["kind_plain"], dtype=np.float32, order="C")
        tables.append(tab)
        state[f"tables.{t}"] = torch.from_numpy(tab).to(dev)
    return state, tables


def params_to_numpy(model) -> Tuple[Dict, Dict]:
    """The port's DLRM -> (dense, sparse) numpy pytree in the JAX layout."""
    def mlp(layers):
        return {f"layer_{i}": {
            "w": lin.weight.detach().cpu().numpy().T.copy(),
            "b": lin.bias.detach().cpu().numpy().copy()}
            for i, lin in enumerate(layers)}

    dense = {"bot": mlp(model.bot), "top": mlp(model.top)}
    sparse = {f"table_{t}": {"kind_plain": tab.detach().cpu().numpy().copy()}
              for t, tab in enumerate(model.tables)}
    return dense, sparse
