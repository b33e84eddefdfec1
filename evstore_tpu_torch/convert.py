"""Conversion between the JAX package's parameter pytree and the port's DLRM.

The JAX package keeps `DLRMParams(dense, sparse)`:
`dense = {"bot"|"top": {"layer_i": {"w": [in, out], "b": [out]}}}` and
`sparse = {"table_t": {"kind_plain": [n, D]}}`.  These functions take and
give that pytree as numpy arrays (`jax.tree_util.tree_map(np.asarray, p)` on
the JAX side), so the port never imports JAX.  Only plain tables are ported.

The optimizer state converts the same way.  The JAX package's
`OptState(step, dense, sparse)` holds `dense = {"mlp": <the dense pytree>,
"fact": {}}` (adagrad/rwsadagrad sums, shaped like the weights) and
`sparse = {"table_t": [N, D] (adagrad) | [N] (rwsadagrad)}`; sgd has
`dense = sparse = {}`.  The port's `OptState` keys the same arrays by the
model's parameter names, with `W` sums transposed like the weights.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from evstore_tpu_torch.config import DLRMConfig
from evstore_tpu_torch.train.optim import OptState, row_state_views
from evstore_tpu_torch.utils.device import resolve_device


def _mlps_from_jax(dense: Dict, cfg: DLRMConfig,
                   dev: torch.device) -> Dict[str, torch.Tensor]:
    """{"bot"|"top": {"layer_i": {"w": [in, out], "b"}}} -> the DLRM's MLP
    state-dict entries (weights [out, in])."""
    state: Dict[str, torch.Tensor] = {}
    for part, dims in (("bot", cfg.mlp_bot), ("top", cfg.mlp_top)):
        for i in range(len(dims) - 1):
            lyr = dense[part][f"layer_{i}"]
            state[f"{part}.{i}.weight"] = torch.from_numpy(
                np.array(np.asarray(lyr["w"]).T, order="C")).to(dev)
            state[f"{part}.{i}.bias"] = torch.from_numpy(
                np.array(lyr["b"])).to(dev)
    return state


def _mlps_to_numpy(state: Dict[str, torch.Tensor], cfg: DLRMConfig) -> Dict:
    """The inverse of `_mlps_from_jax`."""
    out: Dict = {}
    for part, dims in (("bot", cfg.mlp_bot), ("top", cfg.mlp_top)):
        out[part] = {f"layer_{i}": {
            "w": state[f"{part}.{i}.weight"].detach().cpu().numpy().T.copy(),
            "b": state[f"{part}.{i}.bias"].detach().cpu().numpy().copy()}
            for i in range(len(dims) - 1)}
    return out


def params_from_jax(dense: Dict, sparse: Dict, cfg: DLRMConfig,
                    device=None) -> Tuple[Dict[str, torch.Tensor],
                                          List[np.ndarray]]:
    """-> (state dict for `DLRM(cfg, tables=True)`, the plain tables as
    float32 numpy arrays for the port's store)."""
    dev = resolve_device(device)
    state = _mlps_from_jax(dense, cfg, dev)
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
    dense = _mlps_to_numpy(dict(model.named_parameters()), model.cfg)
    sparse = {f"table_{t}": {"kind_plain": tab.detach().cpu().numpy().copy()}
              for t, tab in enumerate(model.tables)}
    return dense, sparse


def opt_state_from_jax(step, dense: Dict, sparse: Dict, cfg: DLRMConfig,
                       device=None) -> OptState:
    """The JAX package's OptState fields, as numpy -> the port's OptState.
    rwsadagrad's [N] accumulators become views of one flat buffer
    (`optim.row_state_views`), as `init_opt_state` builds them."""
    dev = resolve_device(device)
    arrays = [np.asarray(sparse[f"table_{t}"], dtype=np.float32)
              for t in range(cfg.num_tables)] if sparse else []
    if arrays and all(a.ndim == 1 for a in arrays):
        rows = row_state_views(torch.from_numpy(np.concatenate(arrays)).to(
            dev), [a.shape[0] for a in arrays])
    else:
        rows = {f"tables.{t}": torch.from_numpy(np.array(a)).to(dev)
                for t, a in enumerate(arrays)}
    return OptState(
        step=int(step),
        dense=_mlps_from_jax(dense["mlp"], cfg, dev) if dense else {},
        sparse=rows)


def opt_state_to_numpy(opt: OptState, cfg: DLRMConfig
                       ) -> Tuple[int, Dict, Dict]:
    """The port's OptState -> (step, dense, sparse) in the JAX layout."""
    dense = ({"mlp": _mlps_to_numpy(opt.dense, cfg), "fact": {}}
             if opt.dense else {})
    sparse = {f"table_{t}": opt.sparse[f"tables.{t}"].cpu().numpy().copy()
              for t in range(cfg.num_tables)} if opt.sparse else {}
    return opt.step, dense, sparse
