"""Conversion between the JAX package's parameter pytree and the port's DLRM.

The JAX package keeps `DLRMParams(dense, sparse)`:
`dense = {"bot"|"top": {"layer_i": {"w": [in, out], "b": [out]}}}` and
`sparse = {"table_t": entry}`, an entry being `{"kind_plain": [n, D]}` (with
`"pool_w": [n, 1]` under weighted pooling), `{"kind_qr": {"q", "r"}}` or
`{"kind_md": {"table"[, "proj"]}}`.  These functions take and give that
pytree as numpy arrays (`jax.tree_util.tree_map(np.asarray, p)` on the JAX
side), so the port never imports JAX.  The port's parameter names are
`DLRM`'s: `tables.<i>` (the i-th plain table), `qr.<t>.q|r`,
`md.<t>.table|proj` and `pool_w.<t>`.

Over a mesh (`parallel/`), `shard_from_jax` and `butterfly_from_jax` turn
the same numpy pytrees into one rank's row shard (`parallel/sharded.py`)
or its slots of the butterfly stack (`parallel/butterfly.py`), and
`shard_to_numpy` and `butterfly_to_numpy` gather them back, collectively
over the mesh's ranks.

The optimizer state converts the same way.  The JAX package's
`OptState(step, dense, sparse)` holds `dense = {"mlp": <the dense pytree>,
"fact": <the qr/md entries' pytree>}` (adagrad and rwsadagrad sums, shaped
like the weights) and `sparse = {"table_t": [N, D] (adagrad) | [N]
(rwsadagrad), "table_t__pool_w": [N, 1] | [N]}`; sgd has
`dense = sparse = {}`.  The port's `OptState` keys the same arrays by the
model's parameter names: the sums of the parameters that take row updates
(plain, q, r and md tables, pool_w) in `sparse`, as views of one flat
buffer per update group (`train/optim.py::state_groups`), and those of
the MLPs and md projections in `dense`, with `W` sums transposed like the
weights.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from evstore_tpu_torch.config import DLRMConfig
from evstore_tpu_torch.models.embedding import row_sources, table_kinds
from evstore_tpu_torch.train.optim import (OptState, row_state_views,
                                           state_groups)
from evstore_tpu_torch.utils.device import resolve_device


def mlps_from_jax(dense: Dict, cfg: DLRMConfig,
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


def mlps_to_numpy(state: Dict[str, torch.Tensor], cfg: DLRMConfig) -> Dict:
    """The inverse of `mlps_from_jax`."""
    out: Dict = {}
    for part, dims in (("bot", cfg.mlp_bot), ("top", cfg.mlp_top)):
        out[part] = {f"layer_{i}": {
            "w": state[f"{part}.{i}.weight"].detach().cpu().numpy().T.copy(),
            "b": state[f"{part}.{i}.bias"].detach().cpu().numpy().copy()}
            for i in range(len(dims) - 1)}
    return out


def _names(cfg: DLRMConfig) -> List[Dict[str, str]]:
    """Per table: {JAX path "kind/leaf" -> the port's parameter name}."""
    out: List[Dict[str, str]] = [{} for _ in range(cfg.num_tables)]
    jax_path = {"plain": "kind_plain", "q": "kind_qr/q", "r": "kind_qr/r",
                "md": "kind_md/table", "pool_w": "pool_w"}
    for s in row_sources(cfg):
        out[s.table][jax_path[s.part]] = s.name
    for t, (kind, dim) in enumerate(table_kinds(cfg)):
        if kind == "md" and dim != cfg.embedding_dim:
            out[t]["kind_md/proj"] = f"md.{t}.proj"
    return out


def _get(tree: Dict, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _put(tree: Dict, path: str, value) -> None:
    *head, last = path.split("/")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value


def params_from_jax(dense: Dict, sparse: Dict, cfg: DLRMConfig,
                    device=None) -> Tuple[Dict[str, torch.Tensor],
                                          List[np.ndarray]]:
    """-> (state dict for `DLRM(cfg)`, the plain tables as float32 numpy
    arrays for the port's store).  Raises ValueError for a table whose
    kind or parameters are not the ones `cfg` gives."""
    dev = resolve_device(device)
    state = mlps_from_jax(dense, cfg, dev)
    tables = []
    for t, names in enumerate(_names(cfg)):
        entry = sparse[f"table_{t}"]
        got = {f"{k}/{leaf}" if isinstance(v, dict) else k
               for k, v in entry.items()
               for leaf in (v if isinstance(v, dict) else [None])}
        if got != set(names):
            raise ValueError(f"table_{t} holds {sorted(got)}; the config "
                             f"gives {sorted(names)}")
        for path, name in names.items():
            arr = np.array(_get(entry, path), dtype=np.float32, order="C")
            if path == "kind_plain":
                tables.append(arr)
            state[name] = torch.from_numpy(arr).to(dev)
    return state, tables


def params_to_numpy(model) -> Tuple[Dict, Dict]:
    """The port's DLRM -> (dense, sparse) numpy pytree in the JAX layout."""
    params = dict(model.named_parameters())
    dense = mlps_to_numpy(params, model.cfg)
    sparse: Dict = {}
    for t, names in enumerate(_names(model.cfg)):
        entry = sparse[f"table_{t}"] = {}
        for path, name in names.items():
            _put(entry, path, params[name].detach().cpu().numpy().copy())
    return dense, sparse


def _row_state_paths(cfg: DLRMConfig) -> Dict[str, Tuple[str, str]]:
    """The port's name of each row-updated parameter -> (the JAX OptState
    field, its path there)."""
    out = {}
    for t, names in enumerate(_names(cfg)):
        for path, name in names.items():
            if path == "kind_plain":
                out[name] = ("sparse", f"table_{t}")
            elif path == "pool_w":
                out[name] = ("sparse", f"table_{t}__pool_w")
            elif path != "kind_md/proj":
                out[name] = ("fact", f"table_{t}/{path}")
    return out


def opt_state_from_jax(step, dense: Dict, sparse: Dict, cfg: DLRMConfig,
                       device=None) -> OptState:
    """The JAX package's OptState fields, as numpy -> the port's OptState.
    The row-updated parameters' sums become views of one flat buffer per
    update group, as `init_opt_state` builds them; the optimizer is
    rwsadagrad where a plain table's or pool_w's sum is one per row."""
    dev = resolve_device(device)
    if not dense and not sparse:
        return OptState(int(step), {}, {})
    paths = _row_state_paths(cfg)
    fields = {"sparse": sparse, "fact": dense.get("fact", {})}
    arrays = {name: np.asarray(_get(fields[f], p), dtype=np.float32)
              for name, (f, p) in paths.items()}
    rowwise = any(arrays[n].ndim == 1 for n, (f, _) in paths.items()
                  if f == "sparse")
    rows: Dict[str, torch.Tensor] = {}
    for rule, members in state_groups(
            row_sources(cfg), "rwsadagrad" if rowwise else "adagrad"):
        parts = [arrays[s.name] for s in members]
        flat = torch.from_numpy(np.concatenate(parts)).to(dev)
        rows.update(row_state_views(flat, [p.shape[0] for p in parts],
                                    [s.name for s in members]))
    mlp = mlps_from_jax(dense["mlp"], cfg, dev)
    for t, names in enumerate(_names(cfg)):
        if "kind_md/proj" in names:
            mlp[names["kind_md/proj"]] = torch.from_numpy(np.array(
                _get(fields["fact"], f"table_{t}/kind_md/proj"),
                dtype=np.float32)).to(dev)
    return OptState(step=int(step), dense=mlp, sparse=rows)


def opt_state_to_numpy(opt: OptState, cfg: DLRMConfig
                       ) -> Tuple[int, Dict, Dict]:
    """The port's OptState -> (step, dense, sparse) in the JAX layout."""
    if not opt.dense and not opt.sparse:
        return opt.step, {}, {}
    fields: Dict[str, Dict] = {"sparse": {}, "fact": {}}
    for name, (f, path) in _row_state_paths(cfg).items():
        _put(fields[f], path, opt.sparse[name].cpu().numpy().copy())
    for t, names in enumerate(_names(cfg)):
        if "kind_md/proj" in names:
            _put(fields["fact"], f"table_{t}/kind_md/proj",
                 opt.dense[names["kind_md/proj"]].cpu().numpy().copy())
    return (opt.step, {"mlp": mlps_to_numpy(opt.dense, cfg),
                       "fact": fields["fact"]}, fields["sparse"])


# ----------------------------------------------------------- over a mesh

def _full_from_jax(dense: Dict, sparse: Dict, cfg: DLRMConfig, opt, dev):
    """The single-device DLRM (and OptState, from opt = (step, dense,
    sparse) in the JAX layout, or None) on `dev`."""
    from evstore_tpu_torch.models.dlrm import DLRM
    state, _ = params_from_jax(dense, sparse, cfg, device=dev)
    model = DLRM(cfg, device=dev)
    model.load_state_dict(state)
    st = None if opt is None else opt_state_from_jax(*opt, cfg, device=dev)
    return model, st


def shard_from_jax(dense: Dict, sparse: Dict, cfg: DLRMConfig, mesh,
                   opt=None):
    """The JAX params (and opt = (step, dense, sparse) of its OptState, or
    None), as numpy -> rank (d, m)'s shard of `mesh` on its device:
    (model, OptState or None), as `parallel/sharded.py::
    shard_dlrm_params` cuts them."""
    from evstore_tpu_torch.parallel.sharded import shard_dlrm_params
    model, st = _full_from_jax(dense, sparse, cfg, opt, "cpu")
    return shard_dlrm_params(model, mesh, st)


def shard_to_numpy(model, mesh, opt_state: OptState = None):
    """A rank's shard -> (dense, sparse[, (step, dense, sparse)]) numpy
    in the JAX layout, the whole tables gathered over the model group
    (collective)."""
    from evstore_tpu_torch.parallel.sharded import unshard_dlrm_params
    full, st = unshard_dlrm_params(model, mesh, opt_state, device="cpu")
    out = params_to_numpy(full)
    return out if st is None else (*out, opt_state_to_numpy(st, model.cfg))


def butterfly_from_jax(dense: Dict, sparse: Dict, cfg: DLRMConfig, tcfg,
                       mesh, table_order=None, opt=None):
    """The JAX params (plain tables) -> this rank's `ButterflyState`:
    its slots of the [T_pad, N_max, D] stack and the MLPs, with zero sums
    and step 0, or those of opt = (step, dense, sparse)."""
    from evstore_tpu_torch.parallel.butterfly import init_butterfly_state
    model, st = _full_from_jax(dense, sparse, cfg, opt, "cpu")
    return init_butterfly_state(model, tcfg, mesh, table_order, st)


def butterfly_to_numpy(state, cfg: DLRMConfig, mesh, tcfg):
    """A rank's `ButterflyState` -> (dense, sparse, (step, dense, sparse))
    numpy in the JAX layout, every table broadcast from its owner
    (collective)."""
    from evstore_tpu_torch.parallel.butterfly import unstack_state
    model, st = unstack_state(state, cfg, mesh, tcfg, device="cpu")
    return (*params_to_numpy(model), opt_state_to_numpy(st, cfg))
