"""Optimizers and LR policy for DLRM training.

Port of `evstore_tpu/train/optim.py`.  Reference: SGD/Adagrad/RWSAdagrad
selection (dlrm_s_pytorch.py:1383-1410), LRPolicyScheduler (:168-202) and
row-wise sparse Adagrad (optim/rwsadagrad.py:109-118):

  sparse rows:  momentum[row] += mean(grad_row^2);  p[row] -= lr*grad_row /
                (sqrt(momentum[row]) + eps)
  dense params: sum += grad^2;  p -= lr*grad/(sqrt(sum)+eps)

As in the JAX package, a table's update receives the gradients of the rows
the batch gathered, coalesces duplicate ids and touches only those rows.
Unlike the JAX package, which returns new arrays, every update here works in
place on the parameters and the optimizer state.  The JAX package's three
lowerings of `row_update` (dense-grad, rep-trick, sort path) are TPU
scheduling choices; here `rwsadagrad` takes the sorted path through the
CUDA row-update kernel (`ops/cuda_update.py`), in a train step for all
tables at once over one flat accumulator buffer (`flat_row_state`), and
`sgd`, `adagrad` and rwsadagrad with the kernel switched off take
`dedup_rows` and plain torch, table by table.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from evstore_tpu_torch.ops.cuda_update import INT32_MAX, rwsadagrad_row_update

# Padding sentinel for row ids: out of range for every table, so updates
# drop it.
PAD_ROW = INT32_MAX

OPTIMIZERS = ("sgd", "adagrad", "rwsadagrad")


def lr_schedule(base_lr: float, num_warmup_steps: int, decay_start_step: int,
                num_decay_steps: int) -> Callable[[int], float]:
    """Returns step -> lr, matching LRPolicyScheduler
    (dlrm_s_pytorch.py:180-202): linear warmup to base over warmup steps;
    then flat; then quadratic decay over num_decay_steps with floor 1e-7;
    frozen at the floor afterwards.  Decay, once started, takes precedence
    over warmup.  Computed in float32 on the host, as the
    JAX package computes it on the device."""
    f32 = np.float32
    base = f32(base_lr)
    warm = f32(max(num_warmup_steps, 1))
    decay_end_step = decay_start_step + num_decay_steps

    def lr(step: int) -> float:
        s = f32(step)
        if num_decay_steps > 0 and step >= decay_start_step:
            dec = np.clip((f32(decay_end_step) - s)
                          / f32(max(num_decay_steps, 1)), f32(0.0), f32(1.0))
            return float(np.maximum(f32(1e-7), base * dec * dec))
        if step < num_warmup_steps:
            return float(base * (f32(1.0) - (warm - s) / warm))
        return float(base)

    return lr


@dataclasses.dataclass
class OptState:
    step: int
    # per dense parameter (model.named_parameters() names): adagrad sums,
    # {} for sgd
    dense: Dict[str, torch.Tensor]
    # per table ("tables.<t>"): [N, D] for adagrad, [N] for rwsadagrad
    # (views of one flat buffer, `flat_row_state`), {} for sgd
    sparse: Dict[str, torch.Tensor]


def row_state_views(flat: torch.Tensor, sizes: Sequence[int]
                    ) -> Dict[str, torch.Tensor]:
    """rwsadagrad's accumulators as views of one flat [sum N_t] buffer, in
    table order, keyed "tables.<t>": the grouped row update
    (`ops/cuda_update.py::rwsadagrad_row_update`) takes the flat buffer."""
    out, off = {}, 0
    for t, n in enumerate(sizes):
        out[f"tables.{t}"] = flat[off:off + n]
        off += n
    return out


def flat_row_state(sparse: Dict[str, torch.Tensor],
                   tables: Sequence[torch.Tensor]) -> torch.Tensor:
    """The flat [sum N_t] buffer under rwsadagrad's per-table views.  Raises
    ValueError unless the views still lie in one buffer, in table order
    (same storage, offsets the sums of the sizes before them): a state
    whose views were replaced cannot take the grouped update."""
    views = [sparse.get(f"tables.{t}") for t in range(len(tables))]
    v0 = views[0]
    start = off = 0 if v0 is None else v0.storage_offset()
    for t, (v, tab) in enumerate(zip(views, tables)):
        if v is None or v.dtype != torch.float32 or \
                tuple(v.shape) != (tab.shape[0],) or v.stride() != (1,) or \
                v.device != v0.device or \
                v.untyped_storage().data_ptr() != \
                v0.untyped_storage().data_ptr() or \
                v.storage_offset() != off:
            raise ValueError(f"rwsadagrad state tables.{t} is not the view of "
                             f"the one flat accumulator buffer it should be "
                             f"(its {tab.shape[0]} rows at offset "
                             f"{off - start}); build the state with "
                             f"init_opt_state or opt_state_from_jax")
        off += tab.shape[0]
    return v0.as_strided((off - start,), (1,), start)


def dense_parameters(model) -> Dict[str, torch.nn.Parameter]:
    """The parameters autograd trains: the MLPs (the tables take row
    updates)."""
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def make_optimizer(name: str, eps: float = 1e-10):
    """Returns (init_fn, dense_update_fn, sparse_row_update_fn).

    init_fn(model) -> OptState
    dense_update_fn(state, params, lr): params {name: Parameter with .grad},
        updated in place with state {name: sum}
    sparse_row_update_fn(row_state, table, rows, row_grads, lr): rows [U]
        distinct ids in [0, N), row_grads [U, D]; table and row_state are
        updated in place.
    """
    name = name.lower()
    if name not in OPTIMIZERS:
        raise ValueError(f"unsupported optimizer {name}")

    def init(model) -> OptState:
        if name == "sgd":
            return OptState(0, {}, {})
        dense = {n: torch.zeros_like(p, dtype=torch.float32)
                 for n, p in dense_parameters(model).items()}
        if name == "rwsadagrad":
            sizes = [tab.shape[0] for tab in model.tables]
            sparse = row_state_views(torch.zeros(
                sum(sizes), dtype=torch.float32,
                device=model.tables[0].device), sizes) if sizes else {}
        else:
            sparse = {f"tables.{t}": torch.zeros(tab.shape,
                                                 dtype=torch.float32,
                                                 device=tab.device)
                      for t, tab in enumerate(model.tables)}
        return OptState(0, dense, sparse)

    @torch.no_grad()
    def dense_update(state: Dict, params: Dict, lr) -> None:
        for n, p in params.items():
            g = p.grad.float()
            if name == "sgd":
                p.copy_(p.float() - lr * g)
                continue
            # adagrad and rwsadagrad share the dense branch
            # (rwsadagrad.py:115-118)
            s = state[n]
            s.add_(g * g)
            p.copy_(p.float() - lr * g / (torch.sqrt(s) + eps))

    @torch.no_grad()
    def sparse_row_update(row_state, table, rows, row_grads, lr) -> None:
        g = row_grads.float()
        if name == "sgd":
            upd = lr * g
        elif name == "adagrad":
            acc = row_state[rows] + g * g
            row_state[rows] = acc
            upd = lr * g / (torch.sqrt(acc) + eps)
        else:
            acc = row_state[rows] + (g * g).mean(dim=1)
            row_state[rows] = acc
            upd = lr * g / (torch.sqrt(acc) + eps)[:, None]
        table[rows] = (table[rows].float() - upd).to(table.dtype)

    return init, dense_update, sparse_row_update


def dedup_rows(idx: torch.Tensor, grads: torch.Tensor, num_rows: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coalesce duplicate row ids within a batch (the torch sparse-grad
    `coalesce()`, rwsadagrad.py:97).  idx [B] row ids, grads [B, D]
    per-sample row grads.  Ids outside [0, num_rows) (PAD_ROW) are dropped.
    Returns (distinct ids [U] int64, summed grads [U, D] float32)."""
    keep = (idx >= 0) & (idx < num_rows)
    uniq, inv = torch.unique(idx[keep].long(), return_inverse=True)
    summed = torch.zeros((uniq.numel(), grads.shape[1]), dtype=torch.float32,
                         device=grads.device)
    summed.index_add_(0, inv, grads[keep].float())
    return uniq, summed


@torch.no_grad()
def row_update(name: str, state, table: torch.Tensor, ids: torch.Tensor,
               grads: torch.Tensor, lr, eps: float = 1e-10,
               use_kernel: bool = True):
    """One table's sparse update, in place: coalesce duplicate ids and apply
    the optimizer to the rows in `ids` (PAD_ROW and other ids outside
    [0, N) are inert).  state: None (sgd) | [N, D] (adagrad) | [N]
    (rwsadagrad).  rwsadagrad goes through the row-update kernel when
    `use_kernel` is on.  Returns (state, table)."""
    name = name.lower()
    if name == "rwsadagrad" and use_kernel:
        return rwsadagrad_row_update(state, table, ids, grads, lr, eps)
    rows, summed = dedup_rows(ids, grads, table.shape[0])
    make_optimizer(name, eps)[2](state, table, rows, summed, lr)
    return state, table
