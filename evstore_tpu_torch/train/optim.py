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
scheduling choices; here every optimizer takes the sorted path through the
CUDA row-update kernel (`ops/cuda_update.py`), in a train step for a group
of tables at once (`update_groups`) over one flat state buffer a group
(`flat_row_state`); with the kernel switched off each table takes
`dedup_rows` and plain torch (the plain version).

The row rule of a table follows the JAX package: sgd's and adagrad's for
every table; under rwsadagrad, the row-wise rule for plain tables and
pooling weights, and elementwise adagrad (the JAX package's dense branch)
for the q, r and md tables of the qr and md tricks.  On the rows a batch
touches that dense branch is this row update, and on the others it
changes nothing (their gradient is 0).
"""

from __future__ import annotations

import dataclasses
from typing import (Callable, Dict, Iterable, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from evstore_tpu_torch.models.embedding import FACT_PARTS, gather_groups
from evstore_tpu_torch.ops.cuda_update import (INT32_MAX,
                                               adagrad_row_update,
                                               rwsadagrad_row_update,
                                               sgd_row_update)

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
    # per row-updated parameter (the DLRM's names: "tables.<i>",
    # "qr.<t>.q", "md.<t>.table", "pool_w.<t>", ...): [N, D] elementwise
    # sums, or [N] under rwsadagrad's row rule; the views of one flat
    # buffer per update group (`flat_row_state`); {} for sgd
    sparse: Dict[str, torch.Tensor]


def row_rule(name: str, part: str) -> str:
    """The row update a source takes under optimizer `name` (a
    `RowSource.part`): see the module's docstring."""
    if name == "rwsadagrad" and part in FACT_PARTS:
        return "adagrad"
    return name


class UpdateGroup(NamedTuple):
    """Sources updated by one call: columns [lo, hi) of gather group
    `gather`, under one row rule."""
    gather: int
    lo: int
    hi: int
    rule: str
    members: Tuple[int, ...]     # indices into the sources


def update_groups(sources: Sequence, name: str,
                  groups: Optional[Sequence[Sequence[int]]] = None
                  ) -> List[UpdateGroup]:
    """Each gather group (`models/embedding.py::gather_groups`, one width,
    or the caller's `groups`) split into its runs of one row rule: one
    group under sgd and adagrad; under rwsadagrad, the plain tables'
    (row-wise) and the factorised tables' (elementwise), which
    `gather_groups` puts in that order."""
    out = []
    if groups is None:
        groups = gather_groups(sources)
    for g, members in enumerate(groups):
        lo = 0
        for j in range(1, len(members) + 1):
            if j == len(members) or row_rule(name, sources[members[j]].part) \
                    != row_rule(name, sources[members[lo]].part):
                out.append(UpdateGroup(
                    g, lo, j, row_rule(name, sources[members[lo]].part),
                    tuple(members[lo:j])))
                lo = j
    return out


def state_groups(sources: Sequence, name: str,
                 groups: Optional[Sequence[Sequence[int]]] = None):
    """[(rule, [RowSource])]: the sources whose state shares one flat
    buffer, in buffer order (the update groups of `gather_groups` or of
    the caller's `groups`; none under sgd)."""
    name = name.lower()
    if name == "sgd":
        return []
    return [(u.rule, [sources[i] for i in u.members])
            for u in update_groups(sources, name, groups)]


def row_state_views(flat: torch.Tensor, sizes: Sequence[int],
                    names: Optional[Sequence[str]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Per-table states as views of one flat buffer, [sum N_t] (row-wise)
    or [sum N_t, D] (elementwise), in order, keyed by `names`
    ("tables.<t>" by default): the grouped row updates
    (`ops/cuda_update.py`) take the flat buffer."""
    names = names or [f"tables.{t}" for t in range(len(sizes))]
    out, off = {}, 0
    for name, n in zip(names, sizes):
        out[name] = flat[off:off + n]
        off += n
    return out


def flat_row_state(sparse: Dict[str, torch.Tensor],
                   tables: Sequence[torch.Tensor],
                   names: Optional[Sequence[str]] = None) -> torch.Tensor:
    """The flat buffer under the per-table state views `names` of
    `tables` ("tables.<t>" by default): [sum N_t] or [sum N_t, D].  Raises
    ValueError unless the views still lie in one buffer, in order (same
    storage, offsets the sums of the sizes before them): a state whose
    views were replaced cannot take the grouped update."""
    names = names or [f"tables.{t}" for t in range(len(tables))]
    views = [sparse.get(n) for n in names]
    v0 = views[0]
    width = () if v0 is None or v0.dim() == 1 else (v0.shape[1],)
    row = width[0] if width else 1
    start = off = 0 if v0 is None else v0.storage_offset()
    for name, v, tab in zip(names, views, tables):
        shape = (tab.shape[0], *width)
        if v is None or v.dtype != torch.float32 or \
                tuple(v.shape) != shape or \
                v.stride() != ((row, 1) if width else (1,)) or \
                v.device != v0.device or \
                v.untyped_storage().data_ptr() != \
                v0.untyped_storage().data_ptr() or \
                v.storage_offset() != off:
            raise ValueError(f"optimizer state {name} is not the view of "
                             f"the one flat accumulator buffer it should be "
                             f"(its {tab.shape[0]} rows at offset "
                             f"{(off - start) // row}); build the state with "
                             f"init_opt_state or opt_state_from_jax")
        off += tab.shape[0] * row
    n = (off - start) // row
    return v0.as_strided((n, *width), (row, 1) if width else (1,), start)


def dense_parameters(model) -> Dict[str, torch.nn.Parameter]:
    """The parameters autograd trains: the MLPs, the cross network's V, W
    and b, and the md projections (the tables take row updates)."""
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def make_optimizer(name: str, eps: float = 1e-10):
    """Returns (init_fn, dense_update_fn, sparse_row_update_fn).

    init_fn(model, groups=None) -> OptState (the row state's flat buffers
        follow `state_groups(..., groups)`)
    dense_update_fn(state, params, lr): params {name: Parameter with .grad},
        updated in place with state {name: sum}
    sparse_row_update_fn(row_state, table, rows, row_grads, lr): rows [U]
        distinct ids in [0, N), row_grads [U, D]; table and row_state are
        updated in place.
    """
    name = name.lower()
    if name not in OPTIMIZERS:
        raise ValueError(f"unsupported optimizer {name}")

    def init(model, groups=None) -> OptState:
        """Zero sums: per dense parameter, and one flat buffer per state
        group of the row-updated ones, each parameter's a view of it."""
        if name == "sgd":
            return OptState(0, {}, {})
        dense = {n: torch.zeros_like(p, dtype=torch.float32)
                 for n, p in dense_parameters(model).items()}
        sparse: Dict[str, torch.Tensor] = {}
        for rule, members in state_groups(model.row_sources(), name,
                                          groups):
            rows = sum(s.rows for s in members)
            flat = torch.zeros(
                (rows,) if rule == "rwsadagrad" else (rows, members[0].width),
                dtype=torch.float32, device=members[0].param.device)
            sparse.update(row_state_views(flat, [s.rows for s in members],
                                          [s.name for s in members]))
        return OptState(0, dense, sparse)

    @torch.no_grad()
    def dense_update(state: Dict, params: Dict, lr) -> None:
        for n, p in params.items():
            g = p.grad.float()
            if name == "sgd":
                p.copy_(p.float() - lr * g)
                continue
            # adagrad and rwsadagrad share the dense branch
            # (rwsadagrad.py:115-118), the MLPs' and the cross network's
            # plain Adagrad under MLPerf's DLRM-DCNv2
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
               use_kernel: bool = True, columns: Sequence[int] = ()):
    """One table's sparse update, in place: coalesce duplicate ids and apply
    the optimizer to the rows in `ids` (PAD_ROW and other ids outside
    [0, N) are inert).  state: None (sgd) | [N, D] (adagrad) | [N]
    (rwsadagrad).  With `use_kernel` on, the sorted path through the
    row-update kernel, which also takes a list of tables with ids [R, T],
    grads [R, T, D] and their flat state (the grouped update), or with
    `columns` (the table of each column: bags of a length per table) ids
    [R, C] and grads [R, C, D]; off, `dedup_rows` and plain torch.
    Returns (state, table)."""
    name = name.lower()
    if use_kernel:
        if name == "sgd":
            sgd_row_update(table, ids, grads, lr, columns)
            return state, table
        if name == "adagrad":
            return adagrad_row_update(state, table, ids, grads, lr, eps,
                                      columns)
        if name == "rwsadagrad":
            return rwsadagrad_row_update(state, table, ids, grads, lr, eps,
                                         columns)
    rows, summed = dedup_rows(ids, grads, table.shape[0])
    make_optimizer(name, eps)[2](state, table, rows, summed, lr)
    return state, table


def row_update_plan(sources: Sequence, name: str,
                    sparse: Dict[str, torch.Tensor], use_kernel: bool,
                    learned: bool,
                    groups: Optional[Sequence[Sequence[int]]] = None
                    ) -> List[Tuple[UpdateGroup, Optional[torch.Tensor]]]:
    """A train step's row updates: its update groups (`update_groups` of
    `gather_groups` or of the caller's `groups`), less the pooling
    weights' unless `learned`, each with its flat state (`flat_row_state`,
    so a state that cannot take the grouped update raises before anything
    is updated), or None under sgd or with `use_kernel` off."""
    return [(u, flat_row_state(sparse, [sources[i].param for i in u.members],
                               [sources[i].name for i in u.members])
             if use_kernel and u.rule != "sgd" else None)
            for u in update_groups(sources, name.lower(), groups)
            if learned or sources[u.members[0]].part != "pool_w"]


def apply_row_updates(plan, sources: Sequence,
                      sparse: Dict[str, torch.Tensor],
                      rows: Iterable[Tuple[torch.Tensor, torch.Tensor]],
                      lr, use_kernel: bool,
                      columns: Sequence[int] = ()) -> None:
    """`row_update_plan`'s updates, in place, in plan order: `rows` yields
    each update's (ids [R, C], grads [R, C, D]), its sources' columns, and
    is read one update at a time (`update_rows`)."""
    for (u, flat), (ids, grads) in zip(plan, rows):
        update_rows(u.rule, flat,
                    [sparse.get(sources[i].name) for i in u.members],
                    [sources[i].param for i in u.members], ids, grads, lr,
                    use_kernel, columns)


@torch.no_grad()
def update_rows(rule: str, flat, states: Sequence, tables: Sequence,
                ids: torch.Tensor, grads: torch.Tensor, lr,
                use_kernel: bool, columns: Sequence[int] = ()) -> None:
    """One update group's rows, in place: ids [R, C] and grads [R, C, D],
    column c table c's, or under `columns` (bags of a length per table)
    table columns[c]'s.  With `use_kernel` on, one grouped `row_update`
    over `tables` and their `flat` state; off, each table's plain update
    (`dedup_rows`) with its own state `states[j]`, on its columns."""
    if use_kernel:
        row_update(rule, flat, tables, ids, grads, lr, columns=columns)
        return
    for j, tab in enumerate(tables):
        # table j's columns: its one, or its bag's L_j
        sel = [c for c, t in enumerate(columns) if t == j] or [j]
        row_update(rule, states[j], tab, ids[:, sel].reshape(-1),
                   grads[:, sel].reshape(-1, grads.shape[-1]), lr,
                   use_kernel=False)
