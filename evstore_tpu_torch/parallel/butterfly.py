"""Table-wise sharded embeddings with an all-to-all exchange: the
reference's butterfly.

Port of `evstore_tpu/parallel/butterfly.py`.  Reference:
DLRM_Net.distributed_forward (dlrm_s_pytorch.py:529-578): each rank owns a
slice of the tables, looks up the whole batch for them, then an all-to-all
leaves each rank with every table for its batch slice
(extend_distributed.py:389-486).

As in the JAX package the tables are stacked [T_pad, N_max, D], zero-padded
to the largest table, and rank s of the world's n owns the stack's slots
[s·Tl, (s+1)·Tl) (`table_order`, e.g. from `parallel/planner.py`, places
table order[i] in slot i; -1 marks an empty slot).  Per step, rank s:

- looks the whole batch up in its Tl tables through the grouped row-gather
  kernel (K2; a bag is pooled before the exchange, so the wire carries
  [B, Tl, D]);
- sends batch slice j to rank j with `all_to_all_single` inside a
  `torch.autograd.Function` whose backward is the reverse exchange (JAX's
  `lax.all_to_all` and its transpose), and receives its slice of every
  table [Bl, T_pad, D];
- runs the model on its slice; the loss and dense grads take one
  `all_reduce` over the world (divided by n);
- updates its tables with the pooled rows' grads of the whole batch (a
  bag's entries get the pooled grad times their weight) through the grouped
  row update (K5), one call for its Tl tables.  No all-gather: this
  mode's advantage.

`dedup_exchange` ships, per (local table, destination), only the unique
ids of the destination's slice (JAX's static U = min(Bl·L, N_max), filled
with PAD_ROW; one `torch.unique` a step finds them all); the destination
expands them with the inverse map of the same unique, and the grads come
back coalesced per unique row.

The state (`ButterflyState`) holds the rank's slots, their row state, the
MLPs (a `DLRM` without tables) with their sums, and the step.  Unlike the
JAX package, `init_butterfly_state` takes an optimizer state to carry (the
row sums and dense sums of a resumed run and its step count); JAX's starts
every sum and the lr schedule's count at zero (ROADMAP queue 3).  The mode
needs plain tables without pooling weights: JAX's ignores the weights, the
port raises.  `make_butterfly_eval_step` scores a global batch through the
same exchange and all-gathers the probabilities; `unstack_state` gives the
single-device model and optimizer state back, one table at a time.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from evstore_tpu_torch.config import DLRMConfig, TrainConfig
from evstore_tpu_torch.models.dlrm import DLRM, dlrm_loss
from evstore_tpu_torch.models.embedding import flat_ids, pool_bags
from evstore_tpu_torch.ops.cuda_gather import (gather_rows_grouped,
                                               gather_rows_grouped_ref)
from evstore_tpu_torch.parallel.mesh import Mesh
from evstore_tpu_torch.parallel.sharded import (_all_gather_cat,
                                                _copy_mlps, _slice,
                                                _dedup_unique,
                                                optimizer_of)
from evstore_tpu_torch.train.optim import (PAD_ROW, OptState,
                                           dense_parameters, lr_schedule,
                                           make_optimizer, update_rows)
from evstore_tpu_torch.train.train_loop import (_ids, _tensor,
                                                init_opt_state)

def _default_order(T: int, n_devices: int) -> Tuple[int, ...]:
    T_pad = -(-T // n_devices) * n_devices
    return tuple(list(range(T)) + [-1] * (T_pad - T))


def _check_order(order: Sequence[int], T: int, n_devices: int) -> None:
    T_pad = -(-T // n_devices) * n_devices
    if len(order) != T_pad or sorted(o for o in order if o >= 0) != list(
            range(T)):
        raise ValueError("table_order must place each table exactly once "
                         f"in {T_pad} slots")


def _plain_tables(model: DLRM) -> List[torch.Tensor]:
    cfg = model.cfg
    if len(model.tables) != cfg.num_tables:
        raise ValueError("butterfly mode requires plain tables")
    if cfg.weighted_pooling:
        raise ValueError("butterfly mode does not take pooling weights")
    return [t.detach() for t in model.tables]


def stack_tables(tables: Sequence, n_devices: int,
                 table_order: Optional[Tuple[int, ...]] = None,
                 shard: Optional[int] = None):
    """[T_pad, N_max, D] stacked tables (zero-padded), or with `shard` s
    only its slots [s·Tl, (s+1)·Tl); returns (stack, T).  `tables` are
    [N_t, D] tensors or arrays (or a DLRM of plain tables)."""
    if isinstance(tables, DLRM):
        tables = _plain_tables(tables)
    tabs = [t if isinstance(t, torch.Tensor) else torch.from_numpy(
        np.array(t)) for t in tables]
    T = len(tabs)
    order = table_order or _default_order(T, n_devices)
    _check_order(order, T, n_devices)
    Tl = len(order) // n_devices
    slots = range(len(order)) if shard is None else range(shard * Tl,
                                                          (shard + 1) * Tl)
    n_max = max(t.shape[0] for t in tabs)
    stack = tabs[0].new_zeros((len(slots), n_max, *tabs[0].shape[1:]))
    for i, slot in enumerate(slots):
        t = order[slot]
        if t >= 0:
            stack[i, :tabs[t].shape[0]] = tabs[t]
    return stack, T


def unstack_tables(stack: torch.Tensor, table_sizes: Sequence[int],
                   table_order: Optional[Tuple[int, ...]] = None
                   ) -> List[torch.Tensor]:
    """The [N_t, D] tables of a whole stack (views of it)."""
    T = len(table_sizes)
    order = table_order if table_order is not None else tuple(range(T))
    pos_of = {t: slot for slot, t in enumerate(order) if t >= 0}
    return [stack[pos_of[t], :n] for t, n in enumerate(table_sizes)]


@dataclasses.dataclass
class ButterflyState:
    """One rank's butterfly training state."""
    model: DLRM                    # the MLPs (no tables)
    stack: torch.Tensor            # [Tl, N_max, D]: this rank's slots
    row_state: Optional[torch.Tensor]   # [Tl, N_max] | [Tl, N_max, D]
    dense_state: Dict[str, torch.Tensor]
    step: int
    order: Tuple[int, ...]

    def __post_init__(self):
        # the slots as [N_max, D] views, kept so that the grouped kernels'
        # table descriptor is built once
        self.tables = list(self.stack.unbind(0))


def init_butterfly_state(model: DLRM, tcfg: TrainConfig, mesh: Mesh,
                         table_order: Optional[Tuple[int, ...]] = None,
                         opt_state: Optional[OptState] = None
                         ) -> ButterflyState:
    """This rank's state on `mesh.device` from a single-device model: its
    slots of the stack, zero sums and step 0 (as the JAX package), or the
    sums and step of `opt_state` (`init_opt_state`'s layout)."""
    cfg = model.cfg
    tables = _plain_tables(model)
    n, s = mesh.world, mesh.rank
    order = tuple(table_order or _default_order(cfg.num_tables, n))
    stack, _ = stack_tables(tables, n, order, shard=s)
    dev = mesh.device
    dense = DLRM(cfg, device=dev, tables=False)
    _copy_mlps(dense, model)
    name = tcfg.optimizer.lower()
    if opt_state is not None and optimizer_of(
            opt_state, model.row_sources()) != name:
        raise ValueError(f"the optimizer state is not {name}'s")
    if name == "sgd":
        dstate, row_state = {}, None
    else:
        dstate = {k: torch.zeros_like(p, dtype=torch.float32)
                  for k, p in dense_parameters(dense).items()}
        if opt_state is not None:
            for k, v in opt_state.dense.items():
                dstate[k].copy_(v)
            rows = [opt_state.sparse[f"tables.{t}"]
                    for t in range(cfg.num_tables)]
            row_state, _ = stack_tables(rows, n, order, shard=s)
        else:
            shape = stack.shape[:2] if name == "rwsadagrad" else stack.shape
            row_state = torch.zeros(shape, dtype=torch.float32, device=dev)
        row_state = row_state.to(dev).contiguous()
    return ButterflyState(dense, stack.to(dev).contiguous(), row_state,
                          dstate, 0 if opt_state is None else opt_state.step,
                          order)


class _AllToAll(torch.autograd.Function):
    """`all_to_all_single` of equal chunks along dim 0; its backward is the
    reverse exchange, which with equal chunks is the same call."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


def _slot_tables(order, s: int, Tl: int, dev) -> torch.Tensor:
    """The table of each of rank s's slots, -1 for an empty one."""
    return torch.tensor(order[s * Tl:(s + 1) * Tl], dtype=torch.int64,
                        device=dev)


def _local_ids(flat_g: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """[R, Tl] ids of the rank's slots in the global flat ids; an empty
    slot's are -1 (a zero row, inert in updates)."""
    ids = flat_g[:, cols.clamp(min=0)]
    return torch.where(cols[None] >= 0, ids, -1).to(torch.int32).contiguous()


def _gather(state: ButterflyState, ids, use_kernel: bool) -> torch.Tensor:
    return (gather_rows_grouped if use_kernel
            else gather_rows_grouped_ref)(state.tables, ids)


def _pos_of(order) -> List[int]:
    return [order.index(t) for t in range(sum(o >= 0 for o in order))]


def _dense_exchange(cfg, state, mesh, idx_g, bw_g, n, Tl, train: bool):
    """The dense form's lookup and exchange: (ly_local leaf [B, Tl, D],
    ly [Bl, T, D] of this rank's slice, ids [B·L, Tl])."""
    dev = mesh.device
    B = idx_g.shape[0]
    L = idx_g.shape[2] if idx_g.dim() == 3 else 1
    cols = _slot_tables(state.order, mesh.rank, Tl, dev)
    ids = _local_ids(flat_ids(idx_g), cols)
    with torch.no_grad():
        rows = _gather(state, ids, cfg.use_gather_kernel)   # [B·L, Tl, D]
        if idx_g.dim() == 3:
            # sum-pooling commutes with the exchange: pool before it
            w = None if bw_g is None else \
                bw_g[:, cols.clamp(min=0)].transpose(1, 2)   # [B, L, Tl]
            rows = pool_bags(rows.reshape(B, L, Tl, -1), w)
    ly_local = rows.contiguous()
    if train:
        ly_local.requires_grad_(True)
    recv = _AllToAll.apply(ly_local, mesh.group)          # [n·Bl, Tl, D]
    Bl = B // n
    ly = recv.reshape(n, Bl, Tl, -1).transpose(0, 1).reshape(Bl, n * Tl, -1)
    ly = ly[:, torch.tensor(_pos_of(state.order), device=dev)]
    return ly_local, ly, ids, cols


def _dedup_exchange(cfg, state, mesh, idx_g, bw_g, n, Tl):
    """The dedup form: (ly_u leaf [n, Tl, U, D], ly [Bl, T, D], the ids of
    the rows it shipped [n·U, Tl])."""
    dev = mesh.device
    B, T = idx_g.shape[0], idx_g.shape[1]
    L = idx_g.shape[2] if idx_g.dim() == 3 else 1
    Bl = B // n
    n_max = state.stack.shape[1]
    U = min(Bl * L, n_max)
    cols = _slot_tables(state.order, mesh.rank, Tl, dev)
    flat_g = flat_ids(idx_g)                                  # [B·L, T]
    # source side: per (local table, destination) the unique ids of the
    # destination's slice: columns (dest, slot) of [Bl·L, n·Tl]
    src = _local_ids(flat_g, cols).reshape(n, Bl * L, Tl)
    src = src.transpose(0, 1).reshape(Bl * L, n * Tl)
    uniq, _ = _dedup_unique(src.clamp(min=0), U)         # [U, n·Tl]
    uniq = torch.where((cols.repeat(n) >= 0)[None], uniq, PAD_ROW)
    ids = uniq.reshape(U, n, Tl).transpose(0, 1).reshape(n * U, Tl)
    with torch.no_grad():
        rows = _gather(state, ids.contiguous(), cfg.use_gather_kernel)
    ly_u = rows.reshape(n, U, Tl, -1).transpose(1, 2).contiguous()
    ly_u.requires_grad_(True)
    recv = _AllToAll.apply(ly_u, mesh.group)               # [n, Tl, U, D]
    recv = recv.reshape(n * Tl, U, -1)[
        torch.tensor(_pos_of(state.order), device=dev)]    # [T, U, D]
    # destination side: the inverse map over this rank's slice
    lo, hi = _slice(B, mesh)
    mine = flat_g[lo * L:hi * L]                            # [Bl·L, T]
    _, pos = _dedup_unique(mine, U)
    ly = recv[torch.arange(T, device=dev)[None], pos]      # [Bl·L, T, D]
    if idx_g.dim() == 3:
        w = None if bw_g is None else bw_g[lo:hi].transpose(1, 2)
        ly = pool_bags(ly.reshape(Bl, L, T, -1), w)
    return ly_u, ly, ids


def make_butterfly_train_step(cfg: DLRMConfig, tcfg: TrainConfig,
                              mesh: Mesh, dedup_exchange: bool = False,
                              table_order: Optional[Tuple[int, ...]] = None):
    """This rank's butterfly step: (state, dense_x [B, nd], idx [B, T] or
    [B, T, L], labels [B], bag_weights or None) -> the global batch's loss
    (0-d tensor); the state is updated in place.  Every rank is fed the
    global batch, and the step reads its size and kind (one-hot or bags)
    from it.  `table_order` must be the state's."""
    name = tcfg.optimizer.lower()
    _, dense_update, _ = make_optimizer(name)
    lr_fn = lr_schedule(tcfg.learning_rate, tcfg.lr_num_warmup_steps,
                        tcfg.lr_decay_start_step, tcfg.lr_num_decay_steps)
    n = mesh.world

    def step(state: ButterflyState, dense_x, idx, labels, bag_weights=None
             ) -> torch.Tensor:
        order = tuple(table_order or _default_order(cfg.num_tables, n))
        if order != state.order:
            raise ValueError("the state was stacked in another table order")
        dev = mesh.device
        idx_g = _ids(idx, cfg, dev)
        bw_g = None if bag_weights is None else _tensor(bag_weights, dev,
                                                        torch.float32)
        lo, hi = _slice(idx_g.shape[0], mesh)
        B = idx_g.shape[0]
        L = idx_g.shape[2] if idx_g.dim() == 3 else 1
        Tl = state.stack.shape[0]
        dx = _tensor(dense_x, dev, torch.float32)[lo:hi]
        y = _tensor(labels, dev, torch.float32)[lo:hi]
        if dedup_exchange:
            leaf, ly, ids = _dedup_exchange(cfg, state, mesh, idx_g, bw_g,
                                            n, Tl)
        else:
            leaf, ly, ids, cols = _dense_exchange(cfg, state, mesh, idx_g,
                                                  bw_g, n, Tl, train=True)
        params = dense_parameters(state.model)
        for p in params.values():
            p.grad = None
        loss = dlrm_loss(state.model(dx, None, emb_rows=ly), y,
                         tcfg.loss_function, tcfg.loss_weights)
        loss.backward()
        with torch.no_grad():
            grads = [p.grad for p in params.values()]
            buf = torch.cat([loss.detach().float().reshape(1)]
                            + [g.float().reshape(-1) for g in grads])
            dist.all_reduce(buf, group=mesh.group)
            buf /= n
            off = 1
            for p, g in zip(params.values(), grads):
                p.grad = buf[off:off + g.numel()].view_as(p).to(p.dtype)
                off += g.numel()
            loss = buf[0].clone()
        lr = lr_fn(state.step)
        dense_update(state.dense_state, params, lr)
        with torch.no_grad():
            g = leaf.grad / n
            if dedup_exchange:
                # [n, Tl, U, D] -> rows [n·U, Tl, D] in `ids`' order
                g = g.transpose(1, 2).reshape(ids.shape[0], Tl, -1)
            elif idx_g.dim() == 3:
                # the pooled row's grad to each bag entry, times its weight
                g = g[:, None].expand(B, L, Tl, g.shape[-1])
                if bw_g is not None:
                    w = bw_g[:, cols.clamp(min=0)].transpose(1, 2)
                    g = g * w[..., None]
                g = g.reshape(B * L, Tl, -1)
            _update(name, tcfg, state, ids, g.contiguous(), lr)
        state.step += 1
        return loss

    return step


def _update(name, tcfg, state: ButterflyState, ids, grads, lr) -> None:
    """The grouped row update of the rank's slots (K5)."""
    st = state.row_state
    update_rows(name, None if st is None else st.flatten(0, 1),
                [None] * len(state.tables) if st is None else list(st),
                state.tables, ids, grads, lr, tcfg.use_update_kernel)


def make_butterfly_eval_step(cfg: DLRMConfig, mesh: Mesh,
                             table_order: Optional[Tuple[int, ...]] = None):
    """Scoring through the butterfly exchange: (state, dense_x, idx,
    bag_weights or None) -> the global batch's probabilities [B],
    all-gathered, on every rank."""
    n = mesh.world

    def eval_step(state: ButterflyState, dense_x, idx, bag_weights=None
                  ) -> torch.Tensor:
        dev = mesh.device
        with torch.inference_mode():
            idx_g = _ids(idx, cfg, dev)
            bw_g = None if bag_weights is None else _tensor(
                bag_weights, dev, torch.float32)
            lo, hi = _slice(idx_g.shape[0], mesh)
            _, ly, _, _ = _dense_exchange(cfg, state, mesh, idx_g, bw_g, n,
                                          state.stack.shape[0], train=False)
            dx = _tensor(dense_x, dev, torch.float32)[lo:hi]
            p = torch.sigmoid(state.model(dx, None, emb_rows=ly))
            return _all_gather_cat(p, mesh.group, n)

    return eval_step


@torch.no_grad()
def unstack_state(state: ButterflyState, cfg: DLRMConfig, mesh: Mesh,
                  tcfg: TrainConfig, device=None, dst: Optional[int] = None
                  ) -> Tuple[Optional[DLRM], Optional[OptState]]:
    """The single-device model and optimizer state (`init_opt_state`'s
    layout) on `device`, one table at a time (collective over the world).
    With `dst` None every rank gets them, each table broadcast from the
    rank that owns its slot; with a rank `dst` only that rank does, each
    table sent to it by its owner, and the others get (None, None)."""
    dev = mesh.device if device is None else torch.device(device)
    Tl = state.stack.shape[0]
    pos = _pos_of(state.order)
    tables, rows = [], []
    for t, size in enumerate(cfg.table_sizes):
        owner, j = divmod(pos[t], Tl)
        for src, out in ((state.stack, tables), (state.row_state, rows)):
            if src is None:
                continue
            mine = src[j, :size]
            if dst is None:
                buf = (mine.contiguous() if owner == mesh.rank else
                       src.new_empty(mine.shape))
                dist.broadcast(buf, src=owner, group=mesh.group)
            elif mesh.rank == dst:
                buf = mine
                if owner != dst:
                    buf = src.new_empty(mine.shape)
                    dist.recv(buf, src=owner)
            else:
                if owner == mesh.rank:
                    dist.send(mine.contiguous(), dst=dst)
                continue
            out.append(buf.to(dev))
    if dst is not None and mesh.rank != dst:
        return None, None
    model = DLRM(cfg, device=dev, tables=tables)
    _copy_mlps(model, state.model)
    opt = init_opt_state(model, tcfg)
    opt.step = state.step
    for k, v in state.dense_state.items():
        opt.dense[k].copy_(v)
    for t, r in enumerate(rows):
        opt.sparse[f"tables.{t}"].copy_(r)
    return model, opt
