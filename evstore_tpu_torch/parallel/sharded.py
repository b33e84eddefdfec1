"""The row-sharded SPMD train and eval steps: embedding tables sharded by
rows over the "model" axis, MLPs data-parallel over the "data" axis.

Port of `evstore_tpu/parallel/sharded.py`.  The reference's multi-node
path (DLRM_Net.distributed_forward, dlrm_s_pytorch.py:529-578) keeps a
table slice per rank, looks up the whole batch locally and all-to-alls the
rows; the JAX package shards each plain table by rows and combines a masked
local gather with one `psum` over "model".  The port does the same with
one process per rank (`parallel/mesh.py`):

- **Sharding.** `shard_dlrm_params` keeps of each plain table, and of its
  row state, the rank's rows [m·Nl, (m+1)·Nl), Nl = ceil(N / n_model),
  zero-padded (`DLRM(row_shard=...)`).  The pooling weights, the qr and md
  tables and the MLPs are whole on every rank.
- **Batch.** Every rank is fed the same global batch and takes its data
  slice [d·Bl, (d+1)·Bl).
- **Lookup.** The plain tables' rows come through the grouped row-gather
  kernel (K2, `gather_rows_grouped`) on the ids shifted by m·Nl: K2 gives
  a zero row for an id outside [0, Nl), which is the JAX mask.  Then one
  `all_reduce(SUM)` over the model group, for every plain table at once,
  gives each rank the rows of its slice.  The qr, md and pooling-weight
  rows are gathered locally, as on one device.  A position is owned by one
  model rank, so the sum adds zeros to it, exactly; only the sign of a
  zero can change (-0.0 + 0.0 = +0.0, as in JAX's psum).
- **Backward.** The loss is differentiated with respect to the exchanged
  rows, the MLPs and the md projections.  The loss and the dense grads
  take one `all_reduce` over the data group (divided by n_data).  The row
  grads of every table take one `all_gather` over the data group, are
  divided by n_data and go to the port's grouped row updates (K5, one call
  per width and row rule, as `train/train_loop.py`), the plain tables' ids
  shifted to the rank's rows: a foreign id lies outside [0, Nl), which the
  update leaves alone (the JAX package maps it to PAD_ROW).  The ids need
  no exchange: every rank holds the global batch.  Every replica of a
  shard so applies the same update and holds the same bytes.
- **dedup_exchange** ships per plain table the unique ids of the rank's
  slice instead of its entries, JAX's static U (the largest
  min(Bl·L, N_t)) filled with PAD_ROW, found for every table by one
  `torch.unique`; the rows are expanded after the exchange, and the
  unique rows' grads (and their ids) are all-gathered over data.
- **Bags** [B, T, L] ride the exchange flat (B·L entries a table); the
  pooling and bag weights apply after it, as in JAX.

A departure from JAX: JAX's sharded step leaves learned pooling weights as
they are (its loss closes over them); the port trains them as its
single-device step does, their grads averaged over the data group like the
qr and md tables'.  JAX's single-device step trains them too.

`make_sharded_eval_step` returns the probabilities of the whole batch,
all-gathered over the data group, on every rank.  `unshard_dlrm_params`
gathers a sharded model and its state back into the single-device layout
(checkpoints, EV exports and the driver's result).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from evstore_tpu_torch.config import DLRMConfig, TrainConfig
from evstore_tpu_torch.models.dlrm import DLRM, dlrm_loss
from evstore_tpu_torch.models.embedding import (combine_rows, flat_ids,
                                                gather_groups, group_ids)
from evstore_tpu_torch.ops.cuda_gather import (gather_rows_grouped,
                                               gather_rows_grouped_ref)
from evstore_tpu_torch.parallel.mesh import Mesh, shard_rows
from evstore_tpu_torch.train.optim import (PAD_ROW, OptState,
                                           apply_row_updates,
                                           dense_parameters, lr_schedule,
                                           make_optimizer, row_update_plan)
from evstore_tpu_torch.train.train_loop import (_bag_weights, _ids,
                                                _tensor, init_opt_state)


def exchange_groups(sources) -> List[List[int]]:
    """The gather groups of a sharded step: the plain tables first, in
    one group (they all take the exchange), then the other sources'
    `gather_groups` (whole on every rank)."""
    plain = [i for i, s in enumerate(sources) if s.part == "plain"]
    rest = [i for i, s in enumerate(sources) if s.part != "plain"]
    groups = [plain] if plain else []
    return groups + [[rest[j] for j in g]
                     for g in gather_groups([sources[i] for i in rest])]


def optimizer_of(opt_state: OptState, sources) -> str:
    """The optimizer an OptState was built for: sgd has no sums;
    rwsadagrad's plain tables and pooling weights have one a row."""
    if not opt_state.dense and not opt_state.sparse:
        return "sgd"
    rowwise = any(opt_state.sparse[s.name].dim() == 1 for s in sources
                  if s.part in ("plain", "pool_w")
                  and s.name in opt_state.sparse)
    return "rwsadagrad" if rowwise else "adagrad"


def init_sharded_opt_state(model: DLRM, tcfg: TrainConfig) -> OptState:
    """Zero sums for a sharded model, its row state in the flat buffers
    of `exchange_groups`' update groups."""
    return make_optimizer(tcfg.optimizer)[0](
        model, exchange_groups(model.row_sources()))


def _entries(model: DLRM) -> list:
    """The model's tables as `DLRM(tables=...)` entries (its tensors)."""
    plain = dict(zip(model.plain_ids, model.tables))
    out = []
    for t in range(model.cfg.num_tables):
        key = str(t)
        if t in plain:
            e = {"kind_plain": plain[t].detach()}
            if key in model.pool_w:
                e["pool_w"] = model.pool_w[key].detach()
        elif key in model.qr:
            e = {"kind_qr": {"q": model.qr[key].q.detach(),
                             "r": model.qr[key].r.detach()}}
        else:
            md = model.md[key]
            e = {"kind_md": {"table": md.table.detach()}}
            if md.proj is not None:
                e["kind_md"]["proj"] = md.proj.detach()
        out.append(e)
    return out


def _copy_mlps(dst: DLRM, src: DLRM) -> None:
    with torch.no_grad():
        for a, b in ((dst.bot, src.bot), (dst.top, src.top)):
            for la, lb in zip(a, b):
                la.weight.copy_(lb.weight)
                la.bias.copy_(lb.bias)


def shard_dlrm_params(model: DLRM, mesh: Mesh,
                      opt_state: Optional[OptState] = None):
    """A single-device model (and its optimizer state) -> this rank's
    shard on `mesh.device`: (model, opt_state or None).  The plain tables
    and their row state keep rows [m·Nl, (m+1)·Nl), zero-padded; the rest
    is copied whole."""
    cfg = model.cfg
    smodel = DLRM(cfg, device=mesh.device, tables=_entries(model),
                  row_shard=(mesh.m, mesh.n_model))
    _copy_mlps(smodel, model)
    if opt_state is None:
        return smodel, None
    return smodel, shard_opt_state(opt_state, smodel, mesh)


@torch.no_grad()
def shard_opt_state(opt_state: OptState, smodel: DLRM,
                    mesh: Mesh) -> OptState:
    """A single-device optimizer state -> the one of this rank's shard
    `smodel`: the plain tables' row sums cut like their rows, the rest
    copied whole, in `init_sharded_opt_state`'s buffers."""
    name = optimizer_of(opt_state, smodel.row_sources())
    sopt = init_sharded_opt_state(smodel, TrainConfig(optimizer=name))
    sopt.step = opt_state.step
    plain = {s.name for s in smodel.row_sources() if s.part == "plain"}
    for k, v in opt_state.dense.items():
        sopt.dense[k].copy_(v)
    for k, v in opt_state.sparse.items():
        sopt.sparse[k].copy_(shard_rows(v, mesh.m, mesh.n_model)
                             if k in plain else v)
    return sopt


def _all_gather_cat(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """[n · x.shape[0], ...]: x of each rank of `group`, in rank order."""
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def _gather_cat_to(x: torch.Tensor, mesh: Mesh, dst: int,
                   dev: torch.device) -> Optional[torch.Tensor]:
    """On rank `dst`, x of each rank of its model group in rank order,
    concatenated on `dev`; None on the others.  Only `dst`'s data row
    calls it."""
    parts = ([torch.empty_like(x) for _ in range(mesh.n_model)]
             if mesh.rank == dst else None)
    dist.gather(x.contiguous(), parts, dst=dst, group=mesh.model_group)
    return None if parts is None else torch.cat([p.to(dev) for p in parts])


@torch.no_grad()
def unshard_dlrm_params(model: DLRM, mesh: Mesh,
                        opt_state: Optional[OptState] = None, device=None,
                        dst: Optional[int] = None):
    """The inverse of `shard_dlrm_params`, one table at a time: the
    single-device model on `device` (the mesh's by default) and its
    optimizer state in `init_opt_state`'s layout, or None.  With `dst`
    None every rank gets them (collective over each model group); with a
    rank `dst` only that rank does, from its model group (which alone
    calls this), and the others get (None, None) at once.  A whole table
    is on the mesh's device only inside this call."""
    cfg = model.cfg
    dev = mesh.device if device is None else torch.device(device)
    if dst is not None and mesh.d != dst // mesh.n_model:
        return None, None

    def whole(x: torch.Tensor, n: int) -> Optional[torch.Tensor]:
        if dst is None:
            return _all_gather_cat(x, mesh.model_group,
                                   mesh.n_model)[:n].to(dev)
        out = _gather_cat_to(x, mesh, dst, dev)
        return None if out is None else out[:n]

    entries = _entries(model)
    full = {}
    for i, t in enumerate(model.plain_ids):
        w = whole(model.tables[i].detach(), cfg.table_sizes[t])
        entries[t]["kind_plain"] = full[f"tables.{i}"] = w
    if dst is not None and mesh.rank != dst:
        if opt_state is not None:
            for k, v in opt_state.sparse.items():
                if k in full:
                    whole(v, 0)
        return None, None
    fmodel = DLRM(cfg, device=dev, tables=entries)
    _copy_mlps(fmodel, model)
    if opt_state is None:
        return fmodel, None
    name = optimizer_of(opt_state, model.row_sources())
    fopt = init_opt_state(fmodel, TrainConfig(optimizer=name))
    fopt.step = opt_state.step
    for k, v in opt_state.dense.items():
        fopt.dense[k].copy_(v)
    for k, v in opt_state.sparse.items():
        if k in full:
            v = whole(v, fopt.sparse[k].shape[0])
        fopt.sparse[k].copy_(v)
    return fmodel, fopt


# ------------------------------------------------------------ the steps

def _gather(tables, ids, use_kernel: bool) -> torch.Tensor:
    """[R, S, W] rows of one group; a zero row for an id outside its
    table, with the kernel (K2) or its plain version."""
    return (gather_rows_grouped if use_kernel
            else gather_rows_grouped_ref)(tables, ids)


def _local_masked_gather(tables, ids: torch.Tensor, shifts: torch.Tensor,
                         use_kernel: bool) -> torch.Tensor:
    """The rows this model shard owns, zeros elsewhere: the grouped gather
    on ids [R, P] shifted by each table's first row here (an id outside
    [0, Nl) gives a zero row).  Summed over the model group, they are
    every row."""
    local = (ids.long() - shifts).to(torch.int32).contiguous()
    return _gather(tables, local, use_kernel)


def _dedup_unique(ids: torch.Tensor, u_cap: int):
    """Per column of ids [R, P] (ids in [0, 2^31)), its sorted unique ids:
    (uniq int32 [u_cap, P] filled with PAD_ROW, pos int64 [R, P], each
    entry's position in its column's uniq), through one `torch.unique`."""
    R, P = ids.shape
    dev = ids.device
    col = torch.arange(P, device=dev, dtype=torch.int64)
    keys = (col << 32) + ids.long()
    u, inv = torch.unique(keys.reshape(-1), sorted=True, return_inverse=True)
    ucol = u >> 32
    start = torch.searchsorted(u, col << 32)
    upos = torch.arange(u.numel(), device=dev) - start[ucol]
    uniq = torch.full((u_cap, P), PAD_ROW, dtype=torch.int32, device=dev)
    uniq[upos, ucol] = (u & 0xFFFFFFFF).to(torch.int32)
    return uniq, upos[inv].reshape(R, P)


class _Lookup:
    """One sharded lookup of a rank's slice: the gathered rows per group
    (`leaves`, the exchanged rows for the plain group), the rows
    `combine_rows` takes (`rows`), and for the updates the plain group's
    ids on this rank (`plain_ids`: the slice's entries, or under dedup its
    unique ids)."""

    def __init__(self, model: DLRM, mesh: Mesh, flat: torch.Tensor,
                 dedup: bool, train: bool):
        cfg = model.cfg
        self.sources = sources = model.row_sources()
        self.groups = groups = exchange_groups(sources)
        self.has_plain = bool(groups) and sources[groups[0][0]].part == \
            "plain"
        use_kernel = cfg.use_gather_kernel
        ids_of = [group_ids(sources, g, flat) for g in groups]
        self.leaves, self.rows = [], []
        self.plain_ids = None
        for gi, (members, ids) in enumerate(zip(groups, ids_of)):
            tabs = [sources[i].param for i in members]
            if gi == 0 and self.has_plain:
                pos = None
                if dedup:
                    u_cap = max(min(ids.shape[0], sources[i].rows
                                    * mesh.n_model) for i in members)
                    ids, pos = _dedup_unique(ids, u_cap)
                self.plain_ids = ids
                with torch.no_grad():
                    got = _local_masked_gather(
                        tabs, ids, plain_shifts(sources, members, mesh),
                        use_kernel)
                    # one fused exchange for every plain table
                    dist.all_reduce(got, group=mesh.model_group)
                if train:
                    got.requires_grad_(True)
                self.leaves.append(got)
                if pos is not None:
                    got = got[pos, torch.arange(len(members),
                                                device=got.device)]
                self.rows.append(got)
            else:
                with torch.no_grad():
                    got = _gather(tabs, ids, use_kernel)
                if train:
                    got.requires_grad_(True)
                self.leaves.append(got)
                self.rows.append(got)


def _grad(leaf: torch.Tensor) -> torch.Tensor:
    return leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)


def plain_shifts(sources, members, mesh: Mesh) -> torch.Tensor:
    """m·Nl_t for each plain member: the first row of this rank's shard."""
    return torch.tensor([mesh.m * sources[i].rows for i in members],
                        dtype=torch.int64, device=mesh.device)


def mean_over_data(loss: torch.Tensor, params, mesh: Mesh) -> torch.Tensor:
    """The loss and the grads of `params` (a dict, grads set in place)
    averaged over the data group by one all_reduce, as JAX's `pmean`:
    -> the loss of the global batch."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params.values()]
    buf = torch.cat([loss.float().reshape(1)]
                    + [g.float().reshape(-1) for g in grads])
    dist.all_reduce(buf, group=mesh.data_group)
    buf /= mesh.n_data
    off = 1
    for p, g in zip(params.values(), grads):
        p.grad = buf[off:off + g.numel()].view_as(p).to(p.dtype)
        off += g.numel()
    return buf[0].clone()


def _slice(n: int, mesh: Mesh) -> Tuple[int, int]:
    if n % mesh.n_data:
        raise ValueError(f"a batch of {n} does not split over "
                         f"{mesh.n_data} data ranks")
    bl = n // mesh.n_data
    return mesh.d * bl, (mesh.d + 1) * bl


def _local_inputs(cfg, mesh: Mesh, dense_x, idx, bag_weights):
    """The rank's slice of a global batch, on its device, and the
    global flat ids [B·L, T]."""
    dev = mesh.device
    idx = _ids(idx, cfg, dev)
    bw = _bag_weights(bag_weights, idx, dev)
    lo, hi = _slice(idx.shape[0], mesh)
    L = idx.shape[2] if idx.dim() == 3 else 1
    flat_g = flat_ids(idx)
    return (_tensor(dense_x, dev, torch.float32)[lo:hi], idx[lo:hi],
            None if bw is None else bw[lo:hi], flat_g,
            flat_g[lo * L:hi * L])


def make_sharded_train_step(cfg: DLRMConfig, tcfg: TrainConfig, mesh: Mesh,
                            dedup_exchange: bool = False):
    """The SPMD train step of this rank: (model, opt_state, dense_x [B,
    nd], idx [B, T] or [B, T, L], labels [B], bag_weights [B, T, L] or
    None) -> the loss of the global batch (a 0-d tensor), with the model
    this rank's shard (`shard_dlrm_params`) and the inputs the global
    batch.  The model and its state are updated in place.  The step reads
    the batch's size and kind (one-hot or bags) from its inputs."""
    name = tcfg.optimizer.lower()
    _, dense_update, _ = make_optimizer(name)
    learned = cfg.weighted_pooling == "learned"
    lr_fn = lr_schedule(tcfg.learning_rate, tcfg.lr_num_warmup_steps,
                        tcfg.lr_decay_start_step, tcfg.lr_num_decay_steps)
    n_data = mesh.n_data

    def train_step(model: DLRM, opt_state: OptState, dense_x, idx, labels,
                   bag_weights=None) -> torch.Tensor:
        if model.cfg != cfg or model.row_shard != (mesh.m, mesh.n_model):
            raise ValueError("the model is not this rank's shard of cfg")
        dev = mesh.device
        dense_x, idx_l, bw, flat_g, flat = _local_inputs(
            cfg, mesh, dense_x, idx, bag_weights)
        lo, hi = _slice(len(labels), mesh)
        labels = _tensor(labels, dev, torch.float32)[lo:hi]
        look = _Lookup(model, mesh, flat, dedup_exchange, train=True)
        sources, groups = look.sources, look.groups
        plan = row_update_plan(sources, name, opt_state.sparse,
                               tcfg.use_update_kernel, learned, groups)
        params = dense_parameters(model)
        for p in params.values():
            p.grad = None
        emb = combine_rows(cfg, sources, groups, look.rows,
                           model.entries(), tuple(idx_l.shape), bw)
        loss = dlrm_loss(model(dense_x, None, emb_rows=emb), labels,
                         tcfg.loss_function, tcfg.loss_weights)
        loss.backward()
        with torch.no_grad():
            loss = mean_over_data(loss.detach(), params, mesh)
            # the row grads (and under dedup the unique ids): one
            # all_gather over data each
            parts = [_grad(look.leaves[u.gather])[:, u.lo:u.hi]
                     for u, _ in plan]
            row_g = _all_gather_cat(torch.cat(
                [g.reshape(-1) for g in parts]).reshape(1, -1),
                mesh.data_group, n_data) / n_data
            plain_all = None
            if look.has_plain and dedup_exchange:
                plain_all = _all_gather_cat(look.plain_ids,
                                            mesh.data_group, n_data)
        lr = lr_fn(opt_state.step)
        dense_update(opt_state.dense, params, lr)

        def rows():
            # the row grads of the global batch and the shard's ids
            off = 0
            for (u, _), g_l in zip(plan, parts):
                k = g_l.numel()
                grads = row_g[:, off:off + k].reshape(-1, *g_l.shape[1:])
                off += k
                members = groups[u.gather]
                if look.has_plain and u.gather == 0:
                    ids = plain_all if dedup_exchange else group_ids(
                        sources, members, flat_g)
                    ids = (ids.long() - plain_shifts(sources, members,
                                                     mesh))
                    ids = ids[:, u.lo:u.hi]
                else:
                    ids = group_ids(sources, members, flat_g)[:, u.lo:u.hi]
                yield ids, grads

        with torch.no_grad():
            apply_row_updates(plan, sources, opt_state.sparse, rows(), lr,
                              tcfg.use_update_kernel)
        opt_state.step += 1
        return loss

    return train_step


def make_sharded_eval_step(cfg: DLRMConfig, mesh: Mesh,
                           dedup_exchange: bool = False):
    """Sharded inference: the same exchange, no updates.  (model, dense_x
    [B, nd], idx [B, T] or [B, T, L], bag_weights or None) -> the
    probabilities [B] of the global batch, all-gathered over the data
    group, on every rank."""

    def eval_step(model: DLRM, dense_x, idx, bag_weights=None
                  ) -> torch.Tensor:
        dense_x, idx_l, bw, _, flat = _local_inputs(cfg, mesh, dense_x,
                                                    idx, bag_weights)
        with torch.inference_mode():
            look = _Lookup(model, mesh, flat, dedup_exchange, train=False)
            emb = combine_rows(cfg, look.sources, look.groups, look.rows,
                               model.entries(), tuple(idx_l.shape), bw)
            p = torch.sigmoid(model(dense_x, None, emb_rows=emb))
            return _all_gather_cat(p, mesh.data_group, mesh.n_data)

    return eval_step
