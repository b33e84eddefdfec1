"""The row updates of sgd, adagrad and rwsadagrad through the CUDA kernel
`csrc/row_update.cu`.

Port of `evstore_tpu/ops/pallas_update.py`.  `scatter_sub_sorted` is the
port of the TPU kernel `_sub_sweep_kernel`: over a group of tables that
share one global row space (table t holds the global ids [bases[t],
bases[t+1]), `ops/table_desc.py`), it subtracts, in place, the sum of each
run of equal sorted global ids from that row, and leaves ids outside
[0, bases[T]) (PAD_ROW, negative ids) inert.  One table is the group of
T = 1, whose global ids are its own.  The wrapper launches the kernel for
CUDA tensors and takes the plain version (`scatter_sub_sorted_grouped_ref`)
only for CPU tensors.  Unlike the TPU kernel, which rewrites the whole
table, the kernel touches only the rows in the batch.

`rwsadagrad_row_update` mirrors `rwsadagrad_row_update_pallas` for a group
of tables of one width at once (every table of a train step's batch, or
the rows of its bags): map each table's ids to global ids (an id outside
[0, N_t) becomes PAD_ROW first, so that it cannot land in the next table's
rows), sort them, sum each sorted segment, update the row accumulators (one
flat [sum N_t] buffer) and hand the kernel each run's update
lr * G / (sqrt(state_row) + eps) on the run's first entry.
`adagrad_row_update` is the same with an elementwise state (one flat
[sum N_t, D] buffer); `sgd_row_update` pre-scales each entry by lr and
needs no segment sum.  The tables' global row ranges are disjoint, so this
is the per-table math, run once.  None of them waits for the device: every
buffer is sized by the batch, not by the number of distinct ids.  The
tables and the state are updated in place.  The segment sums are the
kernel's too (`segment_sums`: a launch over a zeroed scratch table), so
the sum that moves a row's accumulator and the one that moves the row are
one sum, taken in the kernel's fixed order: the updates are bitwise
repeatable on the card.  `rwsadagrad_row_update_global` is the trainable
cache's form, over ids that are global already.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from evstore_tpu_torch import _build
from evstore_tpu_torch.ops.table_desc import (INT32_MAX, check_global_rows,
                                              column_tables, table_group)

EPS = 1e-10
CHUNK = 128     # sorted entries per block of the kernel (csrc/row_update.cu)

Tables = Union[torch.Tensor, Sequence[torch.Tensor]]

# The kernel's scratch for the partial sums of runs that cross chunks, one
# buffer per (device, stream), grown as needed: a launch on a stream reuses
# it after the launches queued before it, and the wrapper spends no host
# time on an allocation per call.
_scratch: Dict[Tuple[int, int], torch.Tensor] = {}
# `segment_sums`' tables of run sums, one per (device, stream, width)
_sums: Dict[Tuple[int, int, int], torch.Tensor] = {}


def _scratch_for(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    buf = _scratch.get((dev.index, stream))
    if buf is None or buf.numel() < n:
        buf = torch.empty(n, dtype=torch.float32, device=dev)
        _scratch[(dev.index, stream)] = buf
    return buf


def scatter_sub_sorted_ref(table: torch.Tensor, rows_sorted: torch.Tensor,
                           vals: torch.Tensor) -> torch.Tensor:
    """The plain version: a masked `index_add_` of the values into a
    float64 buffer of the distinct rows, subtracted from those rows in
    place.  float64, because a run of thousands of equal ids summed in
    float32 carries a rounding error that depends on the order, and the
    kernel (fixed-order sums: a scan across a warp's lanes, a chain across
    warps, a compensated sum across chunks) is held to this."""
    n = table.shape[0]
    keep = (rows_sorted >= 0) & (rows_sorted < n)
    uniq, inv = torch.unique(rows_sorted[keep].long(), return_inverse=True)
    acc = torch.zeros((uniq.numel(), table.shape[1]), dtype=torch.float64,
                      device=table.device)
    acc.index_add_(0, inv, vals[keep].double())
    table[uniq] = (table[uniq].double() - acc).to(table.dtype)
    return table


def scatter_sub_sorted_grouped_ref(tables: Sequence[torch.Tensor],
                                   rows_sorted: torch.Tensor,
                                   vals: torch.Tensor) -> None:
    """The plain version of the grouped call: `scatter_sub_sorted_ref` on
    each table's slice of the sorted global ids, shifted to its own rows."""
    bases = [0]
    for t in tables:
        bases.append(bases[-1] + t.shape[0])
    cuts = torch.searchsorted(
        rows_sorted.long(),
        torch.tensor(bases, dtype=torch.int64, device=rows_sorted.device),
        side="left").tolist()
    for t, tab in enumerate(tables):
        lo, hi = cuts[t], cuts[t + 1]
        scatter_sub_sorted_ref(tab, rows_sorted[lo:hi] - bases[t],
                               vals[lo:hi])


def _as_list(tables: Tables):
    return [tables] if isinstance(tables, torch.Tensor) else list(tables)


def scatter_sub_sorted(tables: Tables, rows_sorted: torch.Tensor,
                       vals: torch.Tensor) -> Tables:
    """tables: one [N, D] table or a list of T [N_t, D] tables of one type
    (f32 or bf16); rows_sorted [K] int32 global ids, ascending; vals [K, D]
    f32.  table_t[r - bases[t]] -= the run sums of vals, in place; returns
    `tables`."""
    group = _as_list(tables)
    if rows_sorted.device.type == "cpu" and vals.device.type == "cpu" and \
            all(t.device.type == "cpu" for t in group):
        check_global_rows("scatter_sub_sorted", [t.shape[0] for t in group])
        scatter_sub_sorted_grouped_ref(group, rows_sorted, vals)
        return tables
    g = table_group("scatter_sub_sorted", group, global_ids=True)
    dev = rows_sorted.device
    if dev.type != "cuda" or vals.device != dev or group[0].device != dev:
        raise ValueError("scatter_sub_sorted: all tensors must be on one CUDA "
                         "device (or all on the CPU), got rows on "
                         f"{dev}, values on {vals.device}, tables on "
                         f"{group[0].device}")
    if rows_sorted.dtype != torch.int32 or vals.dtype != torch.float32:
        raise TypeError(f"scatter_sub_sorted takes int32 rows and float32 "
                        f"values, got {rows_sorted.dtype} and {vals.dtype}")
    K = rows_sorted.shape[0]
    if rows_sorted.dim() != 1 or tuple(vals.shape) != (K, g.dim):
        raise ValueError(f"shapes rows {tuple(rows_sorted.shape)}, vals "
                         f"{tuple(vals.shape)}: expected [K], [K, {g.dim}]")
    if not (rows_sorted.is_contiguous() and vals.is_contiguous()):
        raise ValueError("scatter_sub_sorted takes contiguous tensors")
    if K == 0:
        return tables
    n_chunks = -(-K // CHUNK)
    stream = _build.stream(dev.index)
    # [n_chunks, 2, D] partials of runs that cross chunks (one leaves none)
    scratch = _scratch_for(dev, stream, n_chunks * 2 * g.dim).data_ptr() \
        if n_chunks > 1 else None
    rc = _build.library().scatter_sub_sorted(
        g.desc.data_ptr(), len(group), g.dim, rows_sorted.data_ptr(),
        vals.data_ptr(), K, scratch, n_chunks if scratch else 0,
        int(g.dtype == torch.bfloat16), dev.index, stream)
    _build.check(rc, "scatter_sub_sorted")
    scatter_sub_sorted.launches += 1
    return tables


scatter_sub_sorted.launches = 0


def _sorted_entries(name: str, state: Optional[torch.Tensor],
                    tables: Tables, ids: torch.Tensor, grads: torch.Tensor,
                    state_shape, columns: Sequence[int] = ()):
    """The shared start of the grouped updates: check the shapes, map each
    table's ids to global ids (an id outside [0, N_t) becomes PAD_ROW
    first, so that it cannot land in the next table's rows) and sort them
    once.  Either one table [N, D] with ids [K] and grads [K, D], or T
    tables with ids [R, T] and grads [R, T, D], or with `columns` (the
    table of each column: bags of a length per table) ids [R, C] and
    grads [R, C, D]; every column of one table maps to the same global
    rows, so a row's entries from all its bags meet in one run.
    `state_shape(n, D)` is the flat state's shape (None: no state).
    Returns (group, global ids sorted int32 [K], the grads in that order,
    f32 [K, D])."""
    group = _as_list(tables)
    g = table_group(name, group, global_ids=True)
    n, D = g.total_rows, g.dim
    if isinstance(tables, torch.Tensor):
        ids, grads = ids.reshape(-1, 1), grads.reshape(-1, 1, D)
    columns = tuple(columns)
    if columns and (max(columns) >= len(group) or min(columns) < 0):
        raise ValueError(f"{name}: columns {columns} name tables outside "
                         f"the {len(group)} given")
    want = None if state_shape is None else state_shape(n, D)
    if ids.dim() != 2 or ids.shape[1] != len(columns or group) or \
            tuple(grads.shape) != (*ids.shape, D) or \
            (want is not None and tuple(state.shape) != want):
        raise ValueError(f"{name}: ids {tuple(ids.shape)}, grads "
                         f"{tuple(grads.shape)}"
                         + ("" if want is None else
                            f", state {tuple(state.shape)}")
                         + f" for {len(group)} tables of {n} rows in all, "
                         f"width {D}")
    bases = g.bases.to(ids.device)
    lo, size = bases[:-1], bases[1:] - bases[:-1]
    if columns:
        cols = column_tables(columns, ids.device)
        lo, size = lo[cols], size[cols]
    ids = ids.long()
    ok = (ids >= 0) & (ids < size)
    gid = torch.where(ok, ids + lo, INT32_MAX).reshape(-1)
    K = gid.shape[0]
    rows_sorted, order = torch.sort(gid.to(torch.int32), stable=True)
    return g, rows_sorted, grads.reshape(K, D).float()[order]


def _sums_for(dev: torch.device, stream: int, k: int,
              d: int) -> torch.Tensor:
    """The table `segment_sums` sums runs into: one per (device, stream,
    width) on the card, grown as needed and otherwise the same tensor, so
    that the kernel's table descriptor stays cached; a new one on the
    CPU."""
    if dev.type != "cuda":
        return torch.zeros((k, d), dtype=torch.float32, device=dev)
    buf = _sums.get((dev.index, stream, d))
    if buf is None or buf.shape[0] < k:
        buf = torch.zeros((max(k, 1), d), dtype=torch.float32, device=dev)
        _sums[(dev.index, stream, d)] = buf
    else:
        buf[:k].zero_()
    return buf


def segment_sums(rows_sorted: torch.Tensor, g_sorted: torch.Tensor,
                 n: int):
    """Sum each run of equal sorted ids, with buffers sized by K (no
    wait for the number of runs): (first [K], the entry begins its run;
    seg [K], the entry's run; Gc [K, D], the run sums by run; valid [K],
    the run is a row of the group; seg_at [K], its row, 0 for the
    others).  The row-update kernel sums the runs, over a zeroed table
    of K rows keyed by the run's index, in its fixed order (on the CPU,
    its plain version, in float64)."""
    K, D = g_sorted.shape
    dev = g_sorted.device
    first = torch.ones(K, dtype=torch.bool, device=dev)
    first[1:] = rows_sorted[1:] != rows_sorted[:-1]
    seg = torch.cumsum(first, 0) - 1                          # [K] int64
    sums = _sums_for(dev, _build.stream(dev.index) if dev.type == "cuda"
                     else 0, K, D)
    scatter_sub_sorted(sums, seg.to(torch.int32), g_sorted)
    Gc = -sums[:K]
    seg_row = torch.full((K,), INT32_MAX, dtype=torch.int64, device=dev)
    seg_row[seg] = rows_sorted.long()       # one value per run
    valid = seg_row < n                     # PAD_ROW and unused runs
    return first, seg, Gc, valid, torch.where(valid, seg_row, 0)


def sgd_row_update(tables: Tables, ids: torch.Tensor, grads: torch.Tensor,
                   lr, columns: Sequence[int] = ()) -> Tables:
    """SGD on the rows in `ids`, in place: table[row] -= lr * G_row, with
    G_row the sum of the row's entries, through one sort and one launch of
    the kernel (each entry pre-scaled by lr).  One table [N, D] with ids
    [K] and grads [K, D], or a list of T tables with ids [R, T] and grads
    [R, T, D], or with `columns` ids [R, C] and grads [R, C, D], column c
    of table columns[c] (`_sorted_entries`).  Ids may repeat and may lie
    outside their table (PAD_ROW): those are inert.  Returns `tables`."""
    _, rows_sorted, g_sorted = _sorted_entries("sgd_row_update", None,
                                               tables, ids, grads, None,
                                               columns)
    return scatter_sub_sorted(tables, rows_sorted, g_sorted * lr)


def adagrad_row_update(state: torch.Tensor, tables: Tables,
                       ids: torch.Tensor, grads: torch.Tensor, lr,
                       eps: float = EPS, columns: Sequence[int] = ()):
    """Adagrad on the rows in `ids`, elementwise, in place: state[row] +=
    G_row^2 and table[row] -= lr * G_row / (sqrt(state[row]) + eps), with
    G_row the sum of the row's entries (one sort and two launches of the
    kernel: the segment sums, then the update).  One table [N, D] with ids
    [K], grads [K, D] and state [N, D], or a list of T tables with ids [R, T],
    grads [R, T, D] and `state` the flat [sum N_t, D] buffer, table t's
    rows at [bases[t], bases[t+1]); `columns` as `sgd_row_update`'s.  Ids
    may repeat and may lie outside their table (PAD_ROW): those are inert.
    Returns (state, tables)."""
    g, rows_sorted, g_sorted = _sorted_entries(
        "adagrad_row_update", state, tables, ids, grads,
        lambda n, D: (n, D), columns)
    first, seg, Gc, valid, seg_at = segment_sums(rows_sorted, g_sorted,
                                                 g.total_rows)
    inc = torch.where(valid[:, None], Gc * Gc, 0.0)
    st_rows = state[seg_at] + inc
    state.index_add_(0, seg_at, inc)
    upd = torch.where(valid[:, None], lr * Gc / (torch.sqrt(st_rows) + eps),
                      0.0)
    return state, _apply_runs(tables, rows_sorted, first, seg, upd)


def _apply_runs(tables, rows_sorted, first, seg, upd):
    """table[row] -= upd of the row's run, through one launch: each run's
    update on its first entry and 0 on the others, so that the kernel's
    run sum is that update exactly.  Pre-scaling every entry instead is
    ill-conditioned: a row's first update is about lr * sign(G) whatever
    |G| is, so where a run's entries nearly cancel, the sum that moved the
    accumulator and the kernel's second sum of the same entries, rounded
    apart, would move the row by their difference."""
    return scatter_sub_sorted(tables, rows_sorted,
                              torch.where(first[:, None], upd[seg], 0.0))


def rwsadagrad_row_update(state: torch.Tensor, tables: Tables,
                          ids: torch.Tensor, grads: torch.Tensor, lr,
                          eps: float = EPS, columns: Sequence[int] = ()):
    """Row-wise sparse Adagrad on the rows in `ids` (optim/rwsadagrad.py:
    109-113), in place: state[row] += mean(G_row^2) and table[row] -=
    lr * G_row / (sqrt(state[row]) + eps), with G_row the sum of the row's
    entries.  Either one table [N, D] with ids [K] and grads [K, D], or a
    list of T tables with ids [R, T] and grads [R, T, D]; `state` is the
    flat [sum N_t] accumulator, table t's rows at [bases[t], bases[t+1]);
    with `columns` (bags of a length per table) ids [R, C] and grads
    [R, C, D], column c of table columns[c], so that a row's entries from
    every bag coalesce before its one state update.  Ids may repeat and
    may lie outside their table (PAD_ROW): those are inert.  Returns
    (state, tables)."""
    g, rows_sorted, g_sorted = _sorted_entries(
        "rwsadagrad_row_update", state, tables, ids, grads,
        lambda n, D: (n,), columns)
    return _rwsadagrad_sorted(g, state, tables, rows_sorted, g_sorted, lr,
                              eps)


def rwsadagrad_row_update_global(state: torch.Tensor,
                                 tables: Sequence[torch.Tensor],
                                 rows: torch.Tensor, grads: torch.Tensor,
                                 lr, eps: float = EPS):
    """`rwsadagrad_row_update` over a group whose ids are global already:
    rows [K] index the group's row space (table t's rows at [bases[t],
    bases[t+1])), grads [K, D], `state` the flat [sum N_t] accumulator.
    The trainable cache's step updates its cache slots and its miss
    buffer's rows this way, one sort and one update for both.  Ids outside
    the group are inert.  Returns (state, tables)."""
    g = table_group("rwsadagrad_row_update_global", list(tables),
                    global_ids=True)
    K, D = rows.numel(), g.dim
    if tuple(grads.shape) != (K, D) or tuple(state.shape) != \
            (g.total_rows,):
        raise ValueError(f"rwsadagrad_row_update_global: rows [{K}], grads "
                         f"{tuple(grads.shape)}, state {tuple(state.shape)}"
                         f" for {len(tables)} tables of {g.total_rows} rows"
                         f" in all, width {D}")
    rows = rows.reshape(-1).long()
    ok = (rows >= 0) & (rows < g.total_rows)
    gid = torch.where(ok, rows, INT32_MAX).to(torch.int32)
    rows_sorted, order = torch.sort(gid, stable=True)
    return _rwsadagrad_sorted(g, state, list(tables), rows_sorted,
                              grads.float()[order], lr, eps)


def _rwsadagrad_sorted(g, state, tables, rows_sorted, g_sorted, lr, eps):
    """rwsadagrad's update from the sorted global ids and their grads: the
    row's accumulator and the row move by the same run sum G, as in the
    JAX step's dense form."""
    first, seg, Gc, valid, seg_at = segment_sums(rows_sorted, g_sorted,
                                                 g.total_rows)
    inc = torch.where(valid, (Gc * Gc).mean(dim=1), 0.0)
    st_rows = state[seg_at] + inc
    state.index_add_(0, seg_at, inc)
    upd = torch.where(valid[:, None],
                      lr * Gc / (torch.sqrt(st_rows) + eps)[:, None], 0.0)
    return state, _apply_runs(tables, rows_sorted, first, seg, upd)
