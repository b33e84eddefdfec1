"""The rwsadagrad row update through the CUDA kernel `csrc/row_update.cu`.

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

`rwsadagrad_row_update` mirrors `rwsadagrad_row_update_pallas` for every
table of a one-hot batch at once: map each table's ids to global ids (an id
outside [0, N_t) becomes PAD_ROW first, so that it cannot land in the next
table's rows), sort them, sum each sorted segment, update the row
accumulators (one flat [sum N_t] buffer), pre-scale each entry by
lr / (sqrt(state_row) + eps) and apply with the kernel.  The tables' global
row ranges are disjoint, so this is the per-table math, run once.  It never
waits for the device: every buffer is sized by the batch, not by the number
of distinct ids.  The tables and the state are updated in place.  The kernel
sums each run in a fixed order; the segment sums that feed the accumulators
come from `index_add_`, whose atomics on the card add in any order, so the
accumulators and the per-row scale agree between runs only to rounding.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import torch

from evstore_tpu_torch import _build
from evstore_tpu_torch.ops.table_desc import (INT32_MAX, check_global_rows,
                                              table_group)

EPS = 1e-10
CHUNK = 128     # sorted entries per block of the kernel (csrc/row_update.cu)

Tables = Union[torch.Tensor, Sequence[torch.Tensor]]

# The kernel's scratch for the partial sums of runs that cross chunks, one
# buffer per (device, stream), grown as needed: a launch on a stream reuses
# it after the launches queued before it, and the wrapper spends no host
# time on an allocation per call.
_scratch: Dict[Tuple[int, int], torch.Tensor] = {}


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


def rwsadagrad_row_update(state: torch.Tensor, tables: Tables,
                          ids: torch.Tensor, grads: torch.Tensor, lr,
                          eps: float = EPS):
    """Row-wise sparse Adagrad on the rows in `ids` (optim/rwsadagrad.py:
    109-113), in place: state[row] += mean(G_row^2) and table[row] -=
    lr * G_row / (sqrt(state[row]) + eps), with G_row the sum of the row's
    entries.  Either one table [N, D] with ids [K] and grads [K, D], or a
    list of T tables with ids [B, T] and grads [B, T, D]; `state` is the
    flat [sum N_t] accumulator, table t's rows at [bases[t], bases[t+1]).
    Ids may repeat and may lie outside their table (PAD_ROW): those are
    inert.  Returns (state, tables)."""
    group = _as_list(tables)
    g = table_group("rwsadagrad_row_update", group, global_ids=True)
    n, D = g.total_rows, g.dim
    if isinstance(tables, torch.Tensor):
        ids, grads = ids.reshape(-1, 1), grads.reshape(-1, 1, D)
    if ids.dim() != 2 or ids.shape[1] != len(group) or \
            tuple(grads.shape) != (*ids.shape, D) or \
            tuple(state.shape) != (n,):
        raise ValueError(f"rwsadagrad_row_update: ids {tuple(ids.shape)}, "
                         f"grads {tuple(grads.shape)}, state "
                         f"{tuple(state.shape)} for {len(group)} tables of "
                         f"{n} rows in all, width {D}")
    dev = ids.device
    bases = g.bases.to(dev)
    ids = ids.long()
    ok = (ids >= 0) & (ids < bases[1:] - bases[:-1])
    gid = torch.where(ok, ids + bases[:-1], INT32_MAX).reshape(-1)
    K = gid.shape[0]
    rows_sorted, order = torch.sort(gid.to(torch.int32), stable=True)
    g_sorted = grads.reshape(K, D).float()[order]
    first = torch.ones(K, dtype=torch.bool, device=dev)
    first[1:] = rows_sorted[1:] != rows_sorted[:-1]
    seg = torch.cumsum(first, 0) - 1                          # [K] int64
    Gc = torch.zeros((K, D), dtype=torch.float32,
                     device=dev).index_add_(0, seg, g_sorted)
    seg_row = torch.full((K,), INT32_MAX, dtype=torch.int64, device=dev)
    seg_row[seg] = rows_sorted.long()       # one value per segment
    valid = seg_row < n                     # PAD_ROW and unused segments
    inc = torch.where(valid, (Gc * Gc).mean(dim=1), 0.0)
    seg_at = torch.where(valid, seg_row, 0)                   # adds 0 there
    st_rows = state[seg_at] + inc
    state.index_add_(0, seg_at, inc)
    # per segment; 0 for inert ids, whose entries the kernel skips anyway
    scale = torch.where(valid, lr / (torch.sqrt(st_rows) + eps), 0.0)
    scatter_sub_sorted(tables, rows_sorted, g_sorted * scale[seg][:, None])
    return state, tables
