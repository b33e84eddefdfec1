"""The rwsadagrad row update through the CUDA kernel `csrc/row_update.cu`.

Port of `evstore_tpu/ops/pallas_update.py`.  `scatter_sub_sorted` is the
port of the TPU kernel `_sub_sweep_kernel`: it subtracts, in place, the sum
of each run of equal sorted ids from that row, and leaves ids outside
[0, N) (PAD_ROW, negative ids) inert.  The wrapper launches the kernel for
CUDA tensors and takes the plain version (`scatter_sub_sorted_ref`) only for
CPU tensors.  Unlike the TPU kernel, which rewrites the whole table, the
kernel touches only the rows in the batch.

`rwsadagrad_row_update` mirrors `rwsadagrad_row_update_pallas`: sort the
ids, sum each sorted segment, update the row accumulators, pre-scale each
entry by lr / (sqrt(state_row) + eps) and apply with the kernel.  It never
waits for the device: every buffer is sized by the batch, not by the number
of distinct ids.  The table and the state are updated in place.  The kernel
sums each run in a fixed order; the segment sums that feed the accumulators
come from `index_add_`, whose atomics on the card add in any order, so the
accumulators and the per-row scale agree between runs only to rounding.
"""

from __future__ import annotations

import torch

from evstore_tpu_torch import _build

EPS = 1e-10
INT32_MAX = 2 ** 31 - 1


def scatter_sub_sorted_ref(table: torch.Tensor, rows_sorted: torch.Tensor,
                           vals: torch.Tensor) -> torch.Tensor:
    """The plain version: a masked `index_add_` of the values into a
    float64 buffer of the distinct rows, subtracted from those rows in
    place.  float64, because a run of thousands of equal ids summed in
    float32 carries a rounding error that depends on the order, and the
    kernel, which compensates its sums, is held to this."""
    n = table.shape[0]
    keep = (rows_sorted >= 0) & (rows_sorted < n)
    uniq, inv = torch.unique(rows_sorted[keep].long(), return_inverse=True)
    acc = torch.zeros((uniq.numel(), table.shape[1]), dtype=torch.float64,
                      device=table.device)
    acc.index_add_(0, inv, vals[keep].double())
    table[uniq] = (table[uniq].double() - acc).to(table.dtype)
    return table


def scatter_sub_sorted(table: torch.Tensor, rows_sorted: torch.Tensor,
                       vals: torch.Tensor) -> torch.Tensor:
    """table [N, D] (f32 or bf16) -= the run sums of vals [K, D] (f32) over
    rows_sorted [K] (int32, ascending), in place; returns the table."""
    tensors = (table, rows_sorted, vals)
    if all(t.device.type == "cpu" for t in tensors):
        return scatter_sub_sorted_ref(table, rows_sorted, vals)
    dev = table.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("scatter_sub_sorted: all tensors must be on one CUDA "
                         "device (or all on the CPU), got "
                         f"{[str(t.device) for t in tensors]}")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"scatter_sub_sorted takes a float32 or bfloat16 "
                        f"table, got {table.dtype}")
    if rows_sorted.dtype != torch.int32 or vals.dtype != torch.float32:
        raise TypeError(f"scatter_sub_sorted takes int32 rows and float32 "
                        f"values, got {rows_sorted.dtype} and {vals.dtype}")
    K = rows_sorted.shape[0]
    if table.dim() != 2 or rows_sorted.dim() != 1 or \
            tuple(vals.shape) != (K, table.shape[1]):
        raise ValueError(f"shapes table {tuple(table.shape)}, rows "
                         f"{tuple(rows_sorted.shape)}, vals "
                         f"{tuple(vals.shape)}: expected [N, D], [K], [K, D]")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("scatter_sub_sorted takes contiguous tensors")
    if K == 0:
        return table
    rc = _build.library().scatter_sub_sorted(
        table.data_ptr(), table.shape[0], table.shape[1],
        rows_sorted.data_ptr(), vals.data_ptr(), K,
        int(table.dtype == torch.bfloat16), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "scatter_sub_sorted")
    scatter_sub_sorted.launches += 1
    return table


scatter_sub_sorted.launches = 0


def rwsadagrad_row_update(state: torch.Tensor, table: torch.Tensor,
                          ids: torch.Tensor, grads: torch.Tensor, lr,
                          eps: float = EPS):
    """Row-wise sparse Adagrad on the rows in `ids` (optim/rwsadagrad.py:
    109-113), in place: state[row] += mean(G_row^2) and table[row] -=
    lr * G_row / (sqrt(state[row]) + eps), with G_row the sum of the row's
    entries.  ids [K] may repeat and may hold inert ids (PAD_ROW, outside
    [0, N)); grads [K, D].  Returns (state, table)."""
    n = table.shape[0]
    K = ids.shape[0]
    rows_sorted, order = torch.sort(ids.to(torch.int32), stable=True)
    g_sorted = grads.float()[order]
    first = torch.ones(K, dtype=torch.bool, device=ids.device)
    first[1:] = rows_sorted[1:] != rows_sorted[:-1]
    seg = torch.cumsum(first, 0) - 1                          # [K] int64
    Gc = torch.zeros((K, table.shape[1]), dtype=torch.float32,
                     device=ids.device).index_add_(0, seg, g_sorted)
    seg_row = torch.full((K,), INT32_MAX, dtype=torch.int64,
                         device=ids.device)
    seg_row[seg] = rows_sorted.long()       # one value per segment
    valid = (seg_row >= 0) & (seg_row < n)  # inert ids and unused segments
    inc = torch.where(valid, (Gc * Gc).mean(dim=1), 0.0)
    seg_at = torch.where(valid, seg_row, 0)                   # adds 0 there
    st_rows = state[seg_at] + inc
    state.index_add_(0, seg_at, inc)
    # per segment; 0 for inert ids, whose entries the kernel skips anyway
    scale = torch.where(valid, lr / (torch.sqrt(st_rows) + eps), 0.0)
    scatter_sub_sorted(table, rows_sorted, g_sorted * scale[seg][:, None])
    return state, table
