"""The descriptor of a group of tables that the grouped kernels read.

`csrc/gather_rows.cu::gather_rows_grouped` and `csrc/row_update.cu` take a
group of T tables of one type and width as one int64 tensor on the tables'
device, [2T + 1]: the T base addresses, then the T + 1 cumulative row
counts (`bases`).  Table t holds the global row ids [bases[t], bases[t+1]).

Building it costs a host-to-device copy, so it is cached: a train step
finds the one built for the model's tables.  The cache is keyed on the
tables' identities and checked against their data addresses, so it is
rebuilt when a table object or its data is replaced (an in-place change of
a table's shape, `resize_` or `set_`, is not seen).  The checks that a
kernel needs of the tables (one device, one type and width, 2-D,
contiguous) run when it is built.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import NamedTuple, Sequence, Tuple

import torch

INT32_MAX = 2 ** 31 - 1
# global int32 row ids leave PAD_ROW = INT32_MAX above every row
MAX_GLOBAL_ROWS = INT32_MAX - 1
_CACHE_SIZE = 16


class TableGroup(NamedTuple):
    desc: torch.Tensor      # int64 [2T + 1] on the tables' device
    bases: torch.Tensor     # desc[T:], the cumulative row counts [T + 1]
    total_rows: int         # bases[T]
    align: int              # the common alignment of the base addresses
    dtype: torch.dtype
    dim: int
    refs: Tuple             # weak references to the tables
    ptrs: Tuple[int, ...]   # their data addresses


_cache: "OrderedDict[tuple, TableGroup]" = OrderedDict()


def check_global_rows(name: str, sizes: Sequence[int]) -> int:
    """The total row count; ValueError when global int32 ids cannot name
    every row with PAD_ROW (INT32_MAX) above them all."""
    total = sum(sizes)
    if total > MAX_GLOBAL_ROWS:
        raise ValueError(f"{name}: the tables hold {total} rows, more than "
                         f"int32 global ids with PAD_ROW = {INT32_MAX} above "
                         f"them can name ({MAX_GLOBAL_ROWS})")
    return total


def _build(name: str, tables: Sequence[torch.Tensor]) -> TableGroup:
    t0 = tables[0]
    for t in tables:
        if t.device != t0.device:
            raise ValueError(f"{name}: all tables must be on one device, got "
                             f"{t.device} and {t0.device}")
        if t.dtype != t0.dtype or t.dtype not in (torch.float32,
                                                  torch.bfloat16):
            raise TypeError(f"{name} takes float32 or bfloat16 tables of one "
                            f"type, got {t.dtype} and {t0.dtype}")
        if t.dim() != 2 or t.shape[1] != t0.shape[1]:
            raise ValueError(f"{name} takes [N_t, D] tables of one width, "
                             f"got {tuple(t.shape)} and {tuple(t0.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tables")
    ptrs = tuple(t.data_ptr() for t in tables)
    bases = [0]
    for t in tables:
        bases.append(bases[-1] + t.shape[0])
    desc = torch.tensor(list(ptrs) + bases, dtype=torch.int64).to(t0.device)
    align = 16
    while align > 4 and any(p % align for p in ptrs):
        align //= 2
    return TableGroup(desc, desc[len(tables):], bases[-1], align, t0.dtype,
                      t0.shape[1], tuple(weakref.ref(t) for t in tables),
                      ptrs)


def table_group(name: str, tables: Sequence[torch.Tensor],
                global_ids: bool = False) -> TableGroup:
    """The descriptor of `tables`, found in the cache or built; raises for
    tables a grouped kernel cannot take.  With `global_ids` (the row
    update's int32 global ids), ValueError for more than MAX_GLOBAL_ROWS
    rows in all, a check made on the sizes before anything is built."""
    if len(tables) == 0:
        raise ValueError(f"{name} takes at least one table")
    key = tuple(map(id, tables))
    group = _cache.get(key)
    if group is None or group.ptrs != tuple(
            map(torch.Tensor.data_ptr, tables)) or any(
            r() is not t for r, t in zip(group.refs, tables)):
        if global_ids:
            check_global_rows(name, [t.shape[0] for t in tables])
        group = _cache[key] = _build(name, tables)
        if len(_cache) > _CACHE_SIZE:
            _cache.popitem(last=False)
    else:
        _cache.move_to_end(key)
    if global_ids:
        check_global_rows(name, [group.total_rows])
    return group
