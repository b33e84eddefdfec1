"""Plain embedding tables: initialization and one-hot lookup.

Port of the plain-table parts of `evstore_tpu/models/embedding.py`.  Each
table is initialised U(-sqrt(1/n), sqrt(1/n)) (dlrm_s_pytorch.py:278-283).
On the card a lookup goes through the row-gather kernel
(`ops/cuda_gather.py`).  qr, md and multi-hot bags are not ported yet.

Ids outside [0, N) are a deliberate departure from the JAX package, which
is not consistent with itself there (its `take_rows` clips them, its
one-hot lookup gives a zero row, its `row_update` wraps negative ids, its
tier engine raises).  The port's rule: where ids are still numpy arrays on
the host (`run_inference`, the device caches' `lookup_batch`, `train`,
`evaluate`), `check_ids` raises `ValueError`, at no device sync.  On device
tensors nothing is checked: a gather gives a zero row (kernels and plain
versions alike) and a row update leaves the table alone.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from evstore_tpu_torch.ops.cuda_gather import gather_rows


def init_embedding_tables(table_sizes: Sequence[int], dim: int,
                          rng: np.random.Generator) -> List[np.ndarray]:
    """Float32 [n, dim] tables drawn from `rng`, U(-sqrt(1/n), sqrt(1/n)).
    Built in place, so a multi-GB table needs no float64 temporary."""
    tables = []
    for n in table_sizes:
        bound = np.float32(np.sqrt(1.0 / n))
        t = rng.random((n, dim), dtype=np.float32)
        t *= 2 * bound
        t -= bound
        tables.append(t)
    return tables


def check_ids(idx: np.ndarray, table_sizes: Sequence[int]) -> None:
    """Raise ValueError unless every id of idx [B, T, ...] (host numpy)
    lies in [0, table_sizes[t]) for its table t."""
    idx = np.asarray(idx)
    sizes = np.asarray(table_sizes, np.int64)
    if idx.ndim < 2 or idx.shape[1] != sizes.size:
        raise ValueError(f"ids of shape {idx.shape} do not match "
                         f"{sizes.size} tables")
    sizes = sizes.reshape(1, -1, *([1] * (idx.ndim - 2)))
    bad = (idx < 0) | (idx >= sizes)
    if bad.any():
        pos = tuple(np.argwhere(bad)[0])
        raise ValueError(f"row id {int(idx[pos])} of table {pos[1]} is "
                         f"outside [0, {int(sizes.flat[pos[1]])})")


def take_rows(table: torch.Tensor, ids: torch.Tensor,
              use_kernel: bool = True) -> torch.Tensor:
    """table [N, D], ids of any shape -> ids.shape + [D]."""
    if use_kernel:
        return gather_rows(table, ids.to(torch.int32).contiguous())
    return torch.index_select(table, 0, ids.reshape(-1).long()).reshape(
        *ids.shape, table.shape[1])


def sparse_arch_lookup(tables: Sequence[torch.Tensor], idx: torch.Tensor,
                       cfg) -> torch.Tensor:
    """One-hot idx [B, T] -> [B, T, D] rows, one lookup per table."""
    if idx.dim() != 2:
        raise NotImplementedError(
            "multi-hot [B, T, L] bags are not ported yet; idx must be [B, T]")
    return torch.stack([take_rows(tables[t], idx[:, t], cfg.use_gather_kernel)
                        for t in range(idx.shape[1])], dim=1)
