"""Offline alternative-key generation for the C3 tier.

Port of `evstore_tpu/tools/gen_altkeys.py`.  Reference pipeline
(script/approximate_embedding/): cuML NearestNeighbors(n_neighbors=11,
euclidean) over all tables' rows concatenated (get_neighbors_GPU.ipynb),
then per row the neighbour with the highest workload frequency
(most_popular_neighbor.ipynb, frequencies from rankedWorkload.csv), packed
as big-endian uint32 alt keys, altKey = (table + 1) + 100 * row
(convert_altkeys_to_binary.py).

The kNN is blocked, each block of query rows against every row through
`ops/cuda_knn.py::knn_topk`.  On the card that is the kernel K7
(`csrc/knn_topk.cu`): the keys are uploaded once and no [block, N] distance
matrix is written, so the 33,762,577 rows of the Criteo Kaggle tables fit;
the blocks are at least `CARD_BLOCK` rows, enough to fill the card.  On the
CPU it is the plain version, per block the squared distances to every
row, ||a||² + ||b||² − 2abᵀ, from one `torch.addmm` (float32), self
masked, then `torch.topk`, as the JAX package's XLA computes them.  It
runs on `device`: the card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from evstore_tpu_torch.cache.tiers import altkey_encode
from evstore_tpu_torch.ops.cuda_knn import knn_topk
from evstore_tpu_torch.utils.device import resolve_device

CARD_BLOCK = 1 << 17    # query rows a K7 call on the card, at least


def _topk_neighbors_blocked(rows: np.ndarray, k: int, block: int = 2048,
                            device=None) -> np.ndarray:
    """[N, D] -> [N, k] neighbour indices (self excluded), nearest first."""
    dev = resolve_device(device)
    x = torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(dev)
    return knn_neighbours(x, torch.arange(len(rows), device=dev), k, block)


def knn_neighbours(keys: torch.Tensor, query_ids: torch.Tensor, k: int,
                   block: int = 2048) -> np.ndarray:
    """The k nearest rows of `keys` [N, D] (float32, on the device that
    computes) to each row `query_ids` [Q] (int64) names, the row itself
    excluded: [Q, k] int64, nearest first, in blocks of `block` query rows
    (of at least CARD_BLOCK on the card)."""
    step = block if keys.device.type == "cpu" else max(block, CARD_BLOCK)
    out = np.empty((len(query_ids), k), np.int64)
    for s in range(0, len(query_ids), step):
        ids = query_ids[s:s + step]
        out[s:s + len(ids)] = knn_topk(keys.index_select(0, ids), ids, keys,
                                       k).cpu().numpy()
    return out


def generate_altkeys(tables: Sequence[np.ndarray],
                     workload_freq: Optional[Sequence[np.ndarray]] = None,
                     n_neighbors: int = 10, block: int = 2048,
                     device=None) -> List[np.ndarray]:
    """Per-table uint32 alt keys of the tables' rows [n_t, D] float32:
    each row's nearest neighbour among all tables' rows, or, with
    `workload_freq` (per-table [n_t] access counts, the rankedWorkload.csv
    equivalent), its most accessed one among the `n_neighbors` nearest
    (ties: the nearer)."""
    sizes = [t.shape[0] for t in tables]
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    allrows = np.concatenate([np.asarray(t, np.float32) for t in tables])
    neigh = _topk_neighbors_blocked(allrows, n_neighbors, block, device)
    freq_all = None if workload_freq is None else np.concatenate(
        [np.asarray(f, np.float64) for f in workload_freq])
    alt_all = pick_altkeys(neigh, sizes, freq_all)
    return [alt_all[offsets[t]:offsets[t + 1]] for t in range(len(tables))]


def pick_altkeys(neigh: np.ndarray, sizes: Sequence[int],
                 freq_all: Optional[np.ndarray] = None) -> np.ndarray:
    """[Q, k] neighbours (global rows over tables of `sizes` rows, nearest
    first) -> [Q] uint32 alt keys: the nearest, or with `freq_all` (a count
    for each global row) the most accessed (ties: the nearer).  ValueError
    where a picked row's key would wrap a uint32 (`cache/tiers.py::
    altkey_encode`)."""
    if freq_all is not None:
        picked = neigh[np.arange(len(neigh)),
                       np.argmax(freq_all[neigh], axis=1)]
    else:
        picked = neigh[:, 0]
    # global row id -> (table, row) -> altKey = (t+1) + 100*row
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    tbl_of = np.searchsorted(offsets, picked, side="right") - 1
    return altkey_encode(tbl_of, picked - offsets[tbl_of]).astype(np.uint32)


def altkey_rows(alts: np.ndarray, sizes: Sequence[int]) -> np.ndarray:
    """uint32 alt keys -> the global rows they name over tables of `sizes`
    rows, -1 where a key names no row."""
    a = np.asarray(alts, np.int64)
    tbl, row = a % 100 - 1, a // 100
    n = np.asarray(sizes, np.int64)
    ok = (tbl >= 0) & (tbl < len(n))
    t = np.where(ok, tbl, 0)
    ok &= row < n[t]
    offsets = np.concatenate([[0], np.cumsum(n)])
    return np.where(ok, offsets[t] + row, -1)


def write_altkeys_binary(alt_tables: Sequence[np.ndarray], out_dir: str
                         ) -> List[str]:
    """Big-endian uint32 per row (convert_altkeys_to_binary.py:27-50)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for t, alts in enumerate(alt_tables):
        p = os.path.join(out_dir, f"alt-keys-{t + 1}.bin")
        np.asarray(alts, ">u4").tofile(p)
        paths.append(p)
    return paths


def workload_frequencies(trace_dir: str, table_sizes: Sequence[int]
                         ) -> List[np.ndarray]:
    """Per-row access counts from a recorded workload trace
    (`utils/trace.py::WorkloadTracer`'s files; ≙ rankedWorkload.csv)."""
    out = []
    for t, n in enumerate(table_sizes):
        f = np.zeros(n, np.int64)
        p = os.path.join(trace_dir, f"trace-table-{t + 1}.csv")
        if os.path.exists(p):
            with open(p) as fh:
                for line in fh:
                    r = int(line)
                    if r < n:
                        f[r] += 1
        out.append(f)
    return out
