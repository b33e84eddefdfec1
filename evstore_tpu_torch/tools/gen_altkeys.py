"""Offline alternative-key generation for the C3 tier.

Port of `evstore_tpu/tools/gen_altkeys.py`.  Reference pipeline
(script/approximate_embedding/): cuML NearestNeighbors(n_neighbors=11,
euclidean) over all tables' rows concatenated (get_neighbors_GPU.ipynb),
then per row the neighbour with the highest workload frequency
(most_popular_neighbor.ipynb, frequencies from rankedWorkload.csv), packed
as big-endian uint32 alt keys, altKey = (table + 1) + 100 * row
(convert_altkeys_to_binary.py).

The kNN is blocked: per block of query rows the squared distances to every
row, ||a||² + ||b||² − 2abᵀ, from one `torch.addmm` (float32, TF32 off),
self masked, then `torch.topk`.  It runs on `device`: the card unless the
caller passes `device="cpu"`.  No TPU kernel computes it (the JAX package
jits it as XLA), so it is plain PyTorch.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from evstore_tpu_torch.utils.device import resolve_device


def _topk_neighbors_blocked(rows: np.ndarray, k: int, block: int = 2048,
                            device=None) -> np.ndarray:
    """[N, D] -> [N, k] neighbour indices (self excluded), nearest first."""
    dev = resolve_device(device)
    N = rows.shape[0]
    x = torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(dev)
    sq = torch.sum(x * x, dim=1)
    out = np.empty((N, k), np.int64)
    for s in range(0, N, block):
        e = min(s + block, N)
        q = x[s:e]
        # (||q||² + ||b||²) − 2 q·b, the JAX package's order of operations
        d = torch.addmm(sq[s:e, None] + sq[None, :], q, x.t(), alpha=-2.0)
        n = torch.arange(e - s, device=dev)
        d[n, s + n] = float("inf")
        out[s:e] = torch.topk(d, k, dim=1, largest=False).indices.cpu()
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

    if workload_freq is not None:
        freq_all = np.concatenate([np.asarray(f, np.float64)
                                   for f in workload_freq])
        choice = np.argmax(freq_all[neigh], axis=1)
        picked = neigh[np.arange(len(neigh)), choice]
    else:
        picked = neigh[:, 0]

    # global row id -> (table, row) -> altKey = (t+1) + 100*row
    tbl_of = np.searchsorted(offsets, picked, side="right") - 1
    row_of = picked - offsets[tbl_of]
    alt_all = ((tbl_of + 1) + 100 * row_of).astype(np.uint32)
    return [alt_all[offsets[t]:offsets[t + 1]] for t in range(len(tables))]


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
