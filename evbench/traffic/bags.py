"""Bags of a length per table, the traffic of MLPerf's DLRM-DCNv2.

A batch's ids are [B, sum L_t]: table t's bag in its L_t consecutive
columns, in table order, no slot padded.  A bag's first id is drawn as
`streams.py` draws a table's one id (a bounded Zipf(alpha) rank through
the table's scatter); the other L_t - 1 ids are uniform over the table's
rows, as the recipe's `--multi_hot_distribution_type uniform` adds them to
the day's one id.  Dense features U[0, 1), labels 0 or 1 with equal odds.
Drawn in torch on the device from the seed, handed back as numpy arrays in
host memory.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from evbench.inputs import generator
from evbench.traffic import streams

CHUNK = 8           # batches drawn by one set of calls


def draw_bags(ids: Dict, sizes: Sequence[int], bag_sizes: Sequence[int],
              n: int, gen, scat, device) -> torch.Tensor:
    """[n, sum L_t] int32 ids of n requests."""
    if ids["distribution"] != "zipf_first_uniform_rest":
        raise ValueError(f"unknown bag distribution {ids['distribution']!r}")
    alpha = float(ids.get("zipf_alpha", 1.05))
    cols = []
    for t, (s, L) in enumerate(zip(sizes, bag_sizes)):
        raw = streams.zipf_ranks(gen, n, s, alpha, device)
        kind, p = scat[t]
        cols.append((p[raw] if kind == "perm" else (raw * p) % s)[:, None])
        if L > 1:
            cols.append(torch.randint(0, s, (n, L - 1), generator=gen,
                                      device=device))
    return torch.cat(cols, dim=1).int()


def make_bag_batches(mix: Dict, sizes: Sequence[int],
                     bag_sizes: Sequence[int], num_dense: int, seed: int,
                     n_batches: int, device, tag: str = "stream"
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """n_batches batches of the mix: (dense [N, B, num_dense] float32,
    idx [N, B, sum L_t] int32, labels [N, B] float32) in host memory; the
    same seed and n_batches give the same batches."""
    B, C = int(mix["batch_size"]), int(sum(bag_sizes))
    scat = streams.scatters(sizes, generator(seed, f"{tag}.scatter", device),
                            device)
    gen = generator(seed, tag, device)
    dense = np.empty((n_batches, B, num_dense), np.float32)
    idx = np.empty((n_batches, B, C), np.int32)
    labels = np.empty((n_batches, B), np.float32)
    for lo in range(0, n_batches, CHUNK):
        k = min(CHUNK, n_batches - lo)
        i = draw_bags(mix["ids"], sizes, bag_sizes, k * B, gen, scat, device)
        d = torch.rand((k * B, num_dense), generator=gen, device=device)
        y = torch.randint(0, 2, (k * B,), generator=gen, device=device)
        idx[lo:lo + k] = i.view(k, B, C).cpu().numpy()
        dense[lo:lo + k] = d.view(k, B, num_dense).cpu().numpy()
        labels[lo:lo + k] = y.view(k, B).float().cpu().numpy()
    return dense, idx, labels
