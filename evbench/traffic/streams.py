"""The one generator every traffic mix is read by.

Frozen copies of the port's `data/synthetic.py` `zipf` and `grouped_zipf`
streams (`_sample_indices`, `random_batches`), drawn in torch on the
device from the seed instead of in numpy, so that set-up makes thousands
of batches in a fraction of a second:

- `zipf`: each table's ids independently, a bounded Zipf(alpha) rank by
  the continuous inverse CDF, in float64;
- `grouped_zipf`: one popularity rank a request over the largest table,
  taken modulo each table's size, and with probability `group_noise` a
  table's rank drawn again on its own (cache_algo/EvLFU_C1.py:97-161);
- a rank becomes an id through a table's own scatter: a random permutation
  for a table of at most 2^20 rows, r * p mod n (p the first odd number
  from 1,000,003 coprime to n) for a larger one;
- dense features U[0, 1), labels 0 or 1 with equal odds.

A mix's file (`traffic/<mix>.json`) gives the parameters under "ids" and
the batch size.  The batches come back as numpy arrays in host memory, as a
data loader hands them to the program; nothing is drawn once a window has
begun.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from evbench.inputs import generator

CHUNK = 64          # batches drawn by one set of calls
PERM_LIMIT = 1 << 20


def zipf_ranks(gen: torch.Generator, n: int, size: int, alpha: float,
               device) -> torch.Tensor:
    """n bounded Zipf(alpha) ranks in [0, size), int64."""
    if size <= 2:
        return torch.randint(0, size, (n,), generator=gen, device=device)
    a = alpha if abs(alpha - 1.0) >= 1e-6 else 1.0 + 1e-6
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    n_pow = float(size) ** (1.0 - a)
    r = ((n_pow - 1.0) * u + 1.0) ** (1.0 / (1.0 - a)) - 1.0
    return r.long().clamp_(0, size - 1)


def scatters(sizes: Sequence[int], gen: torch.Generator, device):
    """Per table: ("perm", permutation) or ("mul", p)."""
    out = []
    for s in sizes:
        if s <= PERM_LIMIT:
            out.append(("perm", torch.randperm(s, generator=gen,
                                               device=device)))
        else:
            p = 1_000_003
            while math.gcd(p, s) != 1:
                p += 2
            out.append(("mul", p))
    return out


def draw_ids(ids: Dict, sizes: Sequence[int], n: int, gen, scat,
             device) -> torch.Tensor:
    """[n, T] int32 ids of n requests."""
    dist = ids["distribution"]
    alpha = float(ids.get("zipf_alpha", 1.05))
    out = torch.empty((n, len(sizes)), dtype=torch.int32, device=device)
    shared = None
    if dist == "grouped_zipf":
        shared = zipf_ranks(gen, n, max(sizes), alpha, device)
    elif dist != "zipf":
        raise ValueError(f"unknown id distribution {dist!r}")
    noise = float(ids.get("group_noise", 0.0))
    for t, s in enumerate(sizes):
        if shared is not None:
            raw = shared % s
            if noise > 0.0:
                flip = torch.rand(n, generator=gen, device=device) < noise
                raw = torch.where(flip, zipf_ranks(gen, n, s, alpha, device),
                                  raw)
        else:
            raw = zipf_ranks(gen, n, s, alpha, device)
        kind, p = scat[t]
        out[:, t] = (p[raw] if kind == "perm" else (raw * p) % s).int()
    return out


def make_batches(mix: Dict, sizes: Sequence[int], num_dense: int, seed: int,
                 n_batches: int, device, tag: str = "stream"
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """n_batches batches of the mix: (dense [N, B, num_dense] float32,
    idx [N, B, T] int32, labels [N, B] float32) in host memory; the same
    seed and n_batches give the same batches."""
    B, T = int(mix["batch_size"]), len(sizes)
    scat = scatters(sizes, generator(seed, f"{tag}.scatter", device), device)
    gen = generator(seed, tag, device)
    dense = np.empty((n_batches, B, num_dense), np.float32)
    idx = np.empty((n_batches, B, T), np.int32)
    labels = np.empty((n_batches, B), np.float32)
    for lo in range(0, n_batches, CHUNK):
        k = min(CHUNK, n_batches - lo)
        i = draw_ids(mix["ids"], sizes, k * B, gen, scat, device)
        d = torch.rand((k * B, num_dense), generator=gen, device=device)
        y = torch.randint(0, 2, (k * B,), generator=gen, device=device)
        idx[lo:lo + k] = i.view(k, B, T).cpu().numpy()
        dense[lo:lo + k] = d.view(k, B, num_dense).cpu().numpy()
        labels[lo:lo + k] = y.view(k, B).float().cpu().numpy()
    return dense, idx, labels
