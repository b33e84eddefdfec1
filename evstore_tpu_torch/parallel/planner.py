"""Table-to-shard placement for the butterfly (table-wise sharded) mode.

Port of `evstore_tpu/parallel/planner.py`, numpy only, kept line for line
so that the same sizes and frequencies give the same order and imbalance.
The reference assigns tables to ranks as contiguous blocks
(dlrm_s_pytorch.py:352-365 get_my_slice); with Criteo's five orders of
magnitude of table-size skew one rank can own nearly all the rows.  This
planner packs per-table cost (rows by default, access frequency when
given) greedily, longest first (LPT), under the equal-slots-per-shard
constraint of the stacked [T_pad, N_max, D] layout (RecShard,
arXiv:2201.10095, does the statistical version).

The `order` plugs into `parallel/butterfly.py` (`stack_tables`,
`make_butterfly_train_step(table_order=...)`): shard s owns the tables
order[s*Tl:(s+1)*Tl], -1 marking a padded slot.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def plan_table_shards(table_sizes: Sequence[int], n_shards: int,
                      freqs: Optional[Sequence[float]] = None
                      ) -> Tuple[Tuple[int, ...], float]:
    """Balance per-shard cost; returns (order, imbalance).

    order: length T_pad (-1 = padded slot), shard-major.
    imbalance: max-shard-cost / mean-shard-cost (1.0 = perfect).
    """
    T = len(table_sizes)
    Tl = -(-T // n_shards)
    cost = np.asarray(freqs if freqs is not None else table_sizes,
                      np.float64)
    if cost.shape != (T,):
        raise ValueError(f"cost must have one entry per table ({T})")
    shards = [[] for _ in range(n_shards)]
    load = np.zeros(n_shards)
    for t in np.argsort(-cost, kind="stable"):
        cands = [s for s in range(n_shards) if len(shards[s]) < Tl]
        s = min(cands, key=lambda c: (load[c], c))
        shards[s].append(int(t))
        load[s] += cost[t]
    order = []
    for s in range(n_shards):
        order.extend(shards[s] + [-1] * (Tl - len(shards[s])))
    return tuple(order), float(load.max() / max(load.mean(), 1e-12))


def contiguous_order(num_tables: int, n_shards: int) -> Tuple[int, ...]:
    """The reference's contiguous block split, as an order (for A/B)."""
    Tl = -(-num_tables // n_shards)
    return tuple(list(range(num_tables))
                 + [-1] * (Tl * n_shards - num_tables))
