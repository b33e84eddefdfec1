"""Alt keys for the C3 tier.

Port of `AltKeyResolver` from `evstore_tpu/cache/tiers.py`, as far as the
device cache needs it.  C3 serves a key that missed C1 and C2 with the row
of an alternative key of the same table (EVStore's approximate embedding,
SURVEY.md §3.5).  The alt keys are an offline product: one neighbour row
per row, from a kNN over the trained tables (`tools/gen_altkeys` in the JAX
package).  `build_cache` hands the resolver's `.tables` to the tier engine
(`NativeDeviceC1Cache.load_altkeys`), which resolves them in C++.  The
reference's loader for its `alt-keys-<t>.bin` files, its per-key lookup,
the host `TieredCache` and the LFU/LRU baselines are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class AltKeyResolver:
    """Holds the per-table neighbour arrays: `tables[t][r]` is the alt row
    of row r of table t."""

    def __init__(self, neighbor_rows: Sequence[np.ndarray]):
        self.tables = [np.asarray(t, np.int64) for t in neighbor_rows]
