"""EvLFU, the groupability-aware cache policy of EVStore's C1 tier.

A copy of `EvLFU` from `evstore_tpu/cache/policy.py` (numpy-free host code),
kept here so the port imports nothing of the JAX package.  Semantics are the
reference's (cache_algo/EvLFU_C1.py): a cached key is valued by the
aggregate hit count of the request group it arrived with; 27 FIFO buckets;
eviction pops from the lowest non-empty bucket (the min pointer wraps past
the top to 1); when the perfect bucket holds perfect_item_cap of capacity,
flush_rate of capacity is evicted from it; a hit promotes the stored
agg_hit when the new one is larger.  `on_evict(key, value)` reports every
eviction.  The C3 tier's evicted-key log and the host tier's
`finish_group` are left out: nothing in the port reads them yet.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Tuple

Key = Tuple[int, int]


class EvLFU:
    """Groupability-aware LFU over request groups of `n_tables` keys."""

    def __init__(self, capacity: int, n_tables: int = 26,
                 flush_rate: float = 0.3, perfect_item_cap: float = 0.95,
                 on_evict=None):
        self.cap = int(capacity)
        self.n_tables = n_tables
        self.flush_rate = flush_rate
        self.max_perfect = int(self.cap * perfect_item_cap)
        self.vals: Dict[Key, list] = {}          # key -> [value, agg_hit]
        self.buckets: List[OrderedDict] = [OrderedDict()
                                           for _ in range(n_tables + 1)]
        self.min_agg = 0
        self.n_perfect = 0
        # stats
        self.n_requests = 0
        self.n_perfect_hits = 0
        self.n_hits = 0
        self.n_lookups = 0
        self.on_evict = on_evict                 # callback(key, value)

    def _evict_one(self) -> Key:
        while not self.buckets[self.min_agg]:
            self.min_agg += 1
            if self.min_agg > self.n_tables:
                self.min_agg = 1  # wrap (EvLFU_C1.py:52-54)
        key, _ = self.buckets[self.min_agg].popitem(last=False)
        if self.on_evict is not None:
            self.on_evict(key, self.vals[key][0])
        del self.vals[key]
        return key

    def set(self, key: Key, value, agg_hit: int) -> None:
        """Insert a new key (EvLFU_C1.py:32-63)."""
        if self.n_perfect >= self.max_perfect:
            # perfect-set flush: evict flush_rate of capacity from bucket N
            n_evict = int(self.flush_rate * self.cap) + 1
            perfect = self.buckets[self.n_tables]
            for _ in range(min(n_evict, len(perfect))):
                k, _ = perfect.popitem(last=False)
                if self.on_evict is not None:
                    self.on_evict(k, self.vals[k][0])
                del self.vals[k]
            self.n_perfect = len(perfect)
        elif len(self.vals) >= self.cap:
            self._evict_one()
        self.vals[key] = [value, agg_hit]
        self.buckets[agg_hit][key] = None
        if agg_hit < self.min_agg:
            self.min_agg = agg_hit

    def update_agg_hit(self, key: Key, agg_hit: int):
        """Promote on hit; returns the cached value or None
        (EvLFU_C1.py:65-78)."""
        ev = self.vals.get(key)
        if ev is None:
            return None
        if ev[1] < agg_hit:
            del self.buckets[ev[1]][key]
            self.buckets[agg_hit][key] = None
            ev[1] = agg_hit
        return ev[0]

    def probe_group(self, keys: List[Key]) -> Tuple[List[bool], int]:
        """Phase 1: membership of all group keys + agg_hit
        (EvLFU_C1.py:110-120)."""
        hits = [k in self.vals for k in keys]
        agg_hit = sum(hits)
        self.n_lookups += len(keys)
        self.n_hits += agg_hit
        return hits, agg_hit

    def stats(self) -> dict:
        return {
            "size": len(self.vals), "capacity": self.cap,
            "requests": self.n_requests, "perfect_hits": self.n_perfect_hits,
            "hit_rate": self.n_hits / max(self.n_lookups, 1),
        }
