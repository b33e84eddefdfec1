"""Cache admission and eviction policies: EvLFU, LFU, LRU.

A copy of `evstore_tpu/cache/policy.py` (host code free of JAX), kept here
so the port imports nothing of the JAX package.  Semantics are the
reference's:

- EvLFU (cache_algo/EvLFU_C1.py), the groupability-aware policy of C1 and
  C2: a cached key is valued by the aggregate hit count of the request
  group it arrived with; 27 FIFO buckets; eviction pops from the lowest
  non-empty bucket (the min pointer wraps past the top to 1); when the
  perfect bucket holds perfect_item_cap of capacity, flush_rate of
  capacity is evicted from it; a hit promotes the stored agg_hit when the
  new one is larger.  `on_evict(key, value)` reports every eviction, and
  `evicted` logs the keys for the C3 tier (`drain_evicted`).
- LFU (cache_algo/LFU.py): per-key frequency buckets.
- LRU (cache_algo/LRU.py): recency order.

Each bucket is an OrderedDict used as a FIFO set, so a miss costs O(1), not
O(cache) as the reference's lists do.  Keys are (table, row) tuples.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Hashable, List, Tuple

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
        self.evicted: List[Key] = []             # drained by the C3 tier
        self.on_evict = on_evict                 # callback(key, value)

    def __len__(self) -> int:
        return len(self.vals)

    def __contains__(self, key: Key) -> bool:
        return key in self.vals

    def _evict_one(self) -> Key:
        while not self.buckets[self.min_agg]:
            self.min_agg += 1
            if self.min_agg > self.n_tables:
                self.min_agg = 1  # wrap (EvLFU_C1.py:52-54)
        key, _ = self.buckets[self.min_agg].popitem(last=False)
        if self.on_evict is not None:
            self.on_evict(key, self.vals[key][0])
        del self.vals[key]
        self.evicted.append(key)
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
                self.evicted.append(k)
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

    def finish_group(self, keys: List[Key], hits: List[bool], agg_hit: int,
                     missing_values, fetch_one=None) -> List:
        """Phase 2: promote the hits, insert the misses; returns the group's
        values in key order (EvLFU_C1.py:134-161).  `fetch_one(key)` covers
        a probed hit that an earlier insert of the same group evicted (the
        reference reads it from storage again, EvLFU_C1.py:88-95)."""
        out = []
        mi = 0
        for k, hit in zip(keys, hits):
            if hit:
                v = self.update_agg_hit(k, agg_hit)
                if v is None:       # evicted by an earlier insert here
                    v = fetch_one(k) if fetch_one is not None else None
                    if v is not None:
                        self.set(k, v, agg_hit)
                out.append(v)
            else:
                v = missing_values[mi]
                mi += 1
                self.set(k, v, agg_hit)
                out.append(v)
        self.n_requests += 1
        if agg_hit == self.n_tables:
            self.n_perfect_hits += 1
            self.n_perfect = len(self.buckets[self.n_tables])
        return out

    def drain_evicted(self) -> List[Key]:
        out = self.evicted
        self.evicted = []
        return out

    def stats(self) -> dict:
        return {
            "size": len(self.vals), "capacity": self.cap,
            "requests": self.n_requests, "perfect_hits": self.n_perfect_hits,
            "hit_rate": self.n_hits / max(self.n_lookups, 1),
        }


class LFU:
    """Per-key LFU with frequency buckets (cache_algo/LFU.py)."""

    def __init__(self, capacity: int):
        self.cap = int(capacity)
        self.vals: Dict[Hashable, list] = {}     # key -> [value, freq]
        self.buckets: Dict[int, OrderedDict] = {1: OrderedDict()}
        self.min_freq = 1
        self.n_hits = 0
        self.n_lookups = 0
        self.evicted: List = []

    def __len__(self):
        return len(self.vals)

    def _touch(self, key):
        """Move `key` up one frequency bucket; counts no lookup (the caller
        decides whether the access is a user lookup)."""
        ev = self.vals[key]
        value, freq = ev
        del self.buckets[freq][key]
        nf = freq + 1
        self.buckets.setdefault(nf, OrderedDict())[key] = None
        ev[1] = nf
        if freq == self.min_freq and not self.buckets[freq]:
            self.min_freq = nf
        return value

    def get(self, key):
        self.n_lookups += 1
        if key not in self.vals:
            return None
        self.n_hits += 1
        return self._touch(key)

    def set(self, key, value):
        if key in self.vals:
            self.vals[key][0] = value
            self._touch(key)     # an internal touch, not a user lookup
            return
        if len(self.vals) >= self.cap:
            while not self.buckets.get(self.min_freq):
                self.min_freq += 1
            k, _ = self.buckets[self.min_freq].popitem(last=False)
            del self.vals[k]
            self.evicted.append(k)
        self.vals[key] = [value, 1]
        self.buckets.setdefault(1, OrderedDict())[key] = None
        self.min_freq = 1

    def stats(self) -> dict:
        return {"size": len(self.vals), "capacity": self.cap,
                "hit_rate": self.n_hits / max(self.n_lookups, 1)}


class LRU:
    """Least recently used first out (cache_algo/LRU.py)."""

    def __init__(self, capacity: int):
        self.cap = int(capacity)
        self.od: OrderedDict = OrderedDict()
        self.n_hits = 0
        self.n_lookups = 0
        self.evicted: List = []

    def __len__(self):
        return len(self.od)

    def get(self, key):
        self.n_lookups += 1
        if key not in self.od:
            return None
        self.n_hits += 1
        self.od.move_to_end(key)
        return self.od[key]

    def set(self, key, value):
        if key in self.od:
            self.od.move_to_end(key)
        elif len(self.od) >= self.cap:
            k, _ = self.od.popitem(last=False)
            self.evicted.append(k)
        self.od[key] = value

    def stats(self) -> dict:
        return {"size": len(self.od), "capacity": self.cap,
                "hit_rate": self.n_hits / max(self.n_lookups, 1)}
