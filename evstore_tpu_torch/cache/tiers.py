"""The host tiers of EVStore: C1, C2 (mixed precision) and C3 (alt keys).

Port of `evstore_tpu/cache/tiers.py`, which follows the reference's native
engine (mixed_precs_caching/cache_manager.cpp, evlfu_{4,8,16,32}.cpp,
aprx_embedding.cpp) request by request:

- C1: EvLFU at `main_precision` (32/16/8/4), the hot tier;
- C2: EvLFU at `secondary_precision`, probed first; it takes double misses
  by the reference's split (evlfu_8.cpp:570-601): once C1 is full and the
  group's agg_hit is below `high_agghit_threshold` (23), C1 and C2 split
  the double misses by index parity; at 23 or more C2 takes them all;
- C3: key -> alt key (tableId + 100 rowId, tables numbered from 1,
  convert_altkeys_to_binary.py:50), the key's precomputed nearest
  neighbour; on a double miss the alt key probes C1 and then C2
  (evlfu_8.cpp:474-490) and counts as a hit.  Eviction is FIFO or second
  chance (aprx_embedding.cpp:360-388); keys evicted from C1 and C2 queue
  up and are inserted `c3_io_batch` at a time (aprx_embedding.hpp:30).

Tiers hold rows encoded at their precision and decode on a hit, as the
reference's char buffers do (evlfu_8.cpp:370-378).  Everything here is
host code on numpy arrays; `run_inference` ships the rows to the card.

`AltKeyResolver` holds the alt keys of every row, from arrays or from the
reference's big-endian `alt-keys-<t>.bin` files; `build_cache` hands its
`.tables` to the tier engine, and the Python `TieredCache` calls it per
batch of evicted keys.  `make_cache_from_policy` gives the reference's
single-tier baselines (`--cache-algo evlfu|lfu|lru`), LFU and LRU behind
`SimpleCacheFrontend`.

Departures of the JAX package from the reference, kept here: when C1 is
full, agg < 23 and an odd-index double miss is also a C3 hit, the
reference queues a file read whose result it discards; this skips it, with
the same visible behaviour.  The approximate-embedding short-circuit's
first stand-in row is drawn from `numpy.random.default_rng(0)`, as the JAX
class draws it, so the rows agree with the JAX package's.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from evstore_tpu_torch.cache.policy import EvLFU, LFU, LRU
from evstore_tpu_torch.cache.storage import (StorageManager, _decode_rows,
                                             encode_rows)
from evstore_tpu_torch.config import CacheConfig

Key = Tuple[int, int]


# the first row whose alt key wraps a uint32: (t + 1) + 100 row < 2^32
ALTKEY_ROW_LIMIT = 42_949_672


def altkey_encode(table: int, row: int) -> int:
    """altKey = tableId + 100 rowId, tableId from 1
    (convert_altkeys_to_binary.py:50, aprx_embedding.cpp:243-268); `table`
    and `row` ints or arrays.  ValueError for a row at or above
    `ALTKEY_ROW_LIMIT`, whose key would wrap the uint32 the tables hold."""
    if np.any(np.asarray(row) >= ALTKEY_ROW_LIMIT):
        raise ValueError(f"row {int(np.max(row))} has no alt key: "
                         f"(t + 1) + 100 row wraps a uint32 from row "
                         f"{ALTKEY_ROW_LIMIT}")
    return (table + 1) + 100 * row


def altkey_decode(alt: int) -> Key:
    return (alt % 100 - 1, alt // 100)


class AltKeyCache:
    """C3: key -> [alt_key, recency flag], FIFO or second-chance eviction,
    batched insertion (aprx_embedding.cpp)."""

    def __init__(self, capacity: int, eviction: str = "recency",
                 io_batch: int = 50):
        self.cap = int(capacity)
        self.eviction = eviction
        self.io_batch = int(io_batch)
        self.od: OrderedDict = OrderedDict()  # key -> [alt_key, recency]
        self.pending: List[Key] = []
        self.n_hits = 0

    def __len__(self):
        return len(self.od)

    def get_altkey(self, key: Key) -> Optional[int]:
        ev = self.od.get(key)
        return None if ev is None else ev[0]

    def set_recency(self, key: Key):
        ev = self.od.get(key)
        if ev is not None:
            ev[1] = True

    def _evict_one(self):
        if self.eviction == "recency":
            # second chance: a flagged entry loses its flag and goes back
            while True:
                key, ev = self.od.popitem(last=False)
                if ev[1]:
                    ev[1] = False
                    self.od[key] = ev
                else:
                    return key
        key, _ = self.od.popitem(last=False)
        return key

    def insert(self, key: Key, alt_key: int):
        if key in self.od:
            self.od[key][0] = alt_key
            return
        if len(self.od) >= self.cap:
            self._evict_one()
        self.od[key] = [alt_key, False]

    def _insert_batch(self, batch: List[Key], resolver):
        for k, alt in zip(batch, resolver(batch)):
            if alt is not None:
                self.insert(k, int(alt))

    def queue_keys(self, keys: Sequence[Key], resolver):
        """Evicted C1/C2 keys queue up; each `io_batch` of them is resolved
        to alt keys (the reference's alt-key file reader thread,
        aprx_embedding.cpp:36-102) and inserted."""
        self.pending.extend(keys)
        while len(self.pending) >= self.io_batch:
            batch, self.pending = (self.pending[:self.io_batch],
                                   self.pending[self.io_batch:])
            self._insert_batch(batch, resolver)

    def flush_pending(self, resolver):
        if self.pending:
            batch, self.pending = self.pending, []
            self._insert_batch(batch, resolver)


class AltKeyResolver:
    """The per-table neighbour arrays (the offline kNN product, SURVEY.md
    §3.5): `tables[t][r]` is the alt key, `altkey_encode(t', r')`, of the
    neighbour (t', r') of row r of table t.  Built from arrays, or read
    from the big-endian uint32 files `alt-keys-<t + 1>.bin` in `bin_dir`
    (convert_altkeys_to_binary.py)."""

    def __init__(self, neighbor_rows: Optional[Sequence[np.ndarray]] = None,
                 bin_dir: Optional[str] = None,
                 table_sizes: Optional[Sequence[int]] = None):
        if neighbor_rows is not None:
            self.tables = [np.asarray(t, np.int64) for t in neighbor_rows]
        else:
            self.tables = [
                np.fromfile(os.path.join(bin_dir, f"alt-keys-{t + 1}.bin"),
                            dtype=">u4").astype(np.int64)
                for t in range(len(table_sizes))]

    def __call__(self, keys: Sequence[Key]) -> List[Optional[int]]:
        """The alt key of each (table, row) key; None past the table's
        end."""
        out = []
        for t, r in keys:
            tab = self.tables[t]
            out.append(int(tab[r]) if r < len(tab) else None)
        return out


def write_altkeys_binary(alt_tables: Sequence[np.ndarray],
                         out_dir: str) -> List[str]:
    """Write the alt keys as `alt-keys-<t + 1>.bin` files, big-endian
    uint32 (convert_altkeys_to_binary.py:27-50; the JAX package's
    `tools/gen_altkeys.py` writes them the same way), which
    `AltKeyResolver(bin_dir=...)` reads."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for t, alts in enumerate(alt_tables):
        p = os.path.join(out_dir, f"alt-keys-{t + 1}.bin")
        np.asarray(alts, ">u4").tofile(p)
        paths.append(p)
    return paths


class TieredCache:
    """The reference's cache_manager: 1, 2 or 3 tiers over a storage
    backend, one request group at a time."""

    def __init__(self, cfg: CacheConfig, storage: StorageManager,
                 n_tables: int = 26, dim: int = 36,
                 altkey_resolver: Optional[AltKeyResolver] = None):
        self.cfg = cfg
        self.storage = storage
        self.n_tables = n_tables
        self.dim = dim
        c1_cap, c2_cap, c3_cap = cfg.tier_capacities()
        self.c1 = EvLFU(c1_cap, n_tables, cfg.flush_rate,
                        cfg.perfect_item_cap)
        self.c2 = (EvLFU(c2_cap, n_tables, cfg.flush_rate,
                         cfg.perfect_item_cap)
                   if cfg.n_caching_layers >= 2 else None)
        self.c3 = (AltKeyCache(c3_cap, cfg.c3_eviction, cfg.c3_io_batch)
                   if cfg.n_caching_layers >= 3 else None)
        self.altkey_resolver = altkey_resolver
        self.p1 = cfg.main_precision
        self.p2 = cfg.secondary_precision
        # counters (cache_manager.cpp:59,262-290)
        self.n_requests = 0
        self.n_perfect = 0
        self.c3_hits = 0
        # the stand-in rows of the approximate-embedding short-circuit, the
        # JAX class's generator and seed
        self._rng = np.random.default_rng(0)

    # ------------------------------------------------------------- helpers

    def _enc(self, rows: np.ndarray, precision: int) -> List[np.ndarray]:
        raw = encode_rows(np.atleast_2d(rows), precision)
        return [raw[i] for i in range(raw.shape[0])]

    def _dec(self, raw: np.ndarray, precision: int) -> np.ndarray:
        return _decode_rows(raw[None] if raw.ndim == 1 else raw,
                            precision, self.dim)[0]

    def _fetch(self, keys: Sequence[Key]) -> np.ndarray:
        return self.storage.get_batch(keys)

    def _drain_to_c3(self, tier: EvLFU):
        evicted = tier.drain_evicted()
        if self.c3 is not None and self.altkey_resolver is not None \
                and evicted:
            self.c3.queue_keys(evicted, self.altkey_resolver)

    # ---------------------------------------------------------- C1-only path

    def _request_c1(self, keys: List[Key]
                    ) -> Tuple[np.ndarray, List[bool], int]:
        """One tier of EvLFU (EvLFU_C1.request_to_ev_lfu, evlfu_8
        request_to_ev_lfu:798-868), with the approximate-embedding
        short-circuit (EvLFU_C1.py:122-152)."""
        hits, agg = self.c1.probe_group(keys)
        thres = self.cfg.approx_emb_threshold
        if thres > 0 and agg >= thres:
            # the misses get a stand-in row, the previous hit's or, before
            # any hit, a random one; they count as hits and are not inserted
            out = np.empty((len(keys), self.dim), np.float32)
            stand_in = self._rng.uniform(-0.09, 0.09,
                                         self.dim).astype(np.float32)
            for i, (k, h) in enumerate(zip(keys, hits)):
                if h:
                    v = self.c1.update_agg_hit(k, agg)
                    row = self._dec(v, self.p1) if v is not None \
                        else stand_in
                    stand_in = row
                    out[i] = row
                else:
                    out[i] = stand_in
            self.c1.n_requests += 1
            hits = [True] * len(keys)
            agg = len(keys)
            self.c1.n_perfect = len(self.c1.buckets[self.c1.n_tables])
            self.c1.n_perfect_hits += 1
            self._drain_to_c3(self.c1)
            return out, hits, agg
        miss_keys = [k for k, h in zip(keys, hits) if not h]
        missing = (self._enc(self._fetch(miss_keys), self.p1)
                   if miss_keys else [])
        vals = self.c1.finish_group(
            keys, hits, agg, missing,
            fetch_one=lambda k: self._enc(self._fetch([k]), self.p1)[0])
        out = _decode_rows(np.stack(vals), self.p1, self.dim)
        self._drain_to_c3(self.c1)
        return out, hits, agg

    # ------------------------------------------------------- C1+C2(+C3) path

    def _request_tiered(self, keys: List[Key]
                        ) -> Tuple[np.ndarray, List[bool], int]:
        """request_to_c1_c2 and request_to_c1_c2_c3 (evlfu_8.cpp:492-868)."""
        T = self.n_tables
        c2_hits, c2_agg = self.c2.probe_group(keys)
        c1_hits = [False] * T
        c3_vals: Dict[int, np.ndarray] = {}
        agg = c2_agg
        c2_update = [True] * T
        c2_insert = [False] * T
        c1_vals: Dict[int, np.ndarray] = {}

        self.c1.n_lookups += T
        self.c1.n_requests += 1
        for i, k in enumerate(keys):
            ev = self.c1.vals.get(k)
            if ev is not None:
                c1_hits[i] = True
                self.c1.n_hits += 1
                c1_vals[i] = ev[0]
                c2_update[i] = False
                if not c2_hits[i]:
                    agg += 1
            elif not c2_hits[i]:
                # a double miss asks C3 (evlfu_8.cpp:531-556)
                alt = self.c3.get_altkey(k) if self.c3 is not None else None
                v = None
                if alt is not None:
                    ak = altkey_decode(alt)
                    aev = self.c1.vals.get(ak)
                    if aev is not None:
                        v = self._dec(aev[0], self.p1)
                    else:
                        aev2 = self.c2.vals.get(ak)
                        if aev2 is not None:
                            v = self._dec(aev2[0], self.p2)
                if v is not None:
                    self.c3.set_recency(k)
                    self.c3_hits += 1
                    agg += 1
                    c1_hits[i] = True         # piggyback (agg_hit -1 marker)
                    c3_vals[i] = v
                    c2_insert[i] = False
                    c2_update[i] = False
                else:
                    c2_insert[i] = True
                    c2_update[i] = False

        c1_fetch_idx: List[int] = []
        if len(self.c1) >= self.c1.cap:
            if agg < self.cfg.high_agghit_threshold:
                # split the double misses by parity (evlfu_8.cpp:570-588)
                for i in range(T):
                    if not c2_hits[i] and not c1_hits[i]:
                        c2_update[i] = False
                        if i % 2 == 1:
                            c1_fetch_idx.append(i)
                            c2_insert[i] = False
            # at agg >= threshold C2 inserts every double miss
        else:
            # C1 not full: C1 takes every C1 miss; C2 stands down
            for i in range(T):
                if not c1_hits[i]:
                    c1_fetch_idx.append(i)
            c2_insert = [False] * T
            c2_update = [False] * T
            agg = sum(1 for i in range(T)
                      if c1_hits[i] and i not in c3_vals)

        out = np.zeros((T, self.dim), np.float32)

        # C2's phase 2 (evlfu_4 phase_2_get_and_insert_missing_values): one
        # fetch for the inserts, applied with the updates in table order; the
        # order sets the buckets' FIFO state, as in the native engine
        c2_ins_keys = [keys[i] for i in range(T) if c2_insert[i]]
        enc2 = (self._enc(self._fetch(c2_ins_keys), self.p2)
                if c2_ins_keys else [])
        j = 0
        for i in range(T):
            if c2_insert[i]:
                self.c2.set(keys[i], enc2[j], agg)
                out[i] = self._dec(enc2[j], self.p2)
                j += 1
            elif c2_update[i]:
                v = self.c2.update_agg_hit(keys[i], agg)
                if v is None:
                    v = self._enc(self._fetch([keys[i]]), self.p2)[0]
                    self.c2.set(keys[i], v, agg)
                out[i] = self._dec(v, self.p2)
        self._drain_to_c3(self.c2)

        # C1's fetch and merge (evlfu_8.cpp:623-652)
        if c1_fetch_idx:
            fetched = self._fetch([keys[i] for i in c1_fetch_idx])
            enc1 = self._enc(fetched, self.p1)
            for j, i in enumerate(c1_fetch_idx):
                self.c1.set(keys[i], enc1[j], agg)
                out[i] = self._dec(enc1[j], self.p1)
        for i in range(T):
            if c1_hits[i]:
                if i in c3_vals:
                    out[i] = c3_vals[i]   # a C3 hit updates no agg_hit
                else:
                    self.c1.update_agg_hit(keys[i], agg)
                    out[i] = self._dec(c1_vals[i], self.p1)
        self._drain_to_c3(self.c1)

        if agg == T:
            self.c1.n_perfect = len(self.c1.buckets[T])
        record_hit = [c1_hits[i] or c2_hits[i] for i in range(T)]
        return out, record_hit, agg

    # --------------------------------------------------------------- public

    def request(self, group_row_ids: Sequence[int]
                ) -> Tuple[np.ndarray, List[bool], int]:
        """One request, one row id per table -> (rows [T, dim] float32,
        per-table hit flags, agg_hit)."""
        keys = [(t, int(r)) for t, r in enumerate(group_row_ids)]
        self.n_requests += 1
        if self.c2 is None:
            rows, hits, agg = self._request_c1(keys)
        else:
            rows, hits, agg = self._request_tiered(keys)
        if agg == self.n_tables:
            self.n_perfect += 1
        return rows, hits, agg

    def request_batch(self, idx: np.ndarray) -> np.ndarray:
        """idx [B, T] -> rows [B, T, dim] float32, request by request."""
        B = idx.shape[0]
        out = np.empty((B, self.n_tables, self.dim), np.float32)
        for b in range(B):
            out[b], _, _ = self.request(idx[b])
        return out

    def stats(self) -> dict:
        s = {
            "requests": self.n_requests,
            "perfect_hits": self.n_perfect,
            "c1": self.c1.stats(),
        }
        if self.c2 is not None:
            s["c2"] = self.c2.stats()
        if self.c3 is not None:
            s["c3"] = {"size": len(self.c3), "hits": self.c3_hits}
        return s


def make_cache_from_policy(policy: str, capacity: int, n_tables: int,
                           storage: StorageManager, dim: int):
    """The reference's --cache-algo choice (dlrm_s_pytorch_C1.py:1295-1303)
    for the single-tier baselines: evlfu | lfu | lru."""
    if policy == "evlfu":
        cfg = CacheConfig(policy="evlfu", n_caching_layers=1,
                          total_size=capacity)
        return TieredCache(cfg, storage, n_tables, dim)
    if policy in ("lfu", "lru"):
        return SimpleCacheFrontend(
            LFU(capacity) if policy == "lfu" else LRU(capacity),
            storage, n_tables, dim)
    raise ValueError(f"unknown cache policy {policy!r}")


class SimpleCacheFrontend:
    """The LFU and LRU baselines (cache_algo/LFU.py request_to_lfu:69,
    LRU.py request_to_lru:38): per-key get and set, no groupability."""

    def __init__(self, cache, storage: StorageManager, n_tables: int,
                 dim: int):
        self.cache = cache
        self.storage = storage
        self.n_tables = n_tables
        self.dim = dim
        self.n_requests = 0
        self.n_perfect = 0

    def request(self, group_row_ids: Sequence[int]):
        keys = [(t, int(r)) for t, r in enumerate(group_row_ids)]
        out = np.empty((self.n_tables, self.dim), np.float32)
        hits = []
        for i, k in enumerate(keys):
            v = self.cache.get(k)
            if v is None:
                v = self.storage.get(k[0], k[1])
                self.cache.set(k, v)
                hits.append(False)
            else:
                hits.append(True)
            out[i] = v
        agg = sum(hits)
        self.n_requests += 1
        if agg == self.n_tables:
            self.n_perfect += 1
        return out, hits, agg

    def request_batch(self, idx: np.ndarray) -> np.ndarray:
        B = idx.shape[0]
        out = np.empty((B, self.n_tables, self.dim), np.float32)
        for b in range(B):
            out[b], _, _ = self.request(idx[b])
        return out

    def stats(self) -> dict:
        return {"requests": self.n_requests, "perfect_hits": self.n_perfect,
                "cache": self.cache.stats()}
