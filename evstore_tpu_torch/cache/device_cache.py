"""Device-resident C1 cache: EvLFU-managed rows living in the card's memory.

Port of `DeviceC1Cache` from `evstore_tpu/cache/device_cache.py`, at fp32.
The hot rows of all embedding tables live in ONE fixed-size [C, D] tensor on
the card, so device memory is bounded by the cache capacity, not the table
sizes.  The EvLFU policy runs on the host and maps keys to cache slots; the
host side (free list, pending and pinned slots, segments, the padded miss
buffer, NO_SLOT deferral, stats) is the JAX class's, line for line.

Per segment the device does two things:

1. copy the shipped miss rows into their slots (`index_copy_`; the slots
   come from a dict, so none repeats and the copy is deterministic);
2. gather every request's rows with the row-gather kernel
   (`ops/cuda_gather.py`): an index below C reads a cache slot, an index
   C + m reads row m of the miss buffer, so concat(cache, buffer) is never
   built.

Within a segment a row inserted this segment is gathered from the miss
buffer, never from its slot, so slots freed by evictions can be reused at
once; a slot that served a hit this segment is pinned until the segment is
applied.  `lookup_batch` returns the rows on the card, with no host round
trip.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

import numpy as np
import torch

from evstore_tpu_torch.cache.policy import EvLFU
from evstore_tpu_torch.cache.storage import StorageManager
from evstore_tpu_torch.config import CacheConfig
from evstore_tpu_torch.ops.cuda_gather import gather_rows
from evstore_tpu_torch.utils.device import resolve_device

Key = Tuple[int, int]


class DeviceC1Cache:
    """Device-resident EvLFU cache in front of a host backing store."""

    def __init__(self, cfg: CacheConfig, storage: StorageManager,
                 n_tables: int, dim: int, insert_bucket: int = 512,
                 device=None):
        if cfg.main_precision == 8:
            raise NotImplementedError(
                "the int8 C1 cache needs the int8 gather+dequant kernel "
                "(evstore_tpu/ops/pallas_gather.py::gather_rows_dequant_int8)"
                ", which is not ported yet; use main_precision=32")
        if cfg.main_precision != 32:
            raise ValueError("device cache supports fp32 or int8 rows")
        if cfg.total_size < n_tables:
            raise ValueError(f"capacity {cfg.total_size} < one request group "
                             f"({n_tables} rows)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.storage = storage
        self.n_tables = n_tables
        self.dim = dim
        self.capacity = cfg.total_size
        self.insert_bucket = insert_bucket
        self.precision = cfg.main_precision

        self._free: List[int] = list(range(self.capacity - 1, -1, -1))
        self._pending: List[int] = []     # freed this segment, maybe pinned
        self._pinned: Set[int] = set()    # slots gathered (as hits) this seg

        def _on_evict(_key, slot):
            if slot >= 0:               # NO_SLOT keys had no device residency
                self._pending.append(slot)

        self.policy = EvLFU(self.capacity, n_tables, cfg.flush_rate,
                            cfg.perfect_item_cap, on_evict=_on_evict)
        self.cache_values = torch.zeros((self.capacity, dim),
                                        dtype=torch.float32,
                                        device=self.device)
        self.n_requests = 0
        self.n_perfect = 0
        self.n_segments = 0
        self.bytes_shipped = 0

    # ----------------------------------------------------------- host side

    def _sweep_pending(self):
        """Move unpinned freed slots back to the free list."""
        still = []
        for s in self._pending:
            if s in self._pinned:
                still.append(s)
            else:
                self._free.append(s)
        self._pending = still

    def _apply_segment(self, seg_slots, ins_keys, scatter_map) -> torch.Tensor:
        slots = np.stack(seg_slots)
        M = len(ins_keys)
        bk = self.insert_bucket
        Mp = max(bk, ((M + bk - 1) // bk) * bk)
        buf = np.zeros((Mp, self.dim), np.float32)
        if M:
            buf[:M] = self.storage.get_batch(ins_keys)
        # the JAX class pads the scatter to Mp with dropped entries; here
        # only the real (slot, buffer row) pairs go to the card
        scat_slots = np.fromiter(scatter_map.keys(), np.int64,
                                 len(scatter_map))
        scat_m = np.fromiter(scatter_map.values(), np.int64,
                             len(scatter_map))
        self.bytes_shipped += Mp * self.dim * 4
        dev = self.device
        buf_d = torch.from_numpy(buf).to(dev)
        if len(scatter_map):
            self.cache_values.index_copy_(
                0, torch.from_numpy(scat_slots).to(dev),
                buf_d[torch.from_numpy(scat_m).to(dev)])
        out = gather_rows(self.cache_values, torch.from_numpy(slots).to(dev),
                          secondary=buf_d)
        self._pinned.clear()
        self._sweep_pending()
        self.n_segments += 1
        return out

    # --------------------------------------------------------------- public

    def lookup_batch(self, idx: np.ndarray) -> torch.Tensor:
        """[B, T] int -> [B, T, D] fp32 rows on the cache's device; updates
        cache state."""
        idx = np.asarray(idx)
        B, T = idx.shape
        C = self.capacity
        outputs: List[torch.Tensor] = []
        seg_slots: List[np.ndarray] = []
        ins_keys: List[Key] = []
        scatter_map: Dict[int, int] = {}      # slot -> last buffer row m
        seg_buf_idx: Dict[Key, int] = {}      # key -> C + m (this segment)

        NO_SLOT = -1

        def buffer_serve(key) -> int:
            """Ship this key's row in the segment buffer; return its gather
            index (C + m)."""
            m = len(ins_keys)
            ins_keys.append(key)
            seg_buf_idx[key] = C + m
            return C + m

        def take_slot():
            if not self._free:
                self._sweep_pending()
            return self._free.pop() if self._free else NO_SLOT

        def insert(key, agg) -> int:
            """policy.set (may evict, freeing slots), then take a slot.  If
            every free slot is pinned by earlier gathers this segment, the
            key lives policy-side with NO_SLOT (served from the buffer; a
            later hit re-attempts slot assignment)."""
            self.policy.set(key, NO_SLOT, agg)
            gidx = buffer_serve(key)
            slot = take_slot()
            if slot != NO_SLOT:
                self.policy.vals[key][0] = slot
                scatter_map[slot] = gidx - C
            return gidx

        for b in range(B):
            # keep segments healthy: recycle freed slots between requests
            if len(self._free) < T and seg_slots:
                avail = len(self._free) + sum(1 for s in self._pending
                                              if s not in self._pinned)
                if avail < T:
                    outputs.append(self._apply_segment(seg_slots, ins_keys,
                                                       scatter_map))
                    seg_slots, ins_keys = [], []
                    scatter_map, seg_buf_idx = {}, {}
            keys = [(t, int(idx[b, t])) for t in range(T)]
            hits, agg = self.policy.probe_group(keys)
            row_slots = np.empty((T,), np.int32)
            for t, (k, h) in enumerate(zip(keys, hits)):
                if h:
                    slot = self.policy.update_agg_hit(k, agg)
                    if slot is None:     # evicted earlier in this segment
                        row_slots[t] = insert(k, agg)
                    elif k in seg_buf_idx:
                        row_slots[t] = seg_buf_idx[k]   # inserted this seg
                    elif slot == NO_SLOT:
                        # device residency was deferred; serve from buffer
                        # and retry slot assignment
                        gidx = buffer_serve(k)
                        row_slots[t] = gidx
                        s2 = take_slot()
                        if s2 != NO_SLOT:
                            self.policy.vals[k][0] = s2
                            scatter_map[s2] = gidx - C
                    else:
                        self._pinned.add(slot)
                        row_slots[t] = slot
                else:
                    row_slots[t] = insert(k, agg)
            seg_slots.append(row_slots)
            self.policy.n_requests += 1
            self.n_requests += 1
            if agg == T:
                self.policy.n_perfect_hits += 1
                self.n_perfect += 1
                self.policy.n_perfect = len(self.policy.buckets[T])

        if seg_slots:
            outputs.append(self._apply_segment(seg_slots, ins_keys,
                                               scatter_map))
        return outputs[0] if len(outputs) == 1 else torch.cat(outputs, 0)

    def stats(self) -> dict:
        s = self.policy.stats()
        return {
            "requests": self.n_requests,
            "perfect_hits": self.n_perfect,
            "hit_rate": s["hit_rate"],
            "size": s["size"],
            "capacity": self.capacity,
            "segments": self.n_segments,
            "hbm_bytes": int(self.capacity * self.dim * 4),
            "bytes_shipped": self.bytes_shipped,
        }
