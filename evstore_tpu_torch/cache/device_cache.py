"""Device-resident C1 cache: EvLFU-managed rows living in the card's memory.

Port of `DeviceC1Cache` and `NativeDeviceC1Cache` from
`evstore_tpu/cache/device_cache.py`, at fp32 and int8.  The hot rows of all
embedding tables live in ONE fixed-size [C, D] tensor on the card (float32,
or uint8 codes of the 8-bit codec at `main_precision=8`), so device memory
is bounded by the cache capacity, not the table sizes.  The EvLFU policy
runs on the host and maps keys to cache slots.

Per device apply the card does two things:

1. copy the shipped miss rows into their slots (`index_copy_`; the slots
   are unique, so the copy is deterministic);
2. gather every request's rows with the two-source gather kernel
   (`ops/cuda_gather.py`: `gather_rows` at fp32, `gather_rows_dequant_int8`
   at int8): an index below C reads a cache slot, an index C + m reads row
   m of the miss buffer, so concat(cache, buffer) is never built.

Within an apply a row inserted by it is gathered from the miss buffer,
never from its slot, so slots freed by evictions can be reused at once; a
slot that served a hit is pinned until the apply.  At int8 the host
quantises the padded miss buffer (`np_quantize_int8`) and ships the codes,
as the JAX package does.  `lookup_batch` returns float32 rows on the card,
with no host round trip.

- `DeviceC1Cache` runs the policy in Python, line for line the JAX class's
  (free list, pending and pinned slots, segments, the padded miss buffer,
  NO_SLOT deferral, stats), and applies once per segment.
- `NativeDeviceC1Cache` is the production configuration: the policy, the
  free list and the miss reads run in the C++ tier engine
  (`native/__init__.py::NativeAssigner`), one call per batch, and the card
  applies once per batch.  With `n_caching_layers` 2-3 the engine's host C2
  (DRAM, secondary precision) and C3 (alt keys) stand behind the device
  C1, and serve its misses without a store read.
- `ShardedDeviceC1Cache` shards the slots of the native cache over the
  ranks of a mesh (`parallel/mesh.py`): rank 0's engine plans each batch
  and broadcasts it, each rank applies its share, and one all-reduce
  combines the rows.
"""

from __future__ import annotations

import concurrent.futures
import time
from typing import Dict, Iterable, Iterator, List, Sequence, Set, Tuple

import numpy as np
import torch
import torch.distributed as dist

from evstore_tpu_torch.cache.policy import EvLFU
from evstore_tpu_torch.cache.storage import StorageManager
from evstore_tpu_torch.config import CacheConfig
from evstore_tpu_torch.models.embedding import check_ids
from evstore_tpu_torch.native import NativeAssigner, NativeTieredCache
from evstore_tpu_torch.ops.cuda_gather import (gather_rows,
                                               gather_rows_dequant_int8)
from evstore_tpu_torch.ops.quant import np_quantize_int8
from evstore_tpu_torch.utils.device import resolve_device

Key = Tuple[int, int]


def _check_precision(cfg: CacheConfig) -> None:
    if cfg.main_precision not in (32, 8):
        raise ValueError(f"device cache supports fp32 or int8 rows, got "
                         f"main_precision={cfg.main_precision}")


def _apply(cache_values: torch.Tensor, slots: np.ndarray,
           scat_slots: np.ndarray, scat_m: np.ndarray,
           buf: np.ndarray) -> torch.Tensor:
    """One device apply: cache[scat_slots] = buf[scat_m], then gather
    `slots` over (cache, buf).  buf is float32 rows, or uint8 codes for a
    uint8 cache.  The three index arrays cross in one int32 copy."""
    dev = cache_values.device
    n_s, n_c = slots.size, scat_slots.size
    ints = torch.from_numpy(np.concatenate(
        [slots.ravel(), scat_slots, scat_m]).astype(np.int32, copy=False)
    ).to(dev)
    buf_d = torch.from_numpy(buf).to(dev)
    if n_c:
        cache_values.index_copy_(0, ints[n_s:n_s + n_c].long(),
                                 buf_d[ints[n_s + n_c:].long()])
    slots_d = ints[:n_s].view(slots.shape)
    if cache_values.dtype == torch.uint8:
        return gather_rows_dequant_int8(cache_values, slots_d, buf_d)
    return gather_rows(cache_values, slots_d, secondary=buf_d)


def _pad(M: int, bucket: int) -> int:
    """Miss-buffer rows shipped for M misses: a multiple of `bucket`, at
    least one bucket (the JAX package's static shapes)."""
    return max(bucket, ((M + bucket - 1) // bucket) * bucket)


class DeviceC1Cache:
    """Device-resident EvLFU cache in front of a host backing store."""

    def __init__(self, cfg: CacheConfig, storage: StorageManager,
                 n_tables: int, dim: int, insert_bucket: int = 512,
                 device=None):
        _check_precision(cfg)
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
        self.cache_values = torch.zeros(
            (self.capacity, dim),
            dtype=torch.uint8 if self.precision == 8 else torch.float32,
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
        M = len(ins_keys)
        Mp = _pad(M, self.insert_bucket)
        buf = np.zeros((Mp, self.dim), np.float32)
        if M:
            buf[:M] = self.storage.get_batch(ins_keys)
        if self.precision == 8:
            buf = np_quantize_int8(buf)
        self.bytes_shipped += buf.nbytes
        # the JAX class pads the scatter to Mp with dropped entries; here
        # only the real (slot, buffer row) pairs go to the card
        n = len(scatter_map)
        out = _apply(self.cache_values, np.stack(seg_slots),
                     np.fromiter(scatter_map.keys(), np.int32, n),
                     np.fromiter(scatter_map.values(), np.int32, n), buf)
        self._pinned.clear()
        self._sweep_pending()
        self.n_segments += 1
        return out

    # --------------------------------------------------------------- public

    def lookup_batch(self, idx: np.ndarray) -> torch.Tensor:
        """[B, T] int -> [B, T, D] fp32 rows on the cache's device; updates
        cache state.  Raises ValueError for an id outside its table."""
        idx = np.asarray(idx)
        check_ids(idx, self.storage.table_sizes())
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
            "hbm_bytes": self.cache_values.nbytes,
            "bytes_shipped": self.bytes_shipped,
        }


class NativeDeviceC1Cache:
    """The device C1 cache with its policy, free list and miss reads in the
    C++ tier engine: per batch, one engine call gives (slots, scatter, miss
    buffer) and one apply runs on the card, its miss buffer padded to a
    multiple of `insert_bucket` rows.

    With `n_caching_layers` 1 the engine is only the backing store and its
    reader pool.  With 2 or 3 it also holds the host tiers C2 and C3, and
    the device C1 takes its share of the budget (`tier_capacities()[0]`).

    The host time of each batch is summed in `host_s`: `assign` (the engine
    call), `pack` (padding and quantising the miss buffer on the host),
    `wait` (the wait for the work already queued on the stream, such as the
    previous batch's forward) and `copy` (the host-to-device copies and the
    apply's launches).  A copy from pageable memory waits for the stream
    anyway; waiting just before it times that wait apart from the copy.
    The cache owns its engine: `close()` frees it."""

    def __init__(self, cfg: CacheConfig, n_tables: int, dim: int,
                 insert_bucket: int = 4096, n_reader_threads: int = 4,
                 device=None):
        _check_precision(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n_tables = n_tables
        self.dim = dim
        self.insert_bucket = insert_bucket
        self.precision = cfg.main_precision
        if cfg.n_caching_layers >= 2:
            # the hybrid stack: device C1 over the engine's host C2 (DRAM,
            # secondary precision) and C3 (alt keys); a true miss goes to C1
            # or C2 by the reference's rule (evlfu_8.cpp:724-736)
            self.engine = NativeTieredCache(cfg, n_tables, dim,
                                            n_reader_threads)
            self.capacity = cfg.tier_capacities()[0]
        else:
            # the engine is the store and reader pool only; its tiers idle
            self.engine = NativeTieredCache(
                CacheConfig(policy="evlfu", n_caching_layers=1,
                            total_size=1), n_tables, dim, n_reader_threads)
            self.capacity = cfg.total_size
        self.assigner = NativeAssigner(self.engine, self.capacity,
                                       cfg.flush_rate, cfg.perfect_item_cap)
        self.cache_values = torch.zeros(
            (self.capacity, dim),
            dtype=torch.uint8 if self.precision == 8 else torch.float32,
            device=self.device)
        self.bytes_shipped = 0
        self.host_s = {"assign": 0.0, "pack": 0.0, "wait": 0.0, "copy": 0.0}
        self._table_sizes: Sequence[int] = ()

    def load_tables(self, tables: Sequence[np.ndarray]):
        """Copy the float32 tables into the engine's store."""
        self.engine.load_tables(tables)
        self._table_sizes = [len(t) for t in tables]
        return self

    def open_table_files(self, bin_dir: str, table_sizes: Sequence[int],
                         precision: int = 32):
        """A file-backed store: the engine reads the rows of table t from
        `ev-table-<t + 1>.bin` in `bin_dir` (`NativeTieredCache.
        open_table_files`)."""
        self.engine.open_table_files(bin_dir, table_sizes, precision)
        self._table_sizes = list(table_sizes)
        return self

    def load_altkeys(self, alt_tables: Sequence[np.ndarray]):
        """C3's alt-key tables (the offline kNN product)."""
        self.engine.load_altkeys([np.asarray(a, np.uint32)
                                  for a in alt_tables])
        return self

    def _assign(self, idx: np.ndarray):
        t0 = time.perf_counter()
        out = self.assigner.assign_batch(idx)
        self.host_s["assign"] += time.perf_counter() - t0
        return out

    def _apply_assign(self, assign) -> torch.Tensor:
        slots, scat_slots, scat_m, buf = assign
        t0 = time.perf_counter()
        M = buf.shape[0]
        buf_p = np.zeros((_pad(M, self.insert_bucket), self.dim), np.float32)
        buf_p[:M] = buf
        if self.precision == 8:
            buf_p = np_quantize_int8(buf_p)
        self.bytes_shipped += buf_p.nbytes
        t1 = time.perf_counter()
        self.host_s["pack"] += t1 - t0
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        t2 = time.perf_counter()
        self.host_s["wait"] += t2 - t1
        # only the real (slot, buffer row) pairs go to the card, where the
        # JAX class pads them with dropped entries
        out = _apply(self.cache_values, slots, scat_slots, scat_m, buf_p)
        self.host_s["copy"] += time.perf_counter() - t2
        return out

    def _checked(self, idx) -> np.ndarray:
        idx = np.asarray(idx)
        check_ids(idx, self._table_sizes)
        return idx

    def lookup_batch(self, idx: np.ndarray) -> torch.Tensor:
        """[B, T] int -> [B, T, D] fp32 rows on the cache's device; updates
        cache state.  Raises ValueError for an id outside its table."""
        return self._apply_assign(self._assign(self._checked(idx)))

    def lookup_batches_pipelined(self, batches: Iterable
                                 ) -> Iterator[torch.Tensor]:
        """`lookup_batch` over `batches`, with the engine's assign for batch
        k+1 on a worker thread while batch k is packed and applied here.
        The policy order is unchanged: one worker, batches in order."""
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
            prev = None
            for idx in batches:
                fut = ex.submit(self._assign, self._checked(idx))
                if prev is not None:
                    yield self._apply_assign(prev.result())
                prev = fut
            if prev is not None:
                yield self._apply_assign(prev.result())

    def request_batch(self, idx: np.ndarray) -> np.ndarray:
        """`lookup_batch` with the rows brought back to the host."""
        return self.lookup_batch(idx).cpu().numpy()

    def stats(self) -> dict:
        s = self.assigner.stats()
        s.update({
            "capacity": self.capacity,
            "hbm_bytes": self.cache_values.nbytes,
            "bytes_shipped": self.bytes_shipped,
        })
        if self.cfg.n_caching_layers >= 2:
            es = self.engine.stats()
            for tier in ("c2", "c3"):
                if tier in es:
                    s[tier] = es[tier]
        return s

    def close(self):
        """Free the engine, its copy of the tables and its reader pool."""
        self.engine.close()


def broadcast_header(values, n: int, mesh) -> List[int]:
    """Rank 0's n ints (`values`; None on the other ranks) to every rank of
    the mesh, read back on the host: the sizes of a plan's parts."""
    head = torch.tensor(list(values) if values is not None else [0] * n,
                        dtype=torch.int64).to(mesh.device)
    dist.broadcast(head, src=0, group=mesh.group)
    return [int(v) for v in head.cpu()]


def broadcast_array(arr, shape, dtype: torch.dtype, mesh) -> torch.Tensor:
    """Rank 0's numpy array (None on the other ranks, which give its shape
    and dtype) on every rank's device."""
    if arr is not None:
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(mesh.device)
    else:
        t = torch.empty(shape, dtype=dtype, device=mesh.device)
    dist.broadcast(t, src=0, group=mesh.group)
    return t


class ShardedDeviceC1Cache:
    """The device C1 cache with its slots sharded over ranks: capacity C
    splits into C / n slots a rank, so it grows with the cards, while the
    policy stays one host trajectory.  Port of the JAX package's
    `ShardedDeviceC1Cache`, one process per rank.

    Rank 0 alone holds the tier engine and its `NativeAssigner` (the
    stores, C2 and C3 of the hybrid stack too).  Per batch every rank of
    the world calls `lookup_batch` with the same ids; rank 0 assigns and
    broadcasts a size header, then the gather slots with the scatter
    lists, then the miss rows padded to a multiple of `insert_bucket`
    (int8 codes at 8 bits).  Each rank writes the misses it owns into its
    `c_local` slots (`index_copy_`; a foreign entry goes to a scratch row
    past them) and reads the [B, T] rows with the two-source gather (K2 at
    fp32, K3 at int8) over [its slots | the miss rows]: its own slot s
    reads s - r0, a miss row (slot C + j) reads c_local + j on rank 0 of
    the cache axis only, any other slot -1, which gives a zero row.  One
    `all_reduce` over the cache axis then gives every rank the same rows,
    each the one rank's row plus zeros.  `axis` is "data", "model" or
    both (the default: every rank of the mesh, as in JAX); rows equal
    `NativeDeviceC1Cache`'s.  `stats()` is the assigner's on rank 0 (the
    other ranks have no policy and report the cache's sizes only), with
    `hbm_bytes` (the whole cache) and `hbm_bytes_per_chip` (a rank's
    slots)."""

    def __init__(self, cfg: CacheConfig, n_tables: int, dim: int, mesh,
                 axis=None, insert_bucket: int = 4096,
                 n_reader_threads: int = 4):
        _check_precision(cfg)
        self.mesh = mesh
        self.device = mesh.device
        self.cfg = cfg
        self.n_tables = n_tables
        self.dim = dim
        self.insert_bucket = insert_bucket
        self.precision = cfg.main_precision
        axes = ("data", "model") if axis is None else (
            (axis,) if isinstance(axis, str) else tuple(axis))
        if set(axes) == {"data", "model"}:
            self.group, n, me = mesh.group, mesh.world, mesh.rank
        elif axes == ("model",):
            self.group, n, me = mesh.model_group, mesh.n_model, mesh.m
        elif axes == ("data",):
            self.group, n, me = mesh.data_group, mesh.n_data, mesh.d
        else:
            raise ValueError(f"axis {axis!r}: data, model or both")
        self.capacity = (cfg.tier_capacities()[0] if cfg.n_caching_layers
                         >= 2 else cfg.total_size)
        if self.capacity % n:
            raise ValueError(f"capacity {self.capacity} must divide the "
                             f"{n}-chip cache axis")
        self.n_shards, self.shard = n, me
        self.c_local = self.capacity // n
        self.engine = self.assigner = None
        if dist.get_rank() == 0:
            eng_cfg = cfg if cfg.n_caching_layers >= 2 else CacheConfig(
                policy="evlfu", n_caching_layers=1, total_size=1)
            self.engine = NativeTieredCache(eng_cfg, n_tables, dim,
                                            n_reader_threads)
            self.assigner = NativeAssigner(self.engine, self.capacity,
                                           cfg.flush_rate,
                                           cfg.perfect_item_cap)
        dtype = torch.uint8 if self.precision == 8 else torch.float32
        # the rank's slots and one scratch row for foreign scatter entries
        self._store = torch.zeros((self.c_local + 1, dim), dtype=dtype,
                                  device=self.device)
        self.cache_values = self._store[:self.c_local]
        self.bytes_shipped = 0
        self.host_s = {"assign": 0.0, "pack": 0.0, "wait": 0.0, "copy": 0.0}
        self._table_sizes: Sequence[int] = ()

    def load_tables(self, tables: Sequence[np.ndarray]):
        """Copy the float32 tables into rank 0's engine (the other ranks
        keep only their sizes, to check ids)."""
        if self.engine is not None:
            self.engine.load_tables(tables)
        self._table_sizes = [len(t) for t in tables]
        return self

    def open_table_files(self, bin_dir: str, table_sizes: Sequence[int],
                         precision: int = 32):
        if self.engine is not None:
            self.engine.open_table_files(bin_dir, table_sizes, precision)
        self._table_sizes = list(table_sizes)
        return self

    def load_altkeys(self, alt_tables: Sequence[np.ndarray]):
        if self.engine is not None:
            self.engine.load_altkeys([np.asarray(a, np.uint32)
                                      for a in alt_tables])
        return self

    def _plan(self, idx: np.ndarray):
        """Rank 0 assigns and packs; every rank gets (slots [B, T],
        scatter slots, scatter rows, miss rows) on its device."""
        dev = self.device
        B, T = idx.shape
        t0 = time.perf_counter()
        head = ints = buf_p = None
        if self.assigner is not None:
            slots, scat_slots, scat_m, buf = self.assigner.assign_batch(idx)
            t1 = time.perf_counter()
            self.host_s["assign"] += t1 - t0
            M = buf.shape[0]
            buf_p = np.zeros((_pad(M, self.insert_bucket), self.dim),
                             np.float32)
            buf_p[:M] = buf
            if self.precision == 8:
                buf_p = np_quantize_int8(buf_p)
            head = (scat_slots.size, buf_p.shape[0])
            ints = np.concatenate([slots.ravel(), scat_slots,
                                   scat_m]).astype(np.int32, copy=False)
            self.host_s["pack"] += time.perf_counter() - t1
        t2 = time.perf_counter()
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        t3 = time.perf_counter()
        self.host_s["wait"] += t3 - t2
        n_c, Mp = broadcast_header(head, 2, self.mesh)
        ints = broadcast_array(ints, (B * T + 2 * n_c,), torch.int32,
                               self.mesh)
        pay = broadcast_array(buf_p, (Mp, self.dim), self._store.dtype,
                              self.mesh)
        self.bytes_shipped += pay.numel() * pay.element_size()
        return (ints[:B * T].view(B, T), ints[B * T:B * T + n_c],
                ints[B * T + n_c:], pay, t3)

    def lookup_batch(self, idx: np.ndarray) -> torch.Tensor:
        """[B, T] int -> [B, T, D] fp32 rows on every rank's device;
        collective over the world (every rank passes the same ids).
        Raises ValueError for an id outside its table."""
        idx = np.asarray(idx)
        check_ids(idx, self._table_sizes)
        slots, scat_slots, scat_m, pay, t0 = self._plan(idx)
        C, cl = self.capacity, self.c_local
        r0 = self.shard * cl
        # the misses this rank owns into its slots, the others into the
        # scratch row past them
        pos = scat_slots.long() - r0
        pos = torch.where((pos >= 0) & (pos < cl), pos, cl)
        self._store.index_copy_(0, pos, pay[scat_m.long()])
        s = slots.long()
        own = (s >= r0) & (s < r0 + cl)
        miss = (s >= C) & (self.shard == 0)
        gid = torch.where(own, s - r0, torch.where(miss, s - C + cl, -1))
        gid = gid.to(torch.int32)
        if self.precision == 8:
            rows = gather_rows_dequant_int8(self.cache_values, gid, pay)
        else:
            rows = gather_rows(self.cache_values, gid, secondary=pay)
        dist.all_reduce(rows, group=self.group)
        self.host_s["copy"] += time.perf_counter() - t0
        return rows

    def request_batch(self, idx: np.ndarray) -> np.ndarray:
        """`lookup_batch` with the rows brought back to the host."""
        return self.lookup_batch(idx).cpu().numpy()

    def stats(self) -> dict:
        s = self.assigner.stats() if self.assigner is not None else {}
        per = self.c_local * self.dim * self._store.element_size()
        s.update({
            "capacity": self.capacity,
            "hbm_bytes": per * self.n_shards,
            "hbm_bytes_per_chip": per,
            "bytes_shipped": self.bytes_shipped,
        })
        if self.engine is not None and self.cfg.n_caching_layers >= 2:
            es = self.engine.stats()
            for tier in ("c2", "c3"):
                if tier in es:
                    s[tier] = es[tier]
        return s

    def close(self):
        """Free rank 0's engine."""
        if self.engine is not None:
            self.engine.close()
