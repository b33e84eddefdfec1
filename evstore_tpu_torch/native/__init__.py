"""ctypes binding for the port's copy of the C++ tier engine.

Port of the serving part of `evstore_tpu/native/__init__.py`.  The engine
(`evstore_core.cpp`, this package's own copy, built by `build.py` into
`evstore_tpu_torch/_build/`) keeps the embedding tables in host RAM, runs
the cache tiers' policies and reads miss rows on a pthread pool.  The ABI is
batched: one call per batch of requests.

- `NativeTieredCache` holds the engine: its backing store (tables copied in
  or borrowed), its host tiers C2 (DRAM, secondary precision) and C3
  (alt keys) when `n_caching_layers` >= 2, and its reader pool.
  Its host lookup path, `request_batch`, serves whole batches from its
  tiers as float32 rows on the host.  Its store holds the tables in RAM
  (`load_tables`, `borrow_tables`) or reads the per-table .bin files
  (`open_table_files`).
- `NativeAssigner` is the slot-assignment front end of the device C1 cache
  (`cache/device_cache.py::NativeDeviceC1Cache`): per batch, one call runs
  the EvLFU policy over the cache's slots and returns the gather indices,
  the scatter list and the miss-row buffer.
- `NativeShardedCache` is the table-partitioned engine (`ShardedEngine`
  in the C++): the tables split round-robin over `n_workers` threads, each
  with its own C1 (and C2) share, over borrowed RAM tables; C1 and C1+C2
  only.
- The log-structured key-value store (`esv_kv_*`) is bound here and used by
  `cache/storage.py::LogKVStore`.
- The Criteo TSV parser (`parse_criteo_tsv_native`, `_range`, `_chunks`)
  feeds `data/criteo.py`.  Its errors reach the caller: nothing here falls
  back to the Python parser.

Not bound yet: the training assigner (`esv_assign_batch_train`,
`esv_fetch_rows`, `esv_assign_resident`).  Its C code is in the copy and
waits for its slice.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Sequence

import numpy as np

from evstore_tpu_torch.config import CacheConfig
from evstore_tpu_torch.native import build as _build

_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_U32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_U64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_F64 = np.ctypeslib.ndpointer(np.float64)
_P, _L, _I, _FL = ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_float
_S = ctypes.c_char_p

# name -> (restype, argtypes)
SIGNATURES = {
    # n_tables, dim, n_layers, c1/c2/c3 capacities, main and secondary
    # precision, flush rate, perfect cap, high-agg threshold, c3 eviction,
    # c3 io batch, reader threads, policy
    "esv_init": (_P, [_I, _I, _I, _L, _L, _L, _I, _I, _FL, _FL, _I, _I, _I,
                      _I, _I]),
    "esv_load_table_mem": (_I, [_P, _I, _F32, _L]),
    "esv_borrow_table_mem": (_I, [_P, _I, _F32, _L]),
    "esv_load_altkeys": (_I, [_P, _I, _U32, _L]),
    # handle, table, path, rows, precision
    "esv_open_table_file": (_I, [_P, _I, ctypes.c_char_p, _L, _I]),
    "esv_lookup_batch": (_L, [_P, _I64, _L, _F32]),
    "esv_stats": (None, [_P, _F64]),
    "esv_close": (None, [_P]),
    "esv_assign_init": (_P, [_P, _L, _FL, _FL]),
    # handle, idx, B, slots, scat_slots, scat_m, buf, maxM, &n_scat
    "esv_assign_batch": (_L, [_P, _I64, _L, _I32, _I32, _I32, _F32, _L,
                              ctypes.POINTER(_L)]),
    "esv_assign_stats": (None, [_P, _F64]),
    "esv_assign_close": (None, [_P]),
    # the log-structured key-value store: path, value bytes
    "esv_kv_open": (_P, [ctypes.c_char_p, _I]),
    "esv_kv_put_batch": (_I, [_P, _U64, _U8, _L]),
    "esv_kv_get_batch": (_L, [_P, _U64, _U8, _L]),
    "esv_kv_count": (_L, [_P]),
    "esv_kv_compact": (_L, [_P]),
    "esv_kv_close": (None, [_P]),
    # the sharded engine: workers, n_tables, dim, n_layers, c1/c2
    # capacities, main and secondary precision, flush rate, perfect cap,
    # high-agg threshold, policy
    "esv_shard_init": (_P, [_I, _I, _I, _I, _L, _L, _I, _I, _FL, _FL, _I,
                            _I]),
    "esv_shard_borrow_table": (_I, [_P, _I, _F32, _L]),
    "esv_shard_lookup_batch": (_L, [_P, _I64, _L, _F32]),
    "esv_shard_stats": (None, [_P, _F64]),
    "esv_shard_close": (None, [_P]),
    # the TSV parser: path, [start, end,] max rows, labels, dense, cats
    "esv_count_lines": (_L, [_S]),
    "esv_parse_criteo_tsv": (_L, [_S, _L, _I32, _I64, _I64]),
    "esv_parse_criteo_tsv_chunk": (_L, [_S, _L, _L, _I32, _I64, _I64,
                                        ctypes.POINTER(_L)]),
    "esv_parse_criteo_tsv_range": (_L, [_S, _L, _L, _L, _I32, _I64, _I64]),
}


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    """The engine library, built at first use and loaded with RTLD_LOCAL,
    so its `esv_*` symbols stay apart from any other copy in the process."""
    lib = ctypes.CDLL(_build.build())
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


_EVICTION = {"fifo": 1, "recency": 2}  # aprx_embedding.hpp:32
_POLICY = {"evlfu": 0, "lfu": 1, "lru": 2}


class NativeTieredCache:
    """The engine: backing store, host tiers and reader pool."""

    def __init__(self, cfg: CacheConfig, n_tables: int, dim: int,
                 n_reader_threads: int = 4):
        self.cfg = cfg
        self.n_tables = n_tables
        self.dim = dim
        self._assign_h = None
        self._lib = get_lib()
        c1, c2, c3 = cfg.tier_capacities()
        self._h = self._lib.esv_init(
            n_tables, dim, cfg.n_caching_layers, c1, c2, c3,
            cfg.main_precision, cfg.secondary_precision,
            cfg.flush_rate, cfg.perfect_item_cap,
            cfg.high_agghit_threshold, _EVICTION[cfg.c3_eviction],
            cfg.c3_io_batch, n_reader_threads, _POLICY[cfg.policy])
        if not self._h:
            raise ValueError(
                f"esv_init rejected config: n_tables={n_tables} (max 64), "
                f"dim={dim}; see evstore_core.cpp kMaxTables")

    def _handle(self):
        if self._h is None:
            raise RuntimeError("the tier engine is closed")
        return self._h

    def load_tables(self, tables: Sequence[np.ndarray]):
        """Copy float32 [n, dim] tables into the engine's store."""
        for t, tab in enumerate(tables):
            tab = np.ascontiguousarray(tab, np.float32)
            rc = self._lib.esv_load_table_mem(self._handle(), t, tab,
                                              tab.shape[0])
            if rc != 0:
                raise RuntimeError(f"esv_load_table_mem({t}) -> {rc}")
        return self

    def borrow_tables(self, tables: Sequence[np.ndarray]):
        """Zero-copy store: the engine reads the caller's buffers, which
        must stay alive and contiguous; changes to them are seen by later
        fetches."""
        self._borrowed_refs = []
        for t, tab in enumerate(tables):
            tab = np.ascontiguousarray(tab, np.float32)
            self._borrowed_refs.append(tab)
            rc = self._lib.esv_borrow_table_mem(self._handle(), t, tab,
                                                tab.shape[0])
            if rc != 0:
                raise RuntimeError(f"esv_borrow_table_mem({t}) -> {rc}")
        return self

    def open_table_files(self, bin_dir: str, table_sizes: Sequence[int],
                         precision: int = 32):
        """File-backed store: the engine reads the rows of table t from
        `ev-table-<t + 1>.bin` in `bin_dir`, stored at `precision`."""
        for t, n in enumerate(table_sizes):
            p = os.path.join(bin_dir, f"ev-table-{t + 1}.bin").encode()
            rc = self._lib.esv_open_table_file(self._handle(), t, p, n,
                                               precision)
            if rc != 0:
                raise RuntimeError(f"esv_open_table_file({t}) -> {rc}")
        return self

    def load_altkeys(self, alt_tables: Sequence[np.ndarray]):
        """C3's alt-key tables: for each table, one alt key per row
        (`altkey_encode(t', r')` of its neighbour)."""
        for t, alts in enumerate(alt_tables):
            alts = np.ascontiguousarray(alts, np.uint32)
            rc = self._lib.esv_load_altkeys(self._handle(), t, alts,
                                            alts.shape[0])
            if rc != 0:
                raise RuntimeError(f"esv_load_altkeys({t}) -> {rc}")
        return self

    def request_batch(self, idx: np.ndarray) -> np.ndarray:
        """The host lookup path: idx [B, T] -> rows [B, T, D] float32, the
        engine's tiers and policy run over the batch's requests in order."""
        idx = np.ascontiguousarray(idx, np.int64)
        B = idx.shape[0]
        out = np.empty((B, self.n_tables, self.dim), np.float32)
        rc = self._lib.esv_lookup_batch(self._handle(), idx.reshape(-1), B,
                                        out.reshape(-1))
        if rc == -2:
            raise ValueError("esv_lookup_batch: row id out of [0, 2^40)")
        return out

    def request(self, group_row_ids):
        """One request group -> (rows [T, D], None, None), the shape of the
        Python tiers' `request`."""
        out = self.request_batch(np.asarray(group_row_ids, np.int64)[None])
        return out[0], None, None

    def stats(self) -> dict:
        s = np.zeros(8, np.float64)
        self._lib.esv_stats(self._handle(), s)
        out = {
            "requests": int(s[0]), "perfect_hits": int(s[1]),
            "c1": {"size": int(s[2]), "hit_rate": float(s[3])},
        }
        if self.cfg.n_caching_layers >= 2:
            out["c2"] = {"size": int(s[4]), "hit_rate": float(s[5])}
        if self.cfg.n_caching_layers >= 3:
            out["c3"] = {"size": int(s[6]), "hits": int(s[7])}
        return out

    def close(self):
        """Free the engine (and its assigner) and join its reader pool."""
        if self._h is not None:
            if self._assign_h is not None:
                self._lib.esv_assign_close(self._assign_h)
                self._assign_h = None
            self._lib.esv_close(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self.close()


class NativeAssigner:
    """Slot assignment for the device C1 cache: the EvLFU policy, the free
    list and the miss reads run in C++; Python gets, per batch, the gather
    indices, the scatter list and the miss-row buffer."""

    def __init__(self, engine: NativeTieredCache, capacity: int,
                 flush_rate: float = 0.3, perfect_item_cap: float = 0.95):
        self.engine = engine
        self.capacity = int(capacity)
        self.dim = engine.dim
        self.n_tables = engine.n_tables
        self._lib = engine._lib
        h = self._lib.esv_assign_init(engine._handle(), self.capacity,
                                      flush_rate, perfect_item_cap)
        if not h:
            raise ValueError("esv_assign_init rejected engine config")
        engine._assign_h = h     # the engine owns the teardown

    def _handle(self):
        if self.engine._assign_h is None:
            raise RuntimeError("the tier engine is closed")
        return self.engine._assign_h

    def assign_batch(self, idx: np.ndarray):
        """idx [B, T] -> (slots [B, T] i32, scat_slots [n] i32,
        scat_m [n] i32, buf [n_buf, D] f32).  `slots` index
        concat(cache [capacity], buf); cache slot scat_slots[i] takes buffer
        row scat_m[i].  The scatter's slots are unique."""
        idx = np.ascontiguousarray(idx, np.int64)
        B, T = idx.shape
        maxM = B * T
        slots = np.empty((B, T), np.int32)
        scat_slots = np.empty(maxM, np.int32)
        scat_m = np.empty(maxM, np.int32)
        buf = np.empty((maxM, self.dim), np.float32)
        n_scat = ctypes.c_long(0)
        n_buf = self._lib.esv_assign_batch(
            self._handle(), idx.reshape(-1), B, slots.reshape(-1),
            scat_slots, scat_m, buf.reshape(-1), maxM, ctypes.byref(n_scat))
        if n_buf == -2:
            raise ValueError("esv_assign_batch: row id out of [0, 2^40)")
        if n_buf < 0:
            raise RuntimeError("esv_assign_batch: buffer overflow")
        return (slots, scat_slots[:n_scat.value], scat_m[:n_scat.value],
                buf[:n_buf])

    def stats(self) -> dict:
        s = np.zeros(4, np.float64)
        self._lib.esv_assign_stats(self._handle(), s)
        return {"requests": int(s[0]), "perfect_hits": int(s[1]),
                "size": int(s[2]), "hit_rate": float(s[3])}


class NativeShardedCache:
    """The table-partitioned engine: table t belongs to worker t mod
    `n_workers`, which runs its own C1 (and C2) share of the capacities;
    per request the workers exchange the request's aggregate hit count
    through atomics.  At one worker it is the serial engine's trajectory
    exactly; at more, each shard's own capacity and eviction pool moves
    hit rates slightly.  C1 and C1+C2 only (alt keys cross shards), over
    borrowed in-RAM tables."""

    def __init__(self, cfg: CacheConfig, n_tables: int, dim: int,
                 n_workers: int = 2):
        if cfg.n_caching_layers > 2:
            raise ValueError("the sharded engine serves C1 and C1+C2 "
                             "only; C3's alt keys cross shards")
        self.cfg = cfg
        self.n_tables = n_tables
        self.dim = dim
        self.n_workers = n_workers
        self._lib = get_lib()
        c1, c2, _ = cfg.tier_capacities()
        self._h = self._lib.esv_shard_init(
            n_workers, n_tables, dim, cfg.n_caching_layers, c1, c2,
            cfg.main_precision, cfg.secondary_precision, cfg.flush_rate,
            cfg.perfect_item_cap, cfg.high_agghit_threshold,
            _POLICY[cfg.policy])
        if not self._h:
            raise ValueError(
                f"esv_shard_init rejected config: n_workers={n_workers} "
                f"(1 to n_tables), n_tables={n_tables} (max 64), dim={dim}")

    def _handle(self):
        if self._h is None:
            raise RuntimeError("the sharded engine is closed")
        return self._h

    def borrow_tables(self, tables: Sequence[np.ndarray]):
        """Zero-copy store over the caller's float32 [n, dim] tables, which
        must stay alive."""
        self._borrowed_refs = []
        for t, tab in enumerate(tables):
            tab = np.ascontiguousarray(tab, np.float32)
            self._borrowed_refs.append(tab)
            rc = self._lib.esv_shard_borrow_table(self._handle(), t, tab,
                                                  tab.shape[0])
            if rc != 0:
                raise RuntimeError(f"esv_shard_borrow_table({t}) -> {rc}")
        return self

    def request_batch(self, idx: np.ndarray) -> np.ndarray:
        """idx [B, T] -> rows [B, T, D] float32, as
        `NativeTieredCache.request_batch`."""
        idx = np.ascontiguousarray(idx, np.int64)
        B = idx.shape[0]
        out = np.empty((B, self.n_tables, self.dim), np.float32)
        rc = self._lib.esv_shard_lookup_batch(self._handle(),
                                              idx.reshape(-1), B,
                                              out.reshape(-1))
        if rc == -2:
            raise ValueError("esv_shard_lookup_batch: row id out of "
                             "[0, 2^40)")
        return out

    def stats(self) -> dict:
        s = np.zeros(6, np.float64)
        self._lib.esv_shard_stats(self._handle(), s)
        out = {"requests": int(s[0]), "perfect_hits": int(s[1]),
               "c1": {"size": int(s[2]), "hit_rate": float(s[3])}}
        if self.cfg.n_caching_layers >= 2:
            out["c2"] = {"size": int(s[4]), "hit_rate": float(s[5])}
        return out

    def close(self):
        """Free the engine and join its workers."""
        if self._h is not None:
            self._lib.esv_shard_close(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self.close()


# ------------------------------------------------------ Criteo TSV parser

_ROW_ARRAYS = ((np.int32, ()), (np.int64, (13,)), (np.int64, (26,)))


def _row_buffers(n: int):
    """(labels int32 [n], dense int64 [n, 13], cats int64 [n, 26])."""
    return tuple(np.empty((n, *shape), dt) for dt, shape in _ROW_ARRAYS)


def parse_criteo_tsv_native(path: str):
    """Parse a Criteo TSV (label, 13 ints, 26 hex categories a line; missing
    and negative dense values 0, missing categories 0; malformed lines
    skipped): -> (labels int32 [n], dense int64 [n, 13], cats int64
    [n, 26])."""
    lib = get_lib()
    n_lines = lib.esv_count_lines(path.encode())
    if n_lines < 0:
        raise FileNotFoundError(path)
    labels, dense, cats = _row_buffers(n_lines)
    n = lib.esv_parse_criteo_tsv(path.encode(), n_lines, labels,
                                 dense.reshape(-1), cats.reshape(-1))
    if n < 0:
        raise FileNotFoundError(path)
    return labels[:n], dense[:n], cats[:n]


def parse_criteo_tsv_range(path: str, start_offset: int, end_offset: int,
                           max_rows: int):
    """Parse the lines that start in the byte range [start_offset,
    end_offset), both line boundaries, at most `max_rows`: the worker's
    share of the parallel preprocessing.  -> (labels, dense, cats)."""
    labels, dense, cats = _row_buffers(max_rows)
    n = get_lib().esv_parse_criteo_tsv_range(
        path.encode(), start_offset, end_offset, max_rows, labels,
        dense.reshape(-1), cats.reshape(-1))
    if n < 0:
        raise FileNotFoundError(path)
    return labels[:n], dense[:n], cats[:n]


def parse_criteo_tsv_chunks(path: str, chunk_rows: int = 1_000_000):
    """(labels, dense, cats) chunks of up to `chunk_rows` rows, with memory
    bounded by the chunk."""
    lib = get_lib()
    offset = ctypes.c_long(0)
    labels, dense, cats = _row_buffers(chunk_rows)
    while True:
        n = lib.esv_parse_criteo_tsv_chunk(
            path.encode(), offset.value, chunk_rows, labels,
            dense.reshape(-1), cats.reshape(-1), ctypes.byref(offset))
        if n < 0:
            raise FileNotFoundError(path)
        if n == 0:
            return
        yield labels[:n].copy(), dense[:n].copy(), cats[:n].copy()
        if n < chunk_rows:
            return
