"""Embedding storage behind the cache tiers.

Port of `evstore_tpu/cache/storage.py` (the reference's emb_storage/): the
in-RAM store (`dummy`), per-table binary files read by seek and read
(`file`) or through mmap (`mmap`), SQLite with one blob per row
(`sqlite`), and a log-structured key-value store in the C++ engine
(`logkv`), behind the `StorageManager` facade.  Every backend answers
batched gets, `get_batch(keys) -> [K, D] float32`, and decodes on the host
with the numpy codecs of `ops/quant.py`.

The binary EV-table format (script/convert_ev_to_binary.py): one file
`ev-table-<t>.bin` per table, tables numbered from 1, rows in order, each
row at the store's precision: 4 bytes a value at 32 bits, 2 (the ushort
codec) at 16, 1 at 8, and two 4-bit codes a byte, high nibble first, at 4.

The `native` backend is the engine's own file mode
(`NativeTieredCache.open_table_files`); as in the JAX package, the facade
raises for it.
"""

from __future__ import annotations

import mmap as _mmap
import os
import sqlite3
from typing import List, Optional, Sequence, Tuple

import numpy as np

from evstore_tpu_torch.ops import quant as qlib

Key = Tuple[int, int]


def _decode_rows(buf: np.ndarray, precision: int, dim: int) -> np.ndarray:
    """Raw stored rows [K, bytes a row] -> float32 [K, dim]."""
    if precision == 32:
        return np.ascontiguousarray(buf).view(np.float32).reshape(-1, dim)
    if precision == 16:
        codes = np.ascontiguousarray(buf).view(np.uint16).reshape(-1, dim)
        return qlib.np_dequantize_ushort(codes)
    if precision == 8:
        return qlib.np_dequantize_int8(buf.reshape(-1, dim))
    if precision == 4:
        # two codes a byte, high nibble first
        packed = buf.reshape(-1, (dim + 1) // 2)
        codes = np.empty((packed.shape[0], 2 * packed.shape[1]), np.uint8)
        codes[:, 0::2] = (packed >> 4) & 0xF
        codes[:, 1::2] = packed & 0xF
        return qlib.np_dequantize_int4(codes[:, :dim])
    raise ValueError(f"unsupported precision {precision}")


def row_nbytes(precision: int, dim: int) -> int:
    if precision == 32:
        return dim * 4
    if precision == 16:
        return dim * 2
    if precision == 8:
        return dim
    if precision == 4:
        return (dim + 1) // 2
    raise ValueError(f"unsupported precision {precision}")


def encode_rows(rows: np.ndarray, precision: int) -> np.ndarray:
    """float32 [K, dim] -> raw bytes [K, row_nbytes] (the offline
    reduce_precision and convert_ev_to_binary pipeline)."""
    rows = np.asarray(rows, np.float32)
    if precision == 32:
        return rows.view(np.uint8).reshape(rows.shape[0], -1)
    if precision == 16:
        codes = qlib.np_quantize_ushort(rows)
        return codes.view(np.uint8).reshape(rows.shape[0], -1)
    if precision == 8:
        return qlib.np_quantize_int8(rows)
    if precision == 4:
        codes = qlib.np_quantize_int4(rows)
        if codes.shape[1] % 2:
            codes = np.concatenate(
                [codes, np.zeros((codes.shape[0], 1), np.uint8)], axis=1)
        return ((codes[:, 0::2] << 4) | codes[:, 1::2]).astype(np.uint8)
    raise ValueError(f"unsupported precision {precision}")


def table_path(bin_dir: str, table: int) -> str:
    """The file of table `table` (0-based): `ev-table-<table + 1>.bin`."""
    return os.path.join(bin_dir, f"ev-table-{table + 1}.bin")


def write_ev_tables_binary(tables: Sequence[np.ndarray], out_dir: str,
                           precision: int = 32) -> List[str]:
    """Write one .bin file per table (convert_ev_to_binary.py:32-56)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for t, tab in enumerate(tables):
        p = table_path(out_dir, t)
        encode_rows(np.asarray(tab), precision).tofile(p)
        paths.append(p)
    return paths


class DummyStore:
    """All tables in RAM, decoded to float32 (emb_storage/storage_dummy.py)."""

    def __init__(self, precision: int = 32, dim: int = 36):
        self.precision = precision
        self.dim = dim
        self.tables: List[np.ndarray] = []

    def load_arrays(self, tables: Sequence[np.ndarray]):
        self.tables = [np.asarray(t, np.float32) for t in tables]
        self.dim = self.tables[0].shape[1]
        return self

    def load(self, bin_dir: str, table_sizes: Sequence[int], dim: int):
        """Read the .bin files at the store's precision and decode them."""
        self.dim = dim
        nb = row_nbytes(self.precision, dim)
        self.tables = []
        for t, n in enumerate(table_sizes):
            raw = np.fromfile(table_path(bin_dir, t),
                              dtype=np.uint8).reshape(n, nb)
            self.tables.append(_decode_rows(raw, self.precision, dim))
        return self

    def get(self, table: int, row: int) -> np.ndarray:
        return self.tables[table][row]

    def get_batch(self, keys: Sequence[Key]) -> np.ndarray:
        out = np.empty((len(keys), self.dim), np.float32)
        for i, (t, r) in enumerate(keys):
            out[i] = self.tables[t][r]
        return out

    def close(self):
        self.tables = []


class FileStore:
    """Per-table .bin files, one seek and read a row
    (emb_storage/file_read.py:27-33)."""

    def __init__(self, bin_dir: str, table_sizes: Sequence[int], dim: int,
                 precision: int = 32):
        self.dim = dim
        self.precision = precision
        self.nb = row_nbytes(precision, dim)
        self.files = [open(table_path(bin_dir, t), "rb")
                      for t in range(len(table_sizes))]

    def get(self, table: int, row: int) -> np.ndarray:
        f = self.files[table]
        f.seek(row * self.nb)
        raw = np.frombuffer(f.read(self.nb), np.uint8)
        return _decode_rows(raw, self.precision, self.dim)[0]

    def get_batch(self, keys: Sequence[Key]) -> np.ndarray:
        raw = np.empty((len(keys), self.nb), np.uint8)
        for i, (t, r) in enumerate(keys):
            f = self.files[t]
            f.seek(r * self.nb)
            raw[i] = np.frombuffer(f.read(self.nb), np.uint8)
        return _decode_rows(raw, self.precision, self.dim)

    def close(self):
        for f in self.files:
            f.close()
        self.files = []


class MmapStore:
    """Per-table .bin files through mmap (emb_storage/mmap_file_read.py:
    32-40)."""

    def __init__(self, bin_dir: str, table_sizes: Sequence[int], dim: int,
                 precision: int = 32):
        self.dim = dim
        self.precision = precision
        self.nb = row_nbytes(precision, dim)
        self.maps = []
        self._files = []
        for t in range(len(table_sizes)):
            f = open(table_path(bin_dir, t), "rb")
            self._files.append(f)
            self.maps.append(_mmap.mmap(f.fileno(), 0, prot=_mmap.PROT_READ))

    def get(self, table: int, row: int) -> np.ndarray:
        m = self.maps[table]
        raw = np.frombuffer(m[row * self.nb:(row + 1) * self.nb], np.uint8)
        return _decode_rows(raw, self.precision, self.dim)[0]

    def get_batch(self, keys: Sequence[Key]) -> np.ndarray:
        raw = np.empty((len(keys), self.nb), np.uint8)
        for i, (t, r) in enumerate(keys):
            m = self.maps[t]
            raw[i] = np.frombuffer(m[r * self.nb:(r + 1) * self.nb], np.uint8)
        return _decode_rows(raw, self.precision, self.dim)

    def close(self):
        for m in self.maps:
            m.close()
        for f in self._files:
            f.close()
        self.maps, self._files = [], []


class SqliteStore:
    """SQLite, one blob a row, in one of two layouts:
    - "global": one table keyed by a global rowid from the tables'
      cumulative offsets (emb_storage/storage_sqlite.py:28-39,106-113);
    - "per_table": one SQL table per EV table
      (emb_storage/storage_sqlite_26_tabs.py)."""

    def __init__(self, db_path: str, table_sizes: Sequence[int], dim: int,
                 precision: int = 32, layout: str = "global"):
        self.dim = dim
        self.precision = precision
        self.nb = row_nbytes(precision, dim)
        self.offsets = np.concatenate([[0], np.cumsum(table_sizes)])
        self.db_path = db_path
        self.layout = layout
        self.n_tables = len(table_sizes)
        self.conn = sqlite3.connect(db_path)

    def create_and_load(self, bin_dir: str, table_sizes: Sequence[int]):
        cur = self.conn.cursor()
        if self.layout == "global":
            cur.execute("DROP TABLE IF EXISTS tab1")
            cur.execute("CREATE TABLE tab1 (b BLOB)")
        for t, n in enumerate(table_sizes):
            raw = np.fromfile(table_path(bin_dir, t),
                              dtype=np.uint8).reshape(n, self.nb)
            if self.layout == "global":
                cur.executemany("INSERT INTO tab1 (b) VALUES (?)",
                                ((r.tobytes(),) for r in raw))
            else:
                cur.execute(f"DROP TABLE IF EXISTS ev_{t + 1}")
                cur.execute(f"CREATE TABLE ev_{t + 1} (b BLOB)")
                cur.executemany(f"INSERT INTO ev_{t + 1} (b) VALUES (?)",
                                ((r.tobytes(),) for r in raw))
        self.conn.commit()
        return self

    def _rowid(self, table: int, row: int) -> int:
        return int(self.offsets[table]) + row + 1  # rowids start at 1

    def get(self, table: int, row: int) -> np.ndarray:
        if self.layout == "global":
            cur = self.conn.execute("SELECT b FROM tab1 WHERE rowid = ?",
                                    (self._rowid(table, row),))
        else:
            cur = self.conn.execute(
                f"SELECT b FROM ev_{table + 1} WHERE rowid = ?", (row + 1,))
        raw = np.frombuffer(cur.fetchone()[0], np.uint8)
        return _decode_rows(raw, self.precision, self.dim)[0]

    def get_batch(self, keys: Sequence[Key]) -> np.ndarray:
        if self.layout != "global":
            raw = np.stack([np.frombuffer(self.conn.execute(
                f"SELECT b FROM ev_{t + 1} WHERE rowid = ?",
                (r + 1,)).fetchone()[0], np.uint8) for t, r in keys])
            return _decode_rows(raw, self.precision, self.dim)
        rowids = [self._rowid(t, r) for t, r in keys]
        qmarks = ",".join("?" * len(rowids))
        cur = self.conn.execute(
            f"SELECT rowid, b FROM tab1 WHERE rowid IN ({qmarks})", rowids)
        by_id = {rid: blob for rid, blob in cur.fetchall()}
        raw = np.stack([np.frombuffer(by_id[rid], np.uint8)
                        for rid in rowids])
        return _decode_rows(raw, self.precision, self.dim)

    def close(self):
        self.conn.close()


class LogKVStore:
    """A write-optimised persistent key-value store, the RocksDB-class
    backend (emb_storage/storage_rocksdb.py:27-123), in the port's C++
    engine (`esv_kv_*`): an append-only log of fixed records with an
    in-RAM hash index, rebuilt by one sequential scan on open; point reads
    by pread in file order; an update appends, and `compact()` reclaims the
    space of superseded records.  Unlike the file and mmap stores it takes
    writes (`put_rows`)."""

    def __init__(self, db_path: str, table_sizes: Sequence[int], dim: int,
                 precision: int = 32, layout: str = "global"):
        """layout "global": one log keyed by (table << 40) | row (the
        reference's "tableId-rowId" single-DB scheme); "per_table": one log
        per EV table, keyed by row (storage_rocksdb_26_tabs.py)."""
        from evstore_tpu_torch.native import get_lib
        self._lib = get_lib()
        self.dim = dim
        self.precision = precision
        self.nb = row_nbytes(precision, dim)
        self.table_sizes = list(table_sizes)
        self.layout = layout
        if layout == "per_table":
            self._h = None
            self._hs = []
            for t in range(len(self.table_sizes)):
                h = self._lib.esv_kv_open(f"{db_path}.t{t}".encode(), self.nb)
                if not h:
                    self.close()
                    raise OSError(f"esv_kv_open({db_path}.t{t}) failed")
                self._hs.append(h)
        elif layout == "global":
            self._hs = None
            self._h = self._lib.esv_kv_open(db_path.encode(), self.nb)
            if not self._h:
                raise OSError(f"esv_kv_open({db_path}) failed")
        else:
            raise ValueError(f"unknown LogKV layout {layout!r}")

    @staticmethod
    def _keys(tables: np.ndarray, rows: np.ndarray) -> np.ndarray:
        return ((tables.astype(np.uint64) << np.uint64(40))
                | rows.astype(np.uint64))

    def _put(self, h, keys: np.ndarray, raw: np.ndarray):
        rc = self._lib.esv_kv_put_batch(
            h, np.ascontiguousarray(keys, np.uint64),
            np.ascontiguousarray(raw, np.uint8).reshape(-1), len(keys))
        if rc != 0:
            raise OSError("esv_kv_put_batch failed")

    def put_rows(self, table: int, rows: np.ndarray, values: np.ndarray):
        """values float32 [K, dim], stored at the store's precision."""
        enc = encode_rows(np.asarray(values, np.float32), self.precision)
        rows = np.asarray(rows, np.int64)
        if self.layout == "per_table":
            self._put(self._hs[table], rows.astype(np.uint64), enc)
        else:
            self._put(self._h, self._keys(np.full(len(rows), table,
                                                  np.int64), rows), enc)

    def create_and_load(self, bin_dir: str, table_sizes: Sequence[int],
                        chunk: int = 65536):
        """Bulk load from the per-table .bin files (storage_rocksdb.load:68),
        `chunk` rows at a time."""
        for t, n in enumerate(table_sizes):
            mm = np.memmap(table_path(bin_dir, t), np.uint8,
                           mode="r").reshape(n, self.nb)
            for s in range(0, n, chunk):
                e = min(s + chunk, n)
                if self.layout == "per_table":
                    self._put(self._hs[t], np.arange(s, e, dtype=np.uint64),
                              mm[s:e])
                else:
                    self._put(self._h, self._keys(
                        np.full(e - s, t, np.int64),
                        np.arange(s, e, dtype=np.int64)), mm[s:e])
            del mm
        return self

    def get(self, table: int, row: int) -> np.ndarray:
        return self.get_batch([(table, row)])[0]

    def get_batch(self, keys: Sequence[Key]) -> np.ndarray:
        """Rows of the keys; a key never written reads as a zero code."""
        ks = np.asarray(keys, np.int64).reshape(-1, 2)
        out = np.empty((len(ks), self.nb), np.uint8)
        if self.layout == "per_table":
            for t in np.unique(ks[:, 0]):
                sel = np.nonzero(ks[:, 0] == t)[0]
                sub = np.empty((len(sel), self.nb), np.uint8)
                self._lib.esv_kv_get_batch(
                    self._hs[int(t)],
                    np.ascontiguousarray(ks[sel, 1].astype(np.uint64)),
                    sub.reshape(-1), len(sel))
                out[sel] = sub
        else:
            self._lib.esv_kv_get_batch(
                self._h, np.ascontiguousarray(self._keys(ks[:, 0], ks[:, 1])),
                out.reshape(-1), len(ks))
        return _decode_rows(out, self.precision, self.dim)

    def _handles(self):
        return (self._hs if self.layout == "per_table" else [self._h]) or []

    def count(self) -> int:
        return sum(int(self._lib.esv_kv_count(h)) for h in self._handles())

    def compact(self) -> int:
        """Rewrite each log with its live records; returns the bytes
        reclaimed."""
        total = 0
        for h in self._handles():
            r = int(self._lib.esv_kv_compact(h))
            if r < 0:
                raise OSError("esv_kv_compact failed")
            total += r
        return total

    def close(self):
        for h in self._handles():
            if h:
                self._lib.esv_kv_close(h)
        self._h, self._hs = None, None


class StorageManager:
    """The facade over the backends (emb_storage/storage_manager.py):
    backend choice, bulk load, the cache-bypass request path, teardown."""

    BACKENDS = ("dummy", "file", "mmap", "sqlite", "logkv", "native")

    def __init__(self, backend: str = "dummy", precision: int = 32,
                 dim: int = 36, layout: str = "global"):
        """`layout` applies to the database backends (sqlite, logkv):
        "global" is one table or log with a global key, "per_table" one
        table or log per EV table (the reference's *_26_tabs.py)."""
        if backend not in self.BACKENDS:
            raise ValueError(f"unknown storage backend {backend!r}; "
                             f"one of {self.BACKENDS}")
        if layout not in ("global", "per_table"):
            raise ValueError(f"unknown storage layout {layout!r}")
        self.backend = backend
        self.precision = precision
        self.dim = dim
        self.layout = layout
        self.store = None
        self._sizes: List[int] = []

    def load(self, *, tables: Optional[Sequence[np.ndarray]] = None,
             bin_dir: Optional[str] = None,
             table_sizes: Optional[Sequence[int]] = None,
             db_path: Optional[str] = None):
        """Bulk load (storage_manager.load_ev_table_into_emb_stor:141-167):
        the dummy store from float32 `tables` or from the .bin files, the
        others from the .bin files in `bin_dir`."""
        if self.backend == "dummy":
            s = DummyStore(self.precision, self.dim)
            if tables is not None:
                s.load_arrays(tables)
            else:
                s.load(bin_dir, table_sizes, self.dim)
        elif self.backend == "file":
            s = FileStore(bin_dir, table_sizes, self.dim, self.precision)
        elif self.backend == "mmap":
            s = MmapStore(bin_dir, table_sizes, self.dim, self.precision)
        elif self.backend == "sqlite":
            s = SqliteStore(db_path or os.path.join(bin_dir,
                                                    "ev-table-all.db"),
                            table_sizes, self.dim, self.precision,
                            layout=self.layout)
            s.create_and_load(bin_dir, table_sizes)
        elif self.backend == "logkv":
            s = LogKVStore(db_path or os.path.join(bin_dir,
                                                   "ev-table-all.log"),
                           table_sizes, self.dim, self.precision,
                           layout=self.layout)
            if s.count() == 0:     # a fresh store: bulk load; else reopen
                s.create_and_load(bin_dir, table_sizes)
        else:
            raise ValueError(f"backend {self.backend} requires the native "
                             "engine (NativeTieredCache.open_table_files)")
        self.store = s
        self._sizes = ([len(t) for t in tables] if tables is not None
                       else [int(n) for n in table_sizes])
        return self

    def get(self, table: int, row: int) -> np.ndarray:
        return self.store.get(table, row)

    def get_batch(self, keys: Sequence[Key]) -> np.ndarray:
        return self.store.get_batch(keys)

    def request_group(self, group_row_ids: Sequence[int]) -> np.ndarray:
        """The cache-bypass path (storage_manager.request_to_emb_storage:
        125-139): one row per table for a request group."""
        return self.get_batch([(t, int(r))
                               for t, r in enumerate(group_row_ids)])

    def table_sizes(self) -> List[int]:
        """Rows per table of the loaded store."""
        return list(self._sizes)

    def close(self):
        if self.store is not None:
            self.store.close()
            self.store = None
