"""Embedding storage behind the cache: the in-RAM (`dummy`) backend.

Port of `DummyStore` and `StorageManager` from
`evstore_tpu/cache/storage.py` (emb_storage/storage_dummy.py and
storage_manager.py in the reference).  The tables stay in host RAM as float32
numpy arrays; only the device cache's miss rows cross to the card.  The
file, mmap, sqlite, logkv and native backends are not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

Key = Tuple[int, int]


class DummyStore:
    """All tables in RAM (emb_storage/storage_dummy.py)."""

    def __init__(self, dim: int = 36):
        self.dim = dim
        self.tables: List[np.ndarray] = []

    def load_arrays(self, tables: Sequence[np.ndarray]):
        self.tables = [np.asarray(t, np.float32) for t in tables]
        self.dim = self.tables[0].shape[1]
        return self

    def get_batch(self, keys: Sequence[Key]) -> np.ndarray:
        out = np.empty((len(keys), self.dim), np.float32)
        for i, (t, r) in enumerate(keys):
            out[i] = self.tables[t][r]
        return out

    def close(self):
        self.tables = []


class StorageManager:
    """Facade over the backends (emb_storage/storage_manager.py)."""

    BACKENDS = ("dummy",)

    def __init__(self, backend: str = "dummy", dim: int = 36):
        if backend not in self.BACKENDS:
            raise NotImplementedError(
                f"storage backend {backend!r} is not ported yet; the port "
                f"has {self.BACKENDS}")
        self.backend = backend
        self.dim = dim
        self.store: Optional[DummyStore] = None

    def load(self, *, tables: Sequence[np.ndarray]):
        """Bulk load from in-memory float32 tables."""
        self.store = DummyStore(self.dim).load_arrays(tables)
        return self

    def get_batch(self, keys: Sequence[Key]) -> np.ndarray:
        return self.store.get_batch(keys)

    def table_sizes(self) -> List[int]:
        return [len(t) for t in self.store.tables]

    def close(self):
        if self.store is not None:
            self.store.close()
            self.store = None
