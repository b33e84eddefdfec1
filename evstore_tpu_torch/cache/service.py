"""TCP embedding service: a cache or a store served over a socket.

A copy of `evstore_tpu/cache/service.py` (host code free of JAX).  The
reference's C++ engine doubles as an epoll TCP server (an accept thread and
10 workers; 26 int keys in, 26x36 floats out; cache_manager.cpp:61-152,
292-385), and it has a standalone in-RAM storage server
(emb_storage/multi_storage_dummy/socket-server.py).  It measures its own
socket as "SLOW (50% of latency)" (cpp_socket_client.py:132), so the
primary transport is the in-process batched engine call; this module is
for serving across processes, with a batched protocol.

Protocol (little-endian):
  request:  uint32 B, uint32 T, then B*T int64 row ids
  response: uint32 n_floats, then B*T*D float32 rows
One connection carries many requests.  Two concurrency modes:

- mode="lock" (the reference's shape): a thread per connection; one lock
  serialises the engine, as the reference's workers contend on its one
  cache (cache_manager.cpp:292-385);
- mode="batched": the connections' readers queue their requests, and ONE
  dispatcher thread drains all that is pending into a single engine batch
  in arrival order, runs it once and hands each reader its rows.
  Concurrent clients share the engine pass instead of contending for it.

`engine` is anything with `request_batch(idx [B, T]) -> [B, T, D]`: a
`TieredCache`, a `NativeTieredCache`, a `SimpleCacheFrontend`, or a bare
`StorageManager` behind `StorageAdapter`.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Optional

import numpy as np


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


class EmbeddingServer:
    """Serves `engine.request_batch(idx) -> [B, T, D] fp32` over TCP."""

    def __init__(self, engine, dim: int, host: str = "127.0.0.1",
                 port: int = 0, mode: str = "lock",
                 max_batch_rows: int = 131072):
        # max_batch_rows caps the engine rows (B*T) that one dispatcher
        # pass coalesces
        if mode not in ("lock", "batched"):
            raise ValueError(f"unknown service mode {mode!r}")
        self.engine = engine
        self.dim = dim
        self.mode = mode
        self.max_batch_rows = max_batch_rows
        self._lock = threading.Lock()
        self._srv = socket.create_server((host, port))
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._threads = []
        self._accept_thread: Optional[threading.Thread] = None
        self._queue = []                      # [(idx, holder, event)]
        self._qcv = threading.Condition()
        self._dispatcher: Optional[threading.Thread] = None

    def start(self):
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()
        if self.mode == "batched":
            self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                                daemon=True)
            self._dispatcher.start()
        return self

    def _dispatch_loop(self):
        try:
            while not self._stop.is_set():
                with self._qcv:
                    while not self._queue and not self._stop.is_set():
                        self._qcv.wait(timeout=0.2)
                    if self._stop.is_set():
                        return
                    batch, rows = [], 0
                    while self._queue and rows < self.max_batch_rows:
                        item = self._queue.pop(0)
                        batch.append(item)
                        # engine rows actually executed are B*T, not B
                        rows += item[0].shape[0] * item[0].shape[1]
                self._run_batch(batch)
        finally:
            # drain on exit: anything still queued (or enqueued during
            # shutdown) gets an error instead of a waiter stuck on ev.wait()
            with self._qcv:
                left, self._queue = self._queue, []
            for idx, holder, ev in left:
                holder.append(ConnectionError("server stopped"))
                ev.set()

    def _run_batch(self, batch):
        if not batch:
            return
        idx_cat = np.concatenate([b[0] for b in batch], axis=0)
        try:
            out = self.engine.request_batch(idx_cat)
            err = None
        except Exception as e:          # propagate to every waiter
            out, err = None, e
        off = 0
        for idx, holder, ev in batch:
            if err is None:
                holder.append(out[off:off + idx.shape[0]])
            else:
                holder.append(err)
            off += idx.shape[0]
            ev.set()

    def _accept_loop(self):
        self._srv.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket):
        try:
            while not self._stop.is_set():
                header = _recv_exact(conn, 8)
                B, T = struct.unpack("<II", header)
                raw = _recv_exact(conn, B * T * 8)
                idx = np.frombuffer(raw, np.int64).reshape(B, T)
                if self.mode == "batched":
                    holder, ev = [], threading.Event()
                    with self._qcv:
                        if self._stop.is_set():
                            raise ConnectionError("server stopped")
                        self._queue.append((idx, holder, ev))
                        self._qcv.notify()
                    # bounded wait: if the dispatcher died/stopped between
                    # our enqueue and its drain, don't hang forever
                    while not ev.wait(timeout=0.2):
                        if self._stop.is_set() and not holder:
                            raise ConnectionError("server stopped")
                    if isinstance(holder[0], Exception):
                        raise ConnectionError(str(holder[0]))
                    rows = holder[0]
                else:
                    with self._lock:
                        rows = self.engine.request_batch(idx)
                payload = np.ascontiguousarray(rows, np.float32).tobytes()
                conn.sendall(struct.pack("<I", len(payload) // 4) + payload)
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def stop(self):
        self._stop.set()
        with self._qcv:
            self._qcv.notify_all()
        try:
            self._srv.close()
        except OSError:
            pass


class EmbeddingClient:
    """request_batch over the wire (≙ cpp_socket_client.cache_lookup_via_socket,
    but batched)."""

    def __init__(self, host: str, port: int, n_tables: int, dim: int):
        self.n_tables = n_tables
        self.dim = dim
        self.sock = socket.create_connection((host, port))

    def request_batch(self, idx: np.ndarray) -> np.ndarray:
        idx = np.ascontiguousarray(idx, np.int64)
        B, T = idx.shape
        self.sock.sendall(struct.pack("<II", B, T) + idx.tobytes())
        n_floats = struct.unpack("<I", _recv_exact(self.sock, 4))[0]
        raw = _recv_exact(self.sock, n_floats * 4)
        return np.frombuffer(raw, np.float32).reshape(B, T, self.dim)

    def request(self, group_row_ids):
        out = self.request_batch(np.asarray(group_row_ids)[None, :])
        return out[0], None, None

    def close(self):
        self.sock.close()


class StorageAdapter:
    """Expose a bare StorageManager as request_batch (the reference's
    standalone storage server serves raw rows the same way)."""

    def __init__(self, storage, n_tables: int):
        self.storage = storage
        self.n_tables = n_tables

    def request_batch(self, idx: np.ndarray) -> np.ndarray:
        B, T = idx.shape
        keys = [(t, int(idx[b, t])) for b in range(B) for t in range(T)]
        rows = self.storage.get_batch(keys)
        return rows.reshape(B, T, -1)
