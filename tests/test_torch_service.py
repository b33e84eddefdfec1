"""The port's TCP embedding service (`evstore_tpu_torch/cache/service.py`)
against the JAX package's, on the CPU, over 127.0.0.1.

The service is a copy, so the checks are of behaviour and of the wire: a
store, the Python tiers and the C++ engine served in `lock` and `batched`
modes give the rows those engines give directly, bit for bit (the payload
is the engine's float32 rows); the cache's state accumulates across
requests and clients as the JAX service's does; and a JAX client talks to
a port server and a port client to a JAX server, since the protocol is the
same.
"""

import threading

import numpy as np
import pytest

from evstore_tpu.cache import service as jsvc
from evstore_tpu.cache import tiers as jt
from evstore_tpu.cache.storage import StorageManager as JaxStorageManager
from evstore_tpu.config import CacheConfig as JaxCacheConfig
from evstore_tpu_torch.cache.service import (EmbeddingClient, EmbeddingServer,
                                             StorageAdapter)
from evstore_tpu_torch.cache.storage import StorageManager
from evstore_tpu_torch.cache.tiers import TieredCache
from evstore_tpu_torch.config import CacheConfig
from evstore_tpu_torch.native import NativeTieredCache

N_TABLES, DIM = 4, 8


def _tables(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-0.9, 0.9, (50, DIM)).astype(np.float32)
            for _ in range(N_TABLES)]


def _idx(seed, B=6):
    return np.random.default_rng(seed).integers(0, 50, (B, N_TABLES))


def _store_rows(tables, idx):
    return np.stack([np.stack([tables[t][r] for t, r in enumerate(row)])
                     for row in idx])


@pytest.mark.parametrize("mode", ["lock", "batched"])
def test_storage_server_roundtrip(mode):
    tables = _tables()
    sm = StorageManager("dummy", dim=DIM).load(tables=tables)
    srv = EmbeddingServer(StorageAdapter(sm, N_TABLES), DIM,
                          mode=mode).start()
    try:
        cli = EmbeddingClient("127.0.0.1", srv.port, N_TABLES, DIM)
        for seed in range(3):
            idx = _idx(seed)
            np.testing.assert_array_equal(cli.request_batch(idx),
                                          _store_rows(tables, idx))
        rows, hits, agg = cli.request(idx[0])
        np.testing.assert_array_equal(rows, _store_rows(tables, idx[:1])[0])
        assert hits is None and agg is None
        cli.close()
    finally:
        srv.stop()


@pytest.mark.parametrize("mode", ["lock", "batched"])
def test_cache_server_matches_the_jax_cache(mode):
    """Two clients, one after the other, through a served TieredCache: the
    rows and the cache's stats equal those of the JAX TieredCache asked
    directly with the same requests."""
    tables = _tables(1)
    kw = dict(policy="evlfu", total_size=40, main_precision=8)
    tc = TieredCache(CacheConfig(**kw),
                     StorageManager("dummy", dim=DIM).load(tables=tables),
                     N_TABLES, DIM)
    jc = jt.TieredCache(JaxCacheConfig(**kw),
                        JaxStorageManager("dummy", dim=DIM).load(
                            tables=tables), N_TABLES, DIM)
    srv = EmbeddingServer(tc, DIM, mode=mode).start()
    try:
        clients = [EmbeddingClient("127.0.0.1", srv.port, N_TABLES, DIM)
                   for _ in range(2)]
        for seed in range(6):
            idx = _idx(seed % 3)
            got = clients[seed % 2].request_batch(idx)
            np.testing.assert_array_equal(got, jc.request_batch(idx))
        assert tc.stats() == jc.stats()
        assert tc.stats()["perfect_hits"] > 0
        for c in clients:
            c.close()
    finally:
        srv.stop()


def test_batched_mode_concurrent_clients_share_engine_passes():
    """mode="batched": six concurrent clients' requests go through fewer
    engine passes than requests, and each client gets its own rows."""
    tables = _tables(2)

    class Counting:
        calls = 0

        def request_batch(self, idx):
            Counting.calls += 1
            return _store_rows(tables, idx)

    srv = EmbeddingServer(Counting(), DIM, mode="batched").start()
    errs = []

    def client(seed):
        try:
            c = EmbeddingClient("127.0.0.1", srv.port, N_TABLES, DIM)
            for k in range(20):
                idx = _idx(100 * seed + k, B=4)
                np.testing.assert_array_equal(c.request_batch(idx),
                                              _store_rows(tables, idx))
            c.close()
        except Exception as e:   # surfaced below
            errs.append(e)

    threads = [threading.Thread(target=client, args=(s,)) for s in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    srv.stop()
    assert not errs, errs
    assert Counting.calls < 6 * 20


def test_native_engine_served_rows_are_the_stores():
    """A fresh fp32 C1 of the port's engine behind the batched server, as
    chip_smoke.py phase 3d serves it: the rows equal the store's bit for
    bit."""
    tables = _tables(3)
    eng = NativeTieredCache(CacheConfig(total_size=30), N_TABLES,
                            DIM).load_tables(tables)
    srv = EmbeddingServer(eng, DIM, mode="batched").start()
    try:
        cli = EmbeddingClient("127.0.0.1", srv.port, N_TABLES, DIM)
        for seed in range(4):
            idx = _idx(seed, B=16)
            np.testing.assert_array_equal(cli.request_batch(idx),
                                          _store_rows(tables, idx))
        assert eng.stats()["requests"] == 64
        cli.close()
    finally:
        srv.stop()
        eng.close()


@pytest.mark.parametrize("server_side", ["port", "jax"])
def test_the_wire_protocol_is_the_jax_services(server_side):
    tables = _tables(4)
    sm = StorageManager("dummy", dim=DIM).load(tables=tables)
    srv_mod, cli_mod = ((EmbeddingServer, jsvc.EmbeddingClient)
                        if server_side == "port"
                        else (jsvc.EmbeddingServer, EmbeddingClient))
    srv = srv_mod(StorageAdapter(sm, N_TABLES), DIM).start()
    try:
        cli = cli_mod("127.0.0.1", srv.port, N_TABLES, DIM)
        idx = _idx(9)
        np.testing.assert_array_equal(cli.request_batch(idx),
                                      _store_rows(tables, idx))
        cli.close()
    finally:
        srv.stop()


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown service mode"):
        EmbeddingServer(None, DIM, mode="epoll")
