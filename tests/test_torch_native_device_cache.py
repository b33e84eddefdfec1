"""The port's `NativeDeviceC1Cache` against the JAX package's, on the CPU.

These cases port the reference's own (tests/test_native_device_cache.py):
exact rows, agreement with the Python `DeviceC1Cache`, int8 rows, the
hybrid with a host C2 at fp32 and at int8, C3's alt keys, and pipelined
lookups.  Each side builds its own copy of the C++ tier engine (the JAX
package's in `evstore_tpu/native/`, the port's in `evstore_tpu_torch/
_build/`) and serves the same numpy request stream from the same tables.

Tolerances: fp32 rows are equal bit for bit; int8 rows within 1.2e-7 (one
f32 ulp near 1: jitted JAX contracts the decode (v/254)*2-1 into
fma(v, 2/254, -1), the port computes the formula with IEEE division, and
the two differ on 130 of the 256 codes by at most 5.96e-8).  The uint8
cache state, the stats and `bytes_shipped` are equal exactly.
"""

import numpy as np
import pytest
import torch

from evstore_tpu.cache.device_cache import \
    NativeDeviceC1Cache as JaxNativeDeviceC1Cache
from evstore_tpu.config import CacheConfig as JaxCacheConfig
from evstore_tpu.ops.quant import np_quantize_int8 as jax_np_quantize_int8
from evstore_tpu_torch.cache.device_cache import (DeviceC1Cache,
                                                  NativeDeviceC1Cache)
from evstore_tpu_torch.cache.storage import StorageManager
from evstore_tpu_torch.config import CacheConfig
from evstore_tpu_torch.ops.quant import dequantize_int8

N_TABLES, DIM, ROWS = 4, 8, 50
INT8_ATOL = 1.2e-7


def _tables(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-0.9, 0.9, (ROWS, DIM)).astype(np.float32)
            for _ in range(N_TABLES)]


def _pair(tables, insert_bucket=16, **kw):
    """The JAX cache and the port's, on the same config and tables."""
    jc = JaxNativeDeviceC1Cache(JaxCacheConfig(**kw), N_TABLES, DIM,
                                insert_bucket=insert_bucket)
    pc = NativeDeviceC1Cache(CacheConfig(**kw), N_TABLES, DIM,
                             insert_bucket=insert_bucket, device="cpu")
    return jc.load_tables(tables), pc.load_tables(tables)


def _stream(n, high, seed, low=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(low, high, N_TABLES) for _ in range(n)])


def _q8(rows):
    """The int8 round trip of store rows, as the port decodes it."""
    return dequantize_int8(torch.from_numpy(
        jax_np_quantize_int8(rows))).numpy()


def _serve_both(jc, pc, batches, int8=False):
    """Serve each batch through both caches and hold them to each other;
    returns the port's rows."""
    outs = []
    for idx in batches:
        ref = np.asarray(jc.lookup_batch(idx, as_numpy=True))
        got = pc.lookup_batch(idx)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        got = got.numpy()
        if int8:
            np.testing.assert_allclose(got, ref, rtol=0, atol=INT8_ATOL)
        else:
            np.testing.assert_array_equal(got.view(np.int32),
                                          ref.view(np.int32))
        np.testing.assert_array_equal(pc.cache_values.numpy(),
                                      np.asarray(jc.cache_values))
        assert pc.stats() == jc.stats()
        outs.append(got)
    return np.concatenate(outs)


def _store_rows(tables, idx):
    return np.stack([tables[t][idx[:, t]] for t in range(N_TABLES)], axis=1)


def test_exact_rows():
    tables = _tables()
    jc, pc = _pair(tables, policy="evlfu", total_size=40, main_precision=32)
    idx = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [1, 2, 3, 4]])
    out = _serve_both(jc, pc, [idx])
    np.testing.assert_array_equal(out, _store_rows(tables, idx))
    s = pc.stats()
    assert s["requests"] == 3 and s["hbm_bytes"] == 40 * DIM * 4
    assert s["bytes_shipped"] == 16 * DIM * 4      # one padded buffer
    np.testing.assert_array_equal(pc.request_batch(idx),
                                  _store_rows(tables, idx))
    pc.close(), jc.close()


@pytest.mark.parametrize("precision", [32, 8])
def test_matches_the_python_cache(precision):
    """Same stream -> the same rows and policy counters as the Python
    DeviceC1Cache, which applies once per segment."""
    tables = _tables(1)
    kw = dict(policy="evlfu", total_size=24, main_precision=precision)
    jc, nc = _pair(tables, insert_bucket=32, **kw)
    py = DeviceC1Cache(CacheConfig(**kw),
                       StorageManager("dummy", dim=DIM).load(tables=tables),
                       N_TABLES, DIM, insert_bucket=32, device="cpu")
    stream = _stream(200, 12, seed=2)
    chunks = [stream[s:s + 40] for s in range(0, 200, 40)]
    out_n = _serve_both(jc, nc, chunks, int8=precision == 8)
    out_p = np.concatenate([py.lookup_batch(c).numpy() for c in chunks])
    np.testing.assert_array_equal(out_n, out_p)
    sp, sn = py.stats(), nc.stats()
    for k in ("requests", "perfect_hits", "hit_rate", "size", "capacity",
              "hbm_bytes"):
        assert sn[k] == sp[k], k
    nc.close(), jc.close()


def test_int8_rows_and_state():
    tables = _tables(2)
    jc, pc = _pair(tables, policy="evlfu", total_size=40, main_precision=8)
    batches = [_stream(6, 30, seed=s) for s in range(5)]
    out = _serve_both(jc, pc, batches, int8=True)
    idx = np.concatenate(batches)
    # bit for bit the codec's round trip of the store's rows
    np.testing.assert_array_equal(out, _q8(_store_rows(tables, idx)))
    assert pc.cache_values.dtype == torch.uint8
    assert pc.stats()["hbm_bytes"] == 40 * DIM
    assert pc.stats()["bytes_shipped"] % (16 * DIM) == 0   # uint8 buffers
    pc.close(), jc.close()


def test_hybrid_host_c2_exact_fp32():
    """Device C1 + host C2 at fp32: every row exact, C2 takes real hits."""
    tables = _tables(3)
    jc, pc = _pair(tables, policy="evlfu", n_caching_layers=2,
                   total_size=24, main_precision=32, secondary_precision=32,
                   size_proportion=(48, 48, 4), high_agghit_threshold=4)
    assert pc.capacity == jc.capacity == 12
    stream = _stream(800, 8, seed=4)
    out = _serve_both(jc, pc, [stream[i:i + 8] for i in range(0, 800, 8)])
    np.testing.assert_array_equal(out, _store_rows(tables, stream))
    s = pc.stats()
    assert s["c2"]["hit_rate"] > 0.1 and s["c2"]["size"] <= 12
    pc.close(), jc.close()


def test_hybrid_c2_secondary_precision_int8():
    """C2 at int8: a C2-served row is the engine's int8 round trip of the
    store row; the two engines agree bit for bit."""
    tables = _tables(4)
    jc, pc = _pair(tables, policy="evlfu", n_caching_layers=2,
                   total_size=24, main_precision=32, secondary_precision=8,
                   size_proportion=(48, 48, 4), high_agghit_threshold=4)
    stream = _stream(600, 8, seed=5)
    out = _serve_both(jc, pc, [stream[i:i + 6] for i in range(0, 600, 6)])
    exact = _store_rows(tables, stream)
    from_c2 = (out != exact).any(axis=-1)
    assert from_c2.any() and pc.stats()["c2"]["hit_rate"] > 0.05
    q8 = _q8(exact)
    np.testing.assert_array_equal(out[from_c2], q8[from_c2])
    pc.close(), jc.close()


def test_hybrid_c3_altkey_serving():
    """C1+C2+C3: a double miss whose alt row is resident is served the alt
    row, counted in C3's hits; both engines take the same decisions."""
    tables = _tables(5)
    jc, pc = _pair(tables, policy="evlfu", n_caching_layers=3,
                   total_size=24, main_precision=32, secondary_precision=32,
                   size_proportion=(40, 40, 20), high_agghit_threshold=4,
                   c3_io_batch=1)
    alts = [np.zeros(ROWS, np.uint32) for _ in range(N_TABLES)]  # row 0
    jc.load_altkeys(alts), pc.load_altkeys(alts)
    churn = _stream(600, 20, seed=6)
    _serve_both(jc, pc, [churn[i:i + 6] for i in range(0, 600, 6)])
    _serve_both(jc, pc, [np.zeros((8, N_TABLES), np.int64)])
    hits0 = pc.stats()["c3"]["hits"]
    assert pc.stats()["c3"]["size"] > 0 and hits0 > 0
    # keys of the churn, some of them drained into C3 with their alt key
    probe = _stream(40, 20, seed=7, low=1)
    out = _serve_both(jc, pc, [probe])
    alt = np.stack([np.broadcast_to(tables[t][0], (40, DIM))
                    for t in range(N_TABLES)], axis=1)
    served_alt = (out == alt).all(-1)
    assert pc.stats()["c3"]["hits"] - hits0 >= served_alt.sum() > 0
    pc.close(), jc.close()


def test_published_three_tier_shape_int8():
    """The C1_C2_C3 configuration's shape (int8 C1, 4-bit C2, alt-key C3,
    48-48-4), with a small budget so every tier fills."""
    tables = _tables(6)
    jc, pc = _pair(tables, policy="evlfu", n_caching_layers=3,
                   total_size=40, main_precision=8, secondary_precision=4,
                   size_proportion=(48, 48, 4), c3_io_batch=4)
    rng = np.random.default_rng(8)
    alts = [rng.integers(0, ROWS, ROWS).astype(np.uint32)
            for _ in range(N_TABLES)]
    jc.load_altkeys(alts), pc.load_altkeys(alts)
    assert pc.capacity == CacheConfig(
        n_caching_layers=3, total_size=40, main_precision=8,
        secondary_precision=4).tier_capacities()[0] == 19
    stream = _stream(400, ROWS, seed=9)
    _serve_both(jc, pc, [stream[i:i + 10] for i in range(0, 400, 10)],
                int8=True)
    s = pc.stats()
    assert s["c2"]["hit_rate"] > 0 and s["c3"]["size"] > 0
    pc.close(), jc.close()


@pytest.mark.parametrize("precision", [32, 8])
def test_pipelined_lookup_matches_sequential(precision):
    """lookup_batches_pipelined runs the engine's assign one batch ahead
    but keeps the sequential policy order."""
    tables = _tables(7)
    kw = dict(policy="evlfu", total_size=24, main_precision=precision)
    jc, a = _pair(tables, insert_bucket=32, **kw)
    b = NativeDeviceC1Cache(CacheConfig(**kw), N_TABLES, DIM,
                            insert_bucket=32, device="cpu").load_tables(
                                tables)
    batches = [_stream(40, 30, seed=10 + i) for i in range(6)]
    seq = _serve_both(jc, a, batches, int8=precision == 8)
    pipe = np.concatenate([r.numpy()
                           for r in b.lookup_batches_pipelined(batches)])
    np.testing.assert_array_equal(pipe, seq)
    np.testing.assert_array_equal(a.cache_values.numpy(),
                                  b.cache_values.numpy())
    assert a.stats() == b.stats()
    assert b.host_s["assign"] > 0 and b.host_s["pack"] > 0
    assert b.host_s["copy"] > 0 and b.host_s["wait"] >= 0
    a.close(), b.close(), jc.close()


def test_ids_outside_their_table_raise():
    """The port's rule: host ids outside [0, N) raise ValueError, before
    the engine sees them (the JAX cache passes ids below 2^40 on)."""
    jc, pc = _pair(_tables(), policy="evlfu", total_size=40,
                   main_precision=32)
    for bad in (-1, ROWS):
        idx = np.array([[1, 2, bad, 4]])
        with pytest.raises(ValueError, match="outside"):
            pc.lookup_batch(idx)
        with pytest.raises(ValueError, match="outside"):
            list(pc.lookup_batches_pipelined([idx]))
    with pytest.raises(ValueError, match=r"2\^40"):
        jc.lookup_batch(np.array([[1, 2, -1, 4]]))
    assert pc.stats()["requests"] == 0
    pc.close(), jc.close()


def test_closed_cache_raises():
    _, pc = _pair(_tables(), policy="evlfu", total_size=40,
                  main_precision=32)
    pc.close()
    pc.close()                                  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        pc.lookup_batch(np.array([[1, 2, 3, 4]]))
    with pytest.raises(RuntimeError, match="closed"):
        pc.stats()


@pytest.mark.parametrize("precision", [16, 4])
def test_unported_precisions_raise(precision):
    with pytest.raises(ValueError, match="fp32 or int8"):
        NativeDeviceC1Cache(CacheConfig(main_precision=precision), N_TABLES,
                            DIM, device="cpu")
