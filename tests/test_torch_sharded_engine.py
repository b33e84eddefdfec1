"""The port's `NativeShardedCache` (the table-partitioned engine) against
the JAX package's, on the CPU: the cases of tests/test_sharded_engine.py.

Both bind the same C++ (`ShardedEngine`), each from its own library.  The
served rows and the stats are equal exactly between the two packages,
except for rows decoded from 8 bits, which may differ by one f32 ulp (atol
1.2e-7): the JAX package builds its engine with -march=native, where g++
may contract the decode into an FMA (tests/test_torch_native.py).  Within
the port: at one worker the sharded engine is the serial engine exactly;
at two, fp32 tiers serve the table's rows exactly and C1's hit rate stays
within 0.05 of the serial engine's, as in the JAX test; C3 is refused.
The ThreadSanitizer case runs only where g++ has libtsan, as there.
"""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from evstore_tpu import native as jax_native
from evstore_tpu.config import CacheConfig as JaxCacheConfig
from evstore_tpu_torch.config import CacheConfig
from evstore_tpu_torch.native import NativeShardedCache, NativeTieredCache
from evstore_tpu_torch.ops.quant import np_dequantize_int8, np_quantize_int8

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mk(seed=0, n_tables=8, dim=6, sizes=None):
    rng = np.random.default_rng(seed)
    sizes = sizes or [50 + 10 * t for t in range(n_tables)]
    tables = [np.asarray(rng.uniform(-1, 1, (s, dim)), np.float32)
              for s in sizes]
    return rng, sizes, tables


def _stream(rng, sizes, n, zipf=True):
    cols = []
    for s in sizes:
        if zipf:
            u = rng.random(n)
            r = np.clip(((s ** -0.05 - 1) * u + 1) ** (1 / -0.05) - 1,
                        0, s - 1).astype(np.int64)
        else:
            r = rng.integers(0, s, n)
        cols.append(r)
    return np.stack(cols, axis=1)


def _both(kw, n_tables, dim, workers, tables):
    """(the port's, the JAX package's) sharded engine over `tables`."""
    ours = NativeShardedCache(CacheConfig(**kw), n_tables, dim,
                              workers).borrow_tables(tables)
    ref = jax_native.NativeShardedCache(JaxCacheConfig(**kw), n_tables, dim,
                                        workers).borrow_tables(tables)
    return ours, ref


def _assert_stats_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            assert a[k] == pytest.approx(b[k], abs=1e-12), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("layers", [1, 2])
def test_w1_matches_sequential(layers):
    rng, sizes, tables = _mk()
    kw = dict(policy="evlfu", n_caching_layers=layers, total_size=60,
              main_precision=8, secondary_precision=4,
              size_proportion=(48, 48, 4))
    seq = NativeTieredCache(CacheConfig(**kw), len(sizes), 6
                            ).borrow_tables(tables)
    sh, ref = _both(kw, len(sizes), 6, 1, tables)
    idx = _stream(rng, sizes, 600)
    for lo in range(0, 600, 100):
        a = seq.request_batch(idx[lo:lo + 100])
        b = sh.request_batch(idx[lo:lo + 100])
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(b, ref.request_batch(idx[lo:lo + 100]),
                                   rtol=0, atol=1.2e-7)
    sa, sb = seq.stats(), sh.stats()
    assert sa["perfect_hits"] == sb["perfect_hits"]
    assert abs(sa["c1"]["hit_rate"] - sb["c1"]["hit_rate"]) < 1e-12
    _assert_stats_equal(sb, ref.stats())
    for c in (seq, sh, ref):
        c.close()


def test_w2_served_rows_exact_fp32():
    rng, sizes, tables = _mk(seed=1)
    kw = dict(policy="evlfu", n_caching_layers=2, total_size=80,
              main_precision=32, secondary_precision=32,
              size_proportion=(48, 48, 4))
    sh, ref = _both(kw, len(sizes), 6, 2, tables)
    idx = _stream(rng, sizes, 400)
    for lo in range(0, 400, 50):
        rows = sh.request_batch(idx[lo:lo + 50])
        want = np.stack([tables[t][idx[lo:lo + 50, t]]
                         for t in range(len(sizes))], axis=1)
        np.testing.assert_array_equal(rows, want)
        np.testing.assert_array_equal(rows, ref.request_batch(
            idx[lo:lo + 50]))
    _assert_stats_equal(sh.stats(), ref.stats())
    sh.close()
    ref.close()


def test_w2_hit_rate_close_to_sequential():
    rng, sizes, tables = _mk(seed=2, n_tables=10)
    kw = dict(policy="evlfu", n_caching_layers=2, total_size=100,
              main_precision=8, secondary_precision=4,
              size_proportion=(48, 48, 4))
    seq = NativeTieredCache(CacheConfig(**kw), len(sizes), 6
                            ).borrow_tables(tables)
    sh, ref = _both(kw, len(sizes), 6, 2, tables)
    idx = _stream(rng, sizes, 3000)
    seq.request_batch(idx)
    sh.request_batch(idx)
    ref.request_batch(idx)
    hr_seq = seq.stats()["c1"]["hit_rate"]
    hr_sh = sh.stats()["c1"]["hit_rate"]
    # each shard's own pool moves evictions a little, not the regime
    assert abs(hr_seq - hr_sh) < 0.05, (hr_seq, hr_sh)
    _assert_stats_equal(sh.stats(), ref.stats())
    for c in (seq, sh, ref):
        c.close()


def test_w2_quantized_rows_match_codec():
    rng, sizes, tables = _mk(seed=3, n_tables=4)
    kw = dict(policy="evlfu", n_caching_layers=1, total_size=1000,
              main_precision=8, size_proportion=(48, 48, 4))
    sh, ref = _both(kw, len(sizes), 6, 2, tables)
    idx = _stream(rng, sizes, 50, zipf=False)
    rows = sh.request_batch(idx)
    want = np.stack([np_dequantize_int8(np_quantize_int8(
        tables[t][idx[:, t]])) for t in range(len(sizes))], axis=1)
    np.testing.assert_allclose(rows, want, atol=1e-6)
    np.testing.assert_allclose(rows, ref.request_batch(idx), rtol=0,
                               atol=1.2e-7)
    sh.close()
    ref.close()


def test_shard_rejects_c3():
    cfg = CacheConfig(policy="evlfu", n_caching_layers=3, total_size=100)
    with pytest.raises(ValueError, match="C1 and C1\\+C2"):
        NativeShardedCache(cfg, 4, 6, 2)
    with pytest.raises(ValueError):     # as the JAX package's
        jax_native.NativeShardedCache(JaxCacheConfig(
            policy="evlfu", n_caching_layers=3, total_size=100), 4, 6, 2)
    # more workers than tables: the engine refuses
    with pytest.raises(ValueError, match="esv_shard_init"):
        NativeShardedCache(CacheConfig(total_size=100), 2, 6, 3)


def test_closed_engine_raises_and_ids_out_of_range_raise():
    _, sizes, tables = _mk(seed=4, n_tables=3)
    sh = NativeShardedCache(CacheConfig(total_size=30), 3, 6, 2
                            ).borrow_tables(tables)
    with pytest.raises(ValueError, match="out of"):
        sh.request_batch(np.full((1, 3), -1, np.int64))
    sh.close()
    sh.close()                          # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        sh.request_batch(np.zeros((1, 3), np.int64))


@pytest.mark.parametrize("workers", [2, 4])
def test_sharded_engine_tsan_clean(workers):
    """The sharded engine's atomics and spin coordination under
    -fsanitize=thread: a zipf workload at W=2 and W=4 with no race report,
    and the fp32 tiers' rows exact.  The instrumented library is the
    port's own (`native/build.py`, ESV_SANITIZE=thread); the TSan runtime
    is preloaded, as an uninstrumented python must have it resident before
    it loads an instrumented library."""
    lib = subprocess.run(["g++", "-print-file-name=libtsan.so"],
                         capture_output=True, text=True).stdout.strip()
    if not lib or not os.path.exists(lib):
        pytest.skip("libtsan not available")
    code = f"""
import numpy as np
from evstore_tpu_torch.config import CacheConfig
from evstore_tpu_torch.native import NativeShardedCache, build, get_lib
assert get_lib()._name == build.library_path("thread")
rng = np.random.default_rng(7)
n_tables, dim = 12, 6
sizes = [60 + 15 * t for t in range(n_tables)]
tables = [np.asarray(rng.uniform(-1, 1, (s, dim)), np.float32)
          for s in sizes]
cfg = CacheConfig(policy="evlfu", n_caching_layers=2, total_size=120,
                  main_precision=32, secondary_precision=32,
                  size_proportion=(48, 48, 4))
sh = NativeShardedCache(cfg, n_tables, dim, {workers}).borrow_tables(tables)
cols = []
for s in sizes:
    u = rng.random(4000)
    cols.append(np.clip(((s ** -0.05 - 1) * u + 1) ** (1 / -0.05) - 1,
                        0, s - 1).astype(np.int64))
idx = np.stack(cols, axis=1)
for lo in range(0, 4000, 200):
    rows = sh.request_batch(idx[lo:lo + 200])
    want = np.stack([tables[t][idx[lo:lo + 200, t]]
                     for t in range(n_tables)], axis=1)
    np.testing.assert_array_equal(rows, want)
st = sh.stats()
assert 0.0 <= st["c1"]["hit_rate"] <= 1.0
sh.close()
print("TSAN-STRESS-OK")
"""
    env = dict(os.environ, ESV_SANITIZE="thread", LD_PRELOAD=lib,
               TSAN_OPTIONS="halt_on_error=0 exitcode=66")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    warns = re.findall(r"WARNING: ThreadSanitizer.*", r.stderr)
    assert r.returncode == 0, (r.returncode, r.stderr[-3000:])
    assert "TSAN-STRESS-OK" in r.stdout, r.stderr[-2000:]
    assert not warns, warns[:5]
