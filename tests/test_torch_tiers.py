"""The port's host tiers and cache policies (`evstore_tpu_torch/cache/
tiers.py`, `cache/policy.py`) against the JAX package's, on the CPU.

Both packages' caches serve the same request streams (grouped Zipf over 26
tables of 40-300 rows, made with numpy from a seed) over the same store,
at capacities small enough that evictions, perfect-set flushes, the C1/C2
split and C3 hits all occur.  Every comparison is exact: the rows of each
request bit for bit (both sides encode and decode with the same numpy
codecs), the hit flags and agg_hit, the tiers' stats, sizes and evicted
keys.  With `approx_emb_threshold` the stand-in rows come from the same
numpy generator and seed on both sides.
"""

import dataclasses

import numpy as np
import pytest

from evstore_tpu.cache import policy as jpol
from evstore_tpu.cache import tiers as jt
from evstore_tpu.cache.storage import StorageManager as JaxStorageManager
from evstore_tpu.config import CacheConfig as JaxCacheConfig
from evstore_tpu.tools.gen_altkeys import \
    write_altkeys_binary as jax_write_altkeys
from evstore_tpu_torch.cache import policy as ppol
from evstore_tpu_torch.cache import tiers as pt
from evstore_tpu_torch.cache.storage import StorageManager
from evstore_tpu_torch.config import CacheConfig
from evstore_tpu_torch.data.synthetic import RandomDataConfig, random_batches

N_TABLES, DIM = 26, 8


def _sizes():
    return [int(n) for n in np.random.default_rng(7).integers(40, 301,
                                                              N_TABLES)]


def _tables(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-0.9, 0.9, (n, DIM)).astype(np.float32)
            for n in _sizes()]


def _alts(seed=12):
    """One uniform row of the same table per row, as alt keys."""
    rng = np.random.default_rng(seed)
    return [np.array([pt.altkey_encode(t, int(r))
                      for r in rng.integers(0, n, n)], np.int64)
            for t, n in enumerate(_sizes())]


def _stream(n_batches=8, B=32, seed=3):
    return [idx for _, idx, _ in random_batches(RandomDataConfig(
        num_dense=4, table_sizes=_sizes(), batch_size=B,
        num_batches=n_batches, seed=seed, distribution="grouped_zipf",
        group_noise=0.1))]


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


TIERED = {
    "c1-32": dict(total_size=300),
    "c1-16": dict(total_size=300, main_precision=16),
    "c1-8": dict(total_size=300, main_precision=8),
    "c1-4": dict(total_size=300, main_precision=4),
    "c1-32-approx": dict(total_size=300, approx_emb_threshold=20),
    "c1-8-approx": dict(total_size=200, main_precision=8,
                        approx_emb_threshold=12),
    "c1c2-32-16": dict(n_caching_layers=2, total_size=400,
                       secondary_precision=16, size_proportion=(50, 50, 0)),
    "c1c2-32-8": dict(n_caching_layers=2, total_size=400,
                      size_proportion=(50, 50, 0), high_agghit_threshold=0),
    "c1c2-8-4": dict(n_caching_layers=2, total_size=400, main_precision=8,
                     secondary_precision=4, size_proportion=(50, 50, 0)),
    "c1c2c3-8-4": dict(n_caching_layers=3, total_size=900, main_precision=8,
                       secondary_precision=4, size_proportion=(48, 48, 4),
                       c3_io_batch=10),
    "c1c2c3-32-8-fifo": dict(n_caching_layers=3, total_size=900,
                             size_proportion=(48, 48, 4), c3_io_batch=7,
                             c3_eviction="fifo"),
}


@pytest.mark.parametrize("name", list(TIERED))
def test_tiered_cache_matches_jax(name):
    kw = dict(policy="evlfu", **TIERED[name])
    tables = _tables()
    alts = _alts()
    pc = pt.TieredCache(CacheConfig(**kw),
                        StorageManager("dummy", dim=DIM).load(tables=tables),
                        N_TABLES, DIM, pt.AltKeyResolver(alts))
    jc = jt.TieredCache(JaxCacheConfig(**kw),
                        JaxStorageManager("dummy", dim=DIM).load(
                            tables=tables),
                        N_TABLES, DIM, jt.AltKeyResolver(alts))
    for i, idx in enumerate(_stream()):
        if i % 2:               # request by request
            for row in idx:
                got, want = pc.request(row), jc.request(row)
                np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
                assert got[1:] == want[1:]
        else:
            np.testing.assert_array_equal(_bits(pc.request_batch(idx)),
                                          _bits(jc.request_batch(idx)))
        assert pc.stats() == jc.stats()
    s = pc.stats()
    assert s["requests"] == 256 and s["c1"]["size"] == s["c1"]["capacity"]
    if "c3" in s:
        assert s["c3"]["hits"] > 0 and s["c3"]["size"] > 0
        assert list(pc.c3.od.items()) == list(jc.c3.od.items())
    if "approx" in name:
        assert s["perfect_hits"] > 0


@pytest.mark.parametrize("policy", ["lfu", "lru", "evlfu"])
def test_single_tier_baselines_match_jax(policy):
    tables = _tables(1)
    pc = pt.make_cache_from_policy(
        policy, 250, N_TABLES, StorageManager("dummy", dim=DIM).load(
            tables=tables), DIM)
    jc = jt.make_cache_from_policy(
        policy, 250, N_TABLES, JaxStorageManager("dummy", dim=DIM).load(
            tables=tables), DIM)
    assert type(pc).__name__ == type(jc).__name__
    for idx in _stream(6, seed=4):
        np.testing.assert_array_equal(_bits(pc.request_batch(idx)),
                                      _bits(jc.request_batch(idx)))
        assert pc.stats() == jc.stats()
    got, want = pc.request(idx[0]), jc.request(idx[0])
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
    assert got[1:] == want[1:]
    with pytest.raises(ValueError, match="unknown cache policy"):
        pt.make_cache_from_policy("arc", 10, N_TABLES, None, DIM)


def test_evlfu_groups_match_jax():
    """probe_group and finish_group over random groups, with values that
    stand for rows; the outputs, evicted keys, stats and contents agree."""
    rng = np.random.default_rng(0)
    p, j = ppol.EvLFU(40, 4), jpol.EvLFU(40, 4)
    for step in range(300):
        keys = [(t, int(r)) for t, r in enumerate(rng.integers(0, 25, 4))]
        (ph, pa), (jh, ja) = p.probe_group(keys), j.probe_group(keys)
        assert (ph, pa) == (jh, ja)
        vals = [k[0] * 100 + k[1] for k, h in zip(keys, ph) if not h]
        fetch = lambda k: -1           # noqa: E731
        assert p.finish_group(keys, ph, pa, vals, fetch) == \
            j.finish_group(keys, jh, ja, vals, fetch)
        if step % 7 == 0:
            assert p.drain_evicted() == j.drain_evicted()
        assert len(p) == len(j) and all((k in p) == (k in j) for k in keys)
    assert p.stats() == j.stats()
    assert p.vals == j.vals
    assert [list(b) for b in p.buckets] == [list(b) for b in j.buckets]


@pytest.mark.parametrize("policy", ["LFU", "LRU"])
def test_lfu_lru_match_jax(policy):
    rng = np.random.default_rng(1)
    p, j = getattr(ppol, policy)(30), getattr(jpol, policy)(30)
    for _ in range(2000):
        k = (int(rng.integers(0, 3)), int(rng.integers(0, 40)))
        if rng.random() < 0.6:
            assert p.get(k) == j.get(k)
        else:
            v = int(rng.integers(0, 1000))
            p.set(k, v)
            j.set(k, v)
        assert len(p) == len(j)
    assert p.evicted == j.evicted and len(p.evicted) > 0
    assert p.stats() == j.stats()


@pytest.mark.parametrize("eviction", ["fifo", "recency"])
def test_altkey_cache_matches_jax(eviction):
    rng = np.random.default_rng(2)
    alts = _alts(3)
    pr, jr = pt.AltKeyResolver(alts), jt.AltKeyResolver(alts)
    p = pt.AltKeyCache(50, eviction, io_batch=9)
    j = jt.AltKeyCache(50, eviction, io_batch=9)
    for _ in range(40):
        keys = [(int(t), int(rng.integers(0, 40)))
                for t in rng.integers(0, N_TABLES, 5)]
        p.queue_keys(keys, pr)
        j.queue_keys(keys, jr)
        probe = keys[0]
        assert p.get_altkey(probe) == j.get_altkey(probe)
        p.set_recency(probe)
        j.set_recency(probe)
    p.flush_pending(pr)
    j.flush_pending(jr)
    assert list(p.od.items()) == list(j.od.items()) and len(p) == 50
    assert p.pending == j.pending == []


def test_altkey_files_read_as_jax_reads_them(tmp_path):
    """alt-keys-<t>.bin, big-endian uint32: written by the port as the JAX
    package's tool writes them, read back by both resolvers alike; a row
    past a table's end resolves to None."""
    alts = _alts(4)
    got = pt.write_altkeys_binary(alts, str(tmp_path / "port"))
    want = jax_write_altkeys(alts, str(tmp_path / "jax"))
    for g, w in zip(got, want):
        assert open(g, "rb").read() == open(w, "rb").read()
    pr = pt.AltKeyResolver(bin_dir=str(tmp_path / "port"),
                           table_sizes=_sizes())
    jr = jt.AltKeyResolver(bin_dir=str(tmp_path / "jax"),
                           table_sizes=_sizes())
    for a, b, c in zip(pr.tables, jr.tables, alts):
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    keys = [(0, 0), (5, 17), (25, _sizes()[25] - 1), (3, 10_000)]
    assert pr(keys) == jr(keys) and pr(keys)[-1] is None
    assert pt.altkey_decode(pr([(5, 17)])[0])[0] == 5


def test_altkey_codec():
    assert pt.altkey_encode(0, 7) == jt.altkey_encode(0, 7) == 701
    for t, r in [(0, 7), (25, 12345), (3, 10_131_226)]:
        assert pt.altkey_decode(pt.altkey_encode(t, r)) == (t, r)
        assert pt.altkey_decode(jt.altkey_encode(t, r)) == \
            jt.altkey_decode(jt.altkey_encode(t, r))


def test_stand_in_rows_match_jax():
    """The approximate-embedding short-circuit: a miss before any hit gets
    the random stand-in (numpy's default_rng(0), as the JAX class draws
    it), a later miss the previous hit's row; none is inserted."""
    tables = _tables(2)
    kw = dict(policy="evlfu", total_size=300, approx_emb_threshold=2)
    pc = pt.TieredCache(CacheConfig(**kw), StorageManager(
        "dummy", dim=DIM).load(tables=tables), N_TABLES, DIM)
    jc = jt.TieredCache(JaxCacheConfig(**kw), JaxStorageManager(
        "dummy", dim=DIM).load(tables=tables), N_TABLES, DIM)
    warm = np.arange(N_TABLES) % 5
    for c in (pc, jc):
        c.request(warm)
    probe = warm.copy()
    probe[0] = 17                  # a miss before any hit
    probe[9] = 33                  # a miss after hits
    got, want = pc.request(probe), jc.request(probe)
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
    assert got[2] == want[2] == N_TABLES and all(got[1])
    np.testing.assert_array_equal(got[0][9], got[0][8])
    assert (0, 17) not in pc.c1 and (9, 33) not in pc.c1
    assert pc.stats() == jc.stats()


@pytest.mark.parametrize("name", ["c1-32", "c1c2c3-8-4"])
def test_engine_request_path_matches_jax(name):
    """`NativeTieredCache.request_batch` and `request`, the port's engine
    against the JAX package's, rows bit for bit and stats equal; both
    refuse a row id past 2^40."""
    from evstore_tpu.native import NativeTieredCache as JaxNative
    from evstore_tpu_torch.native import NativeTieredCache
    kw = dict(policy="evlfu", **TIERED[name])
    tables, alts = _tables(), _alts()
    p = NativeTieredCache(CacheConfig(**kw), N_TABLES, DIM).load_tables(
        tables)
    j = JaxNative(JaxCacheConfig(**kw), N_TABLES, DIM).load_tables(tables)
    p.load_altkeys(alts)
    j.load_altkeys([a.astype(np.uint32) for a in alts])
    try:
        for idx in _stream(4, seed=8):
            np.testing.assert_array_equal(_bits(p.request_batch(idx)),
                                          _bits(j.request_batch(idx)))
        got, want = p.request(idx[0]), j.request(idx[0])
        np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
        assert got[1:] == want[1:] == (None, None)
        assert p.stats() == j.stats()
        bad = idx[:1].astype(np.int64)
        bad[0, 3] = 1 << 40
        for eng in (p, j):
            with pytest.raises(ValueError, match="out of"):
                eng.request_batch(bad)
    finally:
        p.close()
        j.close()
