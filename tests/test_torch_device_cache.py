"""The port's device C1 cache, policy and store against the JAX package's,
on the CPU.

The port's `DeviceC1Cache(device="cpu")` and the JAX `DeviceC1Cache` serve
the same grouped-Zipf request stream over 26 tables of 40-300 rows, with a
capacity small enough that evictions, perfect-set flushes and segment
flushes occur.  Per batch the rows must be bit-exact and the stats equal.
At int8 the uint8 cache state is equal exactly and the rows agree within
1.2e-7 (one f32 ulp near 1: jitted JAX contracts the decode
(v/254)*2-1 into fma(v, 2/254, -1); the port computes the formula, and is
held to it bit for bit).
"""

import numpy as np
import pytest
import torch

from evstore_tpu.cache.device_cache import DeviceC1Cache as JaxDeviceC1Cache
from evstore_tpu.cache.policy import EvLFU as JaxEvLFU
from evstore_tpu.cache.storage import StorageManager as JaxStorageManager
from evstore_tpu.config import CacheConfig as JaxCacheConfig
from evstore_tpu.data.synthetic import RandomDataConfig, random_batches
from evstore_tpu_torch.cache.device_cache import DeviceC1Cache
from evstore_tpu_torch.cache.policy import EvLFU
from evstore_tpu_torch.cache.storage import StorageManager
from evstore_tpu_torch.config import CacheConfig
from evstore_tpu_torch.ops.quant import dequantize_int8, np_quantize_int8

N_TABLES, DIM = 26, 8
STAT_KEYS = ("requests", "perfect_hits", "hit_rate", "size", "segments",
             "bytes_shipped", "capacity", "hbm_bytes")


def _tables(seed=0):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(40, 301, N_TABLES)
    return [rng.uniform(-0.9, 0.9, (int(n), DIM)).astype(np.float32)
            for n in sizes]


@pytest.mark.parametrize("capacity,perfect_item_cap,seed", [
    (60, 0.95, 0),       # barely two groups: constant eviction, NO_SLOT path
    (300, 0.95, 1),      # evictions and segment flushes
    (300, 0.1, 2),       # perfect-set flushes
    (2000, 0.95, 3),     # mostly hits
])
def test_device_cache_matches_jax(capacity, perfect_item_cap, seed):
    tables = _tables(seed)
    kw = dict(policy="evlfu", total_size=capacity, main_precision=32,
              perfect_item_cap=perfect_item_cap)
    jc = JaxDeviceC1Cache(JaxCacheConfig(**kw),
                          JaxStorageManager("dummy", dim=DIM).load(
                              tables=tables), N_TABLES, DIM, insert_bucket=16)
    pc = DeviceC1Cache(CacheConfig(**kw),
                       StorageManager("dummy", dim=DIM).load(tables=tables),
                       N_TABLES, DIM, insert_bucket=16, device="cpu")
    dcfg = RandomDataConfig(num_dense=4, table_sizes=[len(t) for t in tables],
                            batch_size=24, num_batches=8, seed=seed,
                            distribution="grouped_zipf", group_noise=0.1)
    for _, idx, _ in random_batches(dcfg):
        ref = np.asarray(jc.lookup_batch(idx))
        got = pc.lookup_batch(idx)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      ref.view(np.int32))
        np.testing.assert_array_equal(
            got.numpy(), np.stack([tables[t][idx[:, t]]
                                   for t in range(N_TABLES)], axis=1))
        js, ps = jc.stats(), pc.stats()
        assert {k: ps[k] for k in STAT_KEYS} == {k: js[k] for k in STAT_KEYS}
    assert ps["segments"] > 8 or capacity > 1000   # flushes happened
    assert sorted(pc._free) == sorted(jc._free)


def test_policy_matches_jax_evlfu():
    """Random set / promote / probe sequence: identical state throughout,
    including the min-pointer wrap and the perfect-set flush."""
    rng = np.random.default_rng(7)
    ev_j, ev_p = [], []
    jp = JaxEvLFU(40, 4, 0.3, 0.5, on_evict=lambda k, v: ev_j.append(k))
    pp = EvLFU(40, 4, 0.3, 0.5, on_evict=lambda k, v: ev_p.append(k))
    for step in range(3000):
        keys = [(t, int(rng.integers(0, 30))) for t in range(4)]
        hj, aj = jp.probe_group(keys)
        hp, ap = pp.probe_group(keys)
        assert (hj, aj) == (hp, ap)
        for k, h in zip(keys, hj):
            if h:
                assert jp.update_agg_hit(k, aj) == pp.update_agg_hit(k, ap)
            else:
                jp.set(k, step, aj)
                pp.set(k, step, ap)
        if aj == 4:
            jp.n_perfect = len(jp.buckets[4])
            pp.n_perfect = len(pp.buckets[4])
        assert jp.vals == pp.vals and jp.min_agg == pp.min_agg
        assert [list(b) for b in jp.buckets] == [list(b) for b in pp.buckets]
    assert ev_j == ev_p and len(ev_p) > 100
    assert jp.stats() == pp.stats()


def test_store_matches_jax():
    tables = _tables(4)
    keys = [(t, r) for t in (0, 5, 25) for r in (0, 3, 39)]
    ps = StorageManager("dummy", dim=DIM).load(tables=tables)
    js = JaxStorageManager("dummy", dim=DIM).load(tables=tables)
    np.testing.assert_array_equal(ps.get_batch(keys), js.get_batch(keys))
    ps.close()
    assert ps.store is None


@pytest.mark.parametrize("backend", ["file", "mmap", "sqlite", "native"])
def test_unported_store_backends_raise(backend, tmp_path):
    """The file-backed stores are ported: the Python device cache serves
    from them the rows that JAX's serves from the same files, and, as in
    the JAX driver, `build_cache` refuses them behind the device cache
    (the engine opens its own files).  The facade's `native` backend
    raises, as JAX's does."""
    from evstore_tpu.cache.storage import write_ev_tables_binary
    from evstore_tpu_torch.config import make_dlrm_config
    from evstore_tpu_torch.drivers.infer import build_cache
    tables = _tables(6)
    sizes = [len(t) for t in tables]
    write_ev_tables_binary(tables, str(tmp_path))
    kw = dict(bin_dir=str(tmp_path), table_sizes=sizes)
    if backend == "native":
        for sm in (StorageManager(backend, dim=DIM),
                   JaxStorageManager(backend, dim=DIM)):
            with pytest.raises(ValueError, match="native engine"):
                sm.load(**kw)
        return
    ps = StorageManager(backend, dim=DIM).load(
        **kw, db_path=str(tmp_path / "p.db"))
    js = JaxStorageManager(backend, dim=DIM).load(
        **kw, db_path=str(tmp_path / "j.db"))
    ccfg = dict(policy="evlfu", total_size=60)
    pc = DeviceC1Cache(CacheConfig(**ccfg), ps, N_TABLES, DIM,
                       insert_bucket=16, device="cpu")
    jc = JaxDeviceC1Cache(JaxCacheConfig(**ccfg), js, N_TABLES, DIM,
                          insert_bucket=16)
    dcfg = RandomDataConfig(num_dense=4, table_sizes=sizes, batch_size=12,
                            num_batches=3, seed=2,
                            distribution="grouped_zipf", group_noise=0.1)
    for _, idx, _ in random_batches(dcfg):
        np.testing.assert_array_equal(pc.lookup_batch(idx).numpy(),
                                      np.asarray(jc.lookup_batch(idx)))
    assert {k: pc.stats()[k] for k in STAT_KEYS} == \
        {k: jc.stats()[k] for k in STAT_KEYS}
    cfg = make_dlrm_config(DIM, sizes, (8,), (8,), num_dense=4)
    with pytest.raises(ValueError, match="file mode"):
        build_cache(CacheConfig(**ccfg), cfg, ps, use_device_cache=True,
                    device="cpu")
    ps.close()
    js.close()


@pytest.mark.parametrize("capacity,seed", [(60, 0), (300, 1)])
def test_device_cache_int8_matches_jax(capacity, seed):
    """main_precision=8: the padded miss buffer is quantised on the host
    (numpy, half to even), shipped as uint8, copied into the uint8 cache
    and gathered through the int8 gather+dequant's two-source form."""
    tables = _tables(seed)
    kw = dict(policy="evlfu", total_size=capacity, main_precision=8)
    jc = JaxDeviceC1Cache(JaxCacheConfig(**kw),
                          JaxStorageManager("dummy", dim=DIM).load(
                              tables=tables), N_TABLES, DIM, insert_bucket=16)
    pc = DeviceC1Cache(CacheConfig(**kw),
                       StorageManager("dummy", dim=DIM).load(tables=tables),
                       N_TABLES, DIM, insert_bucket=16, device="cpu")
    assert pc.cache_values.dtype == torch.uint8
    dcfg = RandomDataConfig(num_dense=4, table_sizes=[len(t) for t in tables],
                            batch_size=24, num_batches=6, seed=seed,
                            distribution="grouped_zipf", group_noise=0.1)
    for _, idx, _ in random_batches(dcfg):
        ref = np.asarray(jc.lookup_batch(idx))
        got = pc.lookup_batch(idx).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1.2e-7)
        store = np.stack([tables[t][idx[:, t]] for t in range(N_TABLES)],
                         axis=1)
        np.testing.assert_array_equal(
            got, dequantize_int8(torch.from_numpy(
                np_quantize_int8(store))).numpy())
        np.testing.assert_array_equal(pc.cache_values.numpy(),
                                      np.asarray(jc.cache_values))
        js, ps = jc.stats(), pc.stats()
        assert {k: ps[k] for k in STAT_KEYS} == {k: js[k] for k in STAT_KEYS}
    assert ps["hbm_bytes"] == capacity * DIM


def test_host_ids_outside_their_table_raise():
    """The port's rule: ids still on the host that fall outside [0, N)
    raise ValueError before any state changes.  (The JAX class would read
    the store with a wrapped negative id.)"""
    tables = _tables(5)
    pc = DeviceC1Cache(CacheConfig(total_size=60),
                       StorageManager("dummy", dim=DIM).load(tables=tables),
                       N_TABLES, DIM, insert_bucket=16, device="cpu")
    idx = np.zeros((2, N_TABLES), np.int64)
    for t, bad in ((3, -1), (25, len(tables[25]))):
        wrong = idx.copy()
        wrong[1, t] = bad
        with pytest.raises(ValueError, match=f"table {t} is outside"):
            pc.lookup_batch(wrong)
    with pytest.raises(ValueError, match="do not match"):
        pc.lookup_batch(idx[:, :5])
    assert pc.stats()["requests"] == 0


def test_unported_precisions_raise():
    """The device caches take 32- or 8-bit C1 rows, as the JAX package's
    do (16- and 4-bit rows live in the host tiers); the capacity must hold
    one request group."""
    sm = StorageManager("dummy", dim=DIM).load(tables=_tables())
    for p in (16, 4):
        with pytest.raises(ValueError, match="fp32 or int8"):
            DeviceC1Cache(CacheConfig(main_precision=p), sm, N_TABLES, DIM,
                          device="cpu")
    DeviceC1Cache(CacheConfig(main_precision=8), sm, N_TABLES, DIM,
                  device="cpu")
    with pytest.raises(ValueError, match="one request group"):
        DeviceC1Cache(CacheConfig(total_size=10), sm, N_TABLES, DIM,
                      device="cpu")
