"""The port's sharded device C1 cache (`evstore_tpu_torch/cache/
device_cache.py::ShardedDeviceC1Cache`) against the JAX package's and the
port's single-card `NativeDeviceC1Cache`, on the CPU with gloo ranks.

The two cases of tests/test_native_device_cache.py:104-148, each over a
world of 8 ranks (a 1x8 mesh, the cache on the model axis, as JAX's test
shards it over its 8 devices) and a world of 4 (a 2x2 mesh, the cache over
all ranks, the default), every rank calling with the same stream:
- fp32, 24 entries, 300 requests in batches of 50: every rank's rows
  equal JAX's sharded cache's and the port's single-card cache's
  (`np.array_equal`: a row crosses an all-reduce that adds zeros, so only
  a zero's sign may differ), rank 0's counters (requests, perfect hits,
  size, hit rate) equal both, and `hbm_bytes_per_chip · n == hbm_bytes`;
- int8, 16 entries, 120 requests: rows equal the port's single-card
  cache's and JAX's sharded cache's within JAX's test's tolerance (rtol
  1e-5, atol 1e-6: JAX's jitted decode contracts into an FMA, ROADMAP
  queue 3).
Beside them, `run_inference(mesh=, use_device_cache=True)` at
`pipeline_depth` 0 and 2 gives the single-card run's scores and stats.
"""

import functools
import shutil

import numpy as np
import pytest

from evstore_tpu_torch.parallel.multihost import spawn_local

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ toolchain")

N_TABLES, DIM = 4, 8
CASES = {"fp32": (32, 24, 300, 30, 50), "int8": (8, 16, 120, 20, 120)}


def _tables():
    rng = np.random.default_rng(0)     # tests/conftest.py's rng fixture
    tables = [rng.uniform(-0.9, 0.9, (50, DIM)).astype(np.float32)
              for _ in range(N_TABLES)]
    return tables, rng


def _stream(name):
    tables, rng = _tables()
    _, _, n, hi, _ = CASES[name]
    return tables, np.stack([rng.integers(0, hi, N_TABLES)
                             for _ in range(n)])


def _serve(cache, stream, per):
    return np.concatenate([cache.request_batch(stream[lo:lo + per])
                           for lo in range(0, len(stream), per)])


def _cache_case(mesh, axis, name):
    from evstore_tpu_torch.cache.device_cache import (NativeDeviceC1Cache,
                                                      ShardedDeviceC1Cache)
    from evstore_tpu_torch.config import CacheConfig
    prec, cap, _, _, per = CASES[name]
    tables, stream = _stream(name)
    cfg = CacheConfig(policy="evlfu", total_size=cap, main_precision=prec)
    single = NativeDeviceC1Cache(cfg, N_TABLES, DIM, insert_bucket=cap,
                                 device="cpu").load_tables(tables)
    shard = ShardedDeviceC1Cache(cfg, N_TABLES, DIM, mesh, axis=axis,
                                 insert_bucket=cap).load_tables(tables)
    out = {"single": _serve(single, stream, per),
           "sharded": _serve(shard, stream, per),
           "single_stats": single.stats(), "stats": shard.stats()}
    single.close()
    shard.close()
    return out


def _inference_case(mesh):
    from evstore_tpu_torch.cache.storage import StorageManager
    from evstore_tpu_torch.config import CacheConfig, tiny_dlrm_config
    from evstore_tpu_torch.data.synthetic import (RandomDataConfig,
                                                  random_batches)
    from evstore_tpu_torch.drivers.infer import run_inference
    from evstore_tpu_torch.models.dlrm import DLRM
    cfg = tiny_dlrm_config()
    model = DLRM(cfg, device="cpu", seed=0)
    sm = StorageManager("dummy", dim=cfg.embedding_dim).load(
        tables=[t.detach().numpy() for t in model.tables])
    ccfg = CacheConfig(policy="evlfu", total_size=40, main_precision=32)
    batches = list(random_batches(RandomDataConfig(
        num_dense=cfg.num_dense_features, table_sizes=cfg.table_sizes,
        batch_size=32, num_batches=6, seed=5, distribution="zipf")))
    out = {}
    for depth in (0, 2):
        lines = []
        for key, kw in (("single", {}), ("sharded", {"mesh": mesh})):
            res = run_inference(model, cfg, ccfg, batches, sm,
                                use_device_cache=True,
                                pipeline_depth=depth, device="cpu",
                                log_fn=lines.append, **kw)
            out[(key, depth)] = (res.scores, res.cache_stats)
        out[("lines", depth)] = len(lines)
    return out


def _world(rank, world, shape, axis):
    from evstore_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(*shape, device="cpu")
    out = {name: _cache_case(mesh, axis, name) for name in CASES}
    if world == 4:
        out["inference"] = _inference_case(mesh)
    return out


WORLDS = {8: ((1, 8), "model"), 4: ((2, 2), None)}


@functools.lru_cache(maxsize=None)
def world_results(world):
    shape, axis = WORLDS[world]
    return spawn_local(_world, world, (shape, axis), timeout_s=60,
                       limit_s=240)


@functools.lru_cache(maxsize=None)
def jax_rows(name):
    from evstore_tpu.cache.device_cache import ShardedDeviceC1Cache
    from evstore_tpu.config import CacheConfig
    from evstore_tpu.parallel.mesh import make_mesh
    prec, cap, _, _, per = CASES[name]
    tables, stream = _stream(name)
    cfg = CacheConfig(policy="evlfu", total_size=cap, main_precision=prec)
    c = ShardedDeviceC1Cache(cfg, N_TABLES, DIM, make_mesh(1, 8),
                             axis="model",
                             insert_bucket=cap).load_tables(tables)
    rows = _serve(c, stream, per)
    stats = c.stats()
    c.close()
    return rows, stats


@pytest.mark.parametrize("world", [8, 4])
def test_sharded_device_cache_matches_single_chip(world):
    ref, jstats = jax_rows("fp32")
    res = world_results(world)
    for r in range(world):
        got = res[r]["fp32"]
        assert np.array_equal(got["sharded"], ref), r
        assert np.array_equal(got["sharded"], got["single"]), r
    sa, sb = res[0]["fp32"]["single_stats"], res[0]["fp32"]["stats"]
    for k in ("requests", "perfect_hits", "size", "hit_rate"):
        assert sa[k] == sb[k] == jstats[k], k
    assert sb["hbm_bytes_per_chip"] * world == sa["hbm_bytes"] == \
        sb["hbm_bytes"]
    assert sb["capacity"] == jstats["capacity"]
    assert sb["hbm_bytes_per_chip"] == jstats["hbm_bytes_per_chip"] * 8 \
        // world
    # the other ranks hold no policy: the cache's sizes only
    assert "requests" not in res[1]["fp32"]["stats"]


@pytest.mark.parametrize("world", [8, 4])
def test_sharded_device_cache_int8(world):
    ref, _ = jax_rows("int8")
    res = world_results(world)
    for r in range(world):
        got = res[r]["int8"]
        # JAX's jitted decode contracts (v/254)*2-1 into an FMA: within
        # the tolerance of JAX's own test
        np.testing.assert_allclose(got["sharded"], ref, rtol=1e-5,
                                   atol=1e-6, err_msg=str(r))
        assert np.array_equal(got["sharded"], got["single"]), r


def test_run_inference_over_a_mesh_matches_one_card():
    res = world_results(4)
    for depth in (0, 2):
        for r in range(4):
            out = res[r]["inference"]
            (s1, st1), (s2, st2) = out[("single", depth)], \
                out[("sharded", depth)]
            assert np.array_equal(s1, s2), (r, depth)
            if r == 0:
                for k in ("requests", "perfect_hits", "size", "hit_rate",
                          "bytes_shipped", "hbm_bytes"):
                    assert st1[k] == st2[k], k
        # rank 0 logs, the others do not
        assert res[0]["inference"][("lines", depth)] == 2
        assert res[1]["inference"][("lines", depth)] == 1
