"""The port's synthetic streams against the JAX package's.

- The gaussian index stream: the cases of tests/test_synthetic_dist.py,
  and the same config and seed giving the same batches bit for bit
  (one-hot and bags, fixed and drawn bag sizes, with the in-bag dedup's
  weights).
- `trace_profile`, `trace_generate_lru`, `trace_batches` and
  `quality_fixture` bit for bit at two or three settings each, the
  fixture's uint32 alt-key guard, the cases of tests/test_service.py's
  `test_trace_*` on the port's streams, and those of
  tests/test_tier_quality.py through the port's engine
  (`NativeTieredCache`) on the port's fixture.

Tolerance: none (the tier-quality cases keep their own bounds)."""

import numpy as np
import pytest

from evstore_tpu.data import synthetic as jsyn
from evstore_tpu_torch.data import synthetic as psyn


def _same_stream(**kw):
    a = list(psyn.random_batches(psyn.RandomDataConfig(**kw)))
    b = list(jsyn.random_batches(jsyn.RandomDataConfig(**kw)))
    assert len(a) == len(b) == kw["num_batches"]
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)
    return a


def test_gaussian_indices_clip_and_center():
    kw = dict(num_dense=2, table_sizes=(1000, 500), batch_size=4096,
              num_batches=1, seed=0, distribution="gaussian",
              rand_data_min=100, rand_data_max=400, rand_data_mu=-1,
              rand_data_sigma=30)
    _, idx, _ = _same_stream(**kw)[0]
    assert idx.min() >= 100 and idx.max() <= 400
    # mu = -1: the midpoint, 250
    assert abs(idx[:, 0].mean() - 250) < 5
    assert abs(idx[:, 1].mean() - 250) < 5


def test_gaussian_default_range_is_table():
    kw = dict(num_dense=2, table_sizes=(50,), batch_size=2048,
              num_batches=1, seed=1, distribution="gaussian",
              rand_data_min=0, rand_data_max=-1, rand_data_sigma=1000)
    _, idx, _ = _same_stream(**kw)[0]
    assert idx.min() == 0 and idx.max() == 49


def test_gaussian_multihot_bag_dedup():
    kw = dict(num_dense=2, table_sizes=(20,), batch_size=64, num_batches=1,
              seed=2, distribution="gaussian", rand_data_sigma=2.0,
              num_indices_per_lookup=8, num_indices_per_lookup_fixed=True)
    _, idx, bag_w, _ = _same_stream(**kw)[0]
    assert bag_w.sum() < bag_w.size       # a narrow gaussian collides
    for b in range(idx.shape[0]):
        kept = idx[b, 0][bag_w[b, 0] > 0]
        assert len(np.unique(kept)) == len(kept)


@pytest.mark.parametrize("L,fixed,dense_dist", [
    (1, False, "uniform"), (1, False, "gaussian"), (4, False, "uniform"),
    (4, True, "gaussian"), (6, False, "gaussian")])
def test_gaussian_stream_matches_jax(L, fixed, dense_dist):
    _same_stream(num_dense=3, table_sizes=(40, 7, 300, 2), batch_size=32,
                 num_batches=3, seed=9, distribution="gaussian",
                 rand_data_mu=-1, rand_data_sigma=5.0, rand_data_min=2,
                 rand_data_max=30, dense_dist=dense_dist,
                 num_indices_per_lookup=L,
                 num_indices_per_lookup_fixed=fixed)


def test_cli_maps_gaussian():
    from evstore_tpu.cli import _make_data as jax_make_data
    from evstore_tpu.cli import build_parser as jax_parser
    from evstore_tpu.config import tiny_dlrm_config as jax_tiny
    from evstore_tpu_torch.cli import _make_data, build_parser
    from evstore_tpu_torch.config import tiny_dlrm_config
    argv = ["--data-generation", "random", "--rand-data-dist", "gaussian",
            "--rand-data-min", "0", "--rand-data-max", "3",
            "--mini-batch-size", "32", "--num-batches", "2"]
    train_fn, test_fn = _make_data(build_parser().parse_args(argv),
                                   tiny_dlrm_config())
    jtrain, jtest = jax_make_data(jax_parser().parse_args(argv), jax_tiny())
    n = 0
    for (d, idx, y), (jd, jidx, jy) in zip(train_fn(), jtrain()):
        assert idx.max() <= 3
        for u, v in ((d, jd), (idx, jidx), (y, jy)):
            np.testing.assert_array_equal(u, v)
        n += 1
    assert n == 2
    for a, b in zip(test_fn(), jtest()):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


# ------------------------------------------ the trace and quality streams

@pytest.mark.parametrize("trace,max_unique", [
    ([1, 2, 1, 3, 1, 2, 4, 1], None), ([5, 5, 5, 7, 5, 7, 9, 9, 1], 2),
    (list(np.random.default_rng(3).integers(0, 30, 400)), 12)])
def test_trace_profile_matches_jax(trace, max_unique):
    got = psyn.trace_profile(trace, max_unique)
    ref = jsyn.trace_profile(trace, max_unique)
    for u, v in zip(got, ref):
        assert u.dtype == v.dtype
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("pool,vals,cdf,n,seed", [
    (np.arange(100), [0, 1000000], [0.9, 1.0], 2000, 1),
    (np.random.default_rng(0).permutation(50), [0, 1, 4, 16, 1 << 30],
     [0.3, 0.5, 0.7, 0.9, 1.0], 700, 3),
    (np.arange(5), [0, 2, 100], [0.1, 0.2, 1.0], 300, 0)])
def test_trace_generate_lru_matches_jax(pool, vals, cdf, n, seed):
    vals, cdf = np.asarray(vals), np.asarray(cdf)
    got = psyn.trace_generate_lru(pool, vals, cdf, n, seed=seed)
    ref = jsyn.trace_generate_lru(pool, vals, cdf, n, seed=seed)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kw,dist", [
    (dict(num_dense=4, table_sizes=(500, 500), batch_size=64,
          num_batches=4, seed=0), None),
    (dict(num_dense=3, table_sizes=(40, 7, 300), batch_size=16,
          num_batches=3, seed=5), None),
    (dict(num_dense=2, table_sizes=(90, 20), batch_size=8, num_batches=5,
          seed=2), ([0, 3, 1 << 30], [0.5, 0.8, 1.0]))])
def test_trace_batches_match_jax(kw, dist):
    extra = {} if dist is None else {"dist_vals": np.asarray(dist[0]),
                                     "dist_cdf": np.asarray(dist[1])}
    got = list(psyn.trace_batches(psyn.RandomDataConfig(**kw), **extra))
    ref = list(jsyn.trace_batches(jsyn.RandomDataConfig(**kw), **extra))
    assert len(got) == len(ref) == kw["num_batches"]
    for a, b in zip(got, ref):
        for u, v in zip(a, b):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("kw", [
    dict(table_sizes=[100, 50, 77], dim=4, batch_size=16, num_batches=3),
    dict(table_sizes=[300, 64], dim=6, bucket=8, scale=2.0, seed=4,
         batch_size=32, num_batches=2, zipf_alpha=1.2, group_noise=0.3,
         label_seed=1)])
def test_quality_fixture_matches_jax(kw):
    got = psyn.quality_fixture(**kw)
    ref = jsyn.quality_fixture(**kw)
    for part in range(4):
        a, b = got[part], ref[part]
        for u, v in zip(a if isinstance(a, list) else [a],
                        b if isinstance(b, list) else [b]):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)
    rows = np.random.default_rng(0).normal(size=(5, len(kw["table_sizes"]),
                                                 kw["dim"]))
    np.testing.assert_array_equal(got[4](rows), ref[4](rows))


def test_quality_fixture_refuses_uint32_overflow():
    for mod in (psyn, jsyn):
        with pytest.raises(ValueError, match="uint32"):
            mod.quality_fixture([43_000_000], dim=1, num_batches=1,
                                batch_size=1, bucket=43_000_000)


# the cases of tests/test_service.py, on the port's streams

def test_trace_profile_and_generate():
    vals, cdf = psyn.trace_profile([1, 2, 1, 3, 1, 2, 4, 1])
    assert cdf[-1] == 1.0 and len(vals) == len(cdf)
    out = psyn.trace_generate_lru(np.arange(100), np.array([0, 1000000]),
                                  np.array([0.9, 1.0]), 2000, seed=1)
    uniq, counts = np.unique(out, return_counts=True)
    assert len(uniq) <= 100
    assert counts.max() > 2000 / 100


def test_trace_batches_locality():
    cfg = psyn.RandomDataConfig(num_dense=4, table_sizes=(500, 500),
                                batch_size=64, num_batches=10, seed=0)
    seen = []
    for dense, idx, y in psyn.trace_batches(cfg):
        assert dense.shape == (64, 4) and idx.shape == (64, 2)
        seen.append(idx)
    idx_all = np.concatenate(seen)
    assert len(np.unique(idx_all[:, 0])) < 0.6 * len(idx_all)


# the cases of tests/test_tier_quality.py, through the port's engine on
# the port's fixture

QSIZES = [1460, 583, 2173, 3194, 1000, 700, 900, 1100] * 2
QDIM = 12


@pytest.fixture(scope="module")
def quality():
    return psyn.quality_fixture(QSIZES, dim=QDIM, batch_size=256,
                                num_batches=40, seed=1)


def _auc(scores, labels):
    from evstore_tpu_torch.train.metrics import binary_metrics
    return binary_metrics(1 / (1 + np.exp(-scores)), labels)["auc"]


def _tier_run(fixture, n_layers, main_p, sec_p, with_c3, total=2000):
    from evstore_tpu_torch.config import CacheConfig
    from evstore_tpu_torch.native import NativeTieredCache
    tables, altkeys, batches, labels, score_fn = fixture
    nc = NativeTieredCache(CacheConfig(
        policy="evlfu", n_caching_layers=n_layers, total_size=total,
        main_precision=main_p, secondary_precision=sec_p,
        size_proportion=(48, 48, 4)), len(QSIZES), QDIM)
    nc.borrow_tables(tables)
    if with_c3:
        nc.load_altkeys(altkeys)
    scores = np.concatenate([score_fn(nc.request_batch(idx))
                             for idx in batches])
    st = nc.stats()
    nc.close()
    return _auc(scores, labels), st


def _exact_auc(fixture):
    tables, _, batches, labels, score_fn = fixture
    return _auc(np.concatenate([
        score_fn(np.stack([tables[t][idx[:, t]] for t in range(len(QSIZES))],
                          axis=1)) for idx in batches]), labels)


def test_exact_rows_auc_above_bar(quality):
    assert _exact_auc(quality) >= 0.75


def test_tier_quality_deltas_bounded(quality):
    auc_exact = _exact_auc(quality)
    auc_fp32, st = _tier_run(quality, 1, 32, 8, False)
    assert st["c1"]["hit_rate"] < 0.999
    np.testing.assert_allclose(auc_fp32, auc_exact, atol=1e-9)
    auc_i8, _ = _tier_run(quality, 1, 8, 4, False)
    assert abs(auc_i8 - auc_exact) < 2e-3, auc_i8
    auc_c3, st3 = _tier_run(quality, 3, 8, 4, True)
    assert st3["c3"]["hits"] > 0
    assert abs(auc_c3 - auc_exact) < 5e-2, auc_c3
    assert auc_c3 <= auc_i8 + 1e-6
