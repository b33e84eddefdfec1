"""The port's gaussian index stream against the JAX package's: the cases
of tests/test_synthetic_dist.py, and the same config and seed giving the
same batches bit for bit (one-hot and bags, fixed and drawn bag sizes,
with the in-bag dedup's weights).  Tolerance: none."""

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
