"""Multi-hot bags in the port against the JAX package, on the CPU:
`pool_bags`, `sparse_arch_lookup` over [B, T, L] ids with and without bag
weights, 1 and 3 train steps with bags for every optimizer (the kernel
switches on and off: on the CPU both take plain versions, by different
code: the grouped updates and the grouped gather's plain version against
`dedup_rows` and `index_select`), the multi-hot synthetic stream and
`evaluate` with bag weights.

Both sides start from the same weights (`init_dlrm`, carried across with
`convert.py`) and see the same numpy inputs.  Tolerances
(`torch_port_cases.py`): the lookups rtol 1e-6, atol 1e-7 (the same
products, summed over at most L = 4 rows in another order); losses rtol
1e-5; weights and optimizer sums rtol 1e-4, atol 1e-6, as in
`test_torch_train.py::test_train_step_matches_jax`; the stream exact;
evaluate's metrics atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evstore_tpu.data import synthetic as jsyn
from evstore_tpu.models import embedding as jemb
from evstore_tpu.train import train_loop as jloop
from evstore_tpu_torch.data import synthetic as psyn
from evstore_tpu_torch.models import embedding as pemb
from evstore_tpu_torch.train.train_loop import (evaluate, init_opt_state,
                                                make_train_step, train,
                                                unpack_batch)
from torch_port_cases import (batches, configs, jax_params, port_model,
                              run_and_compare)

LOOKUP_TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("weighted", [False, True])
def test_pool_bags_matches_jax(weighted):
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(6, 4, 5)).astype(np.float32)
    w = rng.uniform(0, 2, (6, 4)).astype(np.float32) if weighted else None
    ref = jemb.pool_bags(jnp.asarray(rows),
                         None if w is None else jnp.asarray(w))
    got = pemb.pool_bags(torch.from_numpy(rows),
                         None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LOOKUP_TOL)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kernels", ["on", "off"])
@pytest.mark.parametrize("variant", ["plain", "qr-mult", "md-proj"])
def test_sparse_arch_lookup_bags_matches_jax(variant, kernels, weighted):
    """[B, T, L] bags of up to 4 ids (padded with id 0, weight 0), the
    same weights on both sides; with bag weights, random ones."""
    cj, cp = configs(variant, kernels=kernels)
    params = jax_params(cj)
    model = port_model(cp, params)
    d, idx, w, _ = batches(cp, L=4, n=1)[0]
    if weighted:
        w = w * np.random.default_rng(1).uniform(0.2, 2.0, w.shape
                                                 ).astype(np.float32)
    ref = jemb.sparse_arch_lookup(
        {k: {kk: (jnp.asarray(vv) if not isinstance(vv, dict) else
                  {a: jnp.asarray(b) for a, b in vv.items()})
             for kk, vv in e.items()} for k, e in params.sparse.items()},
        jnp.asarray(idx), cj, jnp.asarray(w) if weighted else None)
    got = pemb.sparse_arch_lookup(
        model.entries(), torch.from_numpy(idx), cp,
        torch.from_numpy(w) if weighted else None, model.pool_weights())
    assert got.shape == (idx.shape[0], cp.num_tables, cp.embedding_dim)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               **LOOKUP_TOL)


def test_bag_padding_is_inert():
    """Slots of weight 0 add nothing, whatever their id: the lookup equals
    the one of the bags cut to their sizes."""
    _, cp = configs("plain")
    model = port_model(cp, jax_params(configs("plain")[0]))
    d, idx, w, _ = batches(cp, L=4, n=1)[0]
    other = np.where(w > 0, idx, 3).astype(np.int32)
    a, b = (pemb.sparse_arch_lookup(model.entries(), torch.from_numpy(i), cp,
                                    torch.from_numpy(w))
            for i in (idx, other))
    assert torch.equal(a, b)
    tables = [t.detach().numpy() for t in model.tables]
    want = np.stack([
        np.stack([tables[t][idx[s, t][w[s, t] > 0]].sum(0)
                  for t in range(cp.num_tables)])
        for s in range(idx.shape[0])])
    np.testing.assert_allclose(a.numpy(), want, **LOOKUP_TOL)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("kernels", ["on", "off"])
@pytest.mark.parametrize("opt", ["sgd", "adagrad", "rwsadagrad"])
def test_train_steps_with_bags_match_jax(opt, kernels, steps):
    """Bags of up to 3 zipf ids with their 0/1 bag weights: every row
    gradient of a table coalesces over the B·L lookups."""
    run_and_compare("plain", None, opt, L=3, steps=steps, kernels=kernels)


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "rwsadagrad"])
def test_fixed_size_bags_train_like_jax(opt):
    """Bags of exactly 3 (`num_indices_per_lookup_fixed`): weights all 1."""
    cj, cp = configs("plain")
    bs = batches(cp, L=3, n=1, fixed=True)
    assert (bs[0][2] == 1).all()
    model = port_model(cp, jax_params(cj))
    from evstore_tpu import config as jcfg
    from evstore_tpu_torch import config as pcfg
    import jax
    tj = jcfg.TrainConfig(batch_size=16, learning_rate=0.1, optimizer=opt)
    tp = pcfg.TrainConfig(learning_rate=0.1, optimizer=opt)
    params = jax.tree_util.tree_map(jnp.asarray, jax_params(cj))
    d, i, y, w = unpack_batch(bs[0])
    _, _, jloss = jax.jit(jloop.make_train_step(cj, tj))(
        params, jloop.init_opt_state(params, tj), jnp.asarray(d),
        jnp.asarray(i), jnp.asarray(y), jnp.asarray(w))
    ploss = make_train_step(cp, tp)(model, init_opt_state(model, tp), d, i,
                                    y, w)
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("fixed", [False, True])
@pytest.mark.parametrize("dense_dist", ["uniform", "gaussian"])
@pytest.mark.parametrize("dist", ["uniform", "zipf", "grouped_zipf"])
def test_multihot_stream_matches_jax(dist, dense_dist, fixed):
    """Batch for batch equal to the JAX package's stream: bags of up to 5
    (or exactly 5), uniform or gaussian dense features."""
    kw = dict(num_dense=4, table_sizes=(40, 3, 2_000_000), batch_size=8,
              num_batches=3, seed=11, distribution=dist,
              num_indices_per_lookup=5, num_indices_per_lookup_fixed=fixed,
              dense_dist=dense_dist)
    ref = list(jsyn.random_batches(jsyn.RandomDataConfig(**kw)))
    got = list(psyn.random_batches(psyn.RandomDataConfig(**kw)))
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        assert len(a) == len(b) == 4
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("dense_dist", ["uniform", "gaussian"])
def test_one_hot_stream_with_dense_dist_matches_jax(dense_dist):
    kw = dict(num_dense=4, table_sizes=(40, 30), batch_size=8,
              num_batches=2, seed=5, distribution="zipf",
              dense_dist=dense_dist)
    for a, b in zip(psyn.random_batches(psyn.RandomDataConfig(**kw)),
                    jsyn.random_batches(jsyn.RandomDataConfig(**kw))):
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_gaussian_index_stream_still_raises():
    with pytest.raises(NotImplementedError, match="gaussian"):
        next(psyn.random_batches(psyn.RandomDataConfig(
            distribution="gaussian", num_indices_per_lookup=3)))


@pytest.mark.parametrize("variant", ["plain", "qr-concat", "md-proj"])
def test_evaluate_with_bag_weights_matches_jax(variant):
    cj, cp = configs(variant, "learned")
    params = jax_params(cj)
    model = port_model(cp, params)
    bs = batches(cp, L=3, n=3, B=32, seed=8)
    import jax
    ref = jloop.evaluate(jax.tree_util.tree_map(jnp.asarray, params), cj, bs)
    got = evaluate(model, cp, bs)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-6, err_msg=k)


def test_train_takes_bagged_batches():
    """`train` over 4-tuples and `evaluate` afterwards; the loss is
    finite and the step count right."""
    _, cp = configs("plain")
    model = port_model(cp, jax_params(configs("plain")[0]))
    from evstore_tpu_torch import config as pcfg
    model, st, hist = train(model, cp, pcfg.TrainConfig(print_freq=1),
                            batches(cp, L=3, n=4), log_fn=lambda *_: None,
                            test_batches=batches(cp, L=3, n=2, seed=9))
    assert st.step == 4 and len(hist["loss"]) == 4
    assert all(np.isfinite(hist["loss"]))
    assert np.isfinite(hist["eval"]["auc"])


def test_bag_inputs_are_checked():
    _, cp = configs("plain")
    model = port_model(cp, jax_params(configs("plain")[0]))
    from evstore_tpu_torch import config as pcfg
    step = make_train_step(cp, pcfg.TrainConfig())
    st = init_opt_state(model, pcfg.TrainConfig())
    d, idx, w, y = batches(cp, L=3, n=1)[0]
    with pytest.raises(ValueError, match="bag weights"):
        step(model, st, d, idx, y, w[:, :, :2])
    with pytest.raises(ValueError, match="bag weights"):
        step(model, st, d, idx[:, :, 0], y, w)
    bad = idx.copy()
    bad[2, 1, 2] = cp.table_sizes[1]
    with pytest.raises(ValueError, match="table 1 is outside"):
        step(model, st, d, bad, y, w)
    with pytest.raises(ValueError, match=r"\[B, T\] or \[B, T, L\]"):
        step(model, st, d, idx[..., None], y)
    assert st.step == 0
