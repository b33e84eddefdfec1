"""The qr and md compressed tables (tricks/qr_embedding_bag.py,
tricks/md_embedding_bag.py) in the port against the JAX package, on the
CPU: qr at mult, add and concat and md with and without a projection; the
kinds and shapes `init_sparse_arch` makes, the lookups, 1 and 3 train steps
per optimizer (one-hot, and with bags of up to 3 and learned pooling on
the plain table), `md_solver` at the Kaggle sizes, and the optimizer-state
round trip with the factorised tables' sums (`fact`) and the pooling
weights' (`__pool_w`).

Both sides start from the same weights (`init_dlrm`, carried across with
`convert.py`).  Tolerances (`torch_port_cases.py`): lookups rtol 1e-6,
atol 1e-7 (the md projection: rtol 1e-5, a matmul summed in another
order); losses rtol 1e-5; weights and optimizer sums rtol 1e-4, atol 1e-6,
as in `test_torch_train.py::test_train_step_matches_jax`; md_solver, the
shapes and the round trip exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evstore_tpu import config as jcfg
from evstore_tpu.models import embedding as jemb
from evstore_tpu.train import train_loop as jloop
from evstore_tpu_torch import config as pcfg
from evstore_tpu_torch.convert import (opt_state_from_jax, opt_state_to_numpy,
                                       params_from_jax, params_to_numpy)
from evstore_tpu_torch.models import embedding as pemb
from evstore_tpu_torch.models.dlrm import DLRM
from evstore_tpu_torch.train import optim as popt
from evstore_tpu_torch.train.train_loop import init_opt_state
from torch_port_cases import (VARIANTS, configs, jax_params, port_model,
                              run_and_compare)

FACTORED = [v for v in VARIANTS if v != "plain"]


def _shapes(tree):
    return {jax.tree_util.keystr(p): np.shape(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("pooling", [None, "learned"])
@pytest.mark.parametrize("variant", FACTORED)
def test_init_kinds_and_shapes_match_jax(variant, pooling):
    """The port's own init (from its numpy generator) makes the kinds,
    keys and shapes of JAX's `init_sparse_arch`; its laws' bounds hold."""
    cj, cp = configs(variant, pooling)
    ref = _shapes(jax_params(cj).sparse)
    model = DLRM(cp, device="cpu", seed=4)
    _, sparse = params_to_numpy(model)
    assert _shapes(sparse) == ref
    host = pemb.init_sparse_arch(cp, np.random.default_rng(4))
    assert _shapes({f"table_{t}": e for t, e in enumerate(host)}) == ref
    for t, e in enumerate(host):
        if "kind_qr" in e:
            nq = e["kind_qr"]["q"].shape[0]
            assert np.abs(e["kind_qr"]["q"]).max() <= np.sqrt(1.0 / nq)
            assert np.abs(e["kind_qr"]["r"]).max() <= np.sqrt(
                1.0 / cp.qr_collisions)
        if "kind_md" in e and "proj" in e["kind_md"]:
            md, D = e["kind_md"]["proj"].shape
            assert np.abs(e["kind_md"]["proj"]).max() <= np.sqrt(
                2.0 / (md + D))
    # the proj of an md model is trained by autograd, the tables by rows
    trained = set(popt.dense_parameters(model))
    assert {n for n in trained if n.startswith("md.")} == \
        {n for n in dict(model.named_parameters()) if n.endswith(".proj")}


@pytest.mark.parametrize("operation", ["mult", "add", "concat"])
def test_qr_lookup_matches_jax(operation):
    rng = np.random.default_rng(1)
    qr = pemb.init_qr_tables(103, 8, 4, operation, rng)
    idx = rng.integers(0, 103, 40).astype(np.int32)
    ref = jemb.qr_lookup({k: jnp.asarray(v) for k, v in qr.items()},
                         jnp.asarray(idx), 4, operation)
    got = pemb.qr_lookup({k: torch.from_numpy(v) for k, v in qr.items()},
                         torch.from_numpy(idx), 4, operation)
    assert got.shape == (40, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("md_dim", [3, 8])
def test_md_lookup_matches_jax(md_dim):
    rng = np.random.default_rng(2)
    md = pemb.init_md_table(60, 8, md_dim, rng)
    assert ("proj" in md) == (md_dim != 8)
    idx = rng.integers(0, 60, 40).astype(np.int32)
    ref = jemb.md_lookup({k: jnp.asarray(v) for k, v in md.items()},
                         jnp.asarray(idx))
    got = pemb.md_lookup({k: torch.from_numpy(v) for k, v in md.items()},
                         torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("kernels", ["on", "off"])
@pytest.mark.parametrize("variant", FACTORED)
def test_sparse_arch_lookup_matches_jax(variant, kernels):
    cj, cp = configs(variant, kernels=kernels)
    params = jax_params(cj)
    model = port_model(cp, params)
    idx = np.stack([np.random.default_rng(t).integers(0, n, 24)
                    for t, n in enumerate(cp.table_sizes)], 1
                   ).astype(np.int32)
    ref = jemb.sparse_arch_lookup(
        jax.tree_util.tree_map(jnp.asarray, params.sparse),
        jnp.asarray(idx), cj)
    got = pemb.sparse_arch_lookup(model.entries(), torch.from_numpy(idx), cp)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("opt", ["sgd", "adagrad", "rwsadagrad"])
@pytest.mark.parametrize("variant", FACTORED)
def test_train_steps_match_jax(variant, opt, steps):
    """One-hot: the q, r and md tables take JAX's dense branch (on the rows
    a batch touched), the projections train with the MLPs."""
    run_and_compare(variant, None, opt, L=1, steps=steps)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("opt", ["sgd", "adagrad", "rwsadagrad"])
@pytest.mark.parametrize("variant", FACTORED)
def test_bagged_train_steps_with_learned_pooling_match_jax(variant, opt,
                                                            steps):
    """Bags of up to 3 and learned pooling weights on the plain table."""
    run_and_compare(variant, "learned", opt, L=3, steps=steps)


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "rwsadagrad"])
@pytest.mark.parametrize("variant", ["qr-concat", "md-proj"])
def test_train_steps_kernels_off_match_jax(variant, opt):
    """Every kernel switch off: `index_select` gathers and the per-table
    `dedup_rows` updates."""
    run_and_compare(variant, "learned", opt, L=3, steps=3, kernels="off")


KAGGLE = jcfg.kaggle_dlrm_config().table_sizes


@pytest.mark.parametrize("round_dim", [False, True])
@pytest.mark.parametrize("temperature", [0.3, -0.3])
def test_md_solver_matches_jax_at_kaggle_sizes(temperature, round_dim):
    ref = jemb.md_solver(np.asarray(KAGGLE), -temperature, d0=36,
                         round_dim=round_dim)
    got = pemb.md_solver(np.asarray(KAGGLE), -temperature, d0=36,
                         round_dim=round_dim)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_md_solver_sign_convention_is_the_references():
    """A fault of the reference, copied on purpose: `init_sparse_arch`
    passes alpha = -md_temperature, so the CLI's default temperature 0.3
    gives every Kaggle md table the full width 36 and no projection; -0.3
    gives widths from 1 to 36."""
    cfg = pcfg.kaggle_dlrm_config(md_flag=True)
    kinds = pemb.table_kinds(cfg)
    md = [d for k, d in kinds if k == "md"]
    assert len(md) == 18 and set(md) == {36}
    cold = pemb.table_kinds(pcfg.kaggle_dlrm_config(md_flag=True,
                                                    md_temperature=-0.3))
    dims = [d for k, d in cold if k == "md"]
    assert min(dims) == 1 and max(dims) == 36
    assert sum(d < 36 for d in dims) == 17
    np.testing.assert_array_equal(
        pemb.md_solver(np.asarray(KAGGLE), -0.3, d0=36), 36)


def test_kaggle_qr_and_md_kinds():
    """The Kaggle model under qr (threshold 200, 4 collisions): 18 qr
    tables and 8 plain ones, as JAX's `init_sparse_arch` decides."""
    kinds = pemb.table_kinds(pcfg.kaggle_dlrm_config(qr_flag=True))
    assert sum(k == "qr" for k, _ in kinds) == 18
    assert sum(k == "plain" for k, _ in kinds) == 8


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "rwsadagrad"])
@pytest.mark.parametrize("variant", ["qr-mult", "qr-concat", "md-proj",
                                     "md-noproj"])
def test_opt_state_round_trip_with_fact_and_pool_w(variant, opt):
    """JAX's OptState with `fact` (the qr/md sums, elementwise under
    adagrad and rwsadagrad) and `table_t__pool_w` -> the port's -> back,
    exact; the port's layout is `init_opt_state`'s, every sum a view of
    its update group's flat buffer."""
    cj, cp = configs(variant, "learned")
    params = jax.tree_util.tree_map(jnp.asarray, jax_params(cj))
    tj = jcfg.TrainConfig(optimizer=opt)
    rng = np.random.default_rng(4)
    jst = jax.tree_util.tree_map(
        lambda a: rng.random(np.shape(a)).astype(np.float32)
        if np.ndim(a) else np.int32(7), jloop.init_opt_state(params, tj))
    if opt != "sgd":
        assert jst.dense["fact"] and any(
            k.endswith("__pool_w") for k in jst.sparse)
    pst = opt_state_from_jax(jst.step, jst.dense, jst.sparse, cp,
                             device="cpu")
    model = DLRM(cp, device="cpu")
    fresh = init_opt_state(model, pcfg.TrainConfig(optimizer=opt))
    assert pst.step == 7
    assert set(pst.dense) == set(fresh.dense)
    assert set(pst.sparse) == set(fresh.sparse)
    for k, v in {**pst.dense, **pst.sparse}.items():
        ref = {**fresh.dense, **fresh.sparse}[k]
        assert v.shape == ref.shape and v.dtype == ref.dtype, k
    sources = model.row_sources()
    for _, members in popt.state_groups(sources, opt):
        popt.flat_row_state(pst.sparse, [s.param for s in members],
                            [s.name for s in members])
    step, dense, sparse = opt_state_to_numpy(pst, cp)
    assert step == 7
    got = jax.tree_util.tree_flatten_with_path((dense, sparse))[0]
    ref = jax.tree_util.tree_flatten_with_path((jst.dense, jst.sparse))[0]
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (_, a), (_, b) in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("variant", FACTORED)
def test_params_round_trip_exact(variant):
    cj, cp = configs(variant, "learned")
    params = jax_params(cj)
    model = port_model(cp, params)
    dense, sparse = params_to_numpy(model)
    got = jax.tree_util.tree_flatten_with_path((dense, sparse))[0]
    ref = jax.tree_util.tree_flatten_with_path((params.dense,
                                                params.sparse))[0]
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (_, a), (_, b) in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_params_of_another_kind_raise():
    """`params_from_jax` takes every kind, and raises where the pytree's
    kinds are not the config's."""
    cj, cp = configs("qr-mult")
    params = jax_params(cj)
    _, plain = configs("plain")
    with pytest.raises(ValueError, match="table_0 holds"):
        params_from_jax(params.dense, params.sparse, plain, device="cpu")
    state, tables = params_from_jax(params.dense, params.sparse, cp,
                                    device="cpu")
    assert len(tables) == 1 and "qr.0.q" in state
