"""Weighted pooling (reference --weighted-pooling, per-row weights v_W,
dlrm_s_pytorch.py:284-293,407-459) in the port against the JAX package, on
the CPU: the cases of `tests/test_weighted_pooling.py` (fixed weights start
as the identity, weights scale rows, learned weights update only the rows
a batch touches, fixed ones never move), each held to JAX's numbers, and
train steps with learned and fixed weights for every optimizer, one-hot
and with bags.

Tolerances (`torch_port_cases.py`): lookups rtol 1e-6; losses rtol 1e-5;
weights and optimizer sums rtol 1e-4, atol 1e-6, as in
`test_torch_train.py::test_train_step_matches_jax`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evstore_tpu.config import TrainConfig as JTrainConfig
from evstore_tpu.models.dlrm import init_dlrm
from evstore_tpu.models.embedding import sparse_arch_lookup as jlookup
from evstore_tpu.train import train_loop as jloop
from evstore_tpu_torch import config as pcfg
from evstore_tpu_torch.convert import params_to_numpy
from evstore_tpu_torch.models.dlrm import DLRM
from evstore_tpu_torch.models.embedding import sparse_arch_lookup
from evstore_tpu_torch.train.train_loop import init_opt_state, make_train_step
from torch_port_cases import configs, jax_params, port_model, run_and_compare


def _tiny(mode):
    from evstore_tpu.config import tiny_dlrm_config as jtiny
    import dataclasses
    return (dataclasses.replace(jtiny(), weighted_pooling=mode),
            pcfg.tiny_dlrm_config(weighted_pooling=mode))


def _jax_sparse(params):
    return jax.tree_util.tree_map(jnp.asarray, params.sparse)


def test_fixed_weights_start_as_identity():
    """The port's own init: pool_w at ones, so the lookup equals the
    unweighted one, as in the JAX package."""
    _, cp = _tiny("fixed")
    model = DLRM(cp, device="cpu", seed=0)
    assert set(model.pool_weights()) == {0, 1, 2}
    for w in model.pool_weights().values():
        assert torch.equal(w, torch.ones_like(w))
    base = DLRM(pcfg.tiny_dlrm_config(), device="cpu", seed=0)
    idx = torch.from_numpy(np.random.default_rng(0).integers(
        0, 20, (8, cp.num_tables)).astype(np.int32))
    a = model(torch.rand(8, 4), idx)
    b = base(torch.rand(8, 4), idx)
    assert a.shape == b.shape
    rows = sparse_arch_lookup(model.entries(), idx, cp,
                              pool_w=model.pool_weights())
    plain = sparse_arch_lookup(base.entries(), idx, pcfg.tiny_dlrm_config())
    assert torch.equal(rows, plain)


def test_weights_scale_rows_like_jax():
    cj, cp = _tiny("fixed")
    params = jax.tree_util.tree_map(np.array,
                                    init_dlrm(jax.random.PRNGKey(0), cj))
    params.sparse["table_0"]["pool_w"][5] = 2.0
    model = port_model(cp, params)
    idx = np.full((1, cp.num_tables), 5, np.int32)
    ref = np.asarray(jlookup(_jax_sparse(params), jnp.asarray(idx), cj))
    got = sparse_arch_lookup(model.entries(), torch.from_numpy(idx), cp,
                             pool_w=model.pool_weights()).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    np.testing.assert_allclose(
        got[0, 0], 2.0 * params.sparse["table_0"]["kind_plain"][5],
        rtol=1e-6)


def _tiny_step(mode, opt):
    cj, cp = _tiny(mode)
    lr = 0.5
    params = jax.tree_util.tree_map(np.asarray,
                                    init_dlrm(jax.random.PRNGKey(0), cj))
    rng = np.random.default_rng(0)
    dense = rng.random((8, cp.num_dense_features)).astype(np.float32)
    idx = rng.integers(0, 10, (8, cp.num_tables)).astype(np.int32)
    y = rng.integers(0, 2, 8).astype(np.float32)
    tj = JTrainConfig(batch_size=8, optimizer=opt, learning_rate=lr)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    p2, _, jloss = jax.jit(jloop.make_train_step(cj, tj))(
        jp, jloop.init_opt_state(jp, tj), jnp.asarray(dense),
        jnp.asarray(idx), jnp.asarray(y))
    model = port_model(cp, params)
    tp = pcfg.TrainConfig(optimizer=opt, learning_rate=lr)
    loss = make_train_step(cp, tp)(model, init_opt_state(model, tp), dense,
                                   idx, y)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    return params, jax.tree_util.tree_map(np.asarray, p2), model, idx


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "rwsadagrad"])
def test_learned_weights_update_only_touched_rows(opt):
    params, p2, model, idx = _tiny_step("learned", opt)
    _, sparse = params_to_numpy(model)
    for t in range(3):
        w0 = params.sparse[f"table_{t}"]["pool_w"]
        w_jax = p2.sparse[f"table_{t}"]["pool_w"]
        w_port = sparse[f"table_{t}"]["pool_w"]
        touched = set(np.unique(idx[:, t]))
        changed = set(np.where(np.any(w0 != w_port, axis=1))[0])
        assert changed and changed <= touched
        np.testing.assert_array_equal(w_port[10:], w0[10:])
        np.testing.assert_allclose(w_port, w_jax, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "rwsadagrad"])
def test_fixed_weights_not_updated_by_training(opt):
    params, p2, model, _ = _tiny_step("fixed", opt)
    _, sparse = params_to_numpy(model)
    for t in range(3):
        np.testing.assert_array_equal(sparse[f"table_{t}"]["pool_w"],
                                      params.sparse[f"table_{t}"]["pool_w"])
        np.testing.assert_array_equal(p2.sparse[f"table_{t}"]["pool_w"],
                                      params.sparse[f"table_{t}"]["pool_w"])
        np.testing.assert_allclose(sparse[f"table_{t}"]["kind_plain"],
                                   p2.sparse[f"table_{t}"]["kind_plain"],
                                   rtol=1e-4, atol=1e-6)


def test_opt_state_holds_pool_weights_sums():
    """`init_opt_state` keeps a sum for each table's pooling weights, as
    JAX's `table_t__pool_w` ([n] under rwsadagrad, [n, 1] under adagrad),
    learned or fixed."""
    for mode in ("learned", "fixed"):
        _, cp = _tiny(mode)
        model = DLRM(cp, device="cpu")
        for opt, shape in (("rwsadagrad", (40,)), ("adagrad", (40, 1))):
            st = init_opt_state(model, pcfg.TrainConfig(optimizer=opt))
            assert tuple(st.sparse["pool_w.0"].shape) == shape


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("L", [1, 3])
@pytest.mark.parametrize("opt", ["sgd", "adagrad", "rwsadagrad"])
def test_learned_pooling_train_steps_match_jax(opt, L, steps):
    """Learned weights on every table, one-hot and with bags of up to 3:
    the tables, the weights and their optimizer sums after 1 and 3 steps."""
    run_and_compare("plain", "learned", opt, L=L, steps=steps)


@pytest.mark.parametrize("opt", ["sgd", "rwsadagrad"])
def test_fixed_pooling_train_steps_match_jax(opt):
    run_and_compare("plain", "fixed", opt, L=3, steps=3)


@pytest.mark.parametrize("opt", ["adagrad", "rwsadagrad"])
def test_learned_pooling_kernels_off_match_jax(opt):
    """With every kernel switch off: `index_select` gathers and the
    per-table `dedup_rows` update of the weights."""
    run_and_compare("plain", "learned", opt, L=3, steps=3, kernels="off")


def test_learned_pooling_with_qr_tables_matches_jax():
    """Weights on the one plain table of a qr model (the qr tables carry
    none, as in the JAX package)."""
    cj, cp = configs("qr-mult", "learned")
    params = jax_params(cj)
    assert [("pool_w" in e) for e in params.sparse.values()] == \
        [False, False, True, False, False]
    run_and_compare("qr-mult", "learned", "rwsadagrad", L=3, steps=3)
