"""The port's training path against the JAX package's, on the CPU: the LR
policy, the loss, the optimizer state conversion, `make_train_step` over
five steps for each optimizer, and `train` + `evaluate` on the learnable
fixture.

Both sides start from the same weights (the JAX pytree converted with
`convert.py`) and see the same numpy batches.  On the CPU every kernel
wrapper of the port takes its plain version; the kernels themselves are
held to those plain versions on the card by chip_smoke.py.

Tolerances: losses rtol 1e-5; tables, accumulators and MLP weights rtol
1e-4, atol 1e-6, as in test_torch_crosscheck.py.  Both are float32 with
TF32 off; the summation order of the gradients differs between XLA and
PyTorch, and rwsadagrad's kernel path scales each entry before summing
where JAX scales the sum.  The LR policy and the conversions are exact.
The full-width kernel-vs-plain test holds each step, taken from one shared
state, to chip_smoke.py phase 3b's rule: losses rtol 1e-5, MLP weights and
tables |d| <= 1e-4 (1 + |ref|), accumulators |d| <= 1e-4 (|ref| + the mean
magnitude of their nonzero entries).  A shared state per step, because at
this size (tables cut to 3,000 rows, so ids repeat far more often than in
the full tables) five compounded steps let the rounding differences of the
two row updates grow past that rule in the top MLP: adagrad divides each
update by the gradient's own accumulated norm, and a small weight change
can flip a ReLU.  chip_smoke.py phase 3b holds the full-size model to the
rule over five compounded steps as well.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evstore_tpu import config as jcfg
from evstore_tpu.data import synthetic as jsyn
from evstore_tpu.models.dlrm import dlrm_loss as jax_dlrm_loss
from evstore_tpu.models.dlrm import init_dlrm
from evstore_tpu.train import optim as jopt
from evstore_tpu.train import train_loop as jloop
from evstore_tpu_torch import config as pcfg
from evstore_tpu_torch.convert import (opt_state_from_jax, opt_state_to_numpy,
                                       params_from_jax, params_to_numpy)
from evstore_tpu_torch.data import synthetic as psyn
from evstore_tpu_torch.models.dlrm import DLRM, dlrm_loss
from evstore_tpu_torch.train import optim as popt
from evstore_tpu_torch.train.train_loop import (evaluate, init_opt_state,
                                                make_train_step, train)

SMALL = ((8, (50, 35, 20, 60), (16, 8), (12,)), {"num_dense": 6})
KERNELS_OFF = {"use_interaction_kernel": False, "use_gather_kernel": False}


def _models(seed=0, **kw):
    """JAX params and the port's DLRM with the same weights (on the CPU)."""
    args, base = SMALL
    cj = jcfg.make_dlrm_config(*args, **base)
    cp = pcfg.make_dlrm_config(*args, **base, **kw)
    params = init_dlrm(jax.random.PRNGKey(seed), cj)
    npp = jax.tree_util.tree_map(np.asarray, params)
    state, _ = params_from_jax(npp.dense, npp.sparse, cp, device="cpu")
    model = DLRM(cp, device="cpu")
    model.load_state_dict(state)
    return cj, cp, params, model


def _batches(cfg, n=5, B=32, seed=3):
    return list(psyn.random_batches(psyn.RandomDataConfig(
        num_dense=cfg.num_dense_features, table_sizes=cfg.table_sizes,
        batch_size=B, num_batches=n, seed=seed, distribution="zipf")))


def _close(got, ref, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-4,
                               atol=1e-6, err_msg=what)


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "rwsadagrad"])
@pytest.mark.parametrize("kernels", ["on", "off"])
def test_train_step_matches_jax(opt, kernels):
    """Five steps from the same start: losses, MLP weights, tables and
    accumulators.  'off' switches every use_*_kernel off, so the port takes
    its plain paths (autograd through the plain interaction, the index
    gather, the coalescing row update)."""
    kw = KERNELS_OFF if kernels == "off" else {}
    cj, cp, params, model = _models(seed=1, **kw)
    lr = 0.3 if opt == "sgd" else 0.1
    tj = jcfg.TrainConfig(batch_size=32, learning_rate=lr, optimizer=opt)
    tp = pcfg.TrainConfig(learning_rate=lr, optimizer=opt,
                          use_update_kernel=kernels == "on")
    jstep = jax.jit(jloop.make_train_step(cj, tj))
    pstep = make_train_step(cp, tp)
    jst = jloop.init_opt_state(params, tj)
    pst = init_opt_state(model, tp)
    batches = _batches(cp)
    # duplicate-heavy zipf ids: coalescing must agree
    assert any(len(np.unique(b[1][:, 0])) < 32 for b in batches)
    for dense, idx, y in batches:
        params, jst, jloss = jstep(params, jst, jnp.asarray(dense),
                                   jnp.asarray(idx), jnp.asarray(y))
        ploss = pstep(model, pst, dense, idx, y)
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)
    assert pst.step == int(jst.step) == len(batches)

    dense_j = jax.tree_util.tree_map(np.asarray, params.dense)
    dense_p, sparse_p = params_to_numpy(model)
    for part in ("bot", "top"):
        for name, lyr in dense_j[part].items():
            for k in ("w", "b"):
                _close(dense_p[part][name][k], lyr[k], f"{part}.{name}.{k}")
    for t in range(cp.num_tables):
        _close(sparse_p[f"table_{t}"]["kind_plain"],
               params.sparse[f"table_{t}"]["kind_plain"], f"table_{t}")

    step, sdense, ssparse = opt_state_to_numpy(pst, cp)
    jst = jax.tree_util.tree_map(np.asarray, jst)
    if opt == "sgd":
        assert sdense == {} and ssparse == {}
        return
    for part in ("bot", "top"):
        for name, lyr in jst.dense["mlp"][part].items():
            for k in ("w", "b"):
                _close(sdense["mlp"][part][name][k], lyr[k],
                       f"acc {part}.{name}.{k}")
    for t in range(cp.num_tables):
        acc = ssparse[f"table_{t}"]
        assert acc.shape == jst.sparse[f"table_{t}"].shape
        _close(acc, jst.sparse[f"table_{t}"], f"acc table_{t}")


def test_kernel_and_plain_paths_agree_per_step_at_full_width():
    """chip_smoke.py phase 3b on the CPU: the Kaggle model's widths (tables
    cut to 3,000 rows), rwsadagrad at B=128 and lr 0.1; before each step
    the plain copy (every use_*_kernel off) takes the kernel copy's state,
    and the two steps must agree to the phase's tolerances."""
    sizes = tuple(min(s, 3000) for s in pcfg.KAGGLE_TABLE_SIZES)
    cfg = pcfg.make_dlrm_config(36, sizes, (512, 256, 64), (512, 256))
    off = dataclasses.replace(cfg, **KERNELS_OFF)
    tcfg = pcfg.TrainConfig(learning_rate=0.1, optimizer="rwsadagrad")
    off_t = dataclasses.replace(tcfg, use_update_kernel=False)
    model, plain = DLRM(cfg, device="cpu"), DLRM(off, device="cpu")
    sk, sp = init_opt_state(model, tcfg), init_opt_state(plain, off_t)
    fk, fp = make_train_step(cfg, tcfg), make_train_step(off, off_t)
    for dense, idx, y in _batches(cfg, n=3, B=128):
        plain.load_state_dict(model.state_dict())
        for part in ("dense", "sparse"):
            for k, v in getattr(sk, part).items():
                getattr(sp, part)[k].copy_(v)
        lk, lp = fk(model, sk, dense, idx, y), fp(plain, sp, dense, idx, y)
        np.testing.assert_allclose(float(lk), float(lp), rtol=1e-5)
        got, ref = model.state_dict(), plain.state_dict()
        for k, v in ref.items():
            assert torch.all((got[k] - v).abs() <= 1e-4 * (1 + v.abs())), k
        # the accumulators, relative to their own size: their entries are
        # sums of squared gradients, whose scale differs by orders of
        # magnitude between tensors
        for part in ("dense", "sparse"):
            for k, v in getattr(sp, part).items():
                a = getattr(sk, part)[k]
                scale = v[v != 0].abs().mean() if bool((v != 0).any()) \
                    else torch.tensor(0.0)
                assert torch.all((a - v).abs()
                                 <= 1e-4 * (v.abs() + scale)), f"acc {k}"


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "rwsadagrad"])
def test_opt_state_round_trip_exact(opt):
    cj, cp, params, _ = _models()
    tj = jcfg.TrainConfig(optimizer=opt)
    rng = np.random.default_rng(4)
    jst = jax.tree_util.tree_map(
        lambda a: rng.random(np.shape(a)).astype(np.float32)
        if np.ndim(a) else np.int32(7), jloop.init_opt_state(params, tj))
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
    step, dense, sparse = opt_state_to_numpy(pst, cp)
    assert step == 7
    got = jax.tree_util.tree_leaves((dense, sparse))
    ref = jax.tree_util.tree_leaves((jst.dense, jst.sparse))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def _shares_one_buffer(sparse, sizes):
    views = [sparse[f"tables.{t}"] for t in range(len(sizes))]
    ptr = views[0].untyped_storage().data_ptr()
    offsets = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    return all(v.untyped_storage().data_ptr() == ptr
               and v.storage_offset() == views[0].storage_offset() + o
               and tuple(v.shape) == (n,)
               for v, o, n in zip(views, offsets, sizes))


def test_rwsadagrad_accumulators_are_views_of_one_buffer():
    """`init_opt_state` and `opt_state_from_jax` build rwsadagrad's
    accumulators as views of one flat buffer, in table order, which the
    grouped update takes whole; adagrad's stay per table."""
    cj, cp, params, model = _models()
    sizes = cp.table_sizes
    st = init_opt_state(model, pcfg.TrainConfig(optimizer="rwsadagrad"))
    assert _shares_one_buffer(st.sparse, sizes)
    flat = popt.flat_row_state(st.sparse, list(model.tables))
    assert flat.shape == (sum(sizes),)
    flat[sizes[0]] = 5.0                     # row 0 of table 1
    assert float(st.sparse["tables.1"][0]) == 5.0
    tj = jcfg.TrainConfig(optimizer="rwsadagrad")
    jst = jax.tree_util.tree_map(np.asarray, jloop.init_opt_state(params, tj))
    pst = opt_state_from_jax(jst.step, jst.dense, jst.sparse, cp,
                             device="cpu")
    assert _shares_one_buffer(pst.sparse, sizes)
    ada = init_opt_state(model, pcfg.TrainConfig(optimizer="adagrad"))
    assert not _shares_one_buffer(
        {k: v[:, 0] for k, v in ada.sparse.items()}, sizes)


def test_replaced_accumulator_views_raise():
    """The grouped update never falls back to the per-table loop: a state
    whose views no longer lie in the one buffer raises ValueError, in
    `flat_row_state` and in the train step, and changes nothing."""
    _, cp, _, model = _models()
    tcfg = pcfg.TrainConfig(optimizer="rwsadagrad", learning_rate=0.1)
    dense, idx, y = _batches(cp, n=1)[0]
    for t in (0, 2):
        st = init_opt_state(model, tcfg)
        st.sparse[f"tables.{t}"] = st.sparse[f"tables.{t}"].clone()
        with pytest.raises(ValueError, match="one flat accumulator buffer"):
            popt.flat_row_state(st.sparse, list(model.tables))
        before = jax.tree_util.tree_leaves(params_to_numpy(model))
        with pytest.raises(ValueError, match="flat accumulator"):
            make_train_step(cp, tcfg)(model, st, dense, idx, y)
        after = jax.tree_util.tree_leaves(params_to_numpy(model))
        assert st.step == 0 and len(after) == len(before)
        for a, b in zip(after, before):
            np.testing.assert_array_equal(a, b)
    # the per-table path (the kernel off) takes any state
    off = dataclasses.replace(tcfg, use_update_kernel=False)
    st = init_opt_state(model, off)
    st.sparse["tables.1"] = st.sparse["tables.1"].clone()
    make_train_step(cp, off)(model, st, dense, idx, y)


@pytest.mark.parametrize("warm,start,ndecay", [(10, 20, 10), (0, 0, 0),
                                               (5, 5, 30), (3, 0, 8)])
def test_lr_schedule_matches_jax(warm, start, ndecay):
    jlr = jopt.lr_schedule(0.1, warm, start, ndecay)
    plr = popt.lr_schedule(0.1, warm, start, ndecay)
    for step in range(0, 60):
        assert plr(step) == float(jlr(step)), step


@pytest.mark.parametrize("loss", ["bce", "mse", "wbce"])
def test_dlrm_loss_matches_jax(loss):
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 3, 64).astype(np.float32)
    y = rng.integers(0, 2, 64).astype(np.float32)
    ref = jax_dlrm_loss(jnp.asarray(logits), jnp.asarray(y), loss,
                        (0.3, 2.0))
    got = dlrm_loss(torch.from_numpy(logits), torch.from_numpy(y), loss,
                    (0.3, 2.0))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_learnable_batches_match_jax():
    kw = dict(num_dense=4, table_sizes=(40, 30, 20), batch_size=16,
              num_batches=4, seed=9)
    for (a, b) in zip(jsyn.learnable_batches(jsyn.RandomDataConfig(**kw)),
                      psyn.learnable_batches(psyn.RandomDataConfig(**kw))):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def _learnable(n=200):
    cfg = pcfg.tiny_dlrm_config()
    return cfg, psyn.RandomDataConfig(
        num_dense=cfg.num_dense_features, table_sizes=cfg.table_sizes,
        batch_size=128, num_batches=n)


def test_train_then_evaluate_learns():
    """The verify recipe: tiny config, bs 128, lr 0.2, rwsadagrad, 200
    learnable batches; then `evaluate` on a held-out stream of the same
    hidden model, and on the training stream."""
    cfg, dcfg = _learnable()
    tcfg = pcfg.TrainConfig(learning_rate=0.2,
                            optimizer="rwsadagrad", print_freq=20)
    model = DLRM(cfg, device="cpu", seed=1)
    logged = []
    model, opt_state, hist = train(
        model, cfg, tcfg, psyn.learnable_batches(dcfg),
        test_batches=psyn.learnable_batches(
            dataclasses.replace(dcfg, num_batches=40, seed=999)),
        log_fn=logged.append)
    assert opt_state.step == 200 and len(hist["loss"]) == len(logged) == 10
    assert hist["it_per_s"] > 0
    assert np.mean(hist["loss"][-3:]) < np.mean(hist["loss"][:3])
    assert hist["eval"]["auc"] > 0.8, hist["eval"]
    assert evaluate(model, cfg, psyn.learnable_batches(dcfg))["auc"] > 0.8


def test_evaluate_matches_jax():
    cj, cp, params, model = _models(seed=2)
    batches = _batches(cp, n=3)
    ref = jloop.evaluate(params, cj, batches)
    got = evaluate(model, cp, batches)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-6, err_msg=k)


def test_unported_training_inputs_raise():
    _, cp, _, model = _models()
    step = make_train_step(cp, pcfg.TrainConfig())
    st = init_opt_state(model, pcfg.TrainConfig())
    dense, idx, y = _batches(cp, n=1)[0]
    with pytest.raises(NotImplementedError, match="multi-hot"):
        step(model, st, dense, idx[:, :, None], y)
    with pytest.raises(NotImplementedError, match="multi-hot"):
        evaluate(model, cp, [(dense, idx, np.ones(idx.shape), y)])
    other = dataclasses.replace(cp, use_gather_kernel=False)
    with pytest.raises(ValueError, match="another DLRMConfig"):
        make_train_step(other, pcfg.TrainConfig())(model, st, dense, idx, y)
    with pytest.raises(ValueError, match="unsupported optimizer"):
        init_opt_state(model, pcfg.TrainConfig(optimizer="adam"))


@pytest.mark.parametrize("kernels", ["on", "off"])
def test_bf16_sgd_step_matches_jax(kernels):
    """One sgd step at compute_dtype=bfloat16 (f32 parameters).  The loss
    within rtol 1e-5; the top MLP and the tables within 1e-4 (1 + |ref|).
    The bottom MLP within 2e-4 (1 + |ref|): its gradient comes through the
    interaction's VJP, which the port computes in float32 and rounds to
    bf16 once, at the end, where XLA rounds after each product, so a bf16
    cotangent can differ by an ulp and move a weight's update by
    lr * 2^-8 |g| (1.27e-4 at most here)."""
    kw = dict(KERNELS_OFF if kernels == "off" else {},
              compute_dtype="bfloat16")
    args, base = SMALL
    cj = jcfg.make_dlrm_config(*args, **base, compute_dtype="bfloat16")
    cp = pcfg.make_dlrm_config(*args, **base, **kw)
    params = init_dlrm(jax.random.PRNGKey(1), cj)
    npp = jax.tree_util.tree_map(np.asarray, params)
    model = DLRM(cp, device="cpu")
    model.load_state_dict(params_from_jax(npp.dense, npp.sparse, cp,
                                          device="cpu")[0])
    tj = jcfg.TrainConfig(batch_size=32, learning_rate=0.3, optimizer="sgd")
    tp = pcfg.TrainConfig(learning_rate=0.3, optimizer="sgd")
    dense, idx, y = _batches(cp, n=1)[0]
    params, _, jloss = jax.jit(jloop.make_train_step(cj, tj))(
        params, jloop.init_opt_state(params, tj), jnp.asarray(dense),
        jnp.asarray(idx), jnp.asarray(y))
    ploss = make_train_step(cp, tp)(model, init_opt_state(model, tp), dense,
                                    idx, y)
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)

    def within(got, ref, rel, what):
        ref = np.asarray(ref)
        d = np.abs(np.asarray(got) - ref) / (1 + np.abs(ref))
        assert d.max() <= rel, (what, float(d.max()))

    dense_j = jax.tree_util.tree_map(np.asarray, params.dense)
    dense_p, sparse_p = params_to_numpy(model)
    for part, rel in (("bot", 2e-4), ("top", 1e-4)):
        for name, lyr in dense_j[part].items():
            for k in ("w", "b"):
                within(dense_p[part][name][k], lyr[k], rel,
                       f"{part}.{name}.{k}")
    for t in range(cp.num_tables):
        within(sparse_p[f"table_{t}"]["kind_plain"],
               params.sparse[f"table_{t}"]["kind_plain"], 1e-4, f"table_{t}")


def test_host_ids_outside_their_table_raise():
    """The port's id rule on the training side: numpy ids outside [0, N)
    raise ValueError in the train step and in `evaluate`; the JAX step
    clips them in its lookup and wraps a negative one in its row update."""
    _, cp, _, model = _models()
    step = make_train_step(cp, pcfg.TrainConfig())
    st = init_opt_state(model, pcfg.TrainConfig())
    dense, idx, y = _batches(cp, n=1)[0]
    before = params_to_numpy(model)
    for t, bad in ((0, -1), (2, cp.table_sizes[2])):
        wrong = idx.copy()
        wrong[5, t] = bad
        with pytest.raises(ValueError, match=f"table {t} is outside"):
            step(model, st, dense, wrong, y)
        with pytest.raises(ValueError, match="outside"):
            evaluate(model, cp, [(dense, wrong, y)])
        with pytest.raises(ValueError, match="outside"):
            train(model, cp, pcfg.TrainConfig(), [(dense, wrong, y)],
                  log_fn=lambda *_: None)
    assert st.step == 0
    after = params_to_numpy(model)
    for t in range(cp.num_tables):
        np.testing.assert_array_equal(after[1][f"table_{t}"]["kind_plain"],
                                      before[1][f"table_{t}"]["kind_plain"])
