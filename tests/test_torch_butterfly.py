"""The port's butterfly (table-wise, all-to-all) mode
(`evstore_tpu_torch/parallel/butterfly.py`) and placement planner
(`parallel/planner.py`) against the JAX package's, on the CPU.

Every case runs in one world of 4 gloo ranks (`parallel/multihost.py::
spawn_local`, every group's timeout 60 s, the world killed after 240 s);
the JAX side runs here on the first 4 devices of its 8-device virtual CPU
mesh, a 1-D mesh, from the same numpy weights and batches.  One case per case of tests/test_butterfly.py:
- the stack and its inverse, equal to JAX's `stack_tables` bit for bit;
- one step under sgd, adagrad and rwsadagrad, dense and dedup exchange,
  held to JAX's `make_butterfly_train_step`: the loss, every table, the
  bottom MLP and the row sums within 1e-5·(1 + |ref|);
- dedup equals the dense exchange on a duplicate-heavy batch;
- the planner equals JAX's (order and imbalance exactly) on the skewed
  sizes of JAX's test and on random sizes and frequencies, and the
  planner's order trains as JAX's does (dense and dedup);
- the loss falls over 60 learnable batches;
- bags with weights, dense and dedup, held to JAX's step with bags;
- `run_training(alltoall_impl="butterfly")` returns the trained model;
- resume: a butterfly run interrupted at its checkpoint and resumed equals
  the uninterrupted run bit for bit, tables and optimizer sums.  JAX's
  run does not (its butterfly route restarts the lr schedule's count at
  zero on resume), which `test_jax_butterfly_resume_restarts_its_count`
  pins.
"""

import functools
import os

import numpy as np
import pytest

from evstore_tpu_torch.parallel.multihost import spawn_local

SIZES = (40, 40, 40, 40, 30, 30, 30, 30)     # JAX's test config
INTERLEAVED = (30, 40, 30, 40, 40, 30, 40, 30)
OPTS = ["sgd", "adagrad", "rwsadagrad"]


def _pcfg(sizes=SIZES):
    from evstore_tpu_torch import config as pcfg
    return pcfg.make_dlrm_config(4, sizes, (8,), (8,), num_dense=4)


def _jcfg(sizes=SIZES):
    from evstore_tpu import config as jcfg
    return jcfg.make_dlrm_config(4, sizes, (8,), (8,), num_dense=4)


def _batch(sizes, B, seed=0, L=None, dup=False):
    rng = np.random.default_rng(seed)
    dense = rng.random((B, 4)).astype(np.float32)
    if L is None:
        hi = [min(s, 5) if dup else s for s in sizes]
        idx = np.stack([rng.integers(0, s, B) for s in hi],
                       axis=1).astype(np.int32)
        w = None
    else:
        idx = np.stack([rng.integers(0, s, (B, L)) for s in sizes],
                       axis=1).astype(np.int32)
        w = rng.random((B, len(sizes), L)).astype(np.float32)
    y = rng.integers(0, 2, B).astype(np.float32)
    return dense, idx, y, w


def bound(got, ref, what=""):
    """|got - ref| <= 1e-5 (1 + |ref|), elementwise."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_array_less(np.abs(got - ref),
                                 1e-5 * (1 + np.abs(ref)) + 1e-300,
                                 err_msg=what)


# ------------------------------------------------ the port, in each rank

def _step_case(mesh, opt, dedup, L, planned, B, seed, dup, params):
    """One butterfly step from the JAX weights: (loss, the JAX-layout
    numpy of the model and its state)."""
    from evstore_tpu_torch import config as pcfg
    from evstore_tpu_torch.convert import (butterfly_from_jax,
                                           butterfly_to_numpy)
    from evstore_tpu_torch.parallel.butterfly import \
        make_butterfly_train_step
    from evstore_tpu_torch.parallel.planner import plan_table_shards
    sizes = INTERLEAVED if planned else SIZES
    cfg = _pcfg(sizes)
    tcfg = pcfg.TrainConfig(batch_size=B, learning_rate=0.1, optimizer=opt)
    order = plan_table_shards(sizes, mesh.world)[0] if planned else None
    st = butterfly_from_jax(params["dense"], params["sparse"], cfg, tcfg,
                            mesh, order)
    step = make_butterfly_train_step(cfg, tcfg, mesh, dedup_exchange=dedup,
                                     table_order=order)
    loss = float(step(st, *_batch(sizes, B, seed, L, dup)))
    return loss, butterfly_to_numpy(st, cfg, mesh, tcfg)


def _converge_case(mesh):
    from evstore_tpu_torch import config as pcfg
    from evstore_tpu_torch.data.synthetic import (RandomDataConfig,
                                                  learnable_batches)
    from evstore_tpu_torch.models.dlrm import DLRM
    from evstore_tpu_torch.parallel.butterfly import (
        init_butterfly_state, make_butterfly_train_step)
    cfg = _pcfg()
    tcfg = pcfg.TrainConfig(batch_size=32, learning_rate=0.3,
                            optimizer="rwsadagrad")
    st = init_butterfly_state(DLRM(cfg, device="cpu", seed=1), tcfg, mesh)
    step = make_butterfly_train_step(cfg, tcfg, mesh)
    dcfg = RandomDataConfig(num_dense=4, table_sizes=cfg.table_sizes,
                            batch_size=32, num_batches=60, seed=0)
    return [float(step(st, d, i, y)) for d, i, y in learnable_batches(dcfg)]


def _driver_case(mesh, tmp, opt):
    """run_training's butterfly route: 8 steps uninterrupted; 4 with a
    checkpoint (an eval every 4 steps), then resumed to 8."""
    from evstore_tpu_torch import config as pcfg
    from evstore_tpu_torch.drivers.train import run_training
    cfg = _pcfg()
    tcfg = pcfg.TrainConfig(batch_size=16, learning_rate=0.1,
                            optimizer=opt, test_freq=4, print_freq=100,
                            lr_num_warmup_steps=6)

    def batches(n):
        return lambda: [_batch(SIZES, 16, 50 + k)[:3] for k in range(n)]

    def run(n, ck, resume):
        res = run_training(cfg, tcfg, batches(n), batches(2),
                           ckpt_dir=ck, resume=resume, seed=3, mesh=mesh,
                           alltoall_impl="butterfly", log_fn=lambda *a: None)
        if res.model is None:
            return res.opt_state, None
        state = {k: v.numpy() for k, v in res.model.state_dict().items()}
        state.update({f"state {k}": v.numpy()
                      for k, v in res.opt_state.sparse.items()})
        state.update({f"dense state {k}": v.numpy()
                      for k, v in res.opt_state.dense.items()})
        return res.opt_state.step, state

    ck = os.path.join(tmp, f"ck-{opt}")
    whole = run(8, None, False)
    run(4, ck, False)
    resumed = run(8, ck, True)
    from evstore_tpu_torch.models.dlrm import DLRM
    init = DLRM(cfg, device="cpu", seed=3)
    return whole, resumed, {k: v.detach().numpy()
                            for k, v in init.state_dict().items()}


def _world(rank, world, cases, params, tmp):
    from evstore_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(world, 1, device="cpu")
    out = {}
    for case in cases:
        kind = case[0]
        if kind == "step":
            out[case] = _step_case(mesh, *case[1:], params[case[4]])
        elif kind == "converge":
            out[case] = _converge_case(mesh)
        elif kind == "driver":
            out[case] = _driver_case(mesh, tmp, case[1])
    return out


# step cases: (opt, dedup, L, planned, B, seed, dup)
STEP4 = [("step", opt, dd, None, False, 16, 0, False) for opt in OPTS
         for dd in (False, True)]
DUP = [("step", "rwsadagrad", dd, None, False, 32, 3, True)
       for dd in (False, True)]
PLANNED = [("step", "rwsadagrad", dd, None, True, 16, 0, False)
           for dd in (False, True)]
BAGS = [("step", opt, dd, 3, False, 16, 7, False)
        for opt in ("sgd", "rwsadagrad") for dd in (False, True)]
CONVERGE = ("converge",)
DRIVER = [("driver", "rwsadagrad"), ("driver", "sgd")]
CASES = {4: STEP4 + DUP + PLANNED + BAGS + [CONVERGE] + DRIVER}


@functools.lru_cache(maxsize=None)
def jax_params(planned: bool):
    import jax
    from evstore_tpu.models.dlrm import init_dlrm
    p = jax.tree_util.tree_map(np.asarray, init_dlrm(
        jax.random.PRNGKey(2 if planned is None else 0),
        _jcfg(INTERLEAVED if planned else SIZES)))
    return {"dense": p.dense, "sparse": p.sparse}


@functools.lru_cache(maxsize=None)
def world_results(world, tmp):
    params = {False: jax_params(False), True: jax_params(True)}
    return spawn_local(_world, world, (CASES[world], params, tmp),
                       timeout_s=60, limit_s=240)


@pytest.fixture(scope="module")
def tmp_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("butterfly"))


def _jax_step(world, opt, dedup, L, planned, B, seed, dup):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from evstore_tpu import config as jcfg
    from evstore_tpu.models.dlrm import DLRMParams
    from evstore_tpu.parallel.butterfly import (AXIS, init_butterfly_state,
                                                make_butterfly_train_step,
                                                unstack_tables)
    from evstore_tpu.parallel.planner import plan_table_shards
    sizes = INTERLEAVED if planned else SIZES
    cfg = _jcfg(sizes)
    tcfg = jcfg.TrainConfig(batch_size=B, learning_rate=0.1, optimizer=opt)
    p = jax_params(planned)
    params = jax.tree_util.tree_map(jnp.asarray,
                                    DLRMParams(p["dense"], p["sparse"]))
    mesh = Mesh(np.asarray(jax.devices()[:world]), (AXIS,))
    order = plan_table_shards(sizes, world)[0] if planned else None
    d0, stack, dstate, row_state = init_butterfly_state(params, tcfg, mesh,
                                                        table_order=order)
    step = make_butterfly_train_step(cfg, tcfg, mesh, B,
                                     dedup_exchange=dedup, table_order=order,
                                     multihot=L is not None)(
        d0, stack, dstate, row_state)
    d, i, y, w = _batch(sizes, B, seed, L, dup)
    args = [jnp.asarray(x) for x in (d, i, y)]
    if w is not None:
        args.append(jnp.asarray(w))
    d1, stack1, _, rs1, loss = step(d0, stack, dstate, row_state,
                                    jnp.zeros((), jnp.int32), *args)
    tables = unstack_tables(stack1, params, table_order=order)
    sums = None
    if rs1 is not None:
        rs = np.asarray(rs1)
        pos = {t: s for s, t in enumerate(order or range(len(sizes)))}
        sums = {f"table_{t}": rs[pos[t], :n] for t, n in enumerate(sizes)}
    return float(loss), jax.tree_util.tree_map(np.asarray, d1), {
        t: np.asarray(v["kind_plain"]) for t, v in tables.sparse.items()}, \
        sums


# ------------------------------------------------------------- the tests

def test_stack_unstack_roundtrip():
    import jax
    from evstore_tpu.models.dlrm import DLRMParams
    from evstore_tpu.parallel.butterfly import stack_tables as jstack
    from evstore_tpu_torch.parallel.butterfly import (stack_tables,
                                                      unstack_tables)
    from evstore_tpu_torch.parallel.planner import plan_table_shards
    p = jax_params(False)
    tabs = [p["sparse"][f"table_{t}"]["kind_plain"] for t in range(8)]
    for n, order in ((8, None), (4, plan_table_shards(SIZES, 4)[0]),
                     (3, None)):
        stack, T = stack_tables(tabs, n, order)
        want, _ = jstack(jax.tree_util.tree_map(
            jax.numpy.asarray, DLRMParams(p["dense"], p["sparse"])), n,
            order)
        assert T == 8 and stack.shape == want.shape
        assert np.array_equal(stack.numpy().view(np.uint32),
                              np.asarray(want).view(np.uint32))
        for t, back in enumerate(unstack_tables(stack, SIZES, order)):
            assert np.array_equal(back.numpy(), tabs[t])
        # a shard's slots are the stack's
        Tl = stack.shape[0] // n
        for s in range(n):
            part, _ = stack_tables(tabs, n, order, shard=s)
            assert np.array_equal(part.numpy(),
                                  stack[s * Tl:(s + 1) * Tl].numpy())


def _check_step(world, case, tmp_dir):
    loss, (dense, sparse, (n, sdense, ssparse)) = \
        world_results(world, tmp_dir)[0][case]
    jloss, jdense, jtables, jsums = _jax_step(world, *case[1:])
    bound([loss], [jloss], "loss")
    assert n == 1
    for t, tab in jtables.items():
        bound(sparse[t]["kind_plain"], tab, t)
    bound(dense["bot"]["layer_0"]["w"], jdense["bot"]["layer_0"]["w"],
          "bot.0")
    if jsums is not None:
        for t, v in jsums.items():
            bound(ssparse[t], v, f"sums {t}")


@pytest.mark.parametrize("case", STEP4 + DUP, ids=lambda c: (
    f"{c[1]}-{'dedup' if c[2] else 'dense'}" + ("-dup" if c[7] else "")))
def test_butterfly_matches_jax(case, tmp_dir):
    _check_step(4, case, tmp_dir)


def test_butterfly_dedup_equals_full_exchange(tmp_dir):
    res = world_results(4, tmp_dir)[0]
    (la, (da, sa, _)), (lb, (db, sb, _)) = res[DUP[0]], res[DUP[1]]
    np.testing.assert_allclose(lb, la, rtol=1e-6)
    for t in sa:
        np.testing.assert_allclose(sb[t]["kind_plain"], sa[t]["kind_plain"],
                                   rtol=1e-6, atol=1e-7)


def test_planner_matches_jax():
    from evstore_tpu.parallel.planner import (contiguous_order as jcont,
                                              plan_table_shards as jplan)
    from evstore_tpu_torch.parallel.planner import (contiguous_order,
                                                    plan_table_shards)
    # the skewed sizes of tests/test_butterfly.py and its bounds
    sizes = [1_000_000, 900_000, 800_000, 700_000] + [100] * 12
    order, imb = plan_table_shards(sizes, 4)
    assert (order, imb) == jplan(sizes, 4)
    assert imb <= (max(sizes) + 3 * 100) / (sum(sizes) / 4) + 1e-6
    freqs = [1.0] * 16
    freqs[15] = 100.0
    assert plan_table_shards(sizes, 4, freqs) == jplan(sizes, 4, freqs)
    assert contiguous_order(16, 4) == jcont(16, 4)
    rng = np.random.default_rng(0)
    for _ in range(200):
        T = int(rng.integers(1, 40))
        n = int(rng.integers(1, 9))
        sz = rng.integers(1, 10_000_000, T).tolist()
        fr = rng.random(T).tolist() if rng.random() < 0.5 else None
        assert plan_table_shards(sz, n, fr) == jplan(sz, n, fr)
        assert contiguous_order(T, n) == jcont(T, n)
    with pytest.raises(ValueError):
        plan_table_shards([1, 2], 2, freqs=[1.0])


@pytest.mark.parametrize("case", PLANNED,
                         ids=lambda c: "dedup" if c[2] else "dense")
def test_butterfly_planned_order_matches_jax(case, tmp_dir):
    from evstore_tpu_torch.parallel.planner import plan_table_shards
    assert plan_table_shards(INTERLEAVED, 4)[0] != tuple(range(8))
    _check_step(4, case, tmp_dir)


def test_butterfly_multiple_steps_converge(tmp_dir):
    losses = world_results(4, tmp_dir)[0][CONVERGE]
    assert len(losses) == 60
    assert np.mean(losses[-10:]) < np.mean(losses[:10])


@pytest.mark.parametrize("case", BAGS, ids=lambda c: (
    f"{c[1]}-{'dedup' if c[2] else 'dense'}"))
def test_butterfly_multihot_matches_jax(case, tmp_dir):
    _check_step(4, case, tmp_dir)


def test_run_training_butterfly_returns_trained_params(tmp_dir):
    (_, whole), _, init = world_results(4, tmp_dir)[0][DRIVER[1]]
    moved = max(float(np.abs(whole[f"tables.{t}"] - init[f"tables.{t}"]
                             ).max()) for t in range(8))
    assert moved > 1e-4, "returned params are the untrained init"


@pytest.mark.parametrize("case", DRIVER, ids=lambda c: c[1])
def test_butterfly_resume_equals_uninterrupted(case, tmp_dir):
    res = world_results(4, tmp_dir)
    (n_whole, whole), (n_res, resumed), _ = res[0][case]
    assert n_whole == n_res == 8
    assert set(whole) == set(resumed)
    for k in whole:
        assert np.array_equal(whole[k], resumed[k]), k
    # rank 0 alone gets the model (on its host), the others None
    for r in range(1, 4):
        assert res[r][case][:2] == ((None, None), (None, None)), r


def test_jax_butterfly_resume_restarts_its_count(tmp_path):
    """The reference's butterfly route (evstore_tpu/drivers/train.py:
    76-118) on the same run over its 8 devices: under sgd, resumed at step
    4, its tables part from the uninterrupted run's by 4.5e-4, as its lr
    schedule's count restarts at 0 (a warm-up of 6 steps replays)."""
    import jax
    from jax.sharding import Mesh
    from evstore_tpu import config as jcfg
    from evstore_tpu.drivers.train import run_training
    from evstore_tpu.parallel.butterfly import AXIS
    cfg = _jcfg()
    mesh = Mesh(np.asarray(jax.devices()), (AXIS,))

    def batches(n):
        return lambda: [_batch(SIZES, 16, 50 + k)[:3] for k in range(n)]

    def run(opt, n, ck, resume):
        tcfg = jcfg.TrainConfig(batch_size=16, learning_rate=0.1,
                                optimizer=opt, test_freq=4, print_freq=100,
                                lr_num_warmup_steps=6)
        res = run_training(cfg, tcfg, batches(n), batches(2), ckpt_dir=ck,
                           resume=resume, seed=3, mesh=mesh,
                           alltoall_impl="butterfly",
                           log_fn=lambda *a: None)
        return [np.asarray(res.params.sparse[f"table_{t}"]["kind_plain"])
                for t in range(8)]

    whole = run("sgd", 8, None, False)
    run("sgd", 4, str(tmp_path / "ck"), False)
    resumed = run("sgd", 8, str(tmp_path / "ck"), True)
    gap = max(float(np.abs(a - b).max()) for a, b in zip(whole, resumed))
    assert gap > 1e-4, gap
