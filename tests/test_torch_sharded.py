"""The port's row-sharded SPMD steps (`evstore_tpu_torch/parallel/sharded.py`)
and mesh (`parallel/mesh.py`) against the JAX package's, on the CPU.

The port runs one process per rank: each case runs in a world of 4 (or 8)
gloo ranks started by `parallel/multihost.py::spawn_local` (a `file://`
store in a temporary directory, every group's timeout 60 s, the world
killed after 240 s), one world per mesh size for every case of this file.
The JAX side runs here, on the 8-device virtual CPU mesh of
tests/conftest.py, from the same numpy weights and batches; each JAX mesh
takes the shape of the port's over its first devices.

One case per case of tests/test_sharded.py:
- mesh construction (2x2, 1x4 and 4x1 over 4 ranks, 2x4 and 8x1 over 8,
  3x3 raises) and `pad_rows_for_mesh`;
- eval at meshes (2, 2), (1, 4), (4, 1) and (2, 4), with and without
  `dedup_exchange`, held to JAX's `make_sharded_eval_step` on the same
  mesh shape: probabilities within 1e-5·(1 + |ref|);
- 5 train steps under sgd, adagrad and rwsadagrad, with and without
  `dedup_exchange`, held to JAX's `make_sharded_train_step` at (2, 2):
  each loss, every table (the JAX tables' padding rows dropped), the MLPs
  and every optimizer sum within 1e-5·(1 + |ref|);
- the port's sharded step against its own single-device step (qr, md and
  learned pooling weights, which JAX's sharded step leaves untrained), at
  1e-5·(1 + |ref|);
- the loss falls over 60 learnable batches;
- every data replica of a shard holds the same bytes after a step;
- a row shard (`DLRM(row_shard=)`) holds its rows only and cannot be
  saved or exported until gathered;
- a checkpoint of the psum route at (2, 2) resumes through the butterfly
  over the 4 ranks, equal to an uninterrupted single-device run;
- tests/test_multihot.py::test_multihot_sharded_matches_single_device
  (bags with weights, held to JAX's sharded step at (2, 2) with bags) and
  tests/test_weighted_pooling.py::test_weighted_sharded_forward_matches_
  single (fixed pooling weights off 1, eval at (2, 2)).

Rows cross the exchange by an all-reduce that adds zeros to each row; the
sign of a zero can change (-0.0 + 0.0 = +0.0, as in JAX's psum), so rows
are compared as floats.
"""

import atexit
import functools
import shutil
import tempfile

import numpy as np
import pytest
import torch

from evstore_tpu_torch.parallel.mesh import pad_rows_for_mesh
from evstore_tpu_torch.parallel.multihost import spawn_local

B = 16
STEPS = 5
SHAPES4 = [(2, 2), (1, 4), (4, 1)]
OPTS = ["sgd", "adagrad", "rwsadagrad"]

# configs by name: (make_dlrm_config's args, kwargs)
CONFIGS = {
    "tiny": ((4, (40, 30, 20), (8,), (8,)), {"num_dense": 4}),
    "fixed": ((4, (40, 30, 20), (8,), (8,)),
              {"num_dense": 4, "weighted_pooling": "fixed"}),
    "learned": ((4, (40, 30, 20), (8,), (8,)),
                {"num_dense": 4, "weighted_pooling": "learned"}),
    "bags": ((8, (50, 35, 20), (16, 8), (12,)),
             {"num_dense": 6, "compute_dtype": "float32"}),
    "qr": ((4, (40, 30, 300), (8,), (8,)),
           {"num_dense": 4, "qr_flag": True, "qr_threshold": 100}),
    "md": ((4, (40, 30, 300), (8,), (8,)),
           {"num_dense": 4, "md_flag": True, "md_threshold": 100,
            "md_temperature": -0.3}),
}


def _pcfg(name):
    from evstore_tpu_torch import config as pcfg
    args, kw = CONFIGS[name]
    return pcfg.make_dlrm_config(*args, **kw)


def _jcfg(name):
    from evstore_tpu import config as jcfg
    args, kw = CONFIGS[name]
    return jcfg.make_dlrm_config(*args, **kw)


def _batch(name, seed, L=None):
    """(dense, idx, y, bag weights or None), numpy, as tests/test_sharded.py
    and tests/test_multihot.py make them."""
    args, kw = CONFIGS[name]
    sizes, nd = args[1], kw["num_dense"]
    rng = np.random.default_rng(seed)
    dense = rng.random((B, nd)).astype(np.float32)
    if L is None:
        idx = np.stack([rng.integers(0, s, B) for s in sizes],
                       axis=1).astype(np.int32)
        w = None
    else:
        idx = np.stack([rng.integers(0, s, (B, L)) for s in sizes],
                       axis=1).astype(np.int32)
        sz = rng.integers(1, L + 1, (B, len(sizes)))
        w = (np.arange(L)[None, None, :] < sz[..., None]).astype(np.float32)
    y = rng.integers(0, 2, B).astype(np.float32)
    return dense, idx, y, w


def bound(got, ref, what=""):
    """|got - ref| <= 1e-5 (1 + |ref|), elementwise."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_array_less(np.abs(got - ref),
                                 1e-5 * (1 + np.abs(ref)) + 1e-300,
                                 err_msg=what)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif tree is not None and not isinstance(tree, (int, float)):
        yield path, np.asarray(tree)


# ------------------------------------------------ the port, in each rank

def _train_case(mesh, cfg_name, opt, dedup, L, params):
    from evstore_tpu_torch import config as pcfg
    from evstore_tpu_torch.convert import shard_from_jax, shard_to_numpy
    from evstore_tpu_torch.parallel.sharded import (init_sharded_opt_state,
                                                    make_sharded_train_step)
    cfg = _pcfg(cfg_name)
    lr = 0.2 if cfg_name == "bags" else 0.1
    tcfg = pcfg.TrainConfig(batch_size=B, learning_rate=lr, optimizer=opt)
    model, _ = shard_from_jax(params["dense"], params["sparse"], cfg, mesh)
    st = init_sharded_opt_state(model, tcfg)
    step = make_sharded_train_step(cfg, tcfg, mesh, dedup_exchange=dedup)
    losses = [float(step(model, st, *_batch(cfg_name, k, L)))
              for k in range(STEPS)]
    dense, sparse, (n, sdense, ssparse) = shard_to_numpy(model, mesh, st)
    return {"losses": losses, "dense": dense, "sparse": sparse,
            "state": {"mlp": sdense.get("mlp", {}), "sparse": ssparse},
            "n": n}


def _eval_case(mesh, cfg_name, dedup, params):
    from evstore_tpu_torch.convert import shard_from_jax
    from evstore_tpu_torch.parallel.sharded import make_sharded_eval_step
    cfg = _pcfg(cfg_name)
    model, _ = shard_from_jax(params["dense"], params["sparse"], cfg, mesh)
    dense, idx, _, _ = _batch(cfg_name, 1)
    return make_sharded_eval_step(cfg, mesh, dedup)(model, dense,
                                                    idx).numpy()


def _single_case(mesh, cfg_name, opt, dedup, L):
    """The port's sharded step against its own single-device step from
    the same seed: the largest |d| / (1 + |ref|) over the losses and the
    gathered model and state."""
    from evstore_tpu_torch import config as pcfg
    from evstore_tpu_torch.models.dlrm import DLRM
    from evstore_tpu_torch.parallel.sharded import (make_sharded_train_step,
                                                    shard_dlrm_params,
                                                    unshard_dlrm_params)
    from evstore_tpu_torch.train.train_loop import (init_opt_state,
                                                    make_train_step)
    cfg = _pcfg(cfg_name)
    tcfg = pcfg.TrainConfig(batch_size=B, learning_rate=0.1, optimizer=opt)
    ref = DLRM(cfg, device="cpu", seed=2)
    ref_st = init_opt_state(ref, tcfg)
    model, st = shard_dlrm_params(ref, mesh, init_opt_state(ref, tcfg))
    step = make_sharded_train_step(cfg, tcfg, mesh, dedup_exchange=dedup)
    ref_step = make_train_step(cfg, tcfg)
    worst = {}

    def rel(what, a, b):
        a, b = a.detach().double(), b.detach().double()
        worst[what] = max(worst.get(what, 0.0),
                          float(((a - b).abs() / (1 + b.abs())).max()))

    for k in range(STEPS):
        batch = _batch(cfg_name, 10 + k, L)
        rel("loss", step(model, st, *batch), ref_step(ref, ref_st, *batch))
    full, full_st = unshard_dlrm_params(model, mesh, st, device="cpu")
    got, want = full.state_dict(), ref.state_dict()
    assert set(got) == set(want)
    for k in want:
        rel(k, got[k], want[k])
    for part in ("dense", "sparse"):
        for k, v in getattr(ref_st, part).items():
            rel(f"state {k}", getattr(full_st, part)[k], v)
    return worst


def _falls_case(mesh):
    from evstore_tpu_torch import config as pcfg
    from evstore_tpu_torch.data.synthetic import (RandomDataConfig,
                                                  learnable_batches)
    from evstore_tpu_torch.models.dlrm import DLRM
    from evstore_tpu_torch.parallel.sharded import (make_sharded_train_step,
                                                    shard_dlrm_params)
    from evstore_tpu_torch.train.train_loop import init_opt_state
    cfg = _pcfg("tiny")
    tcfg = pcfg.TrainConfig(batch_size=32, learning_rate=0.2,
                            optimizer="rwsadagrad")
    full = DLRM(cfg, device="cpu", seed=0)
    model, st = shard_dlrm_params(full, mesh, init_opt_state(full, tcfg))
    step = make_sharded_train_step(cfg, tcfg, mesh)
    dcfg = RandomDataConfig(num_dense=cfg.num_dense_features,
                            table_sizes=cfg.table_sizes, batch_size=32,
                            num_batches=60, seed=3)
    return [float(step(model, st, d, i, y))
            for d, i, y in learnable_batches(dcfg)]


def _replica_case(mesh):
    """Every tensor of this rank's shard and state after a step."""
    from evstore_tpu_torch import config as pcfg
    from evstore_tpu_torch.models.dlrm import DLRM
    from evstore_tpu_torch.parallel.sharded import (make_sharded_train_step,
                                                    shard_dlrm_params)
    from evstore_tpu_torch.train.train_loop import init_opt_state
    cfg = _pcfg("tiny")
    tcfg = pcfg.TrainConfig(batch_size=B, learning_rate=0.5,
                            optimizer="rwsadagrad")
    full = DLRM(cfg, device="cpu", seed=0)
    model, st = shard_dlrm_params(full, mesh, init_opt_state(full, tcfg))
    make_sharded_train_step(cfg, tcfg, mesh)(model, st, *_batch("tiny", 7))
    out = {k: v.numpy().tobytes() for k, v in model.state_dict().items()}
    out.update({f"state {k}": v.numpy().tobytes()
                for k, v in st.sparse.items()})
    return out


def _resume_data(n, seed):
    return lambda: [_batch("tiny", seed + k)[:3] for k in range(n)]


def _resume_case(tmp):
    """A psum run at (2, 2) checkpoints at step 4; a butterfly run over
    the 4 ranks resumes it to step 8: the single-device model and state."""
    from evstore_tpu_torch import config as pcfg
    from evstore_tpu_torch.drivers.train import run_training
    from evstore_tpu_torch.parallel.mesh import make_mesh
    cfg = _pcfg("tiny")
    tcfg = pcfg.TrainConfig(batch_size=B, learning_rate=0.1,
                            optimizer="rwsadagrad", test_freq=4,
                            print_freq=100, lr_num_warmup_steps=6)
    quiet = dict(seed=5, log_fn=lambda *a: None, ckpt_dir=tmp)
    run_training(cfg, tcfg, _resume_data(4, 30), _resume_data(2, 90),
                 mesh=make_mesh(2, 2, device="cpu"), **quiet)
    res = run_training(cfg, tcfg, _resume_data(8, 30), _resume_data(2, 90),
                       mesh=make_mesh(4, 1, device="cpu"), resume=True,
                       alltoall_impl="butterfly", **quiet)
    if res.model is None:
        return res.steps, res.opt_state, None
    return res.steps, res.opt_state.step, {
        **{k: v.numpy() for k, v in res.model.state_dict().items()},
        **{f"state {k}": v.numpy() for k, v in res.opt_state.sparse.items()}}


def _mesh_case(world):
    from evstore_tpu_torch.parallel.mesh import make_mesh
    out = {"default": make_mesh(device="cpu").shape}
    for shape in ((2, world // 2), (world // 2, 2), (None, 2), (3, 3)):
        try:
            m = make_mesh(*shape, device="cpu")
            out[shape] = (m.shape, (m.d, m.m))
        except ValueError as e:
            out[shape] = str(e)
    return out


def _world(rank, world, cases, params, tmp):
    """Every case of one world, in order; each makes its own mesh."""
    from evstore_tpu_torch.parallel.mesh import make_mesh
    out = {}
    for case in cases:
        kind, shape = case[0], case[1]
        if kind == "mesh":
            out[case] = _mesh_case(world)
            continue
        if kind == "resume":
            out[case] = _resume_case(tmp)
            continue
        mesh = make_mesh(*shape, device="cpu")
        if kind == "eval":
            out[case] = _eval_case(mesh, case[2], case[3],
                                   params[case[2]])
        elif kind == "train":
            out[case] = _train_case(mesh, case[2], case[3], case[4],
                                    case[5], params[case[2]])
        elif kind == "single":
            out[case] = _single_case(mesh, *case[2:])
        elif kind == "falls":
            out[case] = _falls_case(mesh)
        elif kind == "replicas":
            out[case] = _replica_case(mesh)
    return out


EVAL4 = [("eval", s, "tiny", dd) for s in SHAPES4 for dd in (False, True)]
EVAL8 = [("eval", (2, 4), "tiny", dd) for dd in (False, True)]
TRAIN = [("train", (2, 2), "tiny", opt, dd, None) for opt in OPTS
         for dd in (False, True)]
BAGS = ("train", (2, 2), "bags", "rwsadagrad", False, 3)
WEIGHTED = ("eval", (2, 2), "fixed", False)
SINGLE = [("single", (2, 2), "qr", "rwsadagrad", False, None),
          ("single", (1, 4), "md", "adagrad", True, None),
          ("single", (4, 1), "learned", "rwsadagrad", False, 3),
          ("single", (2, 2), "learned", "sgd", True, 3),
          ("single", (2, 2), "tiny", "rwsadagrad", True, None)]
FALLS = ("falls", (2, 2))
REPLICAS = ("replicas", (2, 2))
RESUME = ("resume", None)
CASES4 = ([("mesh", None)] + EVAL4 + TRAIN + [BAGS, WEIGHTED] + SINGLE
          + [FALLS, REPLICAS, RESUME])
CASES8 = [("mesh", None)] + EVAL8


@functools.lru_cache(maxsize=None)
def jax_params(cfg_name, seed):
    """init_dlrm's weights as numpy; the fixed pooling weights moved off
    1, as tests/test_weighted_pooling.py does."""
    import jax
    from evstore_tpu.models.dlrm import init_dlrm
    p = jax.tree_util.tree_map(np.asarray, init_dlrm(
        jax.random.PRNGKey(seed), _jcfg(cfg_name)))
    if cfg_name == "fixed":
        rng = np.random.default_rng(1)
        for t in range(len(p.sparse)):
            n = p.sparse[f"table_{t}"]["pool_w"].shape[0]
            p.sparse[f"table_{t}"]["pool_w"] = rng.uniform(
                0.5, 1.5, (n, 1)).astype(np.float32)
    return p


def _params():
    seeds = {"tiny": 0, "fixed": 0, "bags": 2}
    return {name: {"dense": jax_params(name, s).dense,
                   "sparse": jax_params(name, s).sparse}
            for name, s in seeds.items()}


@functools.lru_cache(maxsize=None)
def world_results(world):
    cases = CASES4 if world == 4 else CASES8
    tmp = tempfile.mkdtemp(prefix="torch-sharded-")
    atexit.register(shutil.rmtree, tmp, True)
    return spawn_local(_world, world, (cases, _params(), tmp),
                       timeout_s=60, limit_s=240)


def _jax_mesh(shape):
    import jax
    from evstore_tpu.parallel.mesh import make_mesh
    n = shape[0] * shape[1]
    return make_mesh(*shape, devices=jax.devices()[:n])


def _jax_eval(shape, cfg_name, dedup):
    import jax
    import jax.numpy as jnp
    from evstore_tpu.parallel.sharded import (make_sharded_eval_step,
                                              shard_dlrm_params)
    mesh = _jax_mesh(shape)
    sp, _ = shard_dlrm_params(
        jax.tree_util.tree_map(jnp.asarray, jax_params(cfg_name, 0)), mesh)
    dense, idx, _, _ = _batch(cfg_name, 1)
    return np.asarray(make_sharded_eval_step(_jcfg(cfg_name), mesh, dedup)(
        sp)(sp, jnp.asarray(dense), jnp.asarray(idx)))


def _jax_train(cfg_name, opt, dedup, L):
    import jax
    import jax.numpy as jnp
    from evstore_tpu import config as jcfg
    from evstore_tpu.parallel.sharded import (make_sharded_train_step,
                                              shard_dlrm_params)
    from evstore_tpu.train.train_loop import init_opt_state
    cfg = _jcfg(cfg_name)
    seed = 2 if cfg_name == "bags" else 0
    lr = 0.2 if cfg_name == "bags" else 0.1
    tcfg = jcfg.TrainConfig(batch_size=B, learning_rate=lr, optimizer=opt)
    mesh = _jax_mesh((2, 2))
    params = jax.tree_util.tree_map(jnp.asarray, jax_params(cfg_name, seed))
    sp, so, _, _ = shard_dlrm_params(params, mesh,
                                     init_opt_state(params, tcfg))
    step = make_sharded_train_step(cfg, tcfg, mesh, B, dedup_exchange=dedup,
                                   multihot=L is not None)(sp, so)
    losses = []
    for k in range(STEPS):
        d, i, y, w = _batch(cfg_name, k, L)
        args = [jnp.asarray(x) for x in (d, i, y)]
        if w is not None:
            args.append(jnp.asarray(w))
        sp, so, loss = step(sp, so, *args)
        losses.append(float(loss))
    return losses, jax.tree_util.tree_map(np.asarray, sp), \
        jax.tree_util.tree_map(np.asarray, so)


# ------------------------------------------------------------- the tests

def test_mesh_construction():
    for world, shapes in ((4, [(2, 2), (2, 2), (2, 2)]),
                          (8, [(2, 4), (4, 2), (4, 2)])):
        got = world_results(world)[0][("mesh", None)]
        assert got["default"] == {"data": world, "model": 1}
        for req, shape in zip(((2, world // 2), (world // 2, 2), (None, 2)),
                              shapes):
            assert got[req][0] == {"data": shape[0], "model": shape[1]}
        assert got[(3, 3)] == f"mesh 3x3 != {world} devices"
    # rank r sits at (r // n_model, r % n_model), JAX's device order
    for r, res in enumerate(world_results(8)):
        assert res[("mesh", None)][(2, 4)][1] == (r // 4, r % 4)


def test_pad_rows():
    t = torch.ones((10, 4))
    p = pad_rows_for_mesh(t, 4)
    assert p.shape == (12, 4)
    assert torch.equal(p[10:], torch.zeros(2, 4))
    assert pad_rows_for_mesh(t, 5) is t


def test_a_row_shard_holds_its_rows_only(tmp_path):
    """`DLRM(row_shard=(m, n))` keeps rows [m·Nl, (m+1)·Nl) of each plain
    table, zero-padded, and the rest whole; it cannot look rows up, be
    saved or be exported until it is gathered."""
    from evstore_tpu_torch.models.dlrm import DLRM
    from evstore_tpu_torch.utils.checkpoint import (export_ev_tables,
                                                    save_checkpoint)
    from evstore_tpu_torch.train.train_loop import init_opt_state
    from evstore_tpu_torch import config as pcfg
    cfg = _pcfg("learned")
    full = DLRM(cfg, device="cpu", seed=4)
    for m in range(4):
        part = DLRM(cfg, device="cpu", seed=4, row_shard=(m, 4))
        for t, (a, b) in enumerate(zip(part.tables, full.tables)):
            nl = -(-cfg.table_sizes[t] // 4)
            want = pad_rows_for_mesh(b.detach(), 4)[m * nl:(m + 1) * nl]
            assert torch.equal(a.detach(), want), (m, t)
        for k in ("bot.0.weight", "pool_w.1"):
            assert torch.equal(part.state_dict()[k], full.state_dict()[k])
    dense, idx, _, _ = _batch("learned", 0)
    with pytest.raises(ValueError, match="row shard"):
        part(torch.from_numpy(dense), torch.from_numpy(idx))
    with pytest.raises(ValueError, match="unshard_dlrm_params"):
        export_ev_tables(part, str(tmp_path))
    with pytest.raises(ValueError, match="unshard_dlrm_params"):
        save_checkpoint(str(tmp_path), 1, part, init_opt_state(
            part, pcfg.TrainConfig()))


@pytest.mark.parametrize("case", EVAL4 + EVAL8 + [WEIGHTED],
                         ids=lambda c: f"{c[2]}-{c[1][0]}x{c[1][1]}-"
                                       f"{'dedup' if c[3] else 'dense'}")
def test_sharded_eval_matches_jax(case):
    world = 8 if case[1] == (2, 4) else 4
    got = world_results(world)
    ref = _jax_eval(case[1], case[2], case[3])
    for r in range(world):        # every rank holds the whole batch's
        bound(got[r][case], ref, f"rank {r}")


@pytest.mark.parametrize("case", TRAIN + [BAGS],
                         ids=lambda c: f"{c[2]}-{c[3]}-"
                                       f"{'dedup' if c[4] else 'dense'}")
def test_sharded_train_step_matches_jax(case):
    _, _, cfg_name, opt, dedup, L = case
    got = world_results(4)[0][case]
    losses, sp, so = _jax_train(cfg_name, opt, dedup, L)
    bound(got["losses"], losses, "losses")
    assert got["n"] == STEPS == int(so.step)
    for t, ent in got["sparse"].items():
        want = sp.sparse[t]["kind_plain"]
        bound(ent["kind_plain"], want[:ent["kind_plain"].shape[0]], t)
    for (k, a), (k2, b) in zip(_leaves(got["dense"]), _leaves(sp.dense)):
        assert k == k2
        bound(a, b, k)
    for (k, a), (k2, b) in zip(_leaves(got["state"]["mlp"]),
                               _leaves(so.dense.get("mlp", {}))):
        assert k == k2
        bound(a, b, f"state {k}")
    for t, v in got["state"]["sparse"].items():
        bound(v, np.asarray(so.sparse[t])[:v.shape[0]], f"state {t}")


@pytest.mark.parametrize("case", SINGLE,
                         ids=lambda c: f"{c[2]}-{c[3]}-{c[1][0]}x{c[1][1]}")
def test_sharded_step_matches_single_device(case):
    worst = world_results(4)[0][case]
    assert max(worst.values()) <= 1e-5, worst


def test_sharded_training_reduces_loss():
    losses = world_results(4)[0][FALLS]
    assert len(losses) == 60
    assert np.mean(losses[-10:]) < np.mean(losses[:10])


def test_sharded_update_is_replica_consistent():
    """After a step every data replica of a shard holds the same bytes:
    at (2, 2), rank (0, m) and rank (1, m) hold shard m."""
    res = world_results(4)
    for m in range(2):
        a, b = res[0 + m][REPLICAS], res[2 + m][REPLICAS]
        assert set(a) == set(b)
        for k in a:
            assert a[k] == b[k], k
    # and the two shards differ
    assert res[0][REPLICAS]["tables.0"] != res[1][REPLICAS]["tables.0"]


def test_a_checkpoint_resumes_at_any_mesh_shape():
    """The psum route at (2, 2) writes the single-device checkpoint at
    step 4; the butterfly over the 4 ranks resumes it to step 8, and so
    does one device: both equal an uninterrupted single-device run within
    1e-5·(1 + |ref|); rank 0 alone gets the model, the others None."""
    from evstore_tpu_torch import config as pcfg
    from evstore_tpu_torch.drivers.train import run_training
    res = world_results(4)
    steps, n, got = res[0][RESUME]
    assert steps == 8 and n == 8
    for r in range(1, 4):
        assert res[r][RESUME] == (8, None, None), r
    cfg = _pcfg("tiny")
    tcfg = pcfg.TrainConfig(batch_size=B, learning_rate=0.1,
                            optimizer="rwsadagrad", test_freq=4,
                            print_freq=100, lr_num_warmup_steps=6)
    kw = dict(seed=5, log_fn=lambda *a: None, device="cpu")
    whole = run_training(cfg, tcfg, _resume_data(8, 30),
                         _resume_data(2, 90), **kw)
    ref = {**{k: v.numpy() for k, v in whole.model.state_dict().items()},
           **{f"state {k}": v.numpy()
              for k, v in whole.opt_state.sparse.items()}}
    assert set(got) == set(ref)
    for k in ref:
        bound(got[k], ref[k], k)
