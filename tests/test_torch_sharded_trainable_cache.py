"""The port's sharded trainable cache (`evstore_tpu_torch/cache/trainable.py::
ShardedTrainableDeviceCache`) and `run_cached_training(mesh=)` against the
JAX package's and the port's one-device `TrainableDeviceCache`, on the CPU
with gloo ranks.

Each world (8, 4 and 1 ranks) is started once by `parallel/multihost.py::
spawn_local` (a `file://` store, 60 s group timeouts, the world killed after
240 s) and runs every case of its size; the worker functions import no JAX.
The JAX side runs here, on the 8-device virtual CPU mesh of
tests/conftest.py, from the same numpy weights (`init_dlrm`'s, through
`convert.py`), tables and batches.

- The three sharded cases of tests/test_trainable_cache.py on a (2, 4)
  mesh of 8 ranks: fp32 at capacity 16 over 40 batches, and the masters
  mapped from .bin files over 30, held to JAX's sharded class and to the
  port's one-device class at JAX's tolerances (losses rtol 1e-5, tables
  rtol 1e-4 and atol 1e-6), `hbm_bytes_per_chip · 4 == hbm_bytes`; int8
  cells at capacity 48 over 60 batches of 32 learn (JAX's test), and
  their last losses lie within 0.1 of JAX's (the stochastic rounding's
  draws differ, ROADMAP queue 3).  Every data replica of a shard holds
  the same bytes, and every rank the same buffer.
- World 1: the sharded class equals the one-device class bit for bit at
  fp32 and int8 (losses, tables, row sums, MLPs, cells).
- Over 4 ranks: on a (1, 4) mesh the `save` and `export_ev_tables` files
  are byte-equal to the one-device class's on the same batches; on a
  (2, 2) mesh the files each class writes the other reads and writes back
  byte for byte, both export the loaded tables byte for byte, and a run
  resumed from them continues within JAX's tolerances; `train_batches`
  gives `train_batch`'s stream bit for bit; `run_cached_training(mesh=)` with a
  periodic eval, a save and an EV export against JAX's
  `run_cached_training(mesh=make_mesh(2, 2))` and the port's one-device
  run (losses and tables within 1e-5·(1 + |ref|), metrics 5e-5), every
  rank with the same evals and best.
- A capacity the model axis does not divide raises JAX's ValueError.
"""

import dataclasses
import functools
import os
import shutil

import numpy as np
import pytest
import torch

from evstore_tpu_torch.parallel.multihost import spawn_local

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ toolchain")

TOL = dict(rtol=1e-4, atol=1e-6)
# name: (capacity, precision, batches, batch size, masters from files)
CASES8 = {"fp32": (16, 32, 40, 16, False), "int8": (48, 8, 60, 32, False),
          "files": (16, 32, 30, 16, True)}


@functools.lru_cache(maxsize=None)
def _inputs(n_batches, bs, seed=0):
    """JAX's `_setup` of tests/test_trainable_cache.py as numpy: (the
    port's model state, the tables, the batches)."""
    import jax
    from evstore_tpu import config as jcfg
    from evstore_tpu.data.synthetic import RandomDataConfig, learnable_batches
    from evstore_tpu.models.dlrm import init_dlrm
    from evstore_tpu_torch import config as pcfg
    from evstore_tpu_torch.convert import params_from_jax
    cj = jcfg.tiny_dlrm_config()
    params = jax.tree_util.tree_map(np.asarray,
                                    init_dlrm(jax.random.PRNGKey(0), cj))
    state, _ = params_from_jax(params.dense, params.sparse,
                               pcfg.tiny_dlrm_config(), device="cpu")
    state = {k: v.numpy() for k, v in state.items()
             if not k.startswith("tables.")}
    tables = [params.sparse[f"table_{t}"]["kind_plain"].copy()
              for t in range(cj.num_tables)]
    batches = [tuple(np.asarray(a) for a in b) for b in learnable_batches(
        RandomDataConfig(num_dense=cj.num_dense_features,
                         table_sizes=cj.table_sizes, batch_size=bs,
                         num_batches=n_batches, seed=seed))]
    return state, tables, batches


# ------------------------------------------------------- the port's side

def _cfgs(bs, capacity, precision, lr=0.2):
    from evstore_tpu_torch import config as pcfg
    return (pcfg.tiny_dlrm_config(),
            pcfg.TrainConfig(batch_size=bs, learning_rate=lr,
                             optimizer="rwsadagrad"),
            pcfg.CacheConfig(policy="evlfu", total_size=capacity,
                             main_precision=precision))


def _model(cfg, state):
    from evstore_tpu_torch.cache.trainable import init_dense_state
    from evstore_tpu_torch.models.dlrm import DLRM
    model = DLRM(cfg, device="cpu", tables=False)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model, init_dense_state(model)


def _train(tc, model, dst, batches, start=0, how="batch"):
    if how == "batch":
        return [float(tc.train_batch(model, dst, k + start, *b)[2])
                for k, b in enumerate(batches)]
    return [float(x[2]) for x in tc.train_batches(model, dst, batches,
                                                  start_step=start)]


def _result(tc, model, losses):
    """What a rank returns of a run: its losses, MLP, cells and buffer, the
    stats, and where it holds them the flushed masters and sums."""
    out = {"losses": losses, "w": model.bot[0].weight.detach().numpy().copy(),
           "cells": tc.cache_values.numpy().copy(),
           "buf": tc._buf.numpy().copy(), "stats": tc.stats()}
    if tc.host_tables is not None:
        out["tables"] = [np.array(t) for t in tc.host_tables]
        out["mom"] = [np.array(m) for m in tc.host_mom]
    return out


def _sharded_run(mesh, inputs, capacity, precision, bs, files_dir=None,
                 n=None):
    from evstore_tpu_torch.cache.trainable import ShardedTrainableDeviceCache
    state, tables, batches = inputs
    cfg, tcfg, ccfg = _cfgs(bs, capacity, precision)
    model, dst = _model(cfg, state)
    if files_dir is not None:
        tc = ShardedTrainableDeviceCache.from_files(
            cfg, tcfg, ccfg, files_dir, cfg.table_sizes, mesh=mesh)
    else:
        tc = ShardedTrainableDeviceCache(cfg, tcfg, ccfg, tables, mesh)
    losses = _train(tc, model, dst, batches[:n])
    if files_dir is not None:
        tc.flush_files()
    else:
        tc.flush_to_host()
    out = _result(tc, model, losses)
    tc.close()
    return out


def _single_run(inputs, capacity, precision, bs, n=None):
    from evstore_tpu_torch.cache.trainable import TrainableDeviceCache
    state, tables, batches = inputs
    cfg, tcfg, ccfg = _cfgs(bs, capacity, precision)
    model, dst = _model(cfg, state)
    tc = TrainableDeviceCache(cfg, tcfg, ccfg, tables, device="cpu")
    losses = _train(tc, model, dst, batches[:n])
    tc.flush_to_host()
    out = _result(tc, model, losses)
    tc.close()
    return out


def _world8(rank, world, inputs, files_dir):
    from evstore_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(2, 4, device="cpu")
    out = {}
    for name, (cap, prec, n, bs, files) in CASES8.items():
        data = inputs[(n, bs)]
        out[name] = _sharded_run(mesh, data, cap, prec, bs,
                                 files_dir if files else None)
        if rank == 0:
            out[name]["single"] = _single_run(data, cap, prec, bs)
            if files:
                out[name]["on_disk"] = [np.fromfile(os.path.join(
                    files_dir, f"ev-table-{t + 1}.bin"), np.float32)
                    for t in range(3)]
    return out


def _world1(rank, world, inputs):
    from evstore_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(1, 1, device="cpu")
    return {prec: (_sharded_run(mesh, inputs, cap, prec, 16),
                   _single_run(inputs, cap, prec, 16))
            for prec, cap in ((32, 16), (8, 24))}


def _files_case(mesh14, mesh22, inputs, d):
    """(1, 4): save and export beside the one-device class's; (2, 2): the
    files read across and a resumed run."""
    from evstore_tpu_torch.cache.trainable import (
        ShardedTrainableDeviceCache, TrainableDeviceCache)
    state, tables, batches = inputs
    cfg, tcfg, ccfg = _cfgs(16, 16, 32)
    out = {}
    rank0 = mesh14.rank == 0
    model, dst = _model(cfg, state)
    sh = ShardedTrainableDeviceCache(cfg, tcfg, ccfg, tables, mesh14)
    out["losses"] = _train(sh, model, dst, batches[:20])
    sh.save(os.path.join(d, "sharded_save"))
    sh.export_ev_tables(os.path.join(d, "sharded_ev"))
    sh.close()
    if rank0:
        m1, d1 = _model(cfg, state)
        one = TrainableDeviceCache(cfg, tcfg, ccfg, tables, device="cpu")
        out["single_losses"] = _train(one, m1, d1, batches[:20])
        one.save(os.path.join(d, "single_save"))
        one.export_ev_tables(os.path.join(d, "single_ev"))
        one.close()
    # (2, 2): train, save; each class reads the other's files
    model, dst = _model(cfg, state)
    sh = ShardedTrainableDeviceCache(cfg, tcfg, ccfg, tables, mesh22)
    _train(sh, model, dst, batches[:20])
    sh.save(os.path.join(d, "mesh_save"))
    sh.close()
    fresh = ShardedTrainableDeviceCache(cfg, tcfg, ccfg, tables, mesh22)
    fresh.load(os.path.join(d, "single_save"))
    fresh.save(os.path.join(d, "single_via_mesh"))
    # resume the (2, 2) run from its files on both classes
    fresh.load(os.path.join(d, "mesh_save"))
    fresh.export_ev_tables(os.path.join(d, "mesh_ev"))
    m2, d2 = _model(cfg, state)
    with torch.no_grad():
        m2.load_state_dict(model.state_dict())
        for k in d2:
            d2[k].copy_(dst[k])
    out["resumed"] = _train(fresh, m2, d2, batches[20:], start=20)
    fresh.flush_to_host()
    if rank0:
        out["resumed_tables"] = [np.array(t) for t in fresh.host_tables]
        one = TrainableDeviceCache(cfg, tcfg, ccfg, tables, device="cpu")
        one.load(os.path.join(d, "mesh_save"))
        one.save(os.path.join(d, "mesh_via_single"))
        one.export_ev_tables(os.path.join(d, "mesh_ev_single"))
        m3, d3 = _model(cfg, state)
        with torch.no_grad():
            m3.load_state_dict(model.state_dict())
            for k in d3:
                d3[k].copy_(dst[k])
        out["resumed_single"] = _train(one, m3, d3, batches[20:], start=20)
        one.flush_to_host()
        out["resumed_single_tables"] = [np.array(t) for t in one.host_tables]
        one.close()
    fresh.close()
    return out


def _drivers_case(mesh, inputs):
    from evstore_tpu_torch.cache.trainable import ShardedTrainableDeviceCache
    state, tables, batches = inputs
    cfg, tcfg, ccfg = _cfgs(16, 16, 32)
    out = {}
    for how in ("batch", "pipelined"):
        model, dst = _model(cfg, state)
        tc = ShardedTrainableDeviceCache(cfg, tcfg, ccfg, tables, mesh)
        out[how] = _result(tc, model, _train(tc, model, dst, batches[:12],
                                             start=1, how=how))
        tc.flush_to_host()
        if tc.host_tables is not None:
            out[how]["tables"] = [np.array(t) for t in tc.host_tables]
        tc.close()
    return out


def _driver_kw(inputs, d, tag):
    from evstore_tpu_torch.data.synthetic import (RandomDataConfig,
                                                  learnable_batches)
    state, tables, _ = inputs
    cfg, tcfg, ccfg = _cfgs(16, 24, 32)
    tcfg = dataclasses.replace(tcfg, test_freq=10, print_freq=5)
    test = RandomDataConfig(num_dense=4, table_sizes=cfg.table_sizes,
                            batch_size=16, num_batches=5, seed=99)
    return cfg, tcfg, ccfg, dict(
        save_dir=os.path.join(d, f"{tag}_best"),
        ev_export_dir=os.path.join(d, f"{tag}_ev"),
        make_test_batches=lambda: learnable_batches(test),
        log_fn=lambda *a: None)


def _driver_case(mesh, inputs, d):
    from evstore_tpu_torch.drivers.train import run_cached_training
    state, tables, batches = inputs
    cfg, tcfg, ccfg, kw = _driver_kw(inputs, d, "mesh")
    model, _ = _model(cfg, state)
    res = run_cached_training(cfg, tcfg, ccfg, lambda: iter(batches),
                              tables=tables, mesh=mesh, model=model, **kw)
    return {"history": res.history, "best": res.best_metric,
            "steps": res.steps}


def _world4(rank, world, inputs, d):
    from evstore_tpu_torch.parallel.mesh import make_mesh
    mesh22 = make_mesh(2, 2, device="cpu")
    mesh14 = make_mesh(1, 4, device="cpu")
    return {"files": _files_case(mesh14, mesh22, inputs[(30, 16)], d),
            "drivers": _drivers_case(mesh22, inputs[(30, 16)]),
            "driver": _driver_case(mesh22, inputs[(30, 16)], d)}


# -------------------------------------------------------------- the worlds

@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    from evstore_tpu_torch.cache.storage import write_ev_tables_binary
    files = str(tmp_path_factory.mktemp("files8"))
    _, tables, _ = _inputs(30, 16)
    write_ev_tables_binary(tables, files, 32)
    inputs = {(n, bs): _inputs(n, bs) for _, _, n, bs, _ in CASES8.values()}
    return spawn_local(_world8, 8, (inputs, files), timeout_s=60,
                       limit_s=240)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("world4"))
    return spawn_local(_world4, 4, ({(30, 16): _inputs(30, 16)}, d),
                       timeout_s=60, limit_s=240), d


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    return functools.lru_cache(maxsize=None)(functools.partial(
        _jax_sharded, str(tmp_path_factory.mktemp("jax_files"))))


def _jax_sharded(d, name):
    """JAX's ShardedTrainableDeviceCache on make_mesh(2, 4) for a case."""
    import jax
    import jax.numpy as jnp
    from evstore_tpu import config as jcfg
    from evstore_tpu.cache.storage import write_ev_tables_binary
    from evstore_tpu.cache.trainable import ShardedTrainableDeviceCache
    from evstore_tpu.models.dlrm import init_dlrm
    from evstore_tpu.parallel.mesh import make_mesh
    cap, prec, n, bs, files = CASES8[name]
    cj = jcfg.tiny_dlrm_config()
    tj = jcfg.TrainConfig(batch_size=bs, learning_rate=0.2,
                          optimizer="rwsadagrad")
    cc = jcfg.CacheConfig(policy="evlfu", total_size=cap,
                          main_precision=prec)
    _, tables, batches = _inputs(n, bs)
    params = init_dlrm(jax.random.PRNGKey(0), cj)
    if files:
        write_ev_tables_binary(tables, d, 32)
        tc = ShardedTrainableDeviceCache.from_files(
            cj, tj, cc, d, cj.table_sizes, mesh=make_mesh(2, 4))
    else:
        tc = ShardedTrainableDeviceCache(cj, tj, cc, tables, make_mesh(2, 4))
    dense = params.dense
    dst = jax.tree_util.tree_map(
        lambda p: jnp.zeros_like(p, dtype=jnp.float32), dense)
    losses = []
    for k, (dx, idx, y) in enumerate(batches):
        dense, dst, loss = tc.train_batch(dense, dst, k, dx, idx, y)
        losses.append(float(loss))
    tc.flush_to_host()
    out = {"losses": losses, "tables": [np.array(t) for t in tc.host_tables],
           "stats": tc.stats(),
           "w": np.asarray(dense["bot"]["layer_0"]["w"]).T}
    tc.close()
    return out


def _held(got, ref, what):
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5,
                               err_msg=what)
    for t, (a, b) in enumerate(zip(got["tables"], ref["tables"])):
        np.testing.assert_allclose(a, b, **TOL, err_msg=f"{what} {t}")
    np.testing.assert_allclose(got["w"], ref["w"], **TOL, err_msg=what)


# ----------------------------------------------------------------- tests

@pytest.mark.parametrize("name", ["fp32", "files"])
def test_sharded_cache_matches_jax_and_one_device(world8, jax_sharded,
                                                  name):
    """test_sharded_trainable_cache_matches_single_chip and test_sharded_
    file_backed_composition: the (2, 4) run against JAX's sharded class
    and the port's one-device class."""
    got = world8[0][name]
    _held(got, jax_sharded(name), "against JAX")
    _held(got, got["single"], "against one device")
    s, j = got["stats"], jax_sharded(name)["stats"]
    assert s["hbm_bytes_per_chip"] * 4 == s["hbm_bytes"] == \
        got["single"]["stats"]["hbm_bytes"] == j["hbm_bytes"]
    assert s["hbm_bytes_per_chip"] == j["hbm_bytes_per_chip"]
    for k in ("hit_rate", "size", "dropped_updates"):
        assert s[k] == got["single"]["stats"][k], k
    if name == "files":
        for t in range(3):
            np.testing.assert_array_equal(got["on_disk"][t],
                                          got["tables"][t].ravel())


def test_sharded_int8_cache_learns(world8, jax_sharded):
    got = world8[0]["int8"]
    ref = jax_sharded("int8")
    assert got["cells"].dtype == np.uint8
    assert np.mean(got["losses"][-10:]) < np.mean(got["losses"][:10])
    assert abs(np.mean(got["losses"][-10:])
               - np.mean(ref["losses"][-10:])) < 0.1
    assert abs(np.mean(got["losses"][-10:])
               - np.mean(got["single"]["losses"][-10:])) < 0.1


@pytest.mark.parametrize("name", list(CASES8))
def test_replicas_hold_the_same_bytes(world8, name):
    """Data replicas of a shard (ranks m and 4 + m of the (2, 4) mesh)
    hold the same cells, every rank the same buffer and MLPs, and the
    non-zero ranks hold no policy."""
    res = world8
    for r in range(8):
        got, rep = res[r][name], res[r % 4][name]
        np.testing.assert_array_equal(got["cells"], rep["cells"])
        np.testing.assert_array_equal(got["buf"], res[0][name]["buf"])
        np.testing.assert_array_equal(got["w"], res[0][name]["w"])
        assert got["losses"] == res[0][name]["losses"]
        if r:
            assert "hit_rate" not in got["stats"] and "tables" not in got


@pytest.fixture(scope="module")
def world1():
    return spawn_local(_world1, 1, (_inputs(30, 16),), timeout_s=60,
                       limit_s=240)


@pytest.mark.parametrize("precision", [32, 8])
def test_world_one_is_the_one_device_class(world1, precision):
    got, ref = world1[0][precision]
    assert got["losses"] == ref["losses"]
    np.testing.assert_array_equal(got["w"], ref["w"])
    np.testing.assert_array_equal(got["cells"], ref["cells"])
    for t in range(3):
        np.testing.assert_array_equal(got["tables"][t], ref["tables"][t])
        np.testing.assert_array_equal(got["mom"][t], ref["mom"][t])
    assert got["stats"] == ref["stats"]


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        with open(os.path.join(a, n), "rb") as f, \
                open(os.path.join(b, n), "rb") as g:
            assert f.read() == g.read(), n


def test_save_and_export_equal_the_one_device_files(world4):
    res, d = world4
    out = res[0]["files"]
    assert out["losses"] == out["single_losses"]
    _same_files(os.path.join(d, "sharded_save"),
                os.path.join(d, "single_save"))
    _same_files(os.path.join(d, "sharded_ev"), os.path.join(d, "single_ev"))


def test_files_cross_load_and_resume(world4):
    res, d = world4
    out = res[0]["files"]
    _same_files(os.path.join(d, "single_via_mesh"),
                os.path.join(d, "single_save"))
    _same_files(os.path.join(d, "mesh_via_single"),
                os.path.join(d, "mesh_save"))
    _same_files(os.path.join(d, "mesh_ev"), os.path.join(d, "mesh_ev_single"))
    np.testing.assert_allclose(out["resumed"], out["resumed_single"],
                               rtol=1e-5)
    for a, b in zip(out["resumed_tables"], out["resumed_single_tables"]):
        np.testing.assert_allclose(a, b, **TOL)
    for r in range(1, 4):
        assert res[r]["files"]["resumed"] == out["resumed"]


def test_drivers_give_the_per_batch_stream(world4):
    res, _ = world4
    for r in range(4):
        out = res[r]["drivers"]
        got = out["pipelined"]
        assert got["losses"] == out["batch"]["losses"]
        np.testing.assert_array_equal(got["cells"], out["batch"]["cells"])
        if r == 0:
            for a, b in zip(got["tables"], out["batch"]["tables"]):
                np.testing.assert_array_equal(a, b)


def test_capacity_must_divide_the_model_axis():
    from evstore_tpu_torch.cache.trainable import ShardedTrainableDeviceCache
    from evstore_tpu_torch.parallel.mesh import Mesh
    cfg, tcfg, ccfg = _cfgs(16, 15, 32)
    mesh = Mesh(None, None, None, 1, 2, 0, 0, torch.device("cpu"))
    with pytest.raises(ValueError,
                       match="capacity 15 must divide the 2-shard model"):
        ShardedTrainableDeviceCache(cfg, tcfg, ccfg, [], mesh)


@pytest.fixture(scope="module")
def driver_refs(world4):
    """JAX's run_cached_training over make_mesh(2, 2) and the port's on
    one device, on the world-4 case's inputs."""
    import jax
    from evstore_tpu import config as jcfg
    from evstore_tpu.data.synthetic import (RandomDataConfig,
                                            learnable_batches)
    from evstore_tpu.drivers import train as jtrain
    from evstore_tpu.parallel.mesh import make_mesh
    from evstore_tpu_torch.drivers.train import run_cached_training
    _, d = world4
    inputs = _inputs(30, 16)
    state, tables, batches = inputs
    cfg, tcfg, ccfg, kw = _driver_kw(inputs, d, "single")
    model, _ = _model(cfg, state)
    one = run_cached_training(cfg, tcfg, ccfg, lambda: iter(batches),
                              tables=tables, model=model, device="cpu", **kw)
    cj = jcfg.tiny_dlrm_config()
    tj = jcfg.TrainConfig(batch_size=16, learning_rate=0.2,
                          optimizer="rwsadagrad", test_freq=10,
                          print_freq=5)
    test = RandomDataConfig(num_dense=4, table_sizes=cj.table_sizes,
                            batch_size=16, num_batches=5, seed=99)
    ref = jtrain.run_cached_training(
        cj, tj, jcfg.CacheConfig(policy="evlfu", total_size=24),
        lambda: iter(batches), tables=tables,
        mesh=make_mesh(2, 2, devices=jax.devices()[:4]),
        save_dir=os.path.join(d, "jax_best"),
        ev_export_dir=os.path.join(d, "jax_ev"),
        make_test_batches=lambda: learnable_batches(test),
        log_fn=lambda *a: None)
    return one, ref


def _bound(got, ref, slack=0.0, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    np.testing.assert_array_less(np.abs(got - ref), 1e-5 * (1 + np.abs(ref))
                                 + slack + 1e-300, err_msg=what)


def test_run_cached_training_over_a_mesh_matches_jax_and_one_device(
        world4, driver_refs):
    res, d = world4
    got = res[0]["driver"]
    for ref, tag in zip(driver_refs, ("single", "jax")):
        assert got["steps"] == ref.steps == 30
        assert [s for s, _ in got["history"]["loss"]] == \
            [s for s, _ in ref.history["loss"]]
        _bound([v for _, v in got["history"]["loss"]],
               [v for _, v in ref.history["loss"]], what=tag)
        assert [s for s, _ in got["history"]["eval"]] == \
            [s for s, _ in ref.history["eval"]] == [10, 20, 30, 30]
        for (_, a), (_, b) in zip(got["history"]["eval"],
                                  ref.history["eval"]):
            _bound([a[k] for k in b], [b[k] for k in b], 5e-5, tag)
        _bound([got["best"]], [ref.best_metric], 5e-5, tag)
        for t in range(3):
            _bound(np.load(os.path.join(d, "mesh_best", f"table_{t}.npy")),
                   np.load(os.path.join(d, f"{tag}_best",
                                        f"table_{t}.npy")), what=tag)
            _bound(np.fromfile(os.path.join(d, "mesh_ev",
                                            f"ev-table-{t + 1}.bin"),
                               np.float32),
                   np.fromfile(os.path.join(d, f"{tag}_ev",
                                            f"ev-table-{t + 1}.bin"),
                               np.float32), what=tag)
    assert os.path.exists(os.path.join(d, "mesh_best", "dense_params.npz"))


def test_every_rank_takes_the_same_decisions(world4):
    res, _ = world4
    ref = res[0]["driver"]
    for r in range(1, 4):
        got = res[r]["driver"]
        assert got["history"]["eval"] == ref["history"]["eval"]
        assert got["best"] == ref["best"] and got["steps"] == ref["steps"]
        assert got["history"]["loss"] == ref["history"]["loss"]
