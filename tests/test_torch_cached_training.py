"""The port's cached-training driver and its CLI against the JAX package's,
on the CPU.

- `drivers/train.py::run_cached_training` against JAX's, the port handed
  `init_dlrm(PRNGKey(seed))`'s MLPs and tables through `convert.py`, with
  the periodic eval, the checkpoint on a new best (`save_dir`) and the EV
  export (`ev_export_dir`), the port's one driver held to JAX's pipelined
  run (window 0) and to its windowed run (8), and with the masters mapped
  from .bin files: the loss history, every eval's metrics, the exported
  tables, the saved tables and the final mapped files within 1e-5·(1 +
  |ref|) (the metrics 5e-5, the AUC's slack for a score that lands the
  other side of a tie), the steps and evals equal, and each package's
  `restore_dense_npz` reading the other's dense npz.
- `cli.main` with `--use-evstore True` against `evstore_tpu.cli.main`
  (the port's DLRM built from `init_dlrm`'s weights, as in
  test_torch_cli.py), at `--main-precision` 32 and 16 and
  `--train-window` 0 and 4 (which the port accepts and ignores: its
  printed hit rates are held to the JAX CLI's run without the window,
  whose driver assigns a batch ahead, as the port's does); bags refused
  with the JAX CLI's message.
- The file-backed run over a (2, 2) mesh of 4 gloo ranks
  (`ShardedTrainableDeviceCache.from_files`, rank 0 mapping the files)
  against JAX's over `make_mesh(2, 2)`: losses and the tables' files
  after the run as above, the row sums' files within rtol 1e-5 of the
  port's one-device run and of a quarter of JAX's (JAX's sharded step
  keeps n_model² times the row sums, ROADMAP queue 3).  `mesh=` other than a `parallel.mesh.Mesh` raises
  TypeError; the rest of cached training over a mesh is held in
  tests/test_torch_sharded_trainable_cache.py.
- The handoff from cached training to serving: both CLIs train over .bin
  masters of the same initial tables with `--save-model` and an eval
  every 8 steps, then serve the trained files with `--load-model` on the
  device cache.  The trained files and dense npz agree within 1e-5·(1 +
  |ref|); the JAX CLI serves the seed's MLPs (it looks for `step_*`
  alone), the port the trained ones, each held to the plain eval of those
  MLPs on the trained rows by chip_smoke.py 3f's rule (atol 1e-6, the AUC
  within one tied pair).  With no eval the port's driver writes the dense
  npz at the run's end, its MLPs and sums the trained ones bit for bit
  (masters in files and in memory); `restore_npz_mlps` refuses other MLP
  shapes; `--load-model` raises ValueError where the directory holds no
  checkpoint, where it holds the npz alone on a route that reads the
  model's tables, and on the cached training route.
"""

import ast
import dataclasses
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evstore_tpu import cli as jcli
from evstore_tpu import config as jcfg
from evstore_tpu.cache.storage import write_ev_tables_binary
from evstore_tpu.data import synthetic as jsyn
from evstore_tpu.drivers import train as jtrain
from evstore_tpu.models.dlrm import init_dlrm
from evstore_tpu_torch import cli
from evstore_tpu_torch import config as pcfg
from evstore_tpu_torch.cache.trainable import init_dense_state
from evstore_tpu_torch.convert import mlps_from_jax, params_from_jax
from evstore_tpu_torch.drivers import train as ptrain
from evstore_tpu_torch.models import dlrm as pdlrm
from evstore_tpu_torch.train.metrics import binary_metrics
from evstore_tpu_torch.utils import checkpoint as pck

RealDLRM = pdlrm.DLRM


def bound(got, ref, slack=0.0, what=""):
    """|got - ref| <= 1e-5 (1 + |ref|) + slack, elementwise."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    np.testing.assert_array_less(np.abs(got - ref), 1e-5 * (1 + np.abs(ref))
                                 + slack + 1e-300, err_msg=what)


def _setup(seed=0, bs=16, n_train=30, n_test=5, test_freq=10, lr=0.2):
    cj, cp = jcfg.tiny_dlrm_config(), pcfg.tiny_dlrm_config()
    kw = dict(batch_size=bs, learning_rate=lr, optimizer="rwsadagrad",
              test_freq=test_freq, print_freq=5)
    tj, tp = jcfg.TrainConfig(**kw), pcfg.TrainConfig(**kw)
    dcfg = jsyn.RandomDataConfig(num_dense=4, table_sizes=cj.table_sizes,
                                 batch_size=bs, num_batches=n_train, seed=0)
    tdcfg = jsyn.RandomDataConfig(num_dense=4, table_sizes=cj.table_sizes,
                                  batch_size=bs, num_batches=n_test, seed=99)
    params = jax.tree_util.tree_map(
        np.asarray, init_dlrm(jax.random.PRNGKey(seed), cj))
    return (cj, cp, tj, tp, params,
            lambda: jsyn.learnable_batches(dcfg),
            lambda: jsyn.learnable_batches(tdcfg))


def _port_model(cp, params):
    state, tables = params_from_jax(params.dense, params.sparse, cp,
                                    device="cpu")
    model = RealDLRM(cp, device="cpu", tables=False)
    model.load_state_dict({k: v for k, v in state.items()
                           if not k.startswith("tables.")})
    return model, tables


def _compare(res_p, res_j):
    assert res_p.steps == res_j.steps
    assert [s for s, _ in res_p.history["loss"]] == \
        [s for s, _ in res_j.history["loss"]]
    bound([v for _, v in res_p.history["loss"]],
          [v for _, v in res_j.history["loss"]], what="losses")
    assert [s for s, _ in res_p.history["eval"]] == \
        [s for s, _ in res_j.history["eval"]]
    for (_, mp), (_, mj) in zip(res_p.history["eval"],
                                res_j.history["eval"]):
        assert mp.keys() == mj.keys()
        bound([mp[k] for k in mj], [mj[k] for k in mj], 5e-5, "metrics")
    bound([res_p.best_metric], [res_j.best_metric], 5e-5, "best")


@pytest.mark.parametrize("window,precision", [(0, 32), (8, 32), (0, 16)])
def test_run_cached_training_matches_jax(tmp_path, window, precision):
    cj, cp, tj, tp, params, make_train, make_test = _setup()
    cc = dict(policy="evlfu", total_size=24, main_precision=precision)
    out = {}
    for side in ("j", "p"):
        d = tmp_path / side
        kw = dict(save_dir=str(d / "best"), make_test_batches=make_test,
                  ev_export_dir=str(d / "ev"), log_fn=lambda *a: None)
        if side == "j":
            # the port has one driver, held to each of JAX's
            out[side] = jtrain.run_cached_training(
                cj, tj, jcfg.CacheConfig(**cc), make_train, seed=0,
                window=window, **kw)
        else:
            model, tables = _port_model(cp, params)
            out[side] = ptrain.run_cached_training(
                cp, tp, pcfg.CacheConfig(**cc), make_train, tables=tables,
                model=model, device="cpu", **kw)
    _compare(out["p"], out["j"])
    assert len(out["p"].history["eval"]) == 4      # 3 periodic + the last
    for t in range(3):
        name = f"ev-table-{t + 1}.bin"
        a = np.fromfile(tmp_path / "p" / "ev" / name, np.float32)
        b = np.fromfile(tmp_path / "j" / "ev" / name, np.float32)
        bound(a, b, what=name)
        for f in (f"table_{t}.npy", f"mom_{t}.npy"):
            got = np.load(tmp_path / "p" / "best" / f)
            ref = np.load(tmp_path / "j" / "best" / f)
            if f.startswith("mom"):
                np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
            else:
                bound(got, ref, what=f)
    for side in ("p", "j"):
        with open(tmp_path / side / "best" / "best.json") as f:
            assert set(__import__("json").load(f)) == {"step", "metrics"}
    # each package restores the other's dense npz
    jd = jax.tree_util.tree_map(jnp.asarray, params.dense)
    jz = jax.tree_util.tree_map(lambda p: jnp.zeros_like(p, jnp.float32), jd)
    from_port = jtrain.restore_dense_npz(jd, jz, str(tmp_path / "p" / "best"))
    from_jax = jtrain.restore_dense_npz(jd, jz, str(tmp_path / "j" / "best"))
    model, _ = _port_model(cp, params)
    dstate = init_dense_state(model)
    ptrain.restore_dense_npz(model, dstate, str(tmp_path / "j" / "best"))
    for i in range(2):
        w = model.bot[i].weight.detach().numpy().T
        np.testing.assert_array_equal(
            w, np.asarray(from_jax[0]["bot"][f"layer_{i}"]["w"]))
        np.testing.assert_array_equal(
            dstate[f"bot.{i}.weight"].numpy().T,
            np.asarray(from_jax[1]["bot"][f"layer_{i}"]["w"]))
        bound(np.asarray(from_port[0]["top"][f"layer_{i}"]["w"]),
              np.asarray(from_jax[0]["top"][f"layer_{i}"]["w"]),
              what="top w")
    assert out["p"].opt_state.dense.keys() == dstate.keys()


def test_run_cached_training_file_backed_matches_jax(tmp_path):
    """Masters mapped from the .bin files (`ev_table_dir`), no eval: the
    files after the run within the bound of JAX's, and the row sums'
    files beside them."""
    cj, cp, tj, tp, params, make_train, _ = _setup(n_train=20)
    tables = [params.sparse[f"table_{t}"]["kind_plain"] for t in range(3)]
    cc = dict(policy="evlfu", total_size=16)
    for side in ("j", "p"):
        write_ev_tables_binary(tables, str(tmp_path / side), 32)
    res_j = jtrain.run_cached_training(
        cj, tj, jcfg.CacheConfig(**cc), make_train,
        ev_table_dir=str(tmp_path / "j"), table_sizes=list(cj.table_sizes),
        log_fn=lambda *a: None)
    model, _ = _port_model(cp, params)
    res_p = ptrain.run_cached_training(
        cp, tp, pcfg.CacheConfig(**cc), make_train,
        ev_table_dir=str(tmp_path / "p"), table_sizes=list(cp.table_sizes),
        model=model, device="cpu", log_fn=lambda *a: None)
    _compare(res_p, res_j)
    for t in range(3):
        for name in (f"ev-table-{t + 1}.bin", f"mom-{t + 1}.bin"):
            a = np.fromfile(tmp_path / "p" / name, np.float32)
            b = np.fromfile(tmp_path / "j" / name, np.float32)
            if name.startswith("mom"):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
            else:
                bound(a, b, what=name)
        assert not np.array_equal(
            np.fromfile(tmp_path / "p" / f"ev-table-{t + 1}.bin",
                        np.float32), tables[t].ravel())


def _mesh_file_rank(rank, world, d, state, batches):
    """run_cached_training over a (2, 2) mesh with the masters mapped from
    d's .bin files (read by rank 0)."""
    from evstore_tpu_torch.parallel.mesh import make_mesh
    cp = pcfg.tiny_dlrm_config()
    tp = pcfg.TrainConfig(batch_size=16, learning_rate=0.2,
                          optimizer="rwsadagrad", test_freq=10,
                          print_freq=5)
    model = RealDLRM(cp, device="cpu", tables=False)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    res = ptrain.run_cached_training(
        cp, tp, pcfg.CacheConfig(policy="evlfu", total_size=16),
        lambda: iter(batches), ev_table_dir=d,
        table_sizes=list(cp.table_sizes), mesh=make_mesh(2, 2, device="cpu"),
        model=model, log_fn=lambda *a: None)
    return res.steps, res.history


def test_run_cached_training_file_backed_over_a_mesh_matches_jax(tmp_path):
    """The masters mapped from .bin files, the cells sharded over a (2, 2)
    gloo world: the files after the run, and the losses, against JAX's
    file-backed run over make_mesh(2, 2)."""
    from evstore_tpu.parallel.mesh import make_mesh
    from evstore_tpu_torch.parallel.multihost import spawn_local
    cj, cp, tj, tp, params, make_train, _ = _setup(n_train=20)
    tables = [params.sparse[f"table_{t}"]["kind_plain"] for t in range(3)]
    for side in ("j", "p", "one"):
        write_ev_tables_binary(tables, str(tmp_path / side), 32)
    model, _ = _port_model(cp, params)
    ptrain.run_cached_training(
        cp, tp, pcfg.CacheConfig(policy="evlfu", total_size=16), make_train,
        ev_table_dir=str(tmp_path / "one"), table_sizes=list(cp.table_sizes),
        model=model, device="cpu", log_fn=lambda *a: None)
    res_j = jtrain.run_cached_training(
        cj, tj, jcfg.CacheConfig(policy="evlfu", total_size=16), make_train,
        ev_table_dir=str(tmp_path / "j"), table_sizes=list(cj.table_sizes),
        mesh=make_mesh(2, 2, devices=jax.devices()[:4]),
        log_fn=lambda *a: None)
    model, _ = _port_model(cp, params)
    state = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    batches = [tuple(np.asarray(a) for a in b) for b in make_train()]
    res = spawn_local(_mesh_file_rank, 4, (str(tmp_path / "p"), state,
                                           batches),
                      timeout_s=60, limit_s=240)
    steps, history = res[0]
    assert steps == res_j.steps == 20
    assert [s for s, _ in history["loss"]] == \
        [s for s, _ in res_j.history["loss"]]
    bound([v for _, v in history["loss"]],
          [v for _, v in res_j.history["loss"]], what="losses")
    assert all(r == res[0] for r in res[1:])
    for t in range(3):
        name = f"ev-table-{t + 1}.bin"
        bound(np.fromfile(tmp_path / "p" / name, np.float32),
              np.fromfile(tmp_path / "j" / name, np.float32), what=name)
        # the row sums are the one-device run's; JAX's sharded step keeps
        # n_model² times them (ROADMAP queue 3: the transpose of its psum
        # over "model" is a psum, so its row grads are n_model times the
        # true ones, which rwsadagrad's step lr·g/√Σg² does not see)
        name = f"mom-{t + 1}.bin"
        a = np.fromfile(tmp_path / "p" / name, np.float32)
        np.testing.assert_allclose(
            a, np.fromfile(tmp_path / "one" / name, np.float32),
            rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            a * 4, np.fromfile(tmp_path / "j" / name, np.float32),
            rtol=1e-5, atol=1e-6)


def test_run_cached_training_draws_the_ports_own_init():
    """Without a model or tables: the MLPs and the masters `DLRM(cfg,
    seed=seed)` draws, the tables made in host memory only."""
    _, cp, _, tp, _, make_train, _ = _setup(n_train=3)
    res = ptrain.run_cached_training(
        cp, tp, pcfg.CacheConfig(total_size=50), make_train, seed=4,
        device="cpu", log_fn=lambda *a: None)
    assert not res.model.has_sparse() and res.steps == 3
    ref = RealDLRM(cp, device="cpu", seed=4)
    assert not torch.equal(res.model.bot[0].weight, ref.bot[0].weight)
    assert np.array_equal(pdlrm.init_host_tables(cp, 4)[2],
                          ref.tables[2].detach().numpy())


def test_mesh_raises():
    """A mesh that is not the port's `parallel.mesh.Mesh` raises (cached
    training over a mesh: tests/test_torch_sharded_trainable_cache.py)."""
    _, cp, _, tp, _, make_train, _ = _setup(n_train=1)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        ptrain.run_cached_training(cp, tp, pcfg.CacheConfig(), make_train,
                                   mesh=object(), device="cpu")


# ------------------------------------------------------------- the CLI

ARCH = ("--arch-sparse-feature-size 4 --arch-embedding-size 40-30 "
        "--arch-mlp-bot 4-8-4 --arch-mlp-top 8-1 --compute-dtype float32")


def _jax_cfg(cfg):
    return jcfg.make_dlrm_config(
        cfg.embedding_dim, cfg.table_sizes, cfg.mlp_bot[1:-1],
        cfg.mlp_top[1:-1], num_dense=cfg.mlp_bot[0],
        compute_dtype=cfg.compute_dtype,
        interaction_itself=cfg.interaction_itself)


def _from_jax_init(cfg, *, device=None, seed=0, tables=True):
    """The port's DLRM with `init_dlrm(PRNGKey(seed))`'s weights."""
    params = jax.tree_util.tree_map(
        np.asarray, init_dlrm(jax.random.PRNGKey(seed), _jax_cfg(cfg)))
    state, _ = params_from_jax(params.dense, params.sparse, cfg,
                               device=device)
    model = RealDLRM(cfg, device=device, seed=seed)
    model.load_state_dict(state)
    return model


def _floats(pattern, text):
    return [tuple(float(x) for x in m) for m in re.findall(pattern, text)]


@pytest.mark.parametrize("extra", [
    "", "--train-window 4", "--main-precision 16 --train-window 4"])
def test_cli_cached_training_matches_jax(capsys, monkeypatch, tmp_path,
                                         extra):
    monkeypatch.setattr(ptrain, "DLRM", _from_jax_init)
    argv = (ARCH + " --mini-batch-size 16 --num-batches 20 --print-freq 5 "
            "--use-evstore True --optimizer rwsadagrad --learning-rate 0.1 "
            "--emb-cache-size 24 --test-freq 10 --nbatches-test 4 "
            + extra).split()
    runs = [("j", jcli.main, argv), ("p", cli.main, argv + ["--device",
                                                             "cpu"])]
    if "--train-window" in argv:
        # the hit rate a print reads depends on how far ahead the driver
        # has assigned: JAX's windowed driver a window, the port's one
        # driver a batch, as JAX's pipelined driver (its run without the
        # window) does
        w = argv.index("--train-window")
        runs.append(("j0", jcli.main, argv[:w] + argv[w + 2:]))
    outs = []
    for side, fn, args in runs:
        save = str(tmp_path / side)
        assert fn(args + ["--save-model", save]) == 0
        outs.append(capsys.readouterr().out)
    ref, got, ref0 = (outs + outs[:1])[:3]
    loss = r"step (\d+): loss ([-\d.]+) \(\d+ examples/s, hit rate ([\d.]+)"
    g, r, r0 = _floats(loss, got), _floats(loss, ref), _floats(loss, ref0)
    assert len(g) == len(r) == 4
    assert [s for s, _, _ in g] == [s for s, _, _ in r]
    assert [(s, h) for s, _, h in g] == [(s, h) for s, _, h in r0]
    bound([v for _, v, _ in g], [v for _, v, _ in r], 5e-7, "losses")
    ev = r"eval @ (\d+): auc ([-\d.na]+) acc ([-\d.]+)"
    assert len(_floats(ev, got)) == len(_floats(ev, ref)) == 3
    bound(_floats(ev, got), _floats(ev, ref), 5e-5, "evals")
    done = r"training done: steps=(\d+) best=([-\d.]+) \(cached\)"
    (gs, gb), = _floats(done, got)
    (rs, rb), = _floats(done, ref)
    assert gs == rs == 20
    bound([gb], [rb], 5e-5, "best")
    for t in range(2):
        bound(np.load(tmp_path / "p" / f"table_{t}.npy"),
              np.load(tmp_path / "j" / f"table_{t}.npy"), what="tables")
    assert os.path.exists(tmp_path / "p" / "dense_params.npz")


def test_cli_cached_training_refuses_bags(capsys):
    argv = (ARCH + " --mini-batch-size 8 --num-batches 2 --use-evstore True "
            "--optimizer rwsadagrad --num-indices-per-lookup 3").split()
    assert jcli.main(argv) == 2
    ref = capsys.readouterr().err
    assert cli.main(argv + ["--device", "cpu"]) == 2
    got = capsys.readouterr().err
    assert got == ref and "bag size 1" in got


# ------------------------------------------- the handoff to serving

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")

HANDOFF_ARCH = ("--arch-sparse-feature-size 8 --arch-embedding-size "
                "1200-900-600-3000 --arch-mlp-bot 4-16-8 --arch-mlp-top 16-1 "
                "--compute-dtype float32 --mini-batch-size 32 "
                "--data-generation synthetic --learning-rate 0.1 "
                "--nbatches-test 10")
HANDOFF_TRAIN = (" --num-batches 24 --print-freq 4 --use-evstore True "
                 "--optimizer rwsadagrad --emb-cache-size 300")
HANDOFF_SERVE = (" --inference-only --use-evstore True --use-device-cache True"
                 " --emb-cache-size 300")


def _handoff_cfg():
    args = cli.build_parser().parse_args(HANDOFF_ARCH.split())
    cfg = cli.configs_from_args(args)[0]
    return cfg, args.numpy_rand_seed, cli._make_data(args, cfg)


def _jax_mlps(cfg, seed=0):
    """`init_dlrm(PRNGKey(seed))`'s MLPs and tables for a port config."""
    params = jax.tree_util.tree_map(
        np.asarray, init_dlrm(jax.random.PRNGKey(seed), _jax_cfg(cfg)))
    return params, mlps_from_jax(params.dense, cfg, torch.device("cpu"))


def _mlps_of_jax_init(cfg, *, device=None, seed=0, tables=True):
    """The port's DLRM with `init_dlrm(PRNGKey(seed))`'s MLPs and, where
    `tables` is True, its tables."""
    params, mlps = _jax_mlps(cfg, seed)
    model = RealDLRM(cfg, device=device, seed=seed, tables=(
        [params.sparse[f"table_{t}"]["kind_plain"]
         for t in range(cfg.num_tables)] if tables is True else tables))
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k in mlps:
                v.copy_(mlps[k])
    return model


def _served_metrics(text):
    m = re.search(r"inference done: metrics=(\{.*?\}) perfect_hits", text)
    return ast.literal_eval(m.group(1).replace("nan", "None"))


def _plain_eval(cfg, mlps, ev_dir, batches):
    """The metrics of `mlps` (MLP state-dict entries) on the rows of
    `ev_dir`'s .bin files: the plain forward, no cache, no kernel."""
    model = RealDLRM(dataclasses.replace(cfg, use_gather_kernel=False,
                                         use_interaction_kernel=False),
                     device="cpu", tables=False)
    model.load_state_dict(mlps)
    tabs = [np.fromfile(os.path.join(ev_dir, f"ev-table-{t + 1}.bin"),
                        np.float32).reshape(n, cfg.embedding_dim)
            for t, n in enumerate(cfg.table_sizes)]
    scores, labels = [], []
    with torch.no_grad():
        for dense, idx, y in batches:
            rows = np.stack([tabs[t][idx[:, t]]
                             for t in range(cfg.num_tables)], axis=1)
            scores.append(torch.sigmoid(model(
                torch.from_numpy(dense), None,
                emb_rows=torch.from_numpy(rows))).numpy())
            labels.append(y)
    return binary_metrics(np.concatenate(scores), np.concatenate(labels)), \
        np.concatenate(labels)


def _same_metrics(got, ref, labels):
    """chip_smoke.py 3f's rule: atol 1e-6, the AUC within one tied pair."""
    n_pos = int(labels.sum())
    tie = 1.0 / max(n_pos * (len(labels) - n_pos), 1)
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        assert abs(got[k] - v) <= (tie + 1e-12 if k == "auc" else 1e-6), \
            (k, got[k], v)


@needs_gxx
def test_trained_masters_and_mlps_handed_to_serving(capsys, monkeypatch,
                                                    tmp_path):
    """Both CLIs train through the cache over .bin masters of the same
    initial tables, from the same MLPs and synthetic batches, with an eval
    every 8 steps and `--save-model`; then both serve the trained files
    with `--load-model` on the device cache.  The trained files and MLPs
    agree within 1e-5·(1 + |ref|).  The JAX CLI serves the seed's MLPs on
    the trained rows (its `--load-model` looks for `step_*` alone: the
    fault the port repairs); the port serves the trained MLPs, read from
    `dense_params.npz` bit for bit."""
    cfg, seed, (_, make_test) = _handoff_cfg()
    params, seed_mlps = _jax_mlps(cfg, seed)
    monkeypatch.setattr(ptrain, "DLRM", _mlps_of_jax_init)
    tables = [params.sparse[f"table_{t}"]["kind_plain"]
              for t in range(cfg.num_tables)]
    argv = (HANDOFF_ARCH + HANDOFF_TRAIN + " --test-freq 8").split()
    for side, fn, more in (("j", jcli.main, []),
                           ("p", cli.main, ["--device", "cpu"])):
        write_ev_tables_binary(tables, str(tmp_path / side / "ev"), 32)
        assert fn(argv + ["--ev-table-path", str(tmp_path / side / "ev"),
                          "--save-model", str(tmp_path / side / "ck")]
                  + more) == 0
        assert "training done: steps=24" in capsys.readouterr().out
    for t in range(cfg.num_tables):
        for name in (f"ev-table-{t + 1}.bin", f"mom-{t + 1}.bin"):
            got = np.fromfile(tmp_path / "p" / "ev" / name, np.float32)
            ref = np.fromfile(tmp_path / "j" / "ev" / name, np.float32)
            if name.startswith("mom"):
                np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
            else:
                bound(got, ref, what=name)
        assert not np.array_equal(
            np.fromfile(tmp_path / "p" / "ev" / f"ev-table-{t + 1}.bin",
                        np.float32), tables[t].ravel())
    zp = np.load(tmp_path / "p" / "ck" / "dense_params.npz")
    zj = np.load(tmp_path / "j" / "ck" / "dense_params.npz")
    assert sorted(zp.files) == sorted(zj.files)
    for k in zj.files:
        bound(zp[k], zj[k], what=k)
    trained = RealDLRM(cfg, device="cpu", tables=False)
    pck.restore_npz_mlps(str(tmp_path / "p" / "ck"), trained)
    trained = trained.state_dict()
    assert not torch.equal(trained["top.0.weight"], seed_mlps["top.0.weight"])

    served = {}
    for side, fn, more in (("j", jcli.main, []),
                           ("p", cli.main, ["--device", "cpu"])):
        assert fn((HANDOFF_ARCH + HANDOFF_SERVE).split() + [
            "--ev-table-path", str(tmp_path / side / "ev"),
            "--load-model", str(tmp_path / side / "ck")] + more) == 0
        served[side] = capsys.readouterr().out
    assert "restored the MLPs of cached training's step" in served["p"]
    seed_m, labels = _plain_eval(cfg, seed_mlps, tmp_path / "j" / "ev",
                                 make_test())
    trained_m, _ = _plain_eval(cfg, trained, tmp_path / "p" / "ev",
                               make_test())
    _same_metrics(_served_metrics(served["j"]), seed_m, labels)
    _same_metrics(_served_metrics(served["p"]), trained_m, labels)
    assert max(abs(seed_m[k] - trained_m[k]) for k in seed_m) > 1e-3


@needs_gxx
@pytest.mark.parametrize("masters", ["files", "memory"])
def test_no_eval_saves_the_mlps_at_the_end(tmp_path, masters):
    """With `save_dir` and no eval, the run's end writes `dense_params.npz`
    and `best.json` (the last step, no metrics), whose MLPs are the
    trained model's bit for bit; beside them the cache's table files where
    the masters are in memory, the flushed .bin files where they are
    mapped."""
    _, cp, _, tp, params, make_train, _ = _setup(n_train=12)
    tables = [params.sparse[f"table_{t}"]["kind_plain"] for t in range(3)]
    model, _ = _port_model(cp, params)
    kw = dict(tables=tables)
    if masters == "files":
        write_ev_tables_binary(tables, str(tmp_path / "ev"), 32)
        kw = dict(ev_table_dir=str(tmp_path / "ev"),
                  table_sizes=list(cp.table_sizes))
    res = ptrain.run_cached_training(
        cp, tp, pcfg.CacheConfig(policy="evlfu", total_size=16), make_train,
        save_dir=str(tmp_path / "ck"), model=model, device="cpu",
        log_fn=lambda *a: None, **kw)
    assert res.steps == 12
    with open(tmp_path / "ck" / "best.json") as f:
        assert __import__("json").load(f) == {"step": 12, "metrics": None}
    bare = RealDLRM(cp, device="cpu", seed=5, tables=False)
    assert pck.restore_npz_mlps(str(tmp_path / "ck"), bare) == 12
    want = res.model.state_dict()
    for k, v in bare.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert not torch.equal(bare.top[0].weight,
                           _port_model(cp, params)[0].top[0].weight)
    saved = sorted(os.listdir(tmp_path / "ck"))
    if masters == "files":
        assert saved == ["best.json", "dense_params.npz"]
        assert not np.array_equal(np.fromfile(
            tmp_path / "ev" / "ev-table-1.bin", np.float32),
            tables[0].ravel())
    else:
        assert {"table_0.npy", "mom_2.npy"} <= set(saved)
    # the sums restore too, through the driver's reader
    dstate = init_dense_state(bare)
    ptrain.restore_dense_npz(bare, dstate, str(tmp_path / "ck"))
    for k, v in res.opt_state.dense.items():
        assert torch.equal(dstate[k], v), k


@pytest.mark.parametrize("mlp_top", [(10, 6, 1), (10, 8, 4, 1)])
def test_restore_npz_mlps_of_other_layers_raises(tmp_path, mlp_top):
    """An npz whose MLPs have another width or another layer count than
    the model's raises ValueError."""
    _, cp, _, tp, params, make_train, _ = _setup(n_train=2)
    model, tables = _port_model(cp, params)
    ptrain.run_cached_training(
        cp, tp, pcfg.CacheConfig(total_size=16), make_train, tables=tables,
        save_dir=str(tmp_path), model=model, device="cpu",
        log_fn=lambda *a: None)
    other = RealDLRM(dataclasses.replace(cp, mlp_top=mlp_top), device="cpu",
                     tables=False)
    with pytest.raises(ValueError, match="MLPs"):
        pck.restore_npz_mlps(str(tmp_path), other)


@pytest.mark.parametrize("route,holds", [
    ("device_c1", "nothing"), ("c1_mmap", "nothing"), ("plain", "nothing"),
    ("dummy_store", "nothing"), ("plain", "npz"), ("dummy_store", "npz"),
    ("cached_training", "npz")])
def test_load_model_without_a_usable_checkpoint_raises(tmp_path, route,
                                                       holds):
    """`--load-model` never serves the seed's weights: a directory with no
    checkpoint raises ValueError on every serving route, one with cached
    training's `dense_params.npz` alone on the routes that read the
    model's tables; on the cached training route, which does not resume,
    `--load-model` raises."""
    ck = tmp_path / "ck"
    ck.mkdir()
    if holds == "npz":
        np.savez(ck / "dense_params.npz", x=np.zeros(1))
    flags = {
        "device_c1": HANDOFF_SERVE + f" --ev-table-path {tmp_path}",
        "c1_mmap": (" --inference-only --use-evstore True --emb-stor mmap "
                    f"--ev-table-path {tmp_path}"),
        "plain": " --inference-only",
        "dummy_store": " --inference-only --use-evstore True",
        "cached_training": HANDOFF_TRAIN}[route]
    match = {"nothing": "holds no checkpoint", "npz": "MLPs alone"}[holds]
    if route == "cached_training":
        match = "does not resume"
    with pytest.raises(ValueError, match=match):
        cli.main((HANDOFF_ARCH + flags + f" --load-model {ck} --device cpu"
                  ).split())
