"""The port's checkpoints, EV-table handoff, quantized inference and
training driver against the JAX package's, on the CPU.

- Checkpoints: the port's own format (`torch.save`; JAX's are orbax), so
  each package round-trips its own: every tensor of the model and the
  optimizer state bit for bit, the optimizer's flat buffers still one
  buffer after the restore.  A JAX checkpoint and a port checkpoint of one
  training run hold the same weights within the driver's bound below.
- EV tables: the same weights give the same .bin bytes at 32, 16, 8 and 4
  bits, and each package loads the other's files bit for bit.
- `quantize_embeddings` and `quantize_mlps`: within one f32 ulp of JAX's.
- `run_training`: against JAX's `run_training(seed=s)` with the port handed
  `init_dlrm(PRNGKey(s))`'s weights; the loss history, every eval's
  metrics, the exported tables and the saved weights within
  1e-5·(1 + |ref|), and the steps, evals and checkpoint steps equal.
- The MLPerf logger, the config JSON round trip and the memory and
  profiling helpers.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from evstore_tpu import config as jcfg
from evstore_tpu.data import synthetic as jsyn
from evstore_tpu.models.dlrm import init_dlrm
from evstore_tpu.train import train_loop as jloop
from evstore_tpu.utils import checkpoint as jck
from evstore_tpu_torch import config as pcfg
from evstore_tpu_torch.convert import params_from_jax, params_to_numpy
from evstore_tpu_torch.data import synthetic as psyn
from evstore_tpu_torch.models.dlrm import DLRM
from evstore_tpu_torch.train.optim import flat_row_state
from evstore_tpu_torch.train.train_loop import init_opt_state
from evstore_tpu_torch.utils import checkpoint as pck


def bound(got, ref):
    """|got - ref| <= 1e-5 (1 + |ref|), elementwise."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_array_less(np.abs(got - ref), 1e-5 * (1 + np.abs(ref))
                                 + 1e-300)


def jax_numpy_params(cfg_j, seed):
    return jax.tree_util.tree_map(np.asarray,
                                  init_dlrm(jax.random.PRNGKey(seed), cfg_j))


def port_model(cfg_p, params):
    state, _ = params_from_jax(params.dense, params.sparse, cfg_p,
                               device="cpu")
    model = DLRM(cfg_p, device="cpu")
    model.load_state_dict(state)
    return model


def tiny():
    return jcfg.tiny_dlrm_config(), pcfg.tiny_dlrm_config()


def _trained_state(opt="rwsadagrad", steps=3, seed=0):
    """A port model and optimizer state a few steps from init, so that the
    sums are not zero."""
    from evstore_tpu_torch.train.train_loop import make_train_step
    _, cp = tiny()
    model = DLRM(cp, device="cpu", seed=seed)
    tcfg = pcfg.TrainConfig(optimizer=opt, learning_rate=0.2)
    st = init_opt_state(model, tcfg)
    step = make_train_step(cp, tcfg)
    for d, i, y in psyn.random_batches(psyn.RandomDataConfig(
            num_dense=4, table_sizes=cp.table_sizes, batch_size=16,
            num_batches=steps, seed=seed, distribution="zipf")):
        step(model, st, d, i, y)
    return cp, tcfg, model, st


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "rwsadagrad"])
def test_checkpoint_roundtrip(tmp_path, opt):
    cp, tcfg, model, st = _trained_state(opt)
    path = pck.save_checkpoint(str(tmp_path), 42, model, st,
                               extra={"auc": 0.8})
    assert path == os.path.join(str(tmp_path), "step_42")
    assert os.path.isfile(path)
    assert os.path.isfile(tmp_path / "step_42.meta.json")
    assert pck.latest_step(str(tmp_path)) == 42
    m2 = DLRM(cp, device="cpu", seed=9)          # another init
    s2 = init_opt_state(m2, tcfg)
    m3, s3, extra = pck.restore_checkpoint(str(tmp_path), 42, m2, s2)
    assert m3 is m2 and s3 is s2 and extra == {"auc": 0.8}
    for (k, a), (k2, b) in zip(model.state_dict().items(),
                               m2.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    assert s2.step == st.step == 3
    for part in ("dense", "sparse"):
        a, b = getattr(st, part), getattr(s2, part)
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (part, k)
    if opt != "sgd":     # the views still lie in one flat buffer
        flat_row_state(s2.sparse, list(m2.tables))


def test_restore_refuses_another_structure(tmp_path):
    cp, tcfg, model, st = _trained_state("rwsadagrad")
    pck.save_checkpoint(str(tmp_path), 1, model, st)
    other = DLRM(cp, device="cpu")
    with pytest.raises(ValueError, match="optimizer"):
        pck.restore_checkpoint(str(tmp_path), 1, other, init_opt_state(
            other, pcfg.TrainConfig(optimizer="sgd")))
    small = DLRM(pcfg.make_dlrm_config(4, (40, 30, 21), (8,), (8,),
                                       num_dense=4), device="cpu")
    with pytest.raises(ValueError, match="tables.2"):
        pck.restore_checkpoint(str(tmp_path), 1, small, init_opt_state(
            small, tcfg))


def test_latest_step(tmp_path):
    assert pck.latest_step(str(tmp_path / "nope")) is None
    assert pck.latest_step(str(tmp_path)) is None
    cp, tcfg, model, st = _trained_state("sgd", steps=1)
    for s in (5, 40, 7):
        pck.save_checkpoint(str(tmp_path), s, model, st)
    assert pck.latest_step(str(tmp_path)) == \
        jck.latest_step(str(tmp_path)) == 40


@pytest.mark.parametrize("precision", [32, 16, 8, 4])
def test_ev_export_bytes_and_both_directions(tmp_path, precision):
    cj, cp = tiny()
    params = jax_numpy_params(cj, 3)
    model = port_model(cp, params)
    jp = jck.export_ev_tables(jax.tree_util.tree_map(jax.numpy.asarray,
                                                     params),
                              str(tmp_path / "j"), precision=precision)
    pp = pck.export_ev_tables(model, str(tmp_path / "p"),
                              precision=precision)
    assert [os.path.basename(p) for p in jp] == \
        [os.path.basename(p) for p in pp]
    for a, b in zip(jp, pp):
        assert open(a, "rb").read() == open(b, "rb").read()
    # JAX writes, the port reads
    fresh = DLRM(cp, device="cpu", seed=11)
    mlp_before = fresh.bot[0].weight.clone()
    pck.load_ev_tables_into_params(fresh, str(tmp_path / "j"), precision)
    ref = jck.load_ev_tables_into_params(
        jax.tree_util.tree_map(jax.numpy.asarray, params),
        str(tmp_path / "j"), precision)
    for t in range(cp.num_tables):
        np.testing.assert_array_equal(
            fresh.tables[t].numpy(),
            np.asarray(ref.sparse[f"table_{t}"]["kind_plain"]))
        if precision == 32:
            np.testing.assert_array_equal(
                fresh.tables[t].numpy(),
                params.sparse[f"table_{t}"]["kind_plain"])
    assert torch.equal(fresh.bot[0].weight, mlp_before)
    # the port writes, JAX reads
    got = jck.load_ev_tables_into_params(
        jax.tree_util.tree_map(jax.numpy.asarray,
                               jax_numpy_params(cj, 12)),
        str(tmp_path / "p"), precision)
    for t in range(cp.num_tables):
        np.testing.assert_array_equal(
            np.asarray(got.sparse[f"table_{t}"]["kind_plain"]),
            fresh.tables[t].numpy())


def test_ev_export_table_sizes_csv_and_refusals(tmp_path):
    cj, cp = tiny()
    params = jax_numpy_params(cj, 4)
    model = port_model(cp, params)
    pck.export_ev_tables(model, str(tmp_path), also_csv=True,
                         table_sizes=(10, 30, 5))
    jck.export_ev_tables(jax.tree_util.tree_map(jax.numpy.asarray, params),
                         str(tmp_path / "j"), also_csv=True,
                         table_sizes=(10, 30, 5))
    for t in range(3):
        for ext in ("bin", "csv"):
            name = f"ev-table-{t + 1}.{ext}"
            assert open(tmp_path / name, "rb").read() == \
                open(tmp_path / "j" / name, "rb").read()
    assert os.path.getsize(tmp_path / "ev-table-3.bin") == 5 * 4 * 4
    with pytest.raises(ValueError, match="holds"):
        pck.load_ev_tables_into_params(model, str(tmp_path))
    qr = DLRM(pcfg.make_dlrm_config(4, (400, 30), (8,), (8,), num_dense=4,
                                    qr_flag=True, qr_threshold=100),
              device="cpu")
    with pytest.raises(ValueError, match="plain tables"):
        pck.export_ev_tables(qr, str(tmp_path / "qr"))


def test_quantize_embeddings_and_mlps_match_jax():
    cj, cp = tiny()
    params = jax_numpy_params(cj, 5)
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, params)
    for bits in (16, 8, 4):
        model = port_model(cp, params)
        assert pck.quantize_embeddings(model, bits) is model
        ref = jck.quantize_embeddings(jparams, bits)
        for t in range(cp.num_tables):
            r = np.asarray(ref.sparse[f"table_{t}"]["kind_plain"])
            np.testing.assert_allclose(model.tables[t].numpy(), r, rtol=0,
                                       atol=np.spacing(np.float32(1.0)))
    model = port_model(cp, params)
    pck.quantize_mlps(model, 8)
    dense, _ = params_to_numpy(model)
    ref = jck.quantize_mlps(jparams, 8)
    for part in ("bot", "top"):
        for name, lyr in ref.dense[part].items():
            w = np.asarray(lyr["w"])
            np.testing.assert_allclose(dense[part][name]["w"], w, rtol=0,
                                       atol=np.spacing(np.abs(w).max()))
            np.testing.assert_array_equal(dense[part][name]["b"],
                                          params.dense[part][name]["b"])
    with pytest.raises(ValueError, match="8 bits"):
        pck.quantize_mlps(model, 4)


# ------------------------------------------------------- the driver

def _streams(cfg, seed=0, n=40, n_test=10):
    mk = dict(num_dense=cfg.num_dense_features, table_sizes=cfg.table_sizes,
              batch_size=32, num_batches=n, seed=seed)
    test = dict(mk, num_batches=n_test, seed=99)
    return ((lambda: psyn.learnable_batches(psyn.RandomDataConfig(**mk))),
            (lambda: psyn.learnable_batches(psyn.RandomDataConfig(**test))),
            (lambda: jsyn.learnable_batches(jsyn.RandomDataConfig(**mk))),
            (lambda: jsyn.learnable_batches(jsyn.RandomDataConfig(**test))))


def _tcfgs(**kw):
    return jcfg.TrainConfig(**kw), pcfg.TrainConfig(**kw)


@pytest.mark.parametrize("opt,kw", [
    ("sgd", dict(test_freq=20, nepochs=1)),
    ("adagrad", dict(test_freq=15, nepochs=2)),
    ("rwsadagrad", dict(test_freq=20, nepochs=1)),
    ("rwsadagrad", dict(test_freq=10, mlperf_auc_threshold=0.01))])
def test_run_training_matches_jax(tmp_path, opt, kw):
    from evstore_tpu.drivers.train import run_training as jrun
    from evstore_tpu_torch.drivers.train import run_training as prun
    seed = 2
    cj, cp = tiny()
    tj, tp = _tcfgs(batch_size=32, optimizer=opt, learning_rate=0.2,
                    print_freq=5, **kw)
    p_train, p_test, j_train, j_test = _streams(cp)
    ref = jrun(cj, tj, j_train, j_test, ckpt_dir=str(tmp_path / "jck"),
               ev_export_dir=str(tmp_path / "jev"), seed=seed,
               log_fn=lambda *_: None)
    model = port_model(cp, jax_numpy_params(cj, seed))
    lines = []
    got = prun(cp, tp, p_train, p_test, ckpt_dir=str(tmp_path / "pck"),
               ev_export_dir=str(tmp_path / "pev"), model=model,
               device="cpu", log_fn=lines.append)
    assert got.model is model and got.steps == ref.steps
    assert [s for s, _ in got.history["loss"]] == \
        [s for s, _ in ref.history["loss"]]
    bound([v for _, v in got.history["loss"]],
          [v for _, v in ref.history["loss"]])
    assert [s for s, _ in got.history["eval"]] == \
        [s for s, _ in ref.history["eval"]]
    for (_, m), (_, r) in zip(got.history["eval"], ref.history["eval"]):
        assert m.keys() == r.keys()
        bound([m[k] for k in sorted(r)], [r[k] for k in sorted(r)])
    bound(got.best_metric, ref.best_metric)
    s = jck.latest_step(str(tmp_path / "jck"))
    assert pck.latest_step(str(tmp_path / "pck")) == s
    for t in range(cp.num_tables):
        name = f"ev-table-{t + 1}.bin"
        bound(np.fromfile(tmp_path / "pev" / name, np.float32),
              np.fromfile(tmp_path / "jev" / name, np.float32))
    # the checkpoints of the best eval hold the same weights
    jp = jax.tree_util.tree_map(np.asarray, jck.restore_checkpoint(
        str(tmp_path / "jck"), s, ref.params,
        jloop.init_opt_state(ref.params, tj))[0])
    fresh = DLRM(cp, device="cpu", seed=7)
    pck.restore_checkpoint(str(tmp_path / "pck"), s, fresh,
                           init_opt_state(fresh, tp))
    dense, sparse = params_to_numpy(fresh)
    for part in ("bot", "top"):
        for name, lyr in jp.dense[part].items():
            bound(dense[part][name]["w"], lyr["w"])
            bound(dense[part][name]["b"], lyr["b"])
    for t in range(cp.num_tables):
        bound(sparse[f"table_{t}"]["kind_plain"],
              jp.sparse[f"table_{t}"]["kind_plain"])
    meta = json.load(open(tmp_path / "pck" / f"step_{s}.meta.json"))
    assert meta["step"] == s and "auc" in meta["extra"]["metrics"]
    assert any(line.startswith(f"checkpoint step_{s}:") for line in lines)
    assert any(line.startswith("EV tables exported:") for line in lines)
    assert any(line.startswith("trained ") for line in lines)


def test_run_training_resume_skips_completed_steps(tmp_path):
    from evstore_tpu_torch.drivers.train import run_training
    cj, cp = tiny()
    _, tp = _tcfgs(batch_size=32, optimizer="rwsadagrad", learning_rate=0.2,
                   print_freq=10, test_freq=20)
    p_train, p_test, _, _ = _streams(cp)
    quiet = dict(log_fn=lambda *_: None, device="cpu")
    first = run_training(cp, tp, p_train, p_test,
                         ckpt_dir=str(tmp_path / "ck"),
                         ev_export_dir=str(tmp_path / "ev"), **quiet)
    assert first.steps == 40 and first.best_metric > 0
    s = pck.latest_step(str(tmp_path / "ck"))
    assert s in (20, 40)
    lines = []
    res = run_training(cp, tp, p_train, ckpt_dir=str(tmp_path / "ck"),
                       resume=True, log_fn=lines.append, device="cpu",
                       seed=5)
    assert res.steps == 40
    assert any(f"resumed from checkpoint step {s}" in x for x in lines)
    assert res.opt_state.step == 40
    # without a resume the same run from the same seed trains all 40
    assert run_training(cp, tp, p_train, **quiet).steps == 40


def test_run_training_refuses_mesh_options():
    """The exchange options need a mesh (`parallel/mesh.py::make_mesh`;
    the mesh routes are tests/test_torch_sharded.py's and
    test_torch_butterfly.py's); a mesh must be one."""
    from evstore_tpu_torch.drivers.train import run_training
    _, cp = tiny()
    tp = pcfg.TrainConfig()
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        run_training(cp, tp, lambda: [], device="cpu", mesh=object())
    for kw in (dict(alltoall_impl="butterfly"), dict(dedup_exchange=True)):
        with pytest.raises(ValueError, match="pass a mesh"):
            run_training(cp, tp, lambda: [], device="cpu", **kw)
    with pytest.raises(ValueError, match="unknown alltoall_impl"):
        run_training(cp, tp, lambda: [], device="cpu",
                     alltoall_impl="ring")
    other = DLRM(pcfg.make_dlrm_config(4, (40, 30, 21), (8,), (8,),
                                       num_dense=4), device="cpu")
    with pytest.raises(ValueError, match="another DLRMConfig"):
        run_training(cp, tp, lambda: [], model=other)


# ------------------------------------------------------- utilities

def test_mlperf_logger_format():
    from evstore_tpu.utils.logging import MLPerfLogger as JLogger
    from evstore_tpu_torch.utils.logging import MLPerfLogger
    lines, jlines = [], []
    mll = MLPerfLogger(log_fn=lines.append)
    mll.event("run_start", {"epoch": 0})
    mll.submission_metadata()
    JLogger(log_fn=jlines.append).event("run_start", {"epoch": 0})
    d = json.loads(lines[0][len(":::MLLOG "):])
    j = json.loads(jlines[0][len(":::MLLOG "):])
    assert lines[0].startswith(":::MLLOG ")
    assert {k: v for k, v in d.items() if k != "time_ms"} == \
        {k: v for k, v in j.items() if k != "time_ms"}
    assert len(lines) == 7
    recs = [json.loads(x[len(":::MLLOG "):]) for x in lines[1:]]
    by_key = {r["key"]: r["value"] for r in recs}
    assert by_key["submission_platform"] == (
        torch.cuda.get_device_name(0).replace(" ", "-")
        if torch.cuda.is_available() else "cpu")
    assert by_key["submission_entry"]["framework"] == "pytorch/cuda"
    MLPerfLogger(log_fn=lines.append, rank=1).event("x")
    assert len(lines) == 7


def test_config_json_and_the_terabyte_configs(tmp_path):
    for cfg in (pcfg.tiny_dlrm_config(), pcfg.TrainConfig(optimizer="adagrad"),
                pcfg.CacheConfig(storage_backend="mmap", n_caching_layers=3)):
        assert pcfg.from_json(type(cfg), pcfg.to_json(cfg)) == cfg
    for name in ("terabyte_dlrm_config", "mlperf_dlrm_config"):
        for kw in ({}, {"max_ind_range": 1000}):
            a, b = getattr(jcfg, name)(**kw), getattr(pcfg, name)(**kw)
            assert (a.embedding_dim, a.table_sizes, a.mlp_bot, a.mlp_top) == \
                (b.embedding_dim, b.table_sizes, b.mlp_bot, b.mlp_top)
    jt, pt = jcfg.TrainConfig(), pcfg.TrainConfig()
    for f in ("batch_size", "test_batch_size", "nepochs", "numpy_rand_seed",
              "test_freq", "mlperf_acc_threshold", "mlperf_auc_threshold",
              "save_model", "load_model"):
        assert getattr(jt, f) == getattr(pt, f), f
    jc, pc = jcfg.CacheConfig(), pcfg.CacheConfig()
    for f in ("storage_backend", "storage_path", "n_warmup_requests"):
        assert getattr(jc, f) == getattr(pc, f), f
    from evstore_tpu_torch.utils.config_io import (read_training_config,
                                                   store_training_config)
    path = str(tmp_path / "sub" / "training_config.json")
    store_training_config(path, pcfg.tiny_dlrm_config(), 17, {"k": 1})
    assert read_training_config(path) == (pcfg.tiny_dlrm_config(), 17,
                                          {"k": 1})


def test_memory_and_profiling_helpers(tmp_path):
    from evstore_tpu_torch.utils.memory import (HBMBallast, device_memory,
                                                host_memory)
    from evstore_tpu_torch.utils.profiling import profile_trace, span
    mem = host_memory()
    assert set(mem) == {"MemTotal", "MemAvailable", "MemFree"}
    assert 0 < mem["MemAvailable"] <= mem["MemTotal"]
    assert device_memory("cpu") == {}
    b = HBMBallast(1, device="cpu")
    assert b._buf.numel() * 4 == 1 << 20
    b.release()
    assert b._buf is None
    with profile_trace(str(tmp_path / "prof")):
        with span("work"):
            torch.ones(8).sum()
    trace = json.load(open(tmp_path / "prof" / "trace.json"))
    assert any(e.get("name") == "work" for e in trace["traceEvents"])
