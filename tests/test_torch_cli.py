"""The port's CLI (`python -m evstore_tpu_torch.cli`) against the JAX
package's (`evstore_tpu.cli`), on the CPU (`--device cpu`).

- The parser: every flag of the JAX parser under its name and default,
  except `--use-pallas-gather` / `--use-pallas-interaction`, whose unset
  default keeps the port's kernels on, and the port's own `--device`; the
  flag mappings of tests/test_cli.py.
- Training through `main`: random, gaussian and dataset data (the raw TSV
  preprocessed on demand, `--memory-map` streaming with a process pool,
  `--mlperf-bin-loader` records), the port's model built from the JAX
  package's `init_dlrm` weights for the same seed (torch cannot replay
  `jax.random`).  Each printed loss, eval and the best metric within
  1e-5·(1 + |ref|) plus the print's rounding (5e-7), the step counts
  equal, the exported EV tables within 1e-5·(1 + |ref|).
- Serving through `main`: one set of weights in a JAX checkpoint and a
  port checkpoint, its EV tables exported by the JAX package; the plain
  eval and the three serving flag sets of bench/ (C1 EvLFU over mmap;
  C1+C2+C3 in the engine; C1 on the device cache), metrics within atol
  1e-6 and perfect hits equal.  Where the JAX CLI raises on a file-backed
  store behind the engine, it serves the same tables from its checkpoint.
- What is not ported raises NotImplementedError with its ROADMAP item.
"""

import ast
import dataclasses
import os
import re

import jax
import numpy as np
import pytest
import torch

from evstore_tpu import cli as jcli
from evstore_tpu import config as jcfg
from evstore_tpu.models.dlrm import init_dlrm
from evstore_tpu.train.train_loop import init_opt_state as jinit_opt
from evstore_tpu.utils import checkpoint as jck
from evstore_tpu_torch import cli
from evstore_tpu_torch.convert import params_from_jax
from evstore_tpu_torch.data.criteo import make_synthetic_criteo_txt
from evstore_tpu_torch.models import dlrm as pdlrm
from evstore_tpu_torch.train.train_loop import init_opt_state
from evstore_tpu_torch.utils import checkpoint as pck

RealDLRM = pdlrm.DLRM


def _jax_cfg(cfg):
    """The JAX package's DLRMConfig of a port config (plain tables)."""
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


@pytest.fixture
def jax_weights(monkeypatch):
    import evstore_tpu_torch.drivers.train as dtrain
    monkeypatch.setattr(dtrain, "DLRM", _from_jax_init)
    monkeypatch.setattr(pdlrm, "DLRM", _from_jax_init)


def _out(capsys, fn, argv):
    assert fn(argv) == 0
    return capsys.readouterr().out


def _floats(pattern, text):
    return [tuple(float(x) for x in m) if isinstance(m, tuple) else float(m)
            for m in re.findall(pattern, text)]


def _close(got, ref, slack=5e-7):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and got.size > 0
    np.testing.assert_array_less(np.abs(got - ref),
                                 1e-5 * (1 + np.abs(ref)) + slack)


def _same_training(capsys, argv):
    """Run both CLIs; compare the step losses, evals and the result."""
    ref = _out(capsys, jcli.main, argv)
    got = _out(capsys, cli.main, argv + ["--device", "cpu"])
    loss = r"step (\d+): loss ([-\d.]+)"
    assert [s for s, _ in _floats(loss, got)] == \
        [s for s, _ in _floats(loss, ref)]
    _close([v for _, v in _floats(loss, got)],
           [v for _, v in _floats(loss, ref)])
    ev = r"eval @ (\d+): auc ([-\d.na]+) acc ([-\d.]+)"
    assert len(_floats(ev, got)) == len(_floats(ev, ref))
    if _floats(ev, ref):
        _close(_floats(ev, got), _floats(ev, ref), slack=5e-5)
    done = r"training done: steps=(\d+) best=([-\d.inf]+)"
    (gs, gb), = _floats(done, got)
    (rs, rb), = _floats(done, ref)
    assert gs == rs
    if np.isfinite(rb):
        _close([gb], [rb], slack=5e-5)
    else:
        assert gb == rb
    return got, ref


ARCH = ("--arch-sparse-feature-size 4 --arch-embedding-size 40-30 "
        "--arch-mlp-bot 4-8-4 --arch-mlp-top 8-1 --compute-dtype float32")


# ------------------------------------------------------------- the parser

def test_every_jax_flag_with_its_default():
    ours = {a.dest: a for a in cli.build_parser()._actions}
    ref = {a.dest: a for a in jcli.build_parser()._actions}
    assert set(ours) - set(ref) == {"device"}
    assert set(ref) <= set(ours)
    for dest, a in ref.items():
        b = ours[dest]
        assert a.option_strings == b.option_strings, dest
        if dest in ("use_pallas_gather", "use_pallas_interaction"):
            assert a.default is False and b.default is None
            continue
        assert a.default == b.default, dest
        assert a.choices == b.choices, dest
    assert ours["device"].default == "cuda"


def test_kaggle_flags_map_to_config():
    argv = ("--arch-sparse-feature-size 36 "
            "--arch-embedding-size 100-200-300 "
            "--arch-mlp-bot 13-512-256-64-36 --arch-mlp-top 512-256-1 "
            "--mini-batch-size 128 --learning-rate 0.1 "
            "--optimizer rwsadagrad --loss-function bce").split()
    cfg, tcfg, ccfg = cli.configs_from_args(cli.build_parser().parse_args(argv))
    jc, jt, _ = jcli.configs_from_args(jcli.build_parser().parse_args(argv))
    assert cfg.embedding_dim == 36
    assert cfg.table_sizes == (100, 200, 300)
    assert cfg.mlp_bot == (13, 512, 256, 64, 36)
    assert cfg.mlp_top == (42, 512, 256, 1)
    assert tcfg.learning_rate == 0.1 and tcfg.optimizer == "rwsadagrad"
    for f in ("embedding_dim", "table_sizes", "mlp_bot", "mlp_top",
              "compute_dtype", "interaction_op", "loss_threshold"):
        assert getattr(cfg, f) == getattr(jc, f), f
    for f in dataclasses.fields(tcfg):
        if hasattr(jt, f.name):
            assert getattr(tcfg, f.name) == getattr(jt, f.name), f.name
    assert cfg.use_gather_kernel and cfg.use_interaction_kernel


def test_max_ind_range_caps_tables():
    argv = ("--arch-sparse-feature-size 4 --arch-embedding-size 100-2000 "
            "--arch-mlp-bot 4-4 --arch-mlp-top 8-1 "
            "--max-ind-range 500").split()
    cfg, _, _ = cli.configs_from_args(cli.build_parser().parse_args(argv))
    assert cfg.table_sizes == (100, 500)


def test_evstore_flags():
    argv = ("--use-evstore True --cache-algo evlfu --emb-cache-size 1000 "
            "--n-caching-layers 3 --main-precision 8 "
            "--secondary-precision 4 --size-proportion 48-48-4 "
            "--emb-stor mmap --ev-table-path /x").split()
    _, _, ccfg = cli.configs_from_args(cli.build_parser().parse_args(argv))
    _, _, jccfg = jcli.configs_from_args(jcli.build_parser().parse_args(argv))
    assert ccfg.total_size == 1000 and ccfg.n_caching_layers == 3
    assert ccfg.main_precision == 8 and ccfg.secondary_precision == 4
    assert ccfg.storage_backend == "mmap" and ccfg.storage_path == "/x"
    for f in dataclasses.fields(ccfg):
        if hasattr(jccfg, f.name):
            assert getattr(ccfg, f.name) == getattr(jccfg, f.name), f.name
    assert ccfg.tier_capacities() == jccfg.tier_capacities()


@pytest.mark.parametrize("flags,gather,interaction", [
    ("", True, True), ("--use-pallas-gather False", False, True),
    ("--use-pallas-interaction False --use-pallas-gather True", True,
     False)])
def test_kernel_flags(flags, gather, interaction):
    cfg, _, _ = cli.configs_from_args(cli.build_parser().parse_args(
        flags.split()))
    assert (cfg.use_gather_kernel, cfg.use_interaction_kernel) == \
        (gather, interaction)


# ------------------------------------------------------- what raises

@pytest.mark.parametrize("flags,item", [
    ("--use-evstore True", "item 7"), ("--mesh-data 2", "item 8"),
    ("--mesh-model 2", "item 8"), ("--alltoall-impl butterfly", "item 8"),
    ("--inference-only --use-evstore True --use-device-cache True "
     "--mesh-model 4", "item 8")])
def test_unported_options_raise(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        cli.main((ARCH + " --num-batches 2 --device cpu " + flags).split())


def test_without_a_card_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main((ARCH + " --num-batches 2").split())


# ------------------------------------------------------------ training

@pytest.mark.parametrize("extra", [
    "--optimizer sgd --learning-rate 0.1",
    "--optimizer rwsadagrad --learning-rate 0.1 --nbatches-test 4 "
    "--test-freq 5",
    "--optimizer adagrad --rand-data-dist gaussian --rand-data-min 0 "
    "--rand-data-max 25 --rand-data-sigma 6 --learning-rate 0.1"])
def test_train_random_matches_jax(capsys, jax_weights, extra):
    got, _ = _same_training(capsys, (
        ARCH + " --mini-batch-size 16 --num-batches 10 --print-freq 2 "
        + extra).split())
    assert "trained 10 steps" in got


def _sizes():
    sizes = [50] * 26
    sizes[3], sizes[8], sizes[19] = 3, 4, 10
    return sizes


def _dataset_arch():
    return ("--arch-sparse-feature-size 4 --arch-embedding-size "
            + "-".join(str(s) for s in _sizes())
            + " --arch-mlp-bot 13-8-4 --arch-mlp-top 16-1 "
            "--compute-dtype float32 --mini-batch-size 32 --print-freq 8 "
            "--data-generation dataset --learning-rate 0.1")


@pytest.fixture(scope="module")
def raw_txt(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_raw")
    return make_synthetic_criteo_txt(str(d / "train.txt"), n=1400, seed=11,
                                      vocab=_sizes())


@pytest.mark.parametrize("mode", ["in_memory", "memory_map"])
def test_train_raw_data_file_matches_jax(capsys, jax_weights, raw_txt,
                                         tmp_path, mode):
    extra = (" --memory-map --dataset-multiprocessing 2"
             if mode == "memory_map" else "")
    out = {}
    for name, fn in (("j", jcli.main), ("p", cli.main)):
        argv = (_dataset_arch() + extra + f" --raw-data-file {raw_txt} "
                f"--output-dir {tmp_path / name} "
                f"--ev-table-path {tmp_path / name / 'ev'} "
                "--percent-data-for-inference 0.5 --test-freq 12").split()
        if name == "p":
            argv += ["--device", "cpu", "--save-model",
                     str(tmp_path / "p" / "ck")]
        out[name] = _out(capsys, fn, argv)
    assert "preprocessed" in out["p"] and "lines/s" in out["p"]
    for a, b in (("j", "p"),):
        for t in range(26):
            name = f"ev-table-{t + 1}.bin"
            _close(np.fromfile(tmp_path / b / "ev" / name, np.float32),
                   np.fromfile(tmp_path / a / "ev" / name, np.float32),
                   slack=0)
    loss = r"step (\d+): loss ([-\d.]+)"
    _close([v for _, v in _floats(loss, out["p"])],
           [v for _, v in _floats(loss, out["j"])])
    done = r"training done: steps=(\d+) best=([-\d.]+)"
    assert _floats(done, out["p"])[0][0] == _floats(done, out["j"])[0][0]
    _close([_floats(done, out["p"])[0][1]], [_floats(done, out["j"])[0][1]],
           slack=5e-5)
    assert pck.latest_step(str(tmp_path / "p" / "ck")) is not None


def test_train_mlperf_bin_loader_matches_jax(capsys, jax_weights, raw_txt,
                                             tmp_path):
    from evstore_tpu_torch.data.criteo import (numpy_to_binary,
                                               preprocess_criteo)
    npz = preprocess_criteo(raw_txt, str(tmp_path / "proc"), days=3)
    bin_path = numpy_to_binary(npz, str(tmp_path / "data.bin"))
    _same_training(capsys, (_dataset_arch() + " --mlperf-bin-loader "
                            f"--processed-data-file {bin_path} "
                            "--nbatches-test 3 --test-freq 20").split())


# ------------------------------------------------------------- serving

@pytest.fixture(scope="module")
def served(raw_txt, tmp_path_factory):
    """One set of weights as a JAX checkpoint, a port checkpoint and the
    JAX package's EV export, and the processed test data."""
    from evstore_tpu_torch.data.criteo import preprocess_criteo
    d = tmp_path_factory.mktemp("served")
    npz = preprocess_criteo(raw_txt, str(d / "proc"), days=7)
    argv = _dataset_arch().split()
    cfg, tcfg, _ = cli.configs_from_args(cli.build_parser().parse_args(argv))
    jc, jt, _ = jcli.configs_from_args(jcli.build_parser().parse_args(argv))
    params = init_dlrm(jax.random.PRNGKey(77), jc)
    jck.save_checkpoint(str(d / "jck"), 5, params, jinit_opt(params, jt))
    jck.export_ev_tables(params, str(d / "ev"))
    model = _from_jax_init(cfg, device="cpu", seed=77)
    pck.save_checkpoint(str(d / "pck"), 5, model, init_opt_state(model,
                                                                 tcfg))
    return d, npz


C1 = ("--use-evstore True --cache-algo evlfu --emb-cache-size 300 "
      "--n-caching-layers 1 --emb-stor mmap --enable-warmup True")
C1C2C3 = ("--use-evstore True --cache-algo native --emb-cache-size 400 "
          "--n-caching-layers 3 --main-precision 8 --secondary-precision 4 "
          "--size-proportion 48-48-4 --emb-stor mmap --enable-warmup True")
DEVICE_C1 = C1 + " --use-device-cache True"


def _metrics(text):
    m = re.search(r"inference done: metrics=(\{.*?\}) perfect_hits=(\S+)",
                  text)
    return (ast.literal_eval(m.group(1).replace("nan", "None")),
            int(m.group(2)))


@pytest.mark.parametrize("flags", ["plain", "c1", "c1c2c3", "device_c1"])
def test_serve_matches_jax(capsys, served, tmp_path, flags):
    d, npz = served
    base = (_dataset_arch() + f" --inference-only --processed-data-file {npz}"
            " --percent-data-for-inference 0.5 --numpy-rand-seed 77")
    if flags == "plain":
        ref = _out(capsys, jcli.main, (base + f" --load-model {d / 'jck'}"
                                       ).split())
        got = _out(capsys, cli.main, (base + f" --load-model {d / 'pck'} "
                                      "--device cpu").split())
        g = ast.literal_eval(got.split("inference done: ")[1].strip())
        r = ast.literal_eval(ref.split("inference done: ")[1].strip())
        assert g.keys() == r.keys()
        for k in r:
            assert abs(g[k] - r[k]) <= 1e-6, k
        return
    served_flags = {"c1": C1, "c1c2c3": C1C2C3, "device_c1": DEVICE_C1}[flags]
    ev = f" --ev-table-path {d / 'ev'}"
    cdf = f" --write-cdf-file {tmp_path / 'cdf.csv'}"
    if flags == "c1":
        ref = _out(capsys, jcli.main, (base + " " + served_flags + ev + cdf
                                       + f" --load-model {d / 'jck'}"
                                       ).split())
    else:
        # the JAX CLI refuses a file-backed store behind the engine ...
        with pytest.raises(ValueError, match="file mode"):
            jcli.main((base + " " + served_flags + ev
                       + f" --load-model {d / 'jck'}").split())
        capsys.readouterr()
        # ... and serves the same tables from its checkpoint
        ref = _out(capsys, jcli.main, (
            base + " " + served_flags.replace("--emb-stor mmap", "")
            + f" --load-model {d / 'jck'}").split())
    got = _out(capsys, cli.main, (base + " " + served_flags + ev + cdf
                                  + f" --load-model {d / 'pck'} "
                                  "--device cpu").split())
    (gm, gp), (rm, rp) = _metrics(got), _metrics(ref)
    assert gm.keys() == rm.keys()
    for k in rm:
        assert abs(gm[k] - rm[k]) <= 1e-6, (k, gm[k], rm[k])
    assert gp == rp
    stats = ast.literal_eval(re.search(r"cache stats: (\{.*\})", got)
                             .group(1).replace("true", "True"))
    if flags == "c1c2c3":
        assert stats["c2"]["size"] > 0 and stats["c2"]["hit_rate"] > 0
    assert (tmp_path / "cdf.csv").exists()
