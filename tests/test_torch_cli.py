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
- The table-free serving model: the three file-backed routes again with
  the port's table draw (`models/dlrm.py::init_sparse_arch`) made to
  raise, held to the JAX CLI the same way, their one model holding no
  table; the plain eval and the dummy store drawing the tables once;
  `restore_mlps` equal to a full `restore_checkpoint`'s MLPs, and raising
  ValueError on a checkpoint of other MLP widths or layer counts.
- The mesh flags over 4 gloo ranks in torchrun's environment
  (`--mesh-data 2 --mesh-model 2 --dedup-exchange True`, `--alltoall-impl
  butterfly`, and serving with `--use-device-cache True --mesh-model 4`),
  each held to the port's own single-device run of the same flags, which
  the cases above hold to the JAX CLI (the JAX CLI lays its mesh over the
  8 devices of one process, so it cannot run these shapes).
- `--use-evstore True --mesh-model 2` (cached training, the trainable
  cache's cells sharded) over 4 gloo ranks against the JAX CLI with the
  same flags and `--mesh-data 4` over its 8 devices, the port's model
  from `init_dlrm`'s weights: each printed loss, hit rate, eval and the
  best within 1e-5·(1 + |ref|) plus the print's rounding.
- Without a world the mesh flags raise and say to launch under torchrun.
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

@pytest.mark.parametrize("flags,error,item", [
    ("--use-evstore True --mesh-model 2", ValueError,
     "launch under torchrun"),
    ("--mesh-data 2", ValueError, "launch under torchrun"),
    ("--mesh-model 2", ValueError, "launch under torchrun"),
    ("--alltoall-impl butterfly", ValueError, "launch under torchrun"),
    ("--inference-only --use-evstore True --use-device-cache True "
     "--mesh-model 4", ValueError, "launch under torchrun")])
def test_unported_options_raise(monkeypatch, flags, error, item):
    """Without a world (no WORLD_SIZE) the mesh flags raise and say to
    launch under torchrun, cached training's too."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(error, match=item):
        cli.main((ARCH + " --num-batches 2 --device cpu " + flags).split())


# ---------------------------------------- over 4 gloo ranks, as torchrun

def _torchrun(argv, world, cwd, limit_s=180):
    """`python -m evstore_tpu_torch.cli argv` in `world` processes with
    torchrun's environment, the rendezvous store held here as torchrun's
    agent holds it; -> each rank's output (all must exit 0)."""
    import subprocess
    import sys
    store = torch.distributed.TCPStore("127.0.0.1", 0, world, True,
                                       wait_for_workers=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(store.port), OMP_NUM_THREADS="1",
               TORCHELASTIC_USE_AGENT_STORE="True",
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "evstore_tpu_torch.cli", *argv],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=cwd,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=limit_s)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out}"
    return outs


def _printed(text):
    return [ln for ln in text.splitlines() if not ln.startswith(":::MLLOG")
            and not ln.startswith("[W") and "socket.cpp" not in ln]


@pytest.mark.parametrize("mesh_flags", [
    "--mesh-data 2 --mesh-model 2 --dedup-exchange True --optimizer "
    "rwsadagrad",
    "--alltoall-impl butterfly --optimizer adagrad"])
def test_train_over_four_ranks_matches_one(capsys, tmp_path, mesh_flags):
    """The CLI over 4 gloo ranks against its own single-device run of the
    same flags and seed: each printed loss and eval, and the result,
    within 1e-5·(1 + |ref|) plus the print's rounding; only rank 0
    prints."""
    base = (ARCH + " --mini-batch-size 16 --num-batches 10 --print-freq 2 "
            "--learning-rate 0.1 --nbatches-test 4 --test-freq 5 "
            "--device cpu").split()
    outs = _torchrun(base + mesh_flags.split(), 4, str(tmp_path))
    ref = _out(capsys, cli.main, base + [
        f for f in mesh_flags.split() if f in ("--optimizer", "rwsadagrad",
                                               "adagrad")])
    got = "\n".join(_printed(outs[0]))
    for pattern in (r"step (\d+): loss ([-\d.]+)",
                    r"eval @ (\d+): auc ([-\d.na]+) acc ([-\d.]+)",
                    r"training done: steps=(\d+) best=([-\d.inf]+)"):
        g, r = _floats(pattern, got), _floats(pattern, ref)
        assert len(g) == len(r) > 0, pattern
        _close(g, r, slack=5e-5)
    if "butterfly" in mesh_flags:
        assert "butterfly placement: order" in got
    for out in outs[1:]:
        assert not [ln for ln in _printed(out) if "loss" in ln
                    or "done" in ln]


def test_serve_sharded_device_cache_over_four_ranks(capsys, tmp_path):
    """`--use-device-cache True --mesh-model 4` over 4 gloo ranks: the
    printed metrics, perfect hits and cache stats of the single-card run
    (the stats beside `hbm_bytes_per_chip`, a quarter of `hbm_bytes`)."""
    base = (ARCH + " --mini-batch-size 16 --nbatches-test 6 --inference-only "
            "--use-evstore True --use-device-cache True --emb-cache-size 40 "
            "--device cpu").split()
    outs = _torchrun(base + ["--mesh-model", "4"], 4, str(tmp_path))
    ref = _out(capsys, cli.main, base)
    got = _printed(outs[0])

    def done(lines):        # the metrics and perfect hits, not the p99
        return [ln.split(" p99=")[0] for ln in lines
                if ln.startswith("inference done")]

    assert done(got) == done(ref.splitlines()) and len(done(got)) == 1
    import json
    stats = json.loads(next(ln for ln in got
                            if ln.startswith("cache stats: "))[13:])
    want = json.loads(next(ln for ln in ref.splitlines()
                           if ln.startswith("cache stats: "))[13:])
    assert stats.pop("hbm_bytes_per_chip") * 4 == stats["hbm_bytes"]
    assert stats == want
    for out in outs[1:]:
        assert not [ln for ln in _printed(out) if "done" in ln]


def _cached_rank(rank, world, argv, state):
    """`cli.main(argv)` on a rank of a spawned world, the model built with
    `state` (the JAX package's weights): -> (rc, what it printed)."""
    import contextlib
    import io
    import evstore_tpu_torch.drivers.train as dtrain

    def from_state(cfg, *, device=None, seed=0, tables=True):
        model = RealDLRM(cfg, device=device, seed=seed)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state.items()})
        return model

    dtrain.DLRM = from_state
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


def test_cached_training_over_four_ranks_matches_jax(capsys, tmp_path):
    """`--use-evstore True --mesh-model 2` over 4 gloo ranks (a (2, 2)
    mesh) against the JAX CLI's sharded trainable cache on (4, 2)."""
    from evstore_tpu_torch.parallel.multihost import spawn_local
    argv = (ARCH + " --mini-batch-size 16 --num-batches 20 --print-freq 5 "
            "--use-evstore True --optimizer rwsadagrad --learning-rate 0.1 "
            "--emb-cache-size 24 --test-freq 10 --nbatches-test 4 "
            "--mesh-model 2").split()
    ref = _out(capsys, jcli.main, argv + ["--mesh-data", "4", "--save-model",
                                          str(tmp_path / "j")])
    args = cli.build_parser().parse_args(argv)
    cfg = cli.configs_from_args(args)[0]
    state = {k: v.detach().numpy() for k, v in _from_jax_init(
        cfg, device="cpu", seed=args.numpy_rand_seed).state_dict().items()}
    res = spawn_local(_cached_rank, 4, (argv + [
        "--device", "cpu", "--save-model", str(tmp_path / "p")], state),
        timeout_s=60, limit_s=240)
    assert [rc for rc, _ in res] == [0] * 4
    got = res[0][1]
    loss = r"step (\d+): loss ([-\d.]+) \(\d+ examples/s, hit rate ([\d.]+)"
    g, r = _floats(loss, got), _floats(loss, ref)
    assert len(g) == len(r) == 4
    assert [(s, h) for s, _, h in g] == [(s, h) for s, _, h in r]
    _close([v for _, v, _ in g], [v for _, v, _ in r])
    ev = r"eval @ (\d+): auc ([-\d.na]+) acc ([-\d.]+)"
    assert len(_floats(ev, got)) == len(_floats(ev, ref)) == 3
    _close(_floats(ev, got), _floats(ev, ref), slack=5e-5)
    done = r"training done: steps=(\d+) best=([-\d.]+) \(cached\)"
    (gs, gb), = _floats(done, got)
    (rs, rb), = _floats(done, ref)
    assert gs == rs == 20
    _close([gb], [rb], slack=5e-5)
    for t in range(2):
        _close(np.load(tmp_path / "p" / f"table_{t}.npy"),
               np.load(tmp_path / "j" / f"table_{t}.npy"))
    for _, out in res[1:]:
        assert "loss" not in out and "done" not in out


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


def _serve_base(npz):
    return (_dataset_arch() + f" --inference-only --processed-data-file "
            f"{npz} --percent-data-for-inference 0.5 --numpy-rand-seed 77")


def _serve_both(capsys, served, tmp_path, flags):
    """The JAX CLI's and the port's output for one of the bench/ serving
    flag sets over the JAX export (the port from its own checkpoint)."""
    d, npz = served
    base = _serve_base(npz)
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
    return got, ref


def _same_serving(got, ref):
    """Metrics within atol 1e-6 and the perfect hits equal; -> the port's
    cache stats."""
    (gm, gp), (rm, rp) = _metrics(got), _metrics(ref)
    assert gm.keys() == rm.keys()
    for k in rm:
        assert abs(gm[k] - rm[k]) <= 1e-6, (k, gm[k], rm[k])
    assert gp == rp
    return ast.literal_eval(re.search(r"cache stats: (\{.*\})", got)
                            .group(1).replace("true", "True"))


@pytest.mark.parametrize("flags", ["plain", "c1", "c1c2c3", "device_c1"])
def test_serve_matches_jax(capsys, served, tmp_path, flags):
    d, npz = served
    base = _serve_base(npz)
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
    stats = _same_serving(*_serve_both(capsys, served, tmp_path, flags))
    if flags == "c1c2c3":
        assert stats["c2"]["size"] > 0 and stats["c2"]["hit_rate"] > 0
    assert (tmp_path / "cdf.csv").exists()


def _built_models(monkeypatch):
    """The port's DLRMs the CLI builds, in order."""
    built = []

    def spy(*a, **kw):
        built.append(RealDLRM(*a, **kw))
        return built[-1]

    monkeypatch.setattr(pdlrm, "DLRM", spy)
    return built


@pytest.mark.parametrize("flags", ["c1", "c1c2c3", "device_c1"])
def test_serving_from_the_store_draws_no_table(capsys, served, tmp_path,
                                               monkeypatch, flags):
    """The routes that read every row from the .bin files (the Python store
    over mmap, the engine, the device cache) build a model that holds no
    tables and restore the checkpoint's MLPs alone: with the port's table
    draw made to raise, the CLI still gives the JAX CLI's metrics within
    1e-6 and its perfect hits."""
    def no_draw(*_):
        raise AssertionError("the serving model drew its tables")

    monkeypatch.setattr(pdlrm, "init_sparse_arch", no_draw)
    built = _built_models(monkeypatch)
    stats = _same_serving(*_serve_both(capsys, served, tmp_path, flags))
    assert len(built) == 1 and not built[0].has_sparse()
    if flags == "c1c2c3":
        assert stats["c2"]["size"] > 0 and stats["c2"]["hit_rate"] > 0


@pytest.mark.parametrize("route", ["plain", "dummy_store"])
def test_routes_that_read_the_models_tables_still_draw_them(
        capsys, served, monkeypatch, route):
    """The plain eval (`--use-evstore False`) and the dummy store (no
    `--ev-table-path`) read the model's tables: the CLI draws them once and
    restores the whole checkpoint, and serves as the JAX CLI does."""
    d, npz = served
    draws = []

    def counted(cfg, rng):
        draws.append(cfg.num_tables)
        return pdlrm_init(cfg, rng)

    pdlrm_init = pdlrm.init_sparse_arch
    monkeypatch.setattr(pdlrm, "init_sparse_arch", counted)
    built = _built_models(monkeypatch)
    argv = _serve_base(npz) + ("" if route == "plain" else " " + C1.replace(
        "--emb-stor mmap", ""))
    ref = _out(capsys, jcli.main, (argv + f" --load-model {d / 'jck'}"
                                   ).split())
    got = _out(capsys, cli.main, (argv + f" --load-model {d / 'pck'} "
                                  "--device cpu").split())
    assert draws == [26] and len(built) == 1 and built[0].has_sparse()
    if route == "plain":
        g = ast.literal_eval(got.split("inference done: ")[1].strip())
        r = ast.literal_eval(ref.split("inference done: ")[1].strip())
        assert g.keys() == r.keys()
        for k in r:
            assert abs(g[k] - r[k]) <= 1e-6, k
    else:
        _same_serving(got, ref)


def _dataset_cfg(arch=None):
    argv = (arch or _dataset_arch()).split()
    return cli.configs_from_args(cli.build_parser().parse_args(argv))[:2]


def test_restore_mlps_equals_a_full_restore(served):
    """`--load-model` into the table-free model: the MLPs a full
    `restore_checkpoint` gives, and no table."""
    d, _ = served
    cfg, tcfg = _dataset_cfg()
    full = RealDLRM(cfg, device="cpu", seed=3)
    pck.restore_checkpoint(str(d / "pck"), 5, full,
                           init_opt_state(full, tcfg))
    bare = RealDLRM(cfg, device="cpu", seed=3, tables=False)
    assert pck.restore_mlps(str(d / "pck"), 5, bare) is bare
    assert not bare.has_sparse()
    want = full.state_dict()
    got = bare.state_dict()
    assert set(got) == {k for k in want if k.startswith(("bot.", "top."))}
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
    # a seed of its own: the restored weights are the checkpoint's
    fresh = RealDLRM(cfg, device="cpu", seed=4, tables=False)
    assert not torch.equal(fresh.bot[0].weight, got["bot.0.weight"])


@pytest.mark.parametrize("old,new", [("13-8-4", "13-6-4"),
                                     ("16-1", "16-8-1")])
def test_restore_mlps_of_other_widths_raises(served, old, new):
    """A checkpoint whose MLPs have another width or another layer count
    than the model's raises ValueError."""
    d, _ = served
    cfg, _ = _dataset_cfg(_dataset_arch().replace(old, new))
    bare = RealDLRM(cfg, device="cpu", seed=3, tables=False)
    with pytest.raises(ValueError, match="MLPs"):
        pck.restore_mlps(str(d / "pck"), 5, bare)
