"""The MLPerf recipe's shape trained through the trainable cache, on the
CPU, against the JAX package.

The shape is bench/run_and_time.sh's: dim 128, the 26 Terabyte tables
capped at 40M rows (204,184,588 rows, 104.5 GB at float32), bottom MLP
13-512-256-128, top MLP 1024-1024-512-256-1, under the recipe's schedule
(lr 1.0, 2,750 warm-up steps).  The masters are sparse files: every
`ev-table-<t>.bin` and `mom-<t>.bin` is made with `truncate`, as
scripts/mlperf_rehearsal.py makes them, and is checked to hold no blocks
before anything else runs, so that no test writes 104 GB.  No table is
drawn: holes read as zero, and only the rows a batch lands take pages.

- `from_files` at the full table sizes, C1 of 8,192, 4 steps of B=128 of
  `grouped_zipf` (alpha 1.05, group noise 0.1): the port's per-batch
  driver held to the JAX class by the rule of
  tests/test_torch_trainable_cache.py (stats exactly; losses, the flushed
  rows read back from the files within 1e-5·(1 + |ref|); sums rtol 1e-5,
  atol 1e-6; the MLPs rtol 1e-4, atol 1e-6), and the pipelined driver held
  to the per-batch one bit for bit (losses, MLPs and their sums, cells,
  stats, the flushed rows).  The MLPs are `init_dlrm`'s, drawn for a twin
  config of one-row tables (init_dlrm draws the MLPs from their own keys,
  so they are the full config's), carried over through `convert.py`.
- The CLI with run_and_time.sh's model, loss and schedule flags plus
  `--use-evstore True --ev-table-path <sparse dir>`, 3 batches of 64 of
  random data, against `evstore_tpu.cli.main` with the same flags: the
  printed losses and hit rates, the step count and the flushed rows.  The
  JAX driver draws its tables before it maps the files, so its
  `init_dlrm` gets the twin config here (its tables are not read when the
  masters are files).
- Both CLIs on those flags for 16 batches of 128 (4 printed windows): under
  the recipe's warm-up a printed loss on random labels passes 0.75 in the
  JAX package as in the port, while every loss stays finite and under 2 ln
  2 (the bound chip_smoke.py's phase 3j holds); the first window held to
  JAX within 1e-5·(1 + |ref|), so both ran the same batches.
- One step at dim 128 with the 1024-wide top MLP on the 1M-capped cut
  (`mlperf_dlrm_config(max_ind_range=1_000_000)`, 7,116,632 rows) through
  the cache, held to the full-table `make_train_step`.
- Serving at the MLPerf width with the tables cut to 3,000 rows
  (`mlperf_dlrm_config(max_ind_range=3000)`: dim 128, the same MLPs):
  the tables `init_dlrm` draws, written as .bin files, behind the port's
  `NativeDeviceC1Cache.open_table_files` at fp32 and in the published
  three-tier configuration (int8 C1, 4-bit C2, alt-key C3, 48-48-4),
  through `run_inference` with a `DLRM(tables=False)`, against the JAX
  package's `NativeDeviceC1Cache` over the same tables in memory (its
  engine refuses a file-backed store) and its forward on the rows it
  serves: scores within 1e-5·(1 + |ref|), cache stats equal.
"""

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
from evstore_tpu.cache import trainable as jtr
from evstore_tpu.cache.storage import StorageManager as JaxStorageManager
from evstore_tpu.cache.tiers import AltKeyResolver as JaxAltKeyResolver
from evstore_tpu.data import synthetic as jsyn
from evstore_tpu.drivers import train as jtrain
from evstore_tpu.drivers.infer import build_cache as jax_build_cache
from evstore_tpu.models.dlrm import dlrm_forward, init_dlrm
from evstore_tpu_torch import cli
from evstore_tpu_torch import config as pcfg
from evstore_tpu_torch.cache import trainable as ptr
from evstore_tpu_torch.cache.device_cache import NativeDeviceC1Cache
from evstore_tpu_torch.cache.storage import write_ev_tables_binary
from evstore_tpu_torch.cache.tiers import altkey_encode
from evstore_tpu_torch.convert import mlps_from_jax
from evstore_tpu_torch.drivers import train as ptrain
from evstore_tpu_torch.drivers.infer import run_inference
from evstore_tpu_torch.models.dlrm import DLRM
from evstore_tpu_torch.train.train_loop import (init_opt_state,
                                                make_train_step)

C1 = 8192
# bench/run_and_time.sh's learning-rate schedule
SCHEDULE = dict(learning_rate=1.0, lr_num_warmup_steps=2750,
                lr_decay_start_step=49315, lr_num_decay_steps=27772)
TOL = dict(rtol=1e-5, atol=1e-6)


def _sparse_masters(d, sizes, dim):
    """The tables and their row sums as sparse float32 files in d; each is
    checked to hold (almost) no blocks before anything reads it."""
    os.makedirs(d)
    for t, n in enumerate(sizes):
        for name, nbytes in ((f"ev-table-{t + 1}.bin", n * dim * 4),
                             (f"mom-{t + 1}.bin", n * 4)):
            p = os.path.join(d, name)
            with open(p, "wb") as f:
                f.truncate(nbytes)
            st = os.stat(p)
            assert st.st_size == nbytes and st.st_blocks * 512 <= 1 << 16, \
                f"{p} is not sparse: {st.st_blocks * 512} of {nbytes} bytes"
    return d


def _twin_dense(cfg, seed=0):
    """init_dlrm's MLPs for cfg (as numpy), drawn for a twin of one-row
    tables."""
    twin = jcfg.make_dlrm_config(cfg.embedding_dim, (1,) * cfg.num_tables,
                                 cfg.mlp_bot[1:-1], cfg.mlp_top[1:-1],
                                 num_dense=cfg.mlp_bot[0])
    return jax.tree_util.tree_map(
        np.asarray, init_dlrm(jax.random.PRNGKey(seed), twin).dense)


def _read_rows(d, sizes, dim, ids):
    """Per table, the rows `ids[t]` and their sums as the files hold them."""
    out = []
    for t, (n, rows) in enumerate(zip(sizes, ids)):
        tab = np.memmap(os.path.join(d, f"ev-table-{t + 1}.bin"),
                        np.float32, mode="r", shape=(n, dim))
        mom = np.memmap(os.path.join(d, f"mom-{t + 1}.bin"), np.float32,
                        mode="r", shape=(n,))
        out.append((np.array(tab[rows]), np.array(mom[rows])))
        del tab, mom
    return out


def _bound(got, ref, what):
    """|got - ref| <= 1e-5 (1 + |ref|), elementwise."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    np.testing.assert_array_less(np.abs(got - ref), 1e-5 * (1 + np.abs(ref))
                                 + 1e-300, err_msg=what)


def _mlps_held(model, dense, init, what):
    """`_held_to_jax`'s rule for the MLPs (the first bottom layer's weight,
    rtol 1e-4, atol 1e-6), and every leaf's change over the run within 1e-3
    of the reference's change (2-norms): from zero sums a weight's first
    update is lr·sign(g), so a weight whose gradient is at rounding level
    may move either way."""
    np.testing.assert_allclose(model.bot[0].weight.detach().numpy().T,
                               dense["bot"]["layer_0"]["w"], rtol=1e-4,
                               atol=1e-6, err_msg=what)
    for part in ("bot", "top"):
        for i, lin in enumerate(getattr(model, part)):
            for leaf, got in (("w", lin.weight.detach().numpy().T),
                              ("b", lin.bias.detach().numpy())):
                ref = np.asarray(dense[part][f"layer_{i}"][leaf], np.float64)
                moved = np.linalg.norm(
                    ref - init[part][f"layer_{i}"][leaf])
                assert moved > 0 and np.linalg.norm(got - ref) <= \
                    1e-3 * moved, f"{what} {part} {i} {leaf}"


def _port_model(cfg, dense):
    model = DLRM(cfg, device="cpu", tables=False)
    model.load_state_dict(mlps_from_jax(dense, cfg, torch.device("cpu")))
    return model


def test_from_files_at_the_full_mlperf_sizes_matches_jax(tmp_path):
    cp = pcfg.mlperf_dlrm_config()
    cj = jcfg.mlperf_dlrm_config()
    sizes, D = cp.table_sizes, cp.embedding_dim
    assert sum(sizes) == 204_184_588 and D == 128
    dirs = {k: _sparse_masters(str(tmp_path / k), sizes, D)
            for k in ("batch", "pipelined", "jax")}
    tp = pcfg.TrainConfig(batch_size=128, optimizer="rwsadagrad", **SCHEDULE)
    tj = jcfg.TrainConfig(batch_size=128, optimizer="rwsadagrad", **SCHEDULE)
    batches = list(jsyn.random_batches(jsyn.RandomDataConfig(
        num_dense=13, table_sizes=sizes, batch_size=128, num_batches=4,
        seed=3, distribution="grouped_zipf", zipf_alpha=1.05,
        group_noise=0.1)))
    ids = [np.unique(np.concatenate([b[1][:, t] for b in batches]))
           for t in range(len(sizes))]
    dense = _twin_dense(cj)

    port = {}
    for mode in ("batch", "pipelined"):
        tc = ptr.TrainableDeviceCache.from_files(
            cp, tp, pcfg.CacheConfig(policy="evlfu", total_size=C1),
            dirs[mode], sizes, device="cpu")
        model = _port_model(cp, dense)
        dst = ptr.init_dense_state(model)
        if mode == "batch":
            losses = [float(tc.train_batch(model, dst, k + 1, *b)[2])
                      for k, b in enumerate(batches)]
        else:
            losses = [float(x[2]) for x in tc.train_batches(model, dst,
                                                            batches)]
        cells = (tc.cache_values.clone(), tc.cache_mom.clone())
        tc.flush_files()
        port[mode] = dict(losses=losses, model=model, dstate=dst,
                          cells=cells, stats=tc.stats(),
                          rows=_read_rows(dirs[mode], sizes, D, ids))
        tc.close()

    tc = jtr.TrainableDeviceCache.from_files(
        cj, tj, jcfg.CacheConfig(policy="evlfu", total_size=C1),
        dirs["jax"], sizes)
    dj = jax.tree_util.tree_map(jnp.asarray, dense)
    sj = jax.tree_util.tree_map(
        lambda p: jnp.zeros_like(p, dtype=jnp.float32), dj)
    losses_j = []
    for k, (dx, idx, y) in enumerate(batches):
        dj, sj, loss = tc.train_batch(dj, sj, k + 1, dx, idx, y)
        losses_j.append(float(loss))
    tc.flush_files()
    stats_j = tc.stats()
    tc.close()
    rows_j = _read_rows(dirs["jax"], sizes, D, ids)

    got, twin = port["batch"], port["pipelined"]
    assert got["stats"] == stats_j
    assert np.all(np.isfinite(got["losses"]))
    _bound(got["losses"], losses_j, "losses")
    _mlps_held(got["model"], jax.tree_util.tree_map(np.asarray, dj), dense,
               "MLPs")
    trained = 0
    for t, ((r, m), (rj, mj)) in enumerate(zip(got["rows"], rows_j)):
        _bound(r, rj, f"table {t} rows")
        np.testing.assert_allclose(m, mj, **TOL, err_msg=f"mom {t}")
        trained += int((m != 0).sum())
    assert trained > 0

    # the pipelined driver against the per-batch one, bit for bit
    assert twin["losses"] == got["losses"]
    assert twin["stats"] == got["stats"]
    for (n, p), (_, q) in zip(got["model"].named_parameters(),
                              twin["model"].named_parameters()):
        assert torch.equal(p, q), n
    for n in got["dstate"]:
        assert torch.equal(got["dstate"][n], twin["dstate"][n]), n
    for a, b in zip(got["cells"], twin["cells"]):
        assert torch.equal(a, b)
    for (r, m), (r2, m2) in zip(got["rows"], twin["rows"]):
        np.testing.assert_array_equal(r, r2)
        np.testing.assert_array_equal(m, m2)


def _recipe_flags():
    """bench/run_and_time.sh's model, loss and schedule flags (its data,
    logging and cadence flags left out)."""
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "bench",
                        "run_and_time.sh")
    with open(path) as f:
        lines = f.read().splitlines()
    at = next(i for i, x in enumerate(lines) if "python -m" in x)
    flags = []
    for x in lines[at + 1:]:
        if "$dlrm_extra_option" in x:
            break
        flags += x.replace("\\", " ").split()
    drop = {"--data-generation": 1, "--data-set": 1, "--print-freq": 1,
            "--test-freq": 1, "--mlperf-logging": 0,
            "--mlperf-auc-threshold": 1}
    out, k = [], 0
    while k < len(flags):
        if flags[k] in drop:
            k += 1 + drop[flags[k]]
            continue
        out.append(flags[k])
        k += 1
    return out


def _twin_inits(monkeypatch):
    """Both drivers' model builders draw init_dlrm's MLPs for a twin config
    of one-row tables (the full config's tables would be 104 GB; the
    masters are files, so no table is read)."""
    real_init = init_dlrm

    def twin_init(key, cfg):
        twin = jcfg.make_dlrm_config(
            cfg.embedding_dim, (1,) * cfg.num_tables, cfg.mlp_bot[1:-1],
            cfg.mlp_top[1:-1], num_dense=cfg.mlp_bot[0],
            compute_dtype=cfg.compute_dtype)
        return real_init(key, twin)

    def port_dlrm(cfg, *, device=None, seed=0, tables=True):
        assert tables is False
        return _port_model(cfg, jax.tree_util.tree_map(
            np.asarray, twin_init(jax.random.PRNGKey(seed), cfg).dense))

    monkeypatch.setattr(jtrain, "init_dlrm", twin_init)
    monkeypatch.setattr(ptrain, "DLRM", port_dlrm)


LOSS_LINE = (r"step (\d+): loss ([-\d.]+) \(\d+ examples/s, hit rate "
             r"([\d.]+)")


def test_cli_with_the_recipes_flags_over_sparse_files_matches_jax(
        capsys, monkeypatch, tmp_path):
    flags = _recipe_flags()
    assert "--arch-sparse-feature-size" in flags and \
        "--lr-num-warmup-steps" in flags and "--data-set" not in flags
    argv = flags + ("--data-generation random --num-batches 3 "
                    "--mini-batch-size 64 --print-freq 1 "
                    "--compute-dtype float32 --use-evstore True "
                    "--optimizer rwsadagrad "
                    f"--emb-cache-size {C1}").split()
    cp, _, _ = cli.configs_from_args(cli.build_parser().parse_args(argv))
    assert cp.embedding_dim == 128 and sum(cp.table_sizes) == 204_184_588
    sizes, D = cp.table_sizes, cp.embedding_dim
    _twin_inits(monkeypatch)
    outs, rows = [], []
    for side, fn, more in (("j", jcli.main, []),
                           ("p", cli.main, ["--device", "cpu"])):
        d = _sparse_masters(str(tmp_path / side), sizes, D)
        assert fn(argv + ["--ev-table-path", d] + more) == 0
        outs.append(capsys.readouterr().out)
        rows.append(d)
    ref, got = outs
    g = [tuple(map(float, m)) for m in re.findall(LOSS_LINE, got)]
    r = [tuple(map(float, m)) for m in re.findall(LOSS_LINE, ref)]
    assert len(g) == len(r) == 3
    assert [(s, h) for s, _, h in g] == [(s, h) for s, _, h in r]
    _bound([v for _, v, _ in g], [v for _, v, _ in r], "losses")
    assert np.all(np.isfinite([v for _, v, _ in g]))
    assert "training done: steps=3" in got and "(cached)" in got
    # the rows the run trained, read back from each side's files
    batches = list(cli._make_data(cli.build_parser().parse_args(argv),
                                  cp)[0]())
    ids = [np.unique(np.concatenate([b[1][:, t] for b in batches]))
           for t in range(len(sizes))]
    mine, theirs = (_read_rows(d, sizes, D, ids) for d in rows[::-1])
    for t, ((a, m), (b, n)) in enumerate(zip(mine, theirs)):
        _bound(a, b, f"table {t} rows")
        np.testing.assert_allclose(m, n, **TOL, err_msg=f"mom {t}")
    assert any((m != 0).any() for _, m in mine)


def test_both_clis_pass_0_75_under_the_recipes_warmup_on_random_labels(
        capsys, monkeypatch, tmp_path):
    argv = _recipe_flags() + ("--data-generation random --num-batches 16 "
                              "--mini-batch-size 128 --print-freq 4 "
                              "--compute-dtype float32 --use-evstore True "
                              "--optimizer rwsadagrad "
                              f"--emb-cache-size {C1}").split()
    cp, _, _ = cli.configs_from_args(cli.build_parser().parse_args(argv))
    _twin_inits(monkeypatch)
    losses = []
    for side, fn, more in (("j", jcli.main, []),
                           ("p", cli.main, ["--device", "cpu"])):
        d = _sparse_masters(str(tmp_path / side), cp.table_sizes,
                            cp.embedding_dim)
        assert fn(argv + ["--ev-table-path", d] + more) == 0
        losses.append([float(m[1]) for m in re.findall(
            LOSS_LINE, capsys.readouterr().out)])
        shutil.rmtree(d)
    ref, got = losses
    assert len(ref) == len(got) == 4
    _bound(got[:1], ref[:1], "the first window's loss")
    for side in (ref, got):
        assert np.all(np.isfinite(side)) and max(side) < 2 * np.log(2)
        assert max(side) > 0.75, side


def test_one_dim128_step_on_the_1m_cut_matches_the_full_table_step():
    cfg = pcfg.mlperf_dlrm_config(max_ind_range=1_000_000)
    sizes, D = cfg.table_sizes, cfg.embedding_dim
    assert sum(sizes) == 7_116_632 and cfg.mlp_top[1] == 1024
    tcfg = pcfg.TrainConfig(batch_size=128, optimizer="rwsadagrad",
                            **SCHEDULE)
    dx, idx, y = next(jsyn.random_batches(jsyn.RandomDataConfig(
        num_dense=13, table_sizes=sizes, batch_size=128, num_batches=1,
        seed=5, distribution="grouped_zipf", zipf_alpha=1.05,
        group_noise=0.1)))
    # zeros (pages never touched take no memory) with the batch's rows
    # drawn: the step reads and writes no other row
    rng = np.random.default_rng(7)
    tables = [np.zeros((n, D), np.float32) for n in sizes]
    for t, tab in enumerate(tables):
        rows = np.unique(idx[:, t])
        bnd = np.sqrt(1.0 / sizes[t])
        tab[rows] = rng.uniform(-bnd, bnd, (len(rows), D))
    before = [tab[np.unique(idx[:, t])].copy()
              for t, tab in enumerate(tables)]
    full = DLRM(cfg, device="cpu", seed=1, tables=tables)
    st = init_opt_state(full, tcfg)
    st.step = 1         # the cache's step 1, at the schedule's lr(1)
    ref = float(make_train_step(cfg, tcfg)(full, st, dx, idx, y))

    tc = ptr.TrainableDeviceCache(
        cfg, tcfg, pcfg.CacheConfig(policy="evlfu", total_size=C1), tables,
        copy_tables=False, device="cpu")
    model = DLRM(cfg, device="cpu", seed=1, tables=False)
    dst = ptr.init_dense_state(model)
    loss = float(tc.train_batch(model, dst, 1, dx, idx, y)[2])
    tc.flush_to_host()
    assert tc.stats()["size"] == sum(len(np.unique(idx[:, t]))
                                     for t in range(len(sizes)))
    _bound([loss], [ref], "loss")
    params = dict(full.named_parameters())
    for n, p in model.named_parameters():
        _bound(p.detach().numpy(), params[n].detach().numpy(), n)
    moved = 0
    for t in range(len(sizes)):
        rows = np.unique(idx[:, t])
        _bound(tables[t][rows], full.tables[t].detach().numpy()[rows],
               f"table {t}")
        moved += int((tables[t][rows] != before[t]).any(axis=1).sum())
        np.testing.assert_allclose(
            tc.host_mom[t][rows], st.sparse[f"tables.{t}"].numpy()[rows],
            **TOL, err_msg=f"sums {t}")
    assert moved > 0
    tc.close()


SERVE = {
    "fp32": dict(n_caching_layers=1, total_size=2000, main_precision=32),
    # bench/dlrm_s_criteo_kaggle_C1_C2_C3.sh's shape at a smaller budget
    "c1c2c3": dict(n_caching_layers=3, total_size=3000, main_precision=8,
                   secondary_precision=4, size_proportion=(48, 48, 4),
                   c3_io_batch=10),
}


@pytest.mark.parametrize("name", list(SERVE))
def test_serving_at_the_mlperf_width_from_files_matches_jax(tmp_path, name):
    cj = jcfg.mlperf_dlrm_config(max_ind_range=3000)
    cp = pcfg.mlperf_dlrm_config(max_ind_range=3000)
    sizes, D = cp.table_sizes, cp.embedding_dim
    assert D == 128 and cp.mlp_bot == (13, 512, 256, 128) and \
        cp.mlp_top[1:] == (1024, 1024, 512, 256, 1) and \
        sizes == cj.table_sizes and max(sizes) == 3000
    params = jax.tree_util.tree_map(np.asarray,
                                    init_dlrm(jax.random.PRNGKey(2), cj))
    tables = [params.sparse[f"table_{t}"]["kind_plain"]
              for t in range(cp.num_tables)]
    write_ev_tables_binary(tables, str(tmp_path))
    rng = np.random.default_rng(12)
    alts = [altkey_encode(t, rng.integers(0, n, n)).astype(np.uint32)
            for t, n in enumerate(sizes)]
    stream = list(jsyn.random_batches(jsyn.RandomDataConfig(
        num_dense=13, table_sizes=sizes, batch_size=128, num_batches=6,
        seed=5, distribution="grouped_zipf", zipf_alpha=1.05,
        group_noise=0.1)))
    warm, scored = stream[:2], stream[2:]

    kw = dict(policy="evlfu", **SERVE[name])
    jc = jax_build_cache(
        jcfg.CacheConfig(**kw), cj,
        JaxStorageManager("dummy", dim=D).load(tables=tables),
        JaxAltKeyResolver(alts), use_device_cache=True)
    for _, idx, _ in warm:
        jc.lookup_batch(idx)
    ref = np.concatenate([np.asarray(jax.nn.sigmoid(dlrm_forward(
        params, jnp.asarray(dense), jnp.asarray(idx), cj,
        emb_rows=jc.lookup_batch(idx)))) for dense, idx, _ in scored])
    stats_j = jc.stats()

    model = DLRM(cp, device="cpu", tables=False)
    model.load_state_dict(mlps_from_jax(params.dense, cp,
                                        torch.device("cpu")))
    cache = NativeDeviceC1Cache(pcfg.CacheConfig(**kw), cp.num_tables, D,
                                device="cpu")
    cache.open_table_files(str(tmp_path), sizes, 32)
    cache.load_altkeys(alts)
    try:
        got = run_inference(model, cp, pcfg.CacheConfig(**kw), scored, None,
                            warmup_batches=warm, use_device_cache=True,
                            cache=cache, device="cpu",
                            log_fn=lambda *_: None)
    finally:
        cache.close()
    assert not model.has_sparse()
    assert got.requests == 4 * 128
    _bound(got.scores, ref, "scores")
    assert got.cache_stats == stats_j
    s = got.cache_stats
    assert 0 < s["hit_rate"] < 1 and s["size"] == s["capacity"]
    if name == "c1c2c3":
        assert s["c2"]["hit_rate"] > 0 and s["c3"]["size"] > 0
