"""The port's device-memory-bounded trainer (`cache/trainable.py`) against
the JAX package's `TrainableDeviceCache`, on the CPU.

One case for each single-chip case of tests/test_trainable_cache.py (the
sharded ones are ROADMAP queue 1 item 8), each also held to the JAX class
on the same tables, weights (`init_dlrm`'s, through `convert.py`) and
numpy batches: the assigner's outputs and `stats()` exactly, the losses
and the flushed tables within 1e-5·(1 + |ref|) (`run_training`'s bound in
test_torch_checkpoint.py), the flushed sums within rtol 1e-5, atol 1e-6.
Float32 on both sides, but XLA and PyTorch sum the gradients in other
orders, and a row's first update, lr·G/|G|, carries G's relative error
whatever |G| is: on the tiny model's second step a cell moves 1.43e-6
apart (at |ref| 0.034, `test_cached_training_matches_full_table_when_no_
eviction`), past an atol of 1e-6.

The uint8 cells re-encode with stochastic rounding, whose draws come from
`jax.random` in the JAX package and from a `torch.Generator` in the port.
Held to JAX, the port's cases take JAX's draws for the same step (the
`jax_draws` fixture swaps them in); the port's own codec is held by
distribution: every code within one of the deterministic encode, and the
mean decode within 3σ of the value over 20,000 draws.  Besides: the
training assigner's binding against JAX's, the port's per-batch and
pipelined drivers bit for bit with each other (float32 and int8), the
refusals, and the `save` files read by the other package both ways.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evstore_tpu import config as jcfg
from evstore_tpu import native as jnative
from evstore_tpu.cache import trainable as jtr
from evstore_tpu.data import synthetic as jsyn
from evstore_tpu.models.dlrm import init_dlrm
from evstore_tpu.train import train_loop as jloop
from evstore_tpu_torch import config as pcfg
from evstore_tpu_torch import native as pnative
from evstore_tpu_torch.cache import trainable as ptr
from evstore_tpu_torch.cache.storage import write_ev_tables_binary
from evstore_tpu_torch.convert import params_from_jax
from evstore_tpu_torch.models.dlrm import DLRM
from evstore_tpu_torch.train.train_loop import (init_opt_state,
                                                make_train_step)

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's stochastic rounding with `jax.random`'s draws for the
    step's seed, as the JAX step draws them."""
    def sr(x, gen):
        u = np.asarray(jax.random.uniform(jax.random.PRNGKey(
            gen.initial_seed()), tuple(x.shape), jnp.float32))
        y = (torch.clamp(x, -1.0, 1.0) + 1.0) * 0.5 * 254.0
        return torch.clamp(torch.floor(y + torch.from_numpy(u.copy())), 0,
                           254).to(torch.uint8)
    monkeypatch.setattr(ptr, "_q8_encode_sr", sr)


@dataclasses.dataclass
class Case:
    cj: object
    cp: object
    tj: object
    tp: object
    params: object          # JAX init_dlrm, as numpy
    tables: list
    batches: list

    def ccfg(self, pkg, capacity, precision=32):
        return pkg.CacheConfig(policy="evlfu", total_size=capacity,
                               main_precision=precision)


def _case(n_batches=30, bs=16, seed=0, lr=0.2, dist="uniform",
          learnable=True, cfg_args=None, tables_seed=None, param_seed=0):
    args, kw = cfg_args or (None, None)
    if args is None:
        cj, cp = jcfg.tiny_dlrm_config(), pcfg.tiny_dlrm_config()
    else:
        cj = jcfg.make_dlrm_config(*args, **kw)
        cp = pcfg.make_dlrm_config(*args, **kw)
    tj = jcfg.TrainConfig(batch_size=bs, learning_rate=lr,
                          optimizer="rwsadagrad")
    tp = pcfg.TrainConfig(batch_size=bs, learning_rate=lr,
                          optimizer="rwsadagrad")
    params = jax.tree_util.tree_map(
        np.asarray, init_dlrm(jax.random.PRNGKey(param_seed), cj))
    if tables_seed is None:
        tables = [params.sparse[f"table_{t}"]["kind_plain"].copy()
                  for t in range(cj.num_tables)]
    else:
        rng = np.random.default_rng(tables_seed)
        tables = [rng.uniform(-0.1, 0.1, (s, cj.embedding_dim)).astype(
            np.float32) for s in cj.table_sizes]
    dcfg = jsyn.RandomDataConfig(
        num_dense=cj.num_dense_features, table_sizes=cj.table_sizes,
        batch_size=bs, num_batches=n_batches, seed=seed, distribution=dist,
        zipf_alpha=1.1)
    gen = jsyn.learnable_batches if learnable else jsyn.random_batches
    return Case(cj, cp, tj, tp, params, tables, list(gen(dcfg)))


def _jax_dense(c):
    dense = jax.tree_util.tree_map(jnp.asarray, c.params.dense)
    return dense, jax.tree_util.tree_map(
        lambda p: jnp.zeros_like(p, dtype=jnp.float32), dense)


def _port_model(c):
    state, _ = params_from_jax(c.params.dense, c.params.sparse, c.cp,
                               device="cpu")
    model = DLRM(c.cp, device="cpu", tables=False)
    model.load_state_dict({k: v for k, v in state.items()
                           if not k.startswith("tables.")})
    return model, ptr.init_dense_state(model)


def _run_jax(c, capacity, precision=32, tables=None, start=0):
    tc = jtr.TrainableDeviceCache(c.cj, c.tj,
                                  c.ccfg(jcfg, capacity, precision),
                                  tables or c.tables)
    dense, dst = _jax_dense(c)
    losses = []
    for k, (dx, idx, y) in enumerate(c.batches):
        dense, dst, loss = tc.train_batch(dense, dst, k + start, dx, idx, y)
        losses.append(float(loss))
    tc.flush_to_host()
    out = dict(tables=[t.copy() for t in tc.host_tables],
               mom=[m.copy() for m in tc.host_mom], losses=losses,
               stats=tc.stats(),
               dense=jax.tree_util.tree_map(np.asarray, dense))
    tc.close()
    return out


def _run_port(c, capacity, precision=32, mode="batch", tables=None,
              start=0, tc=None, keep=False, model=None, dst=None):
    if tc is None:
        tc = ptr.TrainableDeviceCache(c.cp, c.tp,
                                      c.ccfg(pcfg, capacity, precision),
                                      tables or c.tables, device="cpu")
    if model is None:
        model, dst = _port_model(c)
    losses = []
    if mode == "batch":
        for k, (dx, idx, y) in enumerate(c.batches):
            _, _, loss = tc.train_batch(model, dst, k + start, dx, idx, y)
            losses.append(float(loss))
    else:
        for _, _, loss in tc.train_batches(model, dst, iter(c.batches),
                                           start_step=start):
            losses.append(float(loss))
    tc.flush_to_host()
    out = dict(tables=[t.copy() for t in tc.host_tables],
               mom=[m.copy() for m in tc.host_mom], losses=losses,
               stats=tc.stats(), model=model, dstate=dst, tc=tc)
    if not keep:
        tc.close()
    return out


def _bound(got, ref, what):
    """|got - ref| <= 1e-5 (1 + |ref|), elementwise."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    np.testing.assert_array_less(np.abs(got - ref), 1e-5 * (1 + np.abs(ref))
                                 + 1e-300, err_msg=what)


def _held_to_jax(got, ref):
    assert got["stats"] == ref["stats"]
    _bound(got["losses"], ref["losses"], "losses")
    for t, (a, b) in enumerate(zip(got["tables"], ref["tables"])):
        _bound(a, b, f"table {t}")
    for t, (a, b) in enumerate(zip(got["mom"], ref["mom"])):
        np.testing.assert_allclose(a, b, **TOL, err_msg=f"mom {t}")
    w = got["model"].bot[0].weight.detach().numpy().T
    np.testing.assert_allclose(w, ref["dense"]["bot"]["layer_0"]["w"],
                               rtol=1e-4, atol=1e-6)


def _same(a, b):
    assert a["losses"] == b["losses"]
    assert a["stats"] == b["stats"]
    for t in range(len(a["tables"])):
        np.testing.assert_array_equal(a["tables"][t], b["tables"][t])
        np.testing.assert_array_equal(a["mom"][t], b["mom"][t])
    for (n, p), (_, q) in zip(a["model"].named_parameters(),
                              b["model"].named_parameters()):
        assert torch.equal(p, q), n
    for n in a["dstate"]:
        assert torch.equal(a["dstate"][n], b["dstate"][n]), n


# ------------------------------------------------- the training assigner

@pytest.mark.parametrize("capacity", [12, 40, 200])
def test_train_assigner_matches_jax(capacity):
    c = _case(n_batches=12, bs=16, seed=4, dist="zipf", learnable=False)
    sides = []
    for pkg, mod in ((jcfg, jnative), (pcfg, pnative)):
        eng = mod.NativeTieredCache(pkg.CacheConfig(total_size=1), 3,
                                    c.cj.embedding_dim, 2)
        eng.borrow_tables(c.tables)
        sides.append((eng, mod.NativeAssigner(eng, capacity, 0.3, 0.95)))
    (je, ja), (pe, pa) = sides
    for _, idx, _ in c.batches:
        ref, got = ja.assign_batch_train(idx), pa.assign_batch_train(idx)
        for r, g in zip(ref[:3] + ref[4:], got[:3] + got[4:]):
            if isinstance(r, list):
                assert r == g
            else:
                np.testing.assert_array_equal(r, g)
        assert ref[3].shape == got[3].shape
        raw_r, raw_g = ja.assign_batch_train_raw(idx), \
            pa.assign_batch_train_raw(idx)
        for k in (0, 1, 2, 4, 5, 6):
            np.testing.assert_array_equal(raw_r[k], raw_g[k])
        keys = [(int(t), int(r)) for t, r in zip(
            np.arange(len(idx)) % 3, idx[np.arange(len(idx)),
                                         np.arange(len(idx)) % 3])]
        np.testing.assert_array_equal(pa.fetch_rows(keys),
                                      ja.fetch_rows(keys))
    rk, rs = ja.resident_entries()
    gk, gs = pa.resident_keys()
    assert gk.dtype == np.int64 and len(gk) > 0
    np.testing.assert_array_equal(gk, [(t << 40) | r for t, r in rk])
    np.testing.assert_array_equal(rs, gs)
    assert pa.stats() == ja.stats()
    bad = np.zeros((2, 3), np.int64)
    bad[1, 2] = -1
    with pytest.raises(ValueError, match="out of"):
        pa.assign_batch_train(bad)
    assert pa.fetch_rows_arrays(np.zeros(0, np.int32),
                                np.zeros(0, np.int64)).shape == \
        (0, c.cj.embedding_dim)
    je.close()
    pe.close()


# ------------------------------------------------------------ the cases

def test_cached_training_matches_full_table_when_no_eviction():
    """Capacity above every distinct key: the port's cached run equals
    its full-table rwsadagrad step's run, and JAX's cached run."""
    c = _case()
    got = _run_port(c, 200)
    _held_to_jax(got, _run_jax(c, 200))
    model = DLRM(c.cp, device="cpu")
    state, _ = params_from_jax(c.params.dense, c.params.sparse, c.cp,
                               device="cpu")
    model.load_state_dict(state)
    opt = init_opt_state(model, c.tp)
    step = make_train_step(c.cp, c.tp)
    # the cached steps count from 0, the full-table step from opt.step = 0
    ref = [float(step(model, opt, dx, idx, y)) for dx, idx, y in c.batches]
    np.testing.assert_allclose(got["losses"], ref, **TOL)
    for t in range(3):
        np.testing.assert_allclose(got["tables"][t],
                                   model.tables[t].detach().numpy(), **TOL)
    np.testing.assert_allclose(got["model"].bot[0].weight.detach().numpy(),
                               model.bot[0].weight.detach().numpy(), **TOL)
    assert got["stats"]["dropped_updates"] == 0


def test_cached_training_bounded_hbm_still_learns():
    c = _case(n_batches=60, bs=32)
    got = _run_port(c, 24)
    _held_to_jax(got, _run_jax(c, 24))
    assert np.mean(got["losses"][-15:]) < np.mean(got["losses"][:15])
    s = got["stats"]
    assert s["dropped_updates"] == 0
    assert s["hbm_bytes"] == 24 * (c.cp.embedding_dim + 1) * 4


def test_small_cache_tracks_full_table_closely():
    c = _case(n_batches=50, bs=8, seed=7)
    got = _run_port(c, 20)
    _held_to_jax(got, _run_jax(c, 20))
    full = _run_port(c, 200)
    gap = np.mean(np.abs(np.subtract(got["losses"], full["losses"])))
    assert gap < 0.02, gap
    diffs = [np.abs(a - b).max() for a, b in zip(got["tables"],
                                                 full["tables"])]
    assert max(diffs) < 0.15 and np.mean(diffs) < 0.08, diffs


def test_writeback_keeps_host_consistent():
    c = _case(n_batches=60, bs=8, seed=3)
    got = _run_port(c, 16)
    _held_to_jax(got, _run_jax(c, 16))
    touched = [set() for _ in range(3)]
    for _, idx, _ in c.batches:
        for t in range(3):
            touched[t].update(int(r) for r in idx[:, t])
    n_changed = n_touched = 0
    for t in range(3):
        for r in range(c.tables[t].shape[0]):
            same = np.array_equal(got["tables"][t][r], c.tables[t][r])
            if r not in touched[t]:
                assert same and got["mom"][t][r] == 0
            else:
                n_touched += 1
                n_changed += int(not same)
    assert n_changed > 0.9 * n_touched


def test_save_load_resume(tmp_path):
    """Save at step 10, restore into a trainer over zeroed tables, resume:
    the uninterrupted run's tables and sums.  Each package reads the
    other's files."""
    c = _case(n_batches=20, bs=8, seed=11)
    whole = _run_port(c, 200)
    head = dataclasses.replace(c, batches=c.batches[:10])
    tail = dataclasses.replace(c, batches=c.batches[10:])
    part = _run_port(head, 200, keep=True)
    part["tc"].save(str(tmp_path / "p"))
    part["tc"].close()
    zeros = [np.zeros_like(t) for t in c.tables]
    tc = ptr.TrainableDeviceCache(c.cp, c.tp, c.ccfg(pcfg, 200), zeros,
                                  device="cpu").load(str(tmp_path / "p"))
    got = _run_port(tail, 200, tc=tc, start=10, keep=True,
                    model=part["model"], dst=part["dstate"])
    for t in range(3):
        np.testing.assert_allclose(got["tables"][t], whole["tables"][t],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(got["mom"][t], whole["mom"][t],
                                   rtol=1e-5, atol=1e-7)
    assert len(tc.export_ev_tables(str(tmp_path / "ev"))) == 3
    tc.close()
    # JAX's trainer saves the same 10 steps; each package loads the other's
    jtc = jtr.TrainableDeviceCache(c.cj, c.tj, c.ccfg(jcfg, 200), c.tables)
    dense, dst = _jax_dense(c)
    for k, (dx, idx, y) in enumerate(head.batches):
        dense, dst, _ = jtc.train_batch(dense, dst, k, dx, idx, y)
    jtc.save(str(tmp_path / "j"))
    jtc.close()
    for reader, src, other in ((jtr, "p", "j"), (ptr, "j", "p")):
        pkg, cfg, tcfg = ((jcfg, c.cj, c.tj) if reader is jtr
                          else (pcfg, c.cp, c.tp))
        kw = {} if reader is jtr else {"device": "cpu"}
        r = reader.TrainableDeviceCache(cfg, tcfg, c.ccfg(pkg, 200),
                                        [np.zeros_like(t) for t in zeros],
                                        **kw)
        r.load(str(tmp_path / src))
        for t in range(3):
            for name, arr in (("table", r.host_tables[t]),
                              ("mom", r.host_mom[t])):
                np.testing.assert_array_equal(
                    arr, np.load(tmp_path / src / f"{name}_{t}.npy"))
                np.testing.assert_allclose(
                    arr, np.load(tmp_path / other / f"{name}_{t}.npy"),
                    **TOL)
        r.close()


def test_file_backed_training_matches_in_ram(tmp_path):
    c = _case(n_batches=40)
    write_ev_tables_binary(c.tables, str(tmp_path), 32)
    ram = _run_port(c, 12)
    _held_to_jax(ram, _run_jax(c, 12))
    fb = ptr.TrainableDeviceCache.from_files(
        c.cp, c.tp, c.ccfg(pcfg, 12), str(tmp_path),
        [t.shape[0] for t in c.tables], device="cpu")
    got = _run_port(c, 12, tc=fb, keep=True)
    fb.flush_files()
    fb.close()
    assert got["losses"] == ram["losses"]
    for t in range(3):
        np.testing.assert_array_equal(got["tables"][t], ram["tables"][t])
        on_disk = np.fromfile(tmp_path / f"ev-table-{t + 1}.bin",
                              np.float32).reshape(c.tables[t].shape)
        np.testing.assert_array_equal(on_disk, ram["tables"][t])
        np.testing.assert_array_equal(
            np.fromfile(tmp_path / f"mom-{t + 1}.bin", np.float32),
            ram["mom"][t])
    assert not np.allclose(ram["tables"][0], c.tables[0])


def test_map_files_makes_absent_sums_sparse_zeros(tmp_path):
    """An absent `mom-<t>.bin` is made with truncate: its holes read as
    zero and hold no blocks (`test_file_backed_training_matches_in_ram`
    trains from such files)."""
    sizes = (1_000_000, 3)
    write_ev_tables_binary([np.ones((n, 4), np.float32) for n in sizes],
                           str(tmp_path), 32)
    tables, moms = ptr._map_files(str(tmp_path), sizes, 4)
    for t, (n, m) in enumerate(zip(sizes, moms)):
        st = os.stat(tmp_path / f"mom-{t + 1}.bin")
        assert st.st_size == n * 4 and m.shape == (n,)
        assert st.st_blocks * 512 < n * 4 // 8 or n * 4 < 4096
        assert not m.any()
    assert all(t.shape == (n, 4) and np.all(t == 1)
               for t, n in zip(tables, sizes))
    del tables, moms


def test_bf16_cache_rows_track_fp32():
    c = _case(n_batches=60)
    got16 = _run_port(c, 64, 16)
    _held_to_jax(got16, _run_jax(c, 64, 16))
    got32 = _run_port(c, 64, 32)
    assert got16["tc"].cache_values.dtype == torch.bfloat16
    assert got16["stats"]["hbm_bytes"] == 64 * (4 * 2 + 4) < \
        got32["stats"]["hbm_bytes"]
    l16, l32 = got16["losses"], got32["losses"]
    assert np.mean(l16[-10:]) < np.mean(l16[:10])
    assert abs(np.mean(l16[-10:]) - np.mean(l32[-10:])) < 0.05


def test_q8_encode_det_matches_jax():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-1.3, 1.3, 4096),
                        (np.arange(-127, 128) / 127.0),
                        (np.arange(0, 255) + 0.5) / 127.0 - 1.0,
                        [-1.0, 1.0, 0.0, -0.0, 2.0, -2.0]]).astype(np.float32)
    got = ptr._q8_encode_det(torch.from_numpy(x)).numpy()
    ref = np.asarray(jtr._q8_encode_det(jnp.asarray(x)))
    np.testing.assert_array_equal(got, ref)
    codes = np.arange(255, dtype=np.uint8)
    np.testing.assert_array_equal(
        ptr._q8_decode(torch.from_numpy(codes)).numpy(),
        np.asarray(jtr._q8_decode(jnp.asarray(codes))))


def test_q8_codec_stochastic_rounding_unbiased():
    """Every stochastic code is within one of the deterministic encode of
    the same value (it is floor or ceil of it), and over 20,000 draws the
    mean decode lies within 3σ of the clipped value, σ the standard error
    of a two-point draw between its neighbouring codes."""
    x = torch.linspace(-1.05, 1.05, 64, dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    n = 20_000
    det = ptr._q8_encode_det(x).int()
    codes = ptr._q8_encode_sr(x.expand(n, 64).contiguous(), gen).int()
    assert int((codes - det).abs().max()) <= 1
    y = (torch.clamp(x, -1, 1) + 1) * 0.5 * 254
    assert bool((codes >= torch.floor(y).int()).all())
    assert bool((codes <= torch.ceil(y).int()).all())
    mean = ptr._q8_decode(codes.to(torch.uint8)).double().mean(0)
    frac = (y - torch.floor(y)).double()
    sigma = (2.0 / 254) * torch.sqrt(frac * (1 - frac) / n)
    err = (mean - torch.clamp(x, -1, 1).double()).abs()
    assert bool((err <= 3 * sigma + 1e-6).all()), float(err.max())
    # the seed fixes the draws
    a = ptr._q8_encode_sr(x, torch.Generator().manual_seed(5))
    b = ptr._q8_encode_sr(x, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)


def test_int8_cache_rows_still_learn(jax_draws):
    c = _case(n_batches=60)
    got8 = _run_port(c, 64, 8)
    _held_to_jax(got8, _run_jax(c, 64, 8))
    got32 = _run_port(c, 64, 32)
    assert got8["tc"].cache_values.dtype == torch.uint8
    assert got8["stats"]["hbm_bytes"] == 64 * (4 + 4)
    l8, l32 = got8["losses"], got32["losses"]
    assert np.mean(l8[-10:]) < np.mean(l8[:10])
    assert abs(np.mean(l8[-10:]) - np.mean(l32[-10:])) < 0.1


def test_int8_untouched_cells_keep_their_bytes(monkeypatch):
    """A step re-encodes only the cells whose gradient is not zero: every
    other cell keeps its bytes (or takes the deterministic code of the
    miss inserted into it), and each re-encoded code lies within one of
    the deterministic encode of its float32 update."""
    c = _case(n_batches=8, bs=8, seed=2)
    tc = ptr.TrainableDeviceCache(c.cp, c.tp, c.ccfg(pcfg, 64, 8), c.tables,
                                  device="cpu")
    model, dst = _port_model(c)
    for k, (dx, idx, y) in enumerate(c.batches[:-1]):
        tc.train_batch(model, dst, k, dx, idx, y)
    before, mom_before = tc.cache_values.clone(), tc.cache_mom.clone()
    seen = {}
    encode, assign = ptr._q8_encode_sr, tc.assigner.assign_batch_train_raw

    def spy_encode(x, gen):
        seen["x"], seen["codes"] = x.clone(), encode(x, gen)
        return seen["codes"]

    def spy_assign(idx):
        out = assign(idx)
        seen["scat"] = out[1].copy()
        seen["target"] = np.where(out[6] == 2**31 - 1, out[0], out[6])
        return out

    monkeypatch.setattr(ptr, "_q8_encode_sr", spy_encode)
    monkeypatch.setattr(tc.assigner, "assign_batch_train_raw", spy_assign)
    tc.train_batch(model, dst, 7, *c.batches[-1])
    inserted = torch.zeros(64, dtype=torch.bool)
    inserted[torch.from_numpy(seen["scat"]).long()] = True
    moved = torch.zeros(64, dtype=torch.bool)   # the cells updated
    moved[torch.from_numpy(seen["target"][seen["target"] < 64]).long()] = \
        True
    assert torch.equal(moved, tc.cache_mom != mom_before)
    keep = ~moved & ~inserted
    assert bool(keep.any()) and bool(moved.any())
    assert torch.equal(tc.cache_values[keep], before[keep])
    assert torch.equal(tc.cache_values[moved], seen["codes"][moved])
    det = ptr._q8_encode_det(seen["x"]).int()
    assert int((seen["codes"].int() - det).abs().max()) <= 1
    tc.close()


@pytest.mark.parametrize("precision", [32, 8])
def test_pipelined_matches_synchronous_bitexact(precision):
    c = _case(n_batches=20, bs=32, seed=5, dist="zipf", learnable=False,
              tables_seed=0)
    ref = _run_port(c, 24, precision, start=1)
    _same(_run_port(c, 24, precision, "pipelined", start=1), ref)


def test_pipelined_int8_runs_and_learns(jax_draws):
    c = _case(n_batches=40, bs=64, seed=2, lr=0.3, tables_seed=None,
              param_seed=3)
    got = _run_port(c, 48, 8, "pipelined", start=1)
    _held_to_jax(got, _run_jax(c, 48, 8, start=1))
    assert np.mean(got["losses"][-8:]) < np.mean(got["losses"][:8])


def test_long_horizon_cached_auc_matches_full_table(jax_draws):
    """Two epochs with the cache below the distinct keys (evictions and
    write-backs live, the pipelined driver): held-out AUC within 1e-3 of the
    port's full-table run at float32, no worse than 1.5e-2 below it at
    int8; each run's stats held to JAX's assigner over the same stream.
    At this size the packages' trajectories part, at every capacity:
    their full-table steps part alike
    (`test_long_horizon_parting_lies_in_the_full_table_steps`), since a
    row's first update, lr·G/|G|, turns G's rounding into a move of up
    to lr."""
    from evstore_tpu_torch.train.metrics import binary_metrics
    args = ((8, (2000, 1500, 1000, 800), (16,), (16,)), {"num_dense": 4})
    c = _case(n_batches=60, bs=128, seed=11, lr=0.1, cfg_args=args)
    train_b, eval_b = c.batches[:52], c.batches[52:]
    epochs = dataclasses.replace(c, batches=train_b * 2)

    def auc(rows_of, model):
        s, l = [], []
        with torch.no_grad():
            for dx, idx, y in eval_b:
                s.append(torch.sigmoid(model(
                    torch.from_numpy(dx), None,
                    emb_rows=torch.from_numpy(rows_of(idx)))).numpy())
                l.append(y)
        return binary_metrics(np.concatenate(s), np.concatenate(l))["auc"]

    model = DLRM(c.cp, device="cpu")
    state, _ = params_from_jax(c.params.dense, c.params.sparse, c.cp,
                               device="cpu")
    model.load_state_dict(state)
    opt = init_opt_state(model, c.tp)
    step = make_train_step(c.cp, c.tp)

    def full_auc():
        tabs = [t.detach().numpy() for t in model.tables]
        return auc(lambda i: np.stack([tabs[t][i[:, t]] for t in range(4)],
                                      1), model)

    for k, (dx, idx, y) in enumerate(epochs.batches):
        step(model, opt, dx, idx, y)
        if k == len(train_b) - 1:
            first_epoch_auc = full_auc()
    auc_ref = full_auc()
    # 52 batches of 128 (JAX's case: 100, AUC > 0.75) reach about 0.727
    assert auc_ref > 0.7 and auc_ref > first_epoch_auc
    eng = jnative.NativeTieredCache(jcfg.CacheConfig(total_size=1), 4, 8, 2)
    eng.borrow_tables(c.tables)
    asg = jnative.NativeAssigner(eng, 600, 0.3, 0.95)
    for _, idx, _ in epochs.batches:
        asg.assign_batch_train(idx)
    ref_stats = dict(asg.stats(), capacity=600)
    eng.close()
    for prec, bound, two_sided in ((32, 1e-3, True), (8, 1.5e-2, False)):
        got = _run_port(epochs, 600, prec, "pipelined", start=1)
        hbm = 600 * (8 * (4 if prec == 32 else 1) + 4)
        ref_stats.update(hbm_bytes=hbm, hbm_bytes_per_chip=hbm,
                         dropped_updates=0)
        assert got["stats"] == ref_stats and got["stats"]["size"] == 600
        assert got["stats"]["hit_rate"] < 0.9
        a = auc(lambda i: np.stack([got["tables"][t][i[:, t]]
                                    for t in range(4)], 1), got["model"])
        if two_sided:
            assert abs(a - auc_ref) <= bound, (prec, a, auc_ref)
        else:
            assert a - auc_ref >= -bound, (prec, a, auc_ref)


def test_long_horizon_parting_lies_in_the_full_table_steps():
    """The witness for the packages' parting over the long-horizon case's
    two epochs (104 steps, nothing evicted at capacity 6,000): the port's
    cached run equals its full-table `make_train_step` run bit for bit
    (one rwsadagrad form, whose run sums move the accumulator and the row
    alike), JAX's cached run stays within 1e-6·(1+|ref|) of JAX's
    full-table step, and so the cached runs part from each other as the
    two full-table runs do.  `-s` prints the four gaps."""
    args = ((8, (2000, 1500, 1000, 800), (16,), (16,)), {"num_dense": 4})
    c = _case(n_batches=60, bs=128, seed=11, lr=0.1, cfg_args=args)
    c = dataclasses.replace(c, batches=c.batches[:52] * 2)
    model = DLRM(c.cp, device="cpu")
    state, _ = params_from_jax(c.params.dense, c.params.sparse, c.cp,
                               device="cpu")
    model.load_state_dict(state)
    opt = init_opt_state(model, c.tp)
    step = make_train_step(c.cp, c.tp)
    port_full = [float(step(model, opt, dx, idx, y))
                 for dx, idx, y in c.batches]
    port = _run_port(c, 6000)
    jax_cached = _run_jax(c, 6000)["losses"]
    params = jax.tree_util.tree_map(jnp.asarray, c.params)
    jst = jloop.init_opt_state(params, c.tj)
    jstep = jax.jit(jloop.make_train_step(c.cj, c.tj))
    jax_full = []
    for dx, idx, y in c.batches:
        params, jst, loss = jstep(params, jst, dx, idx, y)
        jax_full.append(float(loss))

    def gap(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return np.abs(a - b) / (1 + np.abs(b))

    assert port["stats"]["size"] < 6000
    assert port["losses"] == port_full
    for t in range(4):
        np.testing.assert_array_equal(port["tables"][t],
                                      model.tables[t].detach().numpy())
    own_jax = gap(jax_cached, jax_full)
    assert own_jax.max() <= 1e-6
    cached, full = gap(port["losses"], jax_cached), gap(port_full, jax_full)
    assert np.abs(cached - full).max() <= 1e-6
    own_port = gap(port["losses"], port_full).max()
    print(f"\nover {len(c.batches)} steps, losses |a - b| / (1 + |b|): port "
          f"cached against port full-table max {own_port:.3e}; "
          f"JAX cached against JAX full-table max {own_jax.max():.3e}; port "
          f"full-table against JAX full-table max {full.max():.3e} (first "
          f"above 1e-6 at step {int(np.argmax(full > 1e-6))}, "
          f"{full[32]:.3e} at step 32); port cached against JAX cached max "
          f"{cached.max():.3e}")


def test_borrow_stays_aliased_for_noncontiguous_inputs():
    """F-ordered (or CUDA, or other) tables become C-ordered float32 numpy
    masters that the engine borrows: a write to them is what the next
    miss reads."""
    cfg = pcfg.make_dlrm_config(4, (50, 40), (8,), (8,), num_dense=4)
    tcfg = pcfg.TrainConfig(batch_size=8, learning_rate=0.1,
                            optimizer="rwsadagrad")
    rng = np.random.default_rng(0)
    tables = [np.asfortranarray(rng.uniform(-1, 1, (s, 4)).astype(
        np.float32)) for s in (50, 40)]
    assert not tables[0].flags["C_CONTIGUOUS"]
    for tabs in (tables, [torch.from_numpy(np.ascontiguousarray(t)).t()
                          .contiguous().t() for t in tables]):
        tc = ptr.TrainableDeviceCache(cfg, tcfg,
                                      pcfg.CacheConfig(total_size=16),
                                      tabs, device="cpu")
        assert all(t.flags["C_CONTIGUOUS"] for t in tc.host_tables)
        before = tc.assigner.fetch_rows_arrays(np.array([0]), np.array([7]))
        tc.host_tables[0][7] = 42.0
        after = tc.assigner.fetch_rows_arrays(np.array([0]), np.array([7]))
        np.testing.assert_array_equal(before[0], tables[0][7])
        np.testing.assert_array_equal(after[0], np.full(4, 42.0, np.float32))
        tc.close()


def test_refusals():
    c = _case(n_batches=1)
    ccfg = c.ccfg(pcfg, 16)
    with pytest.raises(ValueError, match="rwsadagrad"):
        ptr.TrainableDeviceCache(
            c.cp, dataclasses.replace(c.tp, optimizer="sgd"), ccfg,
            c.tables, device="cpu")
    with pytest.raises(ValueError, match="main_precision"):
        ptr.TrainableDeviceCache(c.cp, c.tp, c.ccfg(pcfg, 16, 4), c.tables,
                                 device="cpu")
    ro = [t.copy() for t in c.tables]
    ro[1].flags.writeable = False
    strided = [np.asfortranarray(t) for t in c.tables]
    for bad in (ro, strided, [t.astype(np.float64) for t in c.tables]):
        with pytest.raises(ValueError, match="copy_tables=False"):
            ptr.TrainableDeviceCache(c.cp, c.tp, ccfg, bad,
                                     copy_tables=False, device="cpu")
    with pytest.raises(ValueError, match="plain one-hot"):
        ptr.TrainableDeviceCache(
            dataclasses.replace(c.cp, qr_flag=True), c.tp, ccfg, c.tables,
            device="cpu")
    with pytest.raises(ValueError, match="do not match"):
        ptr.TrainableDeviceCache(c.cp, c.tp, ccfg, c.tables[:2],
                                 device="cpu")
    tc = ptr.TrainableDeviceCache(c.cp, c.tp, ccfg, c.tables, device="cpu")
    model, dst = _port_model(c)
    dx, idx, y = c.batches[0]
    idx = idx.copy()
    idx[0, 2] = c.cp.table_sizes[2]
    with pytest.raises(ValueError, match="outside"):
        tc.train_batch(model, dst, 0, dx, idx, y)
    other = DLRM(pcfg.make_dlrm_config(4, (40, 30, 21), (8,), (8,),
                                       num_dense=4), device="cpu",
                 tables=False)
    with pytest.raises(ValueError, match="another DLRMConfig"):
        tc.train_batch(other, ptr.init_dense_state(other), 0, *c.batches[0])
    tc.close()
