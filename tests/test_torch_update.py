"""The port's sparse row updates against the JAX package's, on the CPU:
`rwsadagrad_row_update` (the sorted path through the row-update kernel's
wrapper, which takes its plain version on the CPU) against the Pallas
`rwsadagrad_row_update_pallas` in interpret mode and against
`optim.row_update`; the grouped `sgd_row_update` and `adagrad_row_update`
against JAX's `row_update` and the port's plain per-table path; the plain
`row_update` of every optimizer; the kernel's plain version against numpy;
and `dedup_rows`.

Inputs are made with numpy from a seed and handed to both packages.  They
hold duplicate ids (a Zipf-like head), PAD_ROW entries and bf16 tables.

Tolerances, those of tests/test_pallas_update.py: f32 tables rtol 1e-5,
atol 1e-6, accumulators rtol 1e-5, atol 1e-7 (the Pallas path sums
pre-scaled entries, the port scales each run's sum as row_update does: they
agree only to rounding); bf16 tables within one bf16 ulp of the reference plus rtol 1e-4
(the f32 result rounds to bf16 once, and a rounding difference can cross a
bf16 rounding boundary).  The plain row_update, which scales the sum as
JAX does, is held to the same f32 tolerances.  dedup_rows is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evstore_tpu.ops.pallas_update import rwsadagrad_row_update_pallas
from evstore_tpu.train import optim as jopt
from evstore_tpu_torch.ops.cuda_update import (adagrad_row_update,
                                               rwsadagrad_row_update,
                                               scatter_sub_sorted,
                                               scatter_sub_sorted_ref,
                                               sgd_row_update)
from evstore_tpu_torch.train import optim as popt


def _setup(N=3000, D=36, B=512, seed=0, dup=0.3, n_pad=0, dtype="float32"):
    rng = np.random.default_rng(seed)
    table = rng.uniform(-0.1, 0.1, (N, D)).astype(np.float32)
    if dtype == "bfloat16":    # start from values bf16 holds exactly
        table = np.asarray(jnp.asarray(table, jnp.bfloat16), np.float32)
    state = rng.uniform(0, 0.01, N).astype(np.float32)
    ids = np.asarray(rng.integers(0, N, B), np.int32)
    ids[rng.random(B) < dup] = 7            # heavy duplicates (zipf head)
    ids[rng.random(B) < dup / 3] = N - 1    # a second run, the last row
    if n_pad:
        ids[rng.choice(B, n_pad, replace=False)] = jopt.PAD_ROW
    g = rng.normal(0, 1e-2, (B, D)).astype(np.float32)
    return table, state, ids, g


def _port(table, state, ids, g, dtype):
    tdt = getattr(torch, dtype)
    return (torch.from_numpy(table).to(tdt), torch.from_numpy(state.copy()),
            torch.from_numpy(ids), torch.from_numpy(g))


def _assert_table(got: torch.Tensor, ref, dtype):
    got = got.float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    else:
        mag = np.maximum(np.abs(ref), np.float32(2.0 ** -126))
        ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
        excess = np.abs(got - ref) - (ulp + 1e-4 * np.abs(ref))
        assert np.all(excess <= 0), float(np.max(excess))


@pytest.mark.parametrize("dtype,n_pad", [("float32", 0), ("float32", 5),
                                         ("bfloat16", 5)])
def test_rwsadagrad_row_update_matches_pallas(dtype, n_pad):
    table, state, ids, g = _setup(n_pad=n_pad, dtype=dtype)
    jdt = getattr(jnp, dtype)
    ref_s, ref_t = rwsadagrad_row_update_pallas(
        jnp.asarray(state), jnp.asarray(table, jdt), jnp.asarray(ids),
        jnp.asarray(g), 0.1, tile_rows=512, interpret=True)
    t, s, i, gr = _port(table, state, ids, g, dtype)
    new_s, new_t = rwsadagrad_row_update(s, t, i, gr, 0.1)
    assert new_t is t and new_s is s          # in place
    assert new_t.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(new_s.numpy(), np.asarray(ref_s), rtol=1e-5,
                               atol=1e-7)
    _assert_table(new_t, ref_t, dtype)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("n_pad", [0, 5])
def test_rwsadagrad_matches_jax_row_update(use_kernel, n_pad):
    """Both of the port's rwsadagrad paths against JAX's row_update (its
    dense-grad lowering at this size)."""
    table, state, ids, g = _setup(N=2000, B=1024, seed=1, n_pad=n_pad)
    ref_s, ref_t = jopt.row_update("rwsadagrad", jnp.asarray(state),
                                   jnp.asarray(table), jnp.asarray(ids),
                                   jnp.asarray(g), 0.1)
    t, s, i, gr = _port(table, state, ids, g, "float32")
    popt.row_update("rwsadagrad", s, t, i, gr, 0.1, use_kernel=use_kernel)
    np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), rtol=1e-5,
                               atol=1e-7)
    _assert_table(t, ref_t, "float32")


@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_row_update_matches_jax(opt, dtype):
    table, state, ids, g = _setup(N=2000, B=1024, seed=2, n_pad=7,
                                  dtype=dtype)
    jdt = getattr(jnp, dtype)
    st = None if opt == "sgd" else np.zeros_like(table) + 0.01
    ref_s, ref_t = jopt.row_update(
        opt, None if st is None else jnp.asarray(st),
        jnp.asarray(table, jdt), jnp.asarray(ids), jnp.asarray(g), 0.1)
    t, _, i, gr = _port(table, state, ids, g, dtype)
    s = None if st is None else torch.from_numpy(st.copy())
    popt.row_update(opt, s, t, i, gr, 0.1, use_kernel=False)
    if s is not None:
        np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), rtol=1e-5,
                                   atol=1e-7)
    _assert_table(t, ref_t, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_sub_sorted_semantics(dtype):
    """table[r] -= the sum of r's run, for r in [0, N); negative ids,
    PAD_ROW and ids >= N are inert; rows outside the batch are unchanged."""
    N, D = 50, 5
    rng = np.random.default_rng(3)
    tdt = getattr(torch, dtype)
    # start from values the table's dtype holds exactly
    table = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32)
                             ).to(tdt).float().numpy()
    ids = np.sort(np.concatenate([
        rng.integers(0, N, 40), [3, 3, 3, 49, 49, -4, -1, N, N + 7,
                                 jopt.PAD_ROW, jopt.PAD_ROW]])
                  ).astype(np.int32)
    vals = rng.normal(size=(ids.size, D)).astype(np.float32)
    ref = table.astype(np.float64)
    for r, v in zip(ids, vals):
        if 0 <= r < N:
            ref[r] -= v
    t = torch.from_numpy(table).to(tdt)
    before = t.clone()
    out = scatter_sub_sorted(t, torch.from_numpy(ids), torch.from_numpy(vals))
    assert out is t
    touched = np.zeros(N, bool)
    touched[ids[(ids >= 0) & (ids < N)]] = True
    assert torch.equal(t[~torch.from_numpy(touched)],
                       before[~torch.from_numpy(touched)])
    ref_t = torch.from_numpy(ref.astype(np.float32)).to(tdt)
    _assert_table(t, ref_t.float().numpy(), dtype)
    empty = scatter_sub_sorted_ref(t.clone(), torch.zeros(0, dtype=torch.int32),
                                   torch.zeros(0, D))
    assert torch.equal(empty, t)


def test_dedup_rows_matches_jax():
    idx = np.asarray([3, 1, 3, 7, jopt.PAD_ROW, 1, 7, 7], np.int32)
    g = np.arange(16, dtype=np.float32).reshape(8, 2)
    juniq, jsum, jvalid = jopt.dedup_rows(jnp.asarray(idx), jnp.asarray(g), 8)
    keep = np.asarray(jvalid) > 0
    uniq, summed = popt.dedup_rows(torch.from_numpy(idx),
                                   torch.from_numpy(g), 10)
    np.testing.assert_array_equal(uniq.numpy(), np.asarray(juniq)[keep])
    np.testing.assert_array_equal(summed.numpy(), np.asarray(jsum)[keep])


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "rwsadagrad"])
def test_dense_update_matches_jax(opt):
    jinit, jdense, _ = jopt.make_optimizer(opt)
    rng = np.random.default_rng(4)
    p = rng.normal(size=(6, 3)).astype(np.float32)
    g = rng.normal(size=(6, 3)).astype(np.float32)
    s = rng.random((6, 3)).astype(np.float32)
    js = {} if opt == "sgd" else {"w": jnp.asarray(s)}
    js2, jp2 = jdense(js, {"w": jnp.asarray(p)}, {"w": jnp.asarray(g)}, 0.1)
    param = torch.nn.Parameter(torch.from_numpy(p.copy()))
    param.grad = torch.from_numpy(g)
    ps = {} if opt == "sgd" else {"w": torch.from_numpy(s.copy())}
    popt.make_optimizer(opt)[1](ps, {"w": param}, 0.1)
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp2["w"]),
                               rtol=1e-6, atol=1e-7)
    if opt != "sgd":
        np.testing.assert_allclose(ps["w"].numpy(), np.asarray(js2["w"]),
                                   rtol=1e-6)


def test_pad_row_is_the_jax_sentinel():
    assert popt.PAD_ROW == int(jopt.PAD_ROW)


def test_update_wrapper_refuses_what_it_cannot_take():
    t = torch.zeros(4, 8, device="meta")
    rows = torch.zeros(3, dtype=torch.int32, device="meta")
    vals = torch.zeros(3, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        scatter_sub_sorted(t, rows, vals)
    with pytest.raises(ValueError, match="CUDA device"):
        scatter_sub_sorted(torch.zeros(4, 8), rows, torch.zeros(3, 8))


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "rwsadagrad"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_ids_outside_the_table_are_inert(opt, use_kernel):
    """The port's rule for ids outside [0, N) on device tensors: a row
    update leaves the table alone.  The JAX `row_update` wraps a negative
    id as numpy does (id -1 updates row N-1); every in-range row agrees.
    Ids on the host never get here: `train` raises for them."""
    N, D = 50, 4
    rng = np.random.default_rng(5)
    table = rng.uniform(-0.1, 0.1, (N, D)).astype(np.float32)
    ids = np.asarray([3, -1, 7, 3, N], np.int32)
    g = rng.normal(0, 1, (ids.size, D)).astype(np.float32)
    st = (None if opt == "sgd" else
          np.full((N,) if opt == "rwsadagrad" else (N, D), 0.01, np.float32))
    ref_s, ref_t = jopt.row_update(
        opt, None if st is None else jnp.asarray(st), jnp.asarray(table),
        jnp.asarray(ids[:4]), jnp.asarray(g[:4]), 0.1)
    ref_t = np.asarray(ref_t)
    assert np.abs(ref_t[N - 1] - table[N - 1]).max() > 0.05   # JAX wraps
    t = torch.from_numpy(table.copy())
    s = None if st is None else torch.from_numpy(st.copy())
    popt.row_update(opt, s, t, torch.from_numpy(ids), torch.from_numpy(g),
                    0.1, use_kernel=use_kernel)
    np.testing.assert_array_equal(t.numpy()[N - 1], table[N - 1])
    np.testing.assert_allclose(t.numpy()[:N - 1], ref_t[:N - 1], rtol=1e-5,
                               atol=1e-6)
    if s is not None:
        np.testing.assert_array_equal(s.numpy()[N - 1], st[N - 1])
        np.testing.assert_allclose(s.numpy()[:N - 1],
                                   np.asarray(ref_s)[:N - 1], rtol=1e-5,
                                   atol=1e-7)


# ---- the grouped update: every table of a one-hot batch in one call ----

GROUP_SIZES = (50, 3000, 700, 1200, 64)


def _group_setup(D=36, B=512, seed=6, dtype="float32"):
    """T tables, per-table accumulators and ids [B, T] with a Zipf-like
    head, PAD_ROW, and ids of table t that are valid in table t+1 but not
    in t (`cross`, a mask).  Returns numpy arrays."""
    rng = np.random.default_rng(seed)
    tables, states, cols, cross = [], [], [], []
    for t, n in enumerate(GROUP_SIZES):
        tab = rng.uniform(-0.1, 0.1, (n, D)).astype(np.float32)
        if dtype == "bfloat16":
            tab = np.asarray(jnp.asarray(tab, jnp.bfloat16), np.float32)
        tables.append(tab)
        states.append(rng.uniform(0, 0.01, n).astype(np.float32))
        ids = rng.integers(0, n, B).astype(np.int64)
        ids[rng.random(B) < 0.3] = n // 2             # a heavy run
        ids[rng.random(B) < 0.05] = jopt.PAD_ROW
        bad = np.zeros(B, bool)
        if t + 1 < len(GROUP_SIZES) and GROUP_SIZES[t + 1] > n:
            bad = rng.random(B) < 0.05                # valid in t+1 only
            ids[bad] = rng.integers(n, GROUP_SIZES[t + 1], int(bad.sum()))
        cols.append(ids.astype(np.int32))
        cross.append(bad)
    g = rng.normal(0, 1e-2, (B, len(GROUP_SIZES), D)).astype(np.float32)
    return tables, states, np.stack(cols, 1), np.stack(cross, 1), g


def _group_port(tables, states, ids, g, dtype):
    tdt = getattr(torch, dtype)
    tabs = [torch.from_numpy(t.copy()).to(tdt) for t in tables]
    flat = torch.from_numpy(np.concatenate(states))
    return tabs, flat, torch.from_numpy(ids), torch.from_numpy(g)


@pytest.mark.parametrize("ref", ["pallas", "row_update"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_rwsadagrad_matches_jax_per_table(ref, dtype):
    """One grouped call over all tables (the plain path on the CPU) against
    the JAX update of each table on its own column of ids: the Pallas
    sweep in interpret mode, or `optim.row_update`.  Ids of table t that
    are valid in table t+1 stay inert: the JAX side gets PAD_ROW there."""
    tables, states, ids, cross, g = _group_setup(dtype=dtype)
    assert cross.any()
    tabs, flat, i, gr = _group_port(tables, states, ids, g, dtype)
    new_s, new_t = rwsadagrad_row_update(flat, tabs, i, gr, 0.1)
    assert new_s is flat and new_t is tabs
    jdt = getattr(jnp, dtype)
    off = 0
    for t, (tab, st) in enumerate(zip(tables, states)):
        jid = np.where(cross[:, t], jopt.PAD_ROW, ids[:, t]).astype(np.int32)
        args = (jnp.asarray(st), jnp.asarray(tab, jdt), jnp.asarray(jid),
                jnp.asarray(g[:, t]), 0.1)
        if ref == "pallas":
            ref_s, ref_t = rwsadagrad_row_update_pallas(
                *args, tile_rows=512, interpret=True)
        else:
            ref_s, ref_t = jopt.row_update("rwsadagrad", *args)
        n = tab.shape[0]
        np.testing.assert_allclose(flat[off:off + n].numpy(),
                                   np.asarray(ref_s), rtol=1e-5, atol=1e-7,
                                   err_msg=f"state of table {t}")
        _assert_table(tabs[t], ref_t, dtype)
        off += n


def test_grouped_rwsadagrad_cross_table_ids_are_inert():
    """An id of table t that is too large for t would land in table t+1's
    rows if it were offset unchecked; it is inert: the result equals the
    one with PAD_ROW in its place, bit for bit."""
    tables, states, ids, cross, g = _group_setup(seed=7)
    out = []
    for each in (ids, np.where(cross, jopt.PAD_ROW, ids).astype(np.int32)):
        tabs, flat, i, gr = _group_port(tables, states, each, g, "float32")
        rwsadagrad_row_update(flat, tabs, i, gr, 0.1)
        out.append((flat, tabs))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_grouped_scatter_sub_sorted_matches_numpy():
    """The grouped plain version: global ids, sorted, over three tables;
    negative ids, ids past the last table and PAD_ROW are inert."""
    rng = np.random.default_rng(8)
    sizes, D = (20, 5, 30), 4
    bases = np.concatenate([[0], np.cumsum(sizes)])
    tables = [rng.normal(size=(n, D)).astype(np.float32) for n in sizes]
    gids = np.sort(np.concatenate([
        rng.integers(0, bases[-1], 60), [0, 19, 20, 24, 25, 54, 54, -3,
                                         bases[-1], jopt.PAD_ROW]]
    )).astype(np.int32)
    vals = rng.normal(size=(gids.size, D)).astype(np.float32)
    ref = [t.astype(np.float64) for t in tables]
    for r, v in zip(gids, vals):
        if 0 <= r < bases[-1]:
            t = int(np.searchsorted(bases, r, side="right") - 1)
            ref[t][r - bases[t]] -= v
    tabs = [torch.from_numpy(t.copy()) for t in tables]
    assert scatter_sub_sorted(tabs, torch.from_numpy(gids),
                              torch.from_numpy(vals)) is tabs
    for got, want in zip(tabs, ref):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the one-table call is the group of one
    single = torch.from_numpy(tables[2].copy())
    local = np.sort(gids - bases[2]).astype(np.int32)
    keep = (gids >= bases[2]) & (gids < bases[3])
    scatter_sub_sorted(single, torch.from_numpy(local[keep]),
                       torch.from_numpy(vals[keep]))
    assert torch.equal(single, tabs[2])


def test_too_many_rows_for_int32_global_ids_raise():
    """sum N_t > INT32_MAX - 1 leaves no room for PAD_ROW above every
    global id: ValueError, from the sizes alone (meta tensors: nothing is
    allocated)."""
    tabs = [torch.empty((2 ** 30, 4), device="meta"),
            torch.empty((2 ** 30, 4), device="meta")]
    ids = torch.zeros((2, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="PAD_ROW"):
        rwsadagrad_row_update(torch.empty(2 ** 31, device="meta"), tabs, ids,
                              torch.zeros((2, 2, 4), device="meta"), 0.1)
    with pytest.raises(ValueError, match="PAD_ROW"):
        scatter_sub_sorted(tabs, ids.reshape(-1),
                           torch.zeros((4, 4), device="meta"))
    # one row fewer fits
    ok = [torch.empty((2 ** 30, 4), device="meta"),
          torch.empty((2 ** 30 - 2, 4), device="meta")]
    with pytest.raises(ValueError, match="CUDA device"):
        scatter_sub_sorted(ok, ids.reshape(-1),
                           torch.zeros((4, 4), device="meta"))


# ---- the grouped sgd and adagrad updates ----

@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_table_kernel_row_update_matches_jax(opt, dtype):
    """`row_update` with the kernel on (the grouped path with one table)
    against JAX's `row_update`: duplicates and PAD_ROW."""
    table, state, ids, g = _setup(N=2000, B=1024, seed=2, n_pad=7,
                                  dtype=dtype)
    jdt = getattr(jnp, dtype)
    st = None if opt == "sgd" else np.zeros_like(table) + 0.01
    ref_s, ref_t = jopt.row_update(
        opt, None if st is None else jnp.asarray(st),
        jnp.asarray(table, jdt), jnp.asarray(ids), jnp.asarray(g), 0.1)
    t, _, i, gr = _port(table, state, ids, g, dtype)
    s = None if st is None else torch.from_numpy(st.copy())
    popt.row_update(opt, s, t, i, gr, 0.1, use_kernel=True)
    if s is not None:
        np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), rtol=1e-5,
                                   atol=1e-7)
    _assert_table(t, ref_t, dtype)


def _grouped(opt, tabs, flat2d, ids, g):
    if opt == "sgd":
        assert sgd_row_update(tabs, ids, g, 0.1) is tabs
        return
    new_s, new_t = adagrad_row_update(flat2d, tabs, ids, g, 0.1)
    assert new_s is flat2d and new_t is tabs


@pytest.mark.parametrize("ref", ["jax", "plain"])
@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_sgd_adagrad_match_per_table(opt, dtype, ref):
    """One grouped call over all tables (ids [B, T] with a heavy run,
    PAD_ROW, and ids of table t that are valid only in table t+1) against
    each table updated on its own column: JAX's `row_update`, or the port's
    plain `row_update` (`dedup_rows`).  The state is one flat [sum N_t, D]
    buffer; the cross-table ids stay inert (PAD_ROW on the reference
    side)."""
    tables, _, ids, cross, g = _group_setup(dtype=dtype, seed=9)
    assert cross.any()
    D = tables[0].shape[1]
    states = [np.random.default_rng(t).uniform(0, 0.01, tab.shape
                                               ).astype(np.float32)
              for t, tab in enumerate(tables)]
    tdt = getattr(torch, dtype)
    tabs = [torch.from_numpy(t.copy()).to(tdt) for t in tables]
    flat = torch.from_numpy(np.concatenate(states))
    assert flat.shape == (sum(GROUP_SIZES), D)
    _grouped(opt, tabs, flat, torch.from_numpy(ids), torch.from_numpy(g))
    jdt = getattr(jnp, dtype)
    off = 0
    for t, (tab, st) in enumerate(zip(tables, states)):
        jid = np.where(cross[:, t], jopt.PAD_ROW, ids[:, t]).astype(np.int32)
        n = tab.shape[0]
        if ref == "jax":
            ref_s, ref_t = jopt.row_update(
                opt, None if opt == "sgd" else jnp.asarray(st),
                jnp.asarray(tab, jdt), jnp.asarray(jid), jnp.asarray(g[:, t]),
                0.1)
        else:
            ref_t = torch.from_numpy(tab.copy()).to(tdt)
            ref_s = None if opt == "sgd" else torch.from_numpy(st.copy())
            popt.row_update(opt, ref_s, ref_t, torch.from_numpy(jid),
                            torch.from_numpy(g[:, t]), 0.1, use_kernel=False)
            ref_t = ref_t.float().numpy()
        if opt != "sgd":
            np.testing.assert_allclose(flat[off:off + n].numpy(),
                                       np.asarray(ref_s), rtol=1e-5,
                                       atol=1e-7,
                                       err_msg=f"state of table {t}")
        _assert_table(tabs[t], ref_t, dtype)
        off += n


@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_grouped_sgd_adagrad_cross_table_ids_are_inert(opt):
    """Ids too large for their table, negative ids and PAD_ROW: the result
    equals the one with PAD_ROW in their place, bit for bit, and rows no
    valid id names are unchanged."""
    tables, _, ids, cross, g = _group_setup(seed=10)
    ids = ids.copy()
    ids[3, 0], ids[4, 2] = -1, -7
    cross = cross.copy()
    cross[3, 0] = cross[4, 2] = True
    out = []
    for each in (ids, np.where(cross, jopt.PAD_ROW, ids).astype(np.int32)):
        tabs = [torch.from_numpy(t.copy()) for t in tables]
        flat = torch.full((sum(GROUP_SIZES), tables[0].shape[1]), 0.01)
        _grouped(opt, tabs, flat, torch.from_numpy(each),
                 torch.from_numpy(g))
        out.append((flat, tabs))
    assert torch.equal(out[0][0], out[1][0])
    for t, (a, b) in enumerate(zip(out[0][1], out[1][1])):
        assert torch.equal(a, b)
        valid = ids[:, t][(ids[:, t] >= 0) & (ids[:, t] < GROUP_SIZES[t])
                          & ~cross[:, t]]
        untouched = np.setdiff1d(np.arange(GROUP_SIZES[t]), valid)
        np.testing.assert_array_equal(a.numpy()[untouched],
                                      tables[t][untouched])


def test_grouped_updates_check_shapes():
    tabs = [torch.zeros(5, 4), torch.zeros(7, 4)]
    ids = torch.zeros((3, 2), dtype=torch.int32)
    g = torch.zeros((3, 2, 4))
    with pytest.raises(ValueError, match="state"):
        adagrad_row_update(torch.zeros(12), tabs, ids, g, 0.1)
    with pytest.raises(ValueError, match="grads"):
        sgd_row_update(tabs, ids, g[:, :1], 0.1)
    with pytest.raises(ValueError, match="PAD_ROW"):
        sgd_row_update([torch.empty((2 ** 30, 4), device="meta")] * 2,
                       torch.zeros((2, 2), dtype=torch.int32, device="meta"),
                       torch.zeros((2, 2, 4), device="meta"), 0.1)
