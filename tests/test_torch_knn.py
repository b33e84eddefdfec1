"""K7, the alt-key kNN (`evstore_tpu_torch/ops/cuda_knn.py`,
`csrc/knn_topk.cu`), on the CPU.

- The plain version `knn_topk_ref` against the JAX package's
  `gen_altkeys._topk_neighbors_blocked`, array-equal, over the case list
  chip_smoke.py's phase 2 runs on the card: queries from mid-table with
  their ids, D = 7, 36 and 128, k = 1, 10, 11 and 32, N not a multiple of
  the key tile and N < k + m, duplicate rows (the lower id first) and zero
  rows, rows at the Kaggle init's scales side by side; ids of -1 against
  the JAX block's arithmetic without its mask.
- The wrapper's checks, on meta tensors.
- The launch geometry: every D <= 128 and k <= 32 fits shared memory, at
  the widths the kernel's `Geo` has.
- A numpy emulation of K7's rule (inputs truncated to TF32, lower bounds,
  lists of k + m, the exact float32 re-rank, the certificate, the exact
  sweep), held to JAX's neighbours by the correctness rule, and shown
  failing the certificate on constructed near-ties and handing those rows
  to the sweep.
- The lower bound held against the emulated float32 exact distance and
  float64 at each of the 26 Kaggle tables' init scales, with an adversarial
  accumulation error and inputs whose truncation loses the most.
- The tool's alt keys of some rows (`knn_neighbours`, then
  `pick_altkeys`) against the JAX tool's, and `altkey_rows` reading the
  rows back.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evstore_tpu.tools import gen_altkeys as jgen
from evstore_tpu_torch.config import kaggle_dlrm_config
from evstore_tpu_torch.ops import cuda_knn
from evstore_tpu_torch.ops.cuda_knn import (KNN_EXTRA, KNN_MARGIN,
                                            knn_bound_constants,
                                            knn_geometry, knn_ks, knn_topk,
                                            knn_topk_ref)
from evstore_tpu_torch.tools import gen_altkeys as pgen

KAGGLE_SIZES = kaggle_dlrm_config().table_sizes


def kaggle_rows(rng, n, dim, tables=None):
    """n rows drawn at the Kaggle init's scales, U(-sqrt(1/n_t), sqrt(1/n_t))
    of table t, the tables side by side in turn."""
    tables = range(len(KAGGLE_SIZES)) if tables is None else tables
    scales = np.asarray([np.sqrt(1.0 / KAGGLE_SIZES[t]) for t in tables])
    b = scales[np.arange(n) % len(scales)]
    return (rng.uniform(-1, 1, (n, dim)) * b[:, None]).astype(np.float32)


def with_duplicates(rng, n, dim):
    """Uniform rows where rows 5-9 copy row 3, 40-47 copy row 2, and rows
    20-23 are zero."""
    x = rng.uniform(-1, 1, (n, dim)).astype(np.float32)
    x[5:10] = x[3]
    x[40:48] = x[2]
    x[20:24] = 0.0
    return x


def jax_neighbours(rows, k):
    return jgen._topk_neighbors_blocked(rows, k, block=256)


# ------------------------------------------------- the plain version vs JAX

# (N, D, k, kind): the phase-2 case list at CPU sizes
REF_CASES = [(1013, 36, 10, "uniform"), (40, 36, 10, "uniform"),
             (777, 7, 11, "uniform"), (500, 128, 32, "uniform"),
             (600, 64, 1, "uniform"), (900, 36, 10, "kaggle"),
             (300, 36, 11, "duplicates"), (129, 7, 32, "duplicates")]


@pytest.mark.parametrize("N,D,k,kind", REF_CASES)
def test_ref_equals_jax(rng, N, D, k, kind):
    rows = {"uniform": lambda: rng.uniform(-1, 1, (N, D)).astype(np.float32),
            "kaggle": lambda: kaggle_rows(rng, N, D),
            "duplicates": lambda: with_duplicates(rng, N, D)}[kind]()
    want = jax_neighbours(rows, k)
    x = torch.from_numpy(rows)
    got = knn_topk_ref(x, torch.arange(N), x, k).numpy()
    np.testing.assert_array_equal(got, want)
    # queries from mid-table, with their ids, through the wrapper
    a, b = N // 3, N // 3 + min(N // 2, 97)
    ids = torch.arange(a, b)
    np.testing.assert_array_equal(knn_topk(x[a:b], ids, x, k).numpy(),
                                  want[a:b])
    # and through the tool's knn_neighbours, ids in any order
    perm = torch.from_numpy(rng.permutation(N)[:50])
    np.testing.assert_array_equal(pgen.knn_neighbours(x, perm, k, 16),
                                  want[perm.numpy()])
    if kind == "duplicates":
        # a copy's nearest rows are its copies, in id order
        assert list(want[5][:4]) == [3, 6, 7, 8]
        assert list(want[40][:7]) == [2, 41, 42, 43, 44, 45, 46]


@pytest.mark.parametrize("D,k", [(7, 1), (36, 10), (128, 32)])
def test_ref_without_self_equals_jax_block(rng, D, k):
    """ids of -1: nothing is masked; JAX's block arithmetic without the
    mask (gen_altkeys.py:38-39, then lax.top_k)."""
    import jax
    keys = rng.normal(size=(700, D)).astype(np.float32)
    q = rng.normal(size=(33, D)).astype(np.float32)
    kj, qj = jnp.asarray(keys), jnp.asarray(q)
    d = jnp.sum(qj * qj, axis=1)[:, None] + jnp.sum(kj * kj, axis=1)[
        None, :] - 2.0 * jnp.dot(qj, kj.T, preferred_element_type=jnp.float32)
    want = np.asarray(jax.lax.top_k(-d, k)[1])
    got = knn_topk(torch.from_numpy(q), torch.full((33,), -1),
                   torch.from_numpy(keys), k)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------ the wrapper's checks

def _meta(*shape, dtype=torch.float32):
    return torch.zeros(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("args,err,match", [
    ((_meta(4, 36), _meta(4, dtype=torch.int64), _meta(100, 36), 33),
     ValueError, "k <= 32"),
    ((_meta(4, 129), _meta(4, dtype=torch.int64), _meta(100, 129), 10),
     ValueError, "D <= 128"),
    ((_meta(4, 36, dtype=torch.float64), _meta(4, dtype=torch.int64),
      _meta(100, 36), 10), TypeError, "float32 queries"),
    ((_meta(4, 36), _meta(4, dtype=torch.int32), _meta(100, 36), 10),
     TypeError, "int64 query_ids"),
    ((_meta(36, 4).t(), _meta(4, dtype=torch.int64), _meta(100, 36), 10),
     ValueError, "contiguous queries"),
    ((_meta(4, 36), _meta(4, dtype=torch.int64), _meta(36, 100).t(), 10),
     ValueError, "contiguous keys"),
    ((_meta(4, 36), _meta(4, dtype=torch.int64), _meta(100, 35), 10),
     ValueError, r"\[N, D\]"),
    ((_meta(4, 36), _meta(5, dtype=torch.int64), _meta(100, 36), 10),
     ValueError, r"query_ids \[4\]"),
    ((_meta(4, 36), _meta(4, dtype=torch.int64), _meta(10, 36), 10),
     ValueError, "k < N"),
    ((_meta(4, 36), _meta(4, dtype=torch.int64), _meta(100, 36), 10),
     ValueError, "CUDA device"),
])
def test_wrapper_refuses_what_k7_does_not_take(args, err, match):
    with pytest.raises(err, match=match):
        knn_topk(*args)


def test_wrapper_refuses_mixed_devices():
    with pytest.raises(ValueError, match="CUDA device"):
        knn_topk(torch.zeros(4, 36), torch.zeros(4, dtype=torch.int64),
                 _meta(100, 36), 10)


# ------------------------------------------------------------ the geometry

def test_geometry_fits_and_covers():
    for D in range(1, 129):
        ks = knn_ks(D)
        assert 8 * ks >= D + 4 and ks in (2, 5, 8, 17)
        for k in (1, 10, 11, 32):
            for exact in (False, True):
                g = knn_geometry(D, k, exact)
                assert g.smem <= cuda_knn.SMEM_LIMIT, (D, k, g)
                assert g.merge_smem <= cuda_knn.SMEM_LIMIT
                assert g.sk % 16 == 8 and g.sk >= 8 * ks
                assert g.list_len == (k if exact else k + KNN_EXTRA)
    g = knn_geometry(36, 10)
    assert (g.ks, g.mt, g.qb, g.sk, g.stages) == (5, 2, 256, 40, 4)
    assert g.list_len == 26
    # the tool's block of query rows fills about 4 waves of 132 SMs
    assert pgen.CARD_BLOCK // g.qb == 512
    g = knn_geometry(128, 32)
    assert (g.ks, g.mt, g.qb, g.sk, g.stages) == (17, 1, 128, 136, 2)


# ------------------------------------------------------ K7's rule, emulated

F64 = np.float64


def fma32(a, b, c):
    """float32 a * b + c, one rounding (the float64 product is exact)."""
    return (np.asarray(a, F64) * np.asarray(b, F64)
            + np.asarray(c, F64)).astype(np.float32)


def tf32_trunc(a):
    return (np.asarray(a, np.float32).view(np.uint32)
            & np.uint32(0xffffe000)).view(np.float32)


def tf32_rna(a):
    b = np.asarray(a, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


def sq_sum(x):
    s = np.zeros(x.shape[:-1], np.float32)
    for i in range(x.shape[-1]):
        s = fma32(x[..., i], x[..., i], s)
    return s


def exact32(q, x):
    """The kernel's exact distance, [Q, N]: sum of (q_i - x_i)^2 in index
    order by float32 fused multiply-adds."""
    s = np.zeros((len(q), len(x)), np.float32)
    for i in range(q.shape[1]):
        d = q[:, None, i] - x[None, :, i]
        s = fma32(d, d, s)
    return s


def lower_bounds(q, x, adversarial=False):
    """K7's LB, [Q, N]: knn_prep's aux, the query side of the padded dims,
    the tensor core as TF32-truncated inputs with exact products summed in
    float64 and rounded once (adversarial: less gamma times the terms'
    magnitudes, the accumulation error that raises LB most)."""
    D = q.shape[1]
    c1, c2 = knn_bound_constants(D)
    sq = sq_sum(x)
    v = np.float32(-0.5 * (1 - c2)) * sq
    hi = tf32_rna(v)
    lo = v - hi
    a3 = np.float32(0.5 * c1) * np.sqrt(sq)
    sqq = sq_sum(q)
    A = np.float32(1 - c2) * sqq
    nq = tf32_rna(np.sqrt(sqq))
    qt, xt = tf32_rna(q).astype(F64), tf32_trunc(x).astype(F64)
    terms = [qt @ xt.T, np.broadcast_to(hi.astype(F64), (len(q), len(x))),
             np.broadcast_to(tf32_trunc(lo).astype(F64), (len(q), len(x))),
             nq.astype(F64)[:, None] * tf32_trunc(a3).astype(F64)[None, :]]
    acc = sum(terms)
    if adversarial:
        gamma = 9 * (knn_ks(D) + 1) * 2.0 ** -23
        mag = np.abs(qt) @ np.abs(xt).T + sum(np.abs(t) for t in terms[1:])
        acc = acc - gamma * mag
    return fma32(-2.0, acc.astype(np.float32), A[:, None])


def emulate_k7(q, qids, x, k):
    """-> (top k ids [Q, k], certified [Q]): pass 1 keeps the k + m
    smallest (LB, key), self excluded; pass 2 ranks them by (exact, key)
    and certifies; a failing row is swept exactly."""
    Q, N = len(q), len(x)
    L = k + KNN_EXTRA
    lb, ex = lower_bounds(q, x), exact32(q, x)
    sqq = sq_sum(q)
    out = np.empty((Q, k), np.int64)
    cert = np.zeros(Q, bool)
    keys = np.arange(N)
    for r in range(Q):
        ids = keys[keys != qids[r]]
        order = ids[np.lexsort((ids, lb[r, ids]))]
        cand = order[:L]
        top = cand[np.lexsort((cand, ex[r, cand]))][:k]
        dk = ex[r, top[-1]]
        # a list that is not full holds every key: certified
        m = lb[r, order[L - 1]] if len(order) >= L else None
        cert[r] = m is None or \
            m - np.float32(KNN_MARGIN) * (sqq[r] + abs(m)) > dk
        if not cert[r]:
            ids = keys[keys != qids[r]]
            top = ids[np.lexsort((ids, ex[r, ids]))][:k]
        out[r] = top
    return out, cert


def hold_by_rule(rows, qids, got, ref_k1, k):
    """The correctness rule: neighbour sets equal on rows whose k-th and
    k+1-th float64 distances (of the reference's neighbours) differ by more
    than 1e-5 relative; the nearest equal where the 1st and 2nd do.
    -> (rows checked for the sets, for the nearest)."""
    r64 = rows.astype(F64)
    q64 = r64[qids]

    def dist(j):
        return ((q64 - r64[ref_k1[:, j]]) ** 2).sum(1)

    dk, dk1, d1, d2 = dist(k - 1), dist(k), dist(0), dist(1)
    sep, sep1 = dk1 - dk > 1e-5 * dk, d2 - d1 > 1e-5 * d1
    for i in np.flatnonzero(sep):
        assert set(got[i]) == set(ref_k1[i, :k]), i
    for i in np.flatnonzero(sep1):
        assert got[i, 0] == ref_k1[i, 0], i
    return int(sep.sum()), int(sep1.sum())


@pytest.mark.parametrize("kind,D,k,N", [
    ("uniform", 36, 10, 1500), ("kaggle", 36, 10, 1500), ("kaggle", 7, 1, 900),
    ("duplicates", 36, 11, 1500), ("uniform", 128, 32, 700)])
def test_emulated_k7_holds_to_jax(rng, kind, D, k, N):
    rows = {"uniform": lambda: rng.normal(size=(N, D)).astype(np.float32),
            "kaggle": lambda: kaggle_rows(rng, N, D),
            "duplicates": lambda: with_duplicates(rng, N, D)}[kind]()
    qids = np.concatenate([np.arange(0, 60), rng.choice(N, 60, False)])
    ref = jax_neighbours(rows, k + 1)[qids]
    got, cert = emulate_k7(rows[qids], qids, rows, k)
    n_sep, n_sep1 = hold_by_rule(rows, qids, got, ref, k)
    assert n_sep > len(qids) // 2 and n_sep1 > len(qids) // 2
    assert cert.mean() > 0.9


def near_ties(rng, n_q, D, k):
    """Queries each with a private cluster: k keys at squared distance
    about 1 (spread 1e-7 relative), then 2 k + KNN_EXTRA keys from 1 + 2e-5
    (spread 1e-7), all inside TF32's band; the rest far.  The k-th and
    k+1-th distances stay separated by about 2e-5 relative."""
    q = rng.normal(size=(n_q, D))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    per = 3 * k + KNN_EXTRA
    keys = []
    for i in range(n_q):
        u = rng.normal(size=(per, D))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        r2 = np.where(np.arange(per) < k, 1.0, 1.0 + 2e-5) \
            + 1e-7 * rng.random(per)
        keys.append(q[i] + np.sqrt(r2)[:, None] * u)
    far = 3.0 + rng.normal(size=(300, D))
    x = np.concatenate(keys + [far]).astype(np.float32)
    return q.astype(np.float32), x


def test_emulated_k7_fails_certificate_on_near_ties_and_sweeps(rng):
    D, k = 36, 10
    q, x = near_ties(rng, 8, D, k)
    qids = np.full(len(q), -1)
    got, cert = emulate_k7(q, qids, x, k)
    assert not cert.any()           # every row handed to the sweep
    ex = exact32(q, x)
    lb = lower_bounds(q, x)
    for r in range(len(q)):
        # the sweep's answer: the k smallest exact distances, ties by id
        ids = np.arange(len(x))
        want = ids[np.lexsort((ids, ex[r]))][:k]
        np.testing.assert_array_equal(got[r], want)
        # the (k + m)-th lower bound lies under the k-th exact distance
        assert np.sort(lb[r])[k + KNN_EXTRA - 1] < ex[r, want[-1]]
    # the plain version agrees by the rule, on rows it can check
    xt = torch.from_numpy(x)
    allq = np.concatenate([x, q])
    ref = knn_topk_ref(torch.from_numpy(q), torch.full((len(q),), -1), xt,
                       k + 1).numpy()
    n_sep, _ = hold_by_rule(allq, np.arange(len(x), len(allq)), got, ref, k)
    assert n_sep == len(q)


@pytest.mark.parametrize("table", range(len(KAGGLE_SIZES)))
def test_lower_bound_holds_at_each_kaggle_scale(rng, table):
    """Rows of table `table`'s init scale against rows of every scale, and
    rows whose every float loses the most to truncation (low 13 bits
    set), the query parallel to the key: LB <= the float32 exact distance
    and <= float64's, under the adversarial accumulation, and within
    2 (c1 |q||x| + c2 (|q|^2 + |x|^2)) of float64's."""
    D = 36
    c1, c2 = knn_bound_constants(D)
    q = kaggle_rows(rng, 24, D, [table])
    x = np.concatenate([kaggle_rows(rng, 26 * 8, D), q[:4]])
    worst = (np.abs(q[:8]).view(np.uint32) | np.uint32(0x1fff)).view(
        np.float32) * np.sign(q[:8])
    q = np.concatenate([q, worst])
    x = np.concatenate([x, worst, worst * np.float32(0.37)])
    ex = exact32(q, x)
    d64 = ((q.astype(F64)[:, None] - x.astype(F64)[None]) ** 2).sum(-1)
    nq = np.linalg.norm(q.astype(F64), axis=1)[:, None]
    nx = np.linalg.norm(x.astype(F64), axis=1)[None, :]
    e = c1 * nq * nx + c2 * (nq ** 2 + nx ** 2)
    for adversarial in (False, True):
        lb = lower_bounds(q, x, adversarial).astype(F64)
        assert (lb <= ex).all()
        assert (lb <= d64).all()
        assert (d64 - lb <= 2 * e + 1e-30).all()


# ----------------------------------------- the tool's alt keys of some rows

@pytest.mark.parametrize("with_freq", [False, True])
def test_pick_altkeys_of_some_rows_equals_jax(rng, with_freq):
    """`knn_neighbours` of some rows, then `pick_altkeys`: the JAX tool's
    alt keys of those rows (as chip_smoke.py's phase 3c builds C3's)."""
    sizes = [40, 3, 111, 57]
    tables = [kaggle_rows(rng, n, 36, [t]) for t, n in enumerate(sizes)]
    freq = [rng.integers(0, 5, n).astype(np.float64) for n in sizes] \
        if with_freq else None
    want = np.concatenate(jgen.generate_altkeys(tables, workload_freq=freq,
                                                n_neighbors=10))
    x = torch.from_numpy(np.concatenate(tables))
    qids = np.sort(rng.choice(sum(sizes), 70, replace=False))
    neigh = pgen.knn_neighbours(x, torch.from_numpy(qids), 10, 16)
    got = pgen.pick_altkeys(neigh, sizes, None if freq is None
                            else np.concatenate(freq))
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want[qids])


def test_altkey_rows_inverts_the_encoding(rng):
    sizes = [40, 3, 111]
    tables = [rng.normal(size=(n, 8)).astype(np.float32) for n in sizes]
    alts = np.concatenate(jgen.generate_altkeys(tables, n_neighbors=2))
    nearest = jgen._topk_neighbors_blocked(np.concatenate(tables), 2)[:, 0]
    np.testing.assert_array_equal(pgen.altkey_rows(alts, sizes), nearest)
    # table 0 (key % 100 == 0), a table past the last, a row past its table
    bad = np.asarray([100 * 5, 4 + 100 * 1, 2 + 100 * 3, 3 + 100 * 111],
                     np.uint32)
    np.testing.assert_array_equal(pgen.altkey_rows(bad, sizes),
                                  [-1, -1, -1, -1])
    np.testing.assert_array_equal(
        pgen.altkey_rows(np.asarray([2 + 100 * 2, 3 + 100 * 110], np.uint32),
                         sizes), [42, 153])


def test_alt_keys_round_trip_at_the_mlperf_cap():
    """The MLPerf recipe's tables, capped at 40M rows (204,184,588 rows):
    the first and last row of every table keep their alt key through
    `pick_altkeys` and `altkey_encode`, and `altkey_rows` reads them back
    (the largest key, table 22's row 39,999,999, is 3,999,999,922)."""
    from evstore_tpu_torch.cache.tiers import altkey_encode
    from evstore_tpu_torch.config import mlperf_dlrm_config
    sizes = np.asarray(mlperf_dlrm_config().table_sizes, np.int64)
    assert sizes.max() == 40_000_000 and sizes.sum() == 204_184_588
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    rows = np.stack([offsets[:-1], offsets[1:] - 1], axis=1).reshape(-1)
    alts = pgen.pick_altkeys(rows[:, None], sizes)
    np.testing.assert_array_equal(pgen.altkey_rows(alts, sizes), rows)
    enc = np.concatenate([altkey_encode(t, np.asarray([0, n - 1]))
                          for t, n in enumerate(sizes)]).astype(np.uint32)
    np.testing.assert_array_equal(enc, alts)
    assert int(alts.max()) == 3_999_999_922 == 22 + 100 * 39_999_999


@pytest.mark.parametrize("via", ["altkey_encode", "pick_altkeys"])
def test_a_row_whose_alt_key_wraps_raises(via):
    """(t + 1) + 100 row wraps a uint32 from row 42,949,672 on: both
    encoders raise there, where the JAX package wraps silently, and take
    the row before it."""
    from evstore_tpu_torch.cache.tiers import ALTKEY_ROW_LIMIT, altkey_encode
    assert ALTKEY_ROW_LIMIT == 42_949_672
    sizes = [3, 50_000_000]
    if via == "altkey_encode":
        def enc(r):
            return np.asarray(altkey_encode(1, r), np.int64)
    else:
        def enc(r):
            return pgen.pick_altkeys(np.asarray([[3 + r]]), sizes)[0]
    last = ALTKEY_ROW_LIMIT - 1
    assert int(enc(last)) == 2 + 100 * last < 2 ** 32
    assert pgen.altkey_rows(np.asarray([enc(last)], np.uint32),
                            sizes)[0] == 3 + last
    for r in (ALTKEY_ROW_LIMIT, 49_999_999):
        with pytest.raises(ValueError, match="wraps a uint32"):
            enc(r)
    if via == "altkey_encode":
        with pytest.raises(ValueError, match="wraps a uint32"):
            altkey_encode(0, np.asarray([5, ALTKEY_ROW_LIMIT]))
