"""The port's row gathers (kernel wrappers on CPU tensors, plain versions,
plain-table lookup) against the JAX package's, and the kernel build
module's host-side logic.

The JAX side runs the Pallas kernels `gather_rows` and
`gather_rows_dequant_int8` in interpret mode.  On CPU tensors the port's
wrappers take their plain versions; the CUDA kernels are held to those on
the card by chip_smoke.py.

Tolerances: none for the float gather, whose rows are moved as bytes.  The
int8 gather+dequant is bit for bit the codec's formula (v / 254) * 2 - 1 in
numpy over all 256 codes, and within 1.2e-7 (one f32 ulp near 1) of the
JAX functions: jitted JAX contracts the formula into fma(v, 2/254, -1),
which differs on 130 of the 256 codes by at most 5.96e-8.

Ids outside [0, N) on device tensors give a zero row in the port (its
kernels and plain versions alike), a deliberate departure from the JAX
package, whose `take_rows` clips them; ids still on the host raise (see
tests/test_torch_native_device_cache.py and test_torch_train.py).
"""

import ctypes
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evstore_tpu.config import tiny_dlrm_config as jax_tiny
from evstore_tpu.models import embedding as jax_emb
from evstore_tpu.ops.pallas_gather import gather_rows as jax_gather_rows
from evstore_tpu.ops.pallas_gather import gather_rows_dequant_int8 as \
    jax_gather_dequant
from evstore_tpu.ops.pallas_gather import gather_rows_dequant_int8_ref as \
    jax_gather_dequant_ref
from evstore_tpu.ops.quant import np_quantize_int8 as jax_np_quantize_int8
from evstore_tpu_torch import _build
from evstore_tpu_torch.config import tiny_dlrm_config
from evstore_tpu_torch.models import embedding as port_emb
from evstore_tpu_torch.ops import cuda_gather as cg
from evstore_tpu_torch.ops.cuda_gather import (gather_rows,
                                               gather_rows_dequant_int8,
                                               gather_rows_dequant_int8_ref,
                                               gather_rows_grouped,
                                               gather_rows_grouped_ref,
                                               gather_rows_ref)
from evstore_tpu_torch.ops.quant import dequantize_int8, np_quantize_int8

INT8_ATOL = 1.2e-7

JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _bits(a) -> np.ndarray:
    """Raw bit patterns of a JAX array or torch tensor (f32 or bf16)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16 if a.element_size() == 2
                                   else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [4, 36])
def test_gather_rows_matches_pallas_gather(dtype, D):
    rng = np.random.default_rng(D)
    table = rng.normal(size=(300, D)).astype(np.float32)
    idx = rng.integers(0, 300, 64).astype(np.int32)
    idx[10:20] = idx[3]                      # repeated indices
    idx[-1] = 299
    ref = jax_gather_rows(jnp.asarray(table, JAX_DT[dtype]),
                          jnp.asarray(idx), tile_b=16, interpret=True)
    tt = torch.from_numpy(table).to(TORCH_DT[dtype])
    got = gather_rows(tt, torch.from_numpy(idx))
    assert got.shape == (64, D) and got.dtype == TORCH_DT[dtype]
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("shape", [(40,), (8, 26)])
def test_two_source_gather_matches_take_over_concat(shape):
    """An index < C reads the primary, C + m reads secondary row m."""
    rng = np.random.default_rng(1)
    C, M, D = 50, 16, 36
    primary = rng.normal(size=(C, D)).astype(np.float32)
    secondary = rng.normal(size=(M, D)).astype(np.float32)
    idx = rng.integers(0, C + M, shape).astype(np.int32)
    idx.flat[0] = C                          # first buffer row
    idx.flat[-1] = C + M - 1                 # last buffer row
    idx.flat[1] = idx.flat[2]                # a repeat
    ref = jnp.take(jnp.concatenate([jnp.asarray(primary),
                                    jnp.asarray(secondary)]),
                   jnp.asarray(idx), axis=0)
    got = gather_rows(torch.from_numpy(primary), torch.from_numpy(idx),
                      secondary=torch.from_numpy(secondary))
    assert got.shape == (*shape, D)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    np.testing.assert_array_equal(
        got.numpy(), gather_rows_ref(torch.from_numpy(primary),
                                     torch.from_numpy(idx),
                                     torch.from_numpy(secondary)).numpy())


@pytest.mark.parametrize("use_kernel", [True, False])
def test_sparse_arch_lookup_matches_jax(use_kernel):
    """Plain-table lookup: the JAX package's one-hot matmul (tiny tables)
    and take paths are bit-identical to a row copy."""
    cfg_j = jax_tiny()
    cfg_p = tiny_dlrm_config(use_gather_kernel=use_kernel)
    rng = np.random.default_rng(2)
    tables = [rng.normal(size=(n, cfg_p.embedding_dim)).astype(np.float32)
              for n in cfg_p.table_sizes]
    idx = np.stack([rng.integers(0, n, 12) for n in cfg_p.table_sizes],
                   axis=1).astype(np.int32)
    ref = jax_emb.sparse_arch_lookup(
        {f"table_{t}": {"kind_plain": jnp.asarray(tab)}
         for t, tab in enumerate(tables)}, jnp.asarray(idx), cfg_j)
    got = port_emb.sparse_arch_lookup([torch.from_numpy(t) for t in tables],
                                      torch.from_numpy(idx), cfg_p)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [8, 36])
def test_grouped_gather_matches_per_table_and_jax(dtype, D):
    """The grouped gather's plain version (the wrapper on CPU tensors) is
    the per-table plain gather, stacked, bit for bit; for in-range ids it
    is JAX's `take_rows` of each table.  An id of table t that is valid in
    table t+1 but not in t gives a zero row."""
    rng = np.random.default_rng(D)
    sizes = (50, 3000, 7, 1200, 64, 2048)
    tables = [rng.normal(size=(n, D)).astype(np.float32) for n in sizes]
    idx = np.stack([rng.integers(0, n, 40) for n in sizes],
                   axis=1).astype(np.int32)
    idx[3] = idx[4]                                    # a repeated sample
    idx[5, 0] = 1000                                   # valid in table 1
    idx[6, 2] = 60                                     # valid in table 3
    idx[7, 4] = -1
    ok = (idx >= 0) & (idx < np.asarray(sizes))
    tt = [torch.from_numpy(t).to(TORCH_DT[dtype]) for t in tables]
    got = gather_rows_grouped(tt, torch.from_numpy(idx))
    assert got.shape == (40, len(sizes), D) and got.dtype == TORCH_DT[dtype]
    per_table = torch.stack([gather_rows_ref(tab, torch.from_numpy(
        np.ascontiguousarray(idx[:, t]))) for t, tab in enumerate(tt)], 1)
    np.testing.assert_array_equal(_bits(got), _bits(per_table))
    np.testing.assert_array_equal(_bits(got), _bits(gather_rows_grouped_ref(
        tt, torch.from_numpy(idx))))
    assert not got.float().numpy()[~ok].any()
    for t, tab in enumerate(tables):
        rows = np.flatnonzero(ok[:, t])
        ref = jax_emb.take_rows(jnp.asarray(tab, JAX_DT[dtype]),
                                jnp.asarray(idx[rows, t]))
        np.testing.assert_array_equal(_bits(got[rows, t]), _bits(ref))


def test_grouped_gather_wrapper_refuses_what_it_cannot_take():
    meta = dict(device="meta")
    idx = torch.zeros(3, 2, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="CUDA device"):
        gather_rows_grouped([torch.zeros(4, 8, **meta)] * 2, idx)
    with pytest.raises(ValueError, match="one width"):
        gather_rows_grouped([torch.zeros(4, 8, **meta),
                             torch.zeros(4, 6, **meta)], idx)
    with pytest.raises(TypeError, match="one type"):
        gather_rows_grouped([torch.zeros(4, 8, **meta),
                             torch.zeros(4, 8, dtype=torch.bfloat16, **meta)],
                            idx)
    with pytest.raises(ValueError, match="at least one table"):
        gather_rows_grouped([], idx)


def test_init_embedding_tables_law():
    sizes = (4, 100, 2500)
    tabs = port_emb.init_embedding_tables(sizes, 8,
                                          np.random.default_rng(0))
    for n, t in zip(sizes, tabs):
        assert t.shape == (n, 8) and t.dtype == np.float32
        assert np.abs(t).max() <= np.sqrt(1.0 / n)
    # U(-b, b): mean 0, variance b^2/3 on the largest table
    b = np.sqrt(1.0 / 2500)
    assert abs(tabs[2].mean()) < 0.02 * b
    assert abs(tabs[2].var() / (b * b / 3) - 1) < 0.02


def test_gather_wrapper_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="CUDA device"):
        gather_rows(torch.zeros(4, 8, device="meta"),
                    torch.zeros(3, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        gather_rows(torch.zeros(4, 8), torch.zeros(3, dtype=torch.int32),
                    secondary=torch.zeros(2, 8, device="meta"))


def test_dequant_wrapper_refuses_what_it_cannot_take():
    u8 = dict(dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA device"):
        gather_rows_dequant_int8(
            torch.zeros(4, 8, device="meta", **u8),
            torch.zeros(3, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        gather_rows_dequant_int8(
            torch.zeros(4, 8, **u8), torch.zeros(3, dtype=torch.int32),
            torch.zeros(2, 8, device="meta", **u8))


def _codes(rng, shape):
    return rng.integers(0, 256, shape).astype(np.uint8)


def test_dequant_is_the_codec_formula_on_every_code():
    """Bit for bit (v / 254) * 2 - 1 in numpy float32, on all 256 codes,
    through the plain decoder and the gather's plain version."""
    v = np.arange(256, dtype=np.uint8)
    ref = (v.astype(np.float32) / np.float32(254)) * np.float32(2) \
        - np.float32(1)
    got = dequantize_int8(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    table = torch.from_numpy(v.reshape(64, 4))
    rows = gather_rows_dequant_int8(table, torch.arange(64,
                                                        dtype=torch.int32))
    np.testing.assert_array_equal(rows.numpy().reshape(-1).view(np.int32),
                                  ref.view(np.int32))
    # jitted JAX contracts the formula: within one ulp, not equal
    jax_rows = np.asarray(jax_gather_dequant_ref(jnp.asarray(v[:, None]),
                                                 jnp.arange(256)))[:, 0]
    np.testing.assert_allclose(jax_rows, ref, rtol=0, atol=INT8_ATOL)


@pytest.mark.parametrize("D", [4, 36, 512])
def test_gather_dequant_matches_jax(D):
    """The Pallas kernel in interpret mode (D % 4 == 0 there) and the JAX
    plain version, on the same uint8 rows and indices."""
    rng = np.random.default_rng(D)
    table = _codes(rng, (300, D))
    idx = rng.integers(0, 300, 64).astype(np.int32)
    idx[10:20] = idx[3]
    idx[-1] = 299
    got = gather_rows_dequant_int8(torch.from_numpy(table),
                                   torch.from_numpy(idx)).numpy()
    assert got.shape == (64, D) and got.dtype == np.float32
    for ref in (jax_gather_dequant(jnp.asarray(table), jnp.asarray(idx),
                                   tile_b=16, interpret=True),
                jax_gather_dequant_ref(jnp.asarray(table),
                                       jnp.asarray(idx))):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0,
                                   atol=INT8_ATOL)


@pytest.mark.parametrize("shape,D", [((40,), 36), ((8, 26), 36),
                                     ((8, 26), 7)])
def test_two_source_gather_dequant_matches_take_over_concat(shape, D):
    """Cache codes and a miss buffer of codes: an index < C reads the cache,
    C + m buffer row m; any D (7 takes the kernel's byte path)."""
    rng = np.random.default_rng(2)
    C, M = 50, 16
    cache, buf = _codes(rng, (C, D)), _codes(rng, (M, D))
    idx = rng.integers(0, C + M, shape).astype(np.int32)
    idx.flat[0], idx.flat[-1] = C, C + M - 1
    ref = dequantize_int8(torch.from_numpy(
        np.concatenate([cache, buf])[idx])).numpy()
    got = gather_rows_dequant_int8(torch.from_numpy(cache),
                                   torch.from_numpy(idx),
                                   torch.from_numpy(buf))
    assert got.shape == (*shape, D)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        got.numpy(), gather_rows_dequant_int8_ref(
            torch.from_numpy(cache), torch.from_numpy(idx),
            torch.from_numpy(buf)).numpy())


@pytest.mark.parametrize("d", [1, 2, 3, 7, 9, 16, 36, 1000003, 2 ** 31 - 1,
                               2 ** 31, 2 ** 31 + 1, 2 ** 32 - 1])
def test_dequant_magic_divider_is_division(d):
    """K3's unit -> row map: a multiply-high, an add and a shift equal
    n // d for n < 2^32, at the edges (0, 2^32 - 1, multiples of d and one
    below them) and at random n; the multiplier fits 32 bits."""
    magic, shift = cg.magic_divider(d)
    assert 0 < magic < 2 ** 32 and 0 <= shift <= 32
    rng = np.random.default_rng(d % 1000)
    k = np.arange(1, 2000, dtype=np.uint64)
    n = np.concatenate([
        rng.integers(0, 2 ** 32, 50000, dtype=np.uint64),
        np.arange(4000, dtype=np.uint64),
        np.uint64(2 ** 32 - 1) - np.arange(4000, dtype=np.uint64),
        (k * np.uint64(d)) % np.uint64(2 ** 32),
        (k * np.uint64(d) - np.uint64(1)) % np.uint64(2 ** 32)])
    np.testing.assert_array_equal(
        cg.magic_div(n, np.uint64(magic), np.uint64(shift)),
        n // np.uint64(d))


def _dequant_units(R, D, words, grid):
    """The units K3's grid visits, as its loops walk them: block b, thread
    t, unit j and pass k give u = b T U + t + j T + k (grid T U), kept
    while u0 = b T U + t + k (grid T U) and u stay below the total."""
    T, U = cg.DEQUANT_THREADS, cg.DEQUANT_UNITS
    total = R * cg.dequant_units_per_row(D, words)
    step = grid * T * U
    base = (np.arange(grid)[:, None] * T * U + np.arange(T)[None, :]).ravel()
    units = []
    for k in range(-(-total // step)):
        u0 = base + k * step
        u0 = u0[u0 < total]
        for j in range(U):
            u = u0 + j * T
            units.append(u[u < total])
    return np.concatenate(units).astype(np.uint64), total


@pytest.mark.parametrize("R", [1, 3, 255, 1025, 4097])
@pytest.mark.parametrize("D,words", [(4, True), (8, True), (36, True),
                                     (64, True), (7, False), (36, False),
                                     (4, False)])
@pytest.mark.parametrize("grid", [1, 3, 1056])
def test_dequant_unit_plan_writes_each_unit_once(R, D, words, grid):
    """K3's plan writes each (row, word), or (row, code) on the byte path,
    exactly once, for R that no thread's units divide, at any grid; the
    magic divisor gives each unit its row."""
    u, total = _dequant_units(R, D, words, grid)
    assert np.array_equal(np.sort(u), np.arange(total, dtype=np.uint64))
    nu = cg.dequant_units_per_row(D, words)
    magic, shift = cg.magic_divider(nu)
    r = cg.magic_div(u, np.uint64(magic), np.uint64(shift))
    w = u - r * np.uint64(nu)
    assert r.max() < R and w.max() < nu
    seen = np.zeros((R, nu), np.int64)
    np.add.at(seen, (r.astype(np.int64), w.astype(np.int64)), 1)
    assert np.all(seen == 1)


def _emulate_dequant(primary, idx, secondary, words, grid):
    """K3's work split in numpy: a 256-entry table of the codec's formula;
    each unit reads idx of its row, then its word (4 codes, little-endian)
    or code of that row's source, and writes table entries, or zeros for an
    index outside [0, C + M)."""
    C, D = primary.shape
    M = 0 if secondary is None else len(secondary)
    src = primary if secondary is None else np.concatenate([primary,
                                                            secondary])
    lut = (np.arange(256, dtype=np.float32) / np.float32(254)) \
        * np.float32(2) - np.float32(1)
    R = idx.size
    nu = cg.dequant_units_per_row(D, words)
    per = D // nu
    u, _ = _dequant_units(R, D, words, grid)
    magic, shift = cg.magic_divider(nu)
    r = cg.magic_div(u, np.uint64(magic), np.uint64(shift)).astype(np.int64)
    w = u.astype(np.int64) - r * nu
    k = idx.reshape(-1)[r].astype(np.int64)
    hit = (k >= 0) & (k < C + M)
    out = np.full((R, D), np.nan, np.float32)
    for e in range(per):
        codes = src[np.where(hit, k, 0), w * per + e]
        out[r, w * per + e] = np.where(hit, lut[codes], np.float32(0))
    return out.reshape(*idx.shape, D)


@pytest.mark.parametrize("R", [1, 3, 1025])
@pytest.mark.parametrize("D,words", [(4, True), (8, True), (36, True),
                                     (64, True), (7, False), (36, False)])
@pytest.mark.parametrize("two_sources", [True, False])
def test_dequant_work_split_matches_plain(R, D, words, two_sources):
    """The emulated K3 against the plain version, bit for bit: cache and
    buffer rows, indices at C - 1, C, C + M - 1 and C + M, negative ones,
    and no secondary."""
    rng = np.random.default_rng(R * D)
    C, M = 37, (5 if two_sources else 0)
    cache = _codes(rng, (C, D))
    buf = _codes(rng, (M, D)) if two_sources else None
    idx = rng.integers(-3, C + M + 3, R).astype(np.int32)
    edges = np.asarray([C - 1, C, C + M - 1, C + M, -1, 2 ** 31 - 1],
                       np.int32)
    idx[:min(R, len(edges))] = edges[:min(R, len(edges))]
    ref = gather_rows_dequant_int8_ref(
        torch.from_numpy(cache), torch.from_numpy(idx),
        None if buf is None else torch.from_numpy(buf)).numpy()
    for grid in (1, 5):
        got = _emulate_dequant(cache, idx, buf, words, grid)
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_dequant_every_index_out_of_range_gives_zeros():
    """All indices outside [0, C + M): the emulated K3, the plain version
    and the wrapper on CPU tensors give zero rows (not code 0's -1.0)."""
    rng = np.random.default_rng(9)
    cache, buf = _codes(rng, (10, 36)), _codes(rng, (4, 36))
    idx = np.asarray([-2 ** 31, -1, 14, 15, 2 ** 31 - 1] * 7, np.int32)
    got = _emulate_dequant(cache, idx, buf, True, 2)
    assert got.shape == (35, 36) and not got.any()
    wrapped = gather_rows_dequant_int8(torch.from_numpy(cache),
                                       torch.from_numpy(idx),
                                       torch.from_numpy(buf)).numpy()
    np.testing.assert_array_equal(wrapped.view(np.int32),
                                  got.view(np.int32))


def test_quantizer_matches_jax():
    """numpy's round (half to even) on the host, as the JAX package has it,
    including the values that fall exactly between two codes."""
    x = np.concatenate([np.linspace(-1.2, 1.2, 4001, dtype=np.float32),
                        (np.arange(255, dtype=np.float32) + 0.5) / 127 - 1])
    np.testing.assert_array_equal(np_quantize_int8(x),
                                  jax_np_quantize_int8(x))


def test_ids_outside_the_sources_give_zero_rows():
    """The port's rule on device tensors: a zero row, in the float gather
    and the int8 gather (not the -1.0 that code 0 decodes to).  The JAX
    package's `take_rows` agrees on a table of 2,048 rows or fewer (its
    one-hot lookup) and clips the ids to rows 0 and N-1 on a larger one."""
    rng = np.random.default_rng(3)
    for N in (30, 3000):
        table = rng.normal(size=(N, 8)).astype(np.float32)
        codes = _codes(rng, (N, 8))
        idx = np.asarray([-5, -1, 0, N - 1, N, N + 1, 2 ** 31 - 1], np.int32)
        ok = (idx >= 0) & (idx < N)
        got = gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
        np.testing.assert_array_equal(got.numpy()[~ok], 0.0)
        np.testing.assert_array_equal(got.numpy()[ok], table[idx[ok]])
        got8 = gather_rows_dequant_int8(torch.from_numpy(codes),
                                        torch.from_numpy(idx)).numpy()
        np.testing.assert_array_equal(got8[~ok], 0.0)
        two = gather_rows_dequant_int8(torch.from_numpy(codes[:20]),
                                       torch.from_numpy(idx),
                                       torch.from_numpy(codes[20:])).numpy()
        np.testing.assert_array_equal(two, got8)
        jax_rows = np.asarray(jax_emb.take_rows(jnp.asarray(table),
                                                jnp.asarray(idx)))
        np.testing.assert_array_equal(
            jax_rows[~ok], 0.0 if N <= 2048
            else table[np.clip(idx[~ok], 0, N - 1)])


def test_library_name_follows_the_sources():
    srcs = [os.path.basename(s) for s in _build.sources()]
    assert srcs == ["common.cuh", "dcn_cross.cu", "gather_rows.cu",
                    "gather_rows_dequant_int8.cu", "interaction_bwd.cu",
                    "interaction_fwd.cu", "interaction_gram.cu",
                    "knn_topk.cu", "row_update.cu"]
    path = _build.library_path()
    assert path == _build.library_path()
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path).startswith("libevstore_kernels-")
    assert set(_build.SIGNATURES) == {
        "interaction_fwd", "interaction_bwd", "interaction_gram",
        "gather_rows", "gather_rows_grouped", "gather_rows_dequant_int8",
        "scatter_sub_sorted", "knn_prep", "knn_candidates", "knn_merge",
        "dcn_cross_fwd", "dcn_cross_bwd"}
    # x, ly, pair table, out: four pointers, then B as a 64-bit int; then
    # T, D, P, is_bf16, samples a group, blocks, device as ints and the
    # stream
    assert _build.SIGNATURES["interaction_gram"] == (
        (ctypes.c_void_p,) * 4 + (ctypes.c_int64,) + (ctypes.c_int,) * 7
        + (ctypes.c_void_p,))
    # K7's bound terms and margin are floats: ctypes passes them as c_float
    assert _build.SIGNATURES["knn_prep"][3:5] == (ctypes.c_float,) * 2
    assert _build.SIGNATURES["knn_candidates"][9] == ctypes.c_float
    assert _build.SIGNATURES["knn_merge"][9] == ctypes.c_float
    assert "--use_fast_math" not in _build.NVCC_FLAGS


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_failed_launch_raises():
    _build.check(0, "k")
    with pytest.raises(RuntimeError, match="cudaError 9"):
        _build.check(9, "k")


def test_build_compiles_each_source_then_links(monkeypatch, tmp_path):
    """One nvcc per .cu with -c, then one link with -shared; the library
    lands under its hashed name with the compilers' report beside it.  A
    stand-in nvcc records its arguments and writes its -o file."""
    calls = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\necho "$@" >> ' + str(calls) + '\n'
                    'while [ "$1" != "-o" ]; do shift; done\n'
                    'echo built > "$2"\necho "ptxas info: 0 spills"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    path = _build.build()
    assert path == _build.library_path() and os.path.exists(path)
    lines = calls.read_text().splitlines()
    cus = [s for s in _build.sources() if s.endswith(".cu")]
    compiles = [ln for ln in lines if " -c " in ln]
    links = [ln for ln in lines if "-shared" in ln]
    assert len(compiles) == len(cus) == 8 and len(links) == 1
    assert sorted(ln.split()[-1] for ln in compiles) == sorted(cus)
    assert all("sm_90a" in ln for ln in lines)
    assert "0 spills" in open(path[:-3] + ".log").read()
    assert sorted(os.listdir(tmp_path / "out")) == sorted(
        [os.path.basename(path), os.path.basename(path)[:-3] + ".log"])
    assert _build.build() == path and len(calls.read_text().splitlines()) \
        == len(lines)                      # reused, not rebuilt
