"""The port's storage backends (`evstore_tpu_torch/cache/storage.py`)
against the JAX package's, on the CPU.

Tables of uniform values in [-1, 1] are made with numpy from a seed.  The
JAX package writes the per-table .bin files; both packages' stores then
read the same files (the LogKV stores each keep their own log, through
their own copy of the C++ engine).  Every comparison is exact: the bytes
written, the rows read (bit for bit, at 32, 16, 8 and 4 bits), the live
counts and the bytes a compaction reclaims.  Both sides decode with the
same numpy codecs, so nothing may differ.
"""

import os

import numpy as np
import pytest

from evstore_tpu.cache import storage as js
from evstore_tpu_torch.cache import storage as ps

PRECISIONS = [32, 16, 8, 4]
SIZES = [50, 37, 20, 64]


def _tables(dim, seed=0, sizes=SIZES):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (n, dim)).astype(np.float32) for n in sizes]


def _keys(seed=1, n=60, sizes=SIZES):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, len(sizes), n)
    keys = [(int(a), int(rng.integers(0, sizes[a]))) for a in t]
    return keys + keys[:7]                       # repeats too


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("dim", [8, 7])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_codec_rows_match_jax(precision, dim):
    """encode_rows, row_nbytes and _decode_rows, odd widths included (the
    4-bit rows pad the last byte's low nibble)."""
    rows = _tables(dim, seed=precision)[0]
    assert ps.row_nbytes(precision, dim) == js.row_nbytes(precision, dim)
    raw = ps.encode_rows(rows, precision)
    np.testing.assert_array_equal(raw, js.encode_rows(rows, precision))
    np.testing.assert_array_equal(
        _bits(ps._decode_rows(raw, precision, dim)),
        _bits(js._decode_rows(raw, precision, dim)))
    for bad in (12,):
        with pytest.raises(ValueError, match="unsupported precision"):
            ps.encode_rows(rows, bad)
        with pytest.raises(ValueError, match="unsupported precision"):
            ps.row_nbytes(bad, dim)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_written_files_match_jax(precision, tmp_path):
    tables = _tables(7, seed=3)
    got = ps.write_ev_tables_binary(tables, str(tmp_path / "port"), precision)
    want = js.write_ev_tables_binary(tables, str(tmp_path / "jax"), precision)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    for g, w in zip(got, want):
        assert open(g, "rb").read() == open(w, "rb").read()


BACKENDS = [("dummy", "global"), ("file", "global"), ("mmap", "global"),
            ("sqlite", "global"), ("sqlite", "per_table"),
            ("logkv", "global"), ("logkv", "per_table")]


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("backend,layout", BACKENDS)
def test_backend_rows_match_jax(backend, layout, precision, tmp_path):
    """Each backend and layout loads the same .bin files as the JAX
    package's and hands back the same rows through get, get_batch and
    request_group."""
    dim = 8
    tables = _tables(dim, seed=precision)
    bins = str(tmp_path / "bins")
    js.write_ev_tables_binary(tables, bins, precision)
    kw = dict(bin_dir=bins, table_sizes=SIZES)
    pm = ps.StorageManager(backend, precision=precision, dim=dim,
                           layout=layout).load(
        **kw, db_path=str(tmp_path / "port.db"))
    jm = js.StorageManager(backend, precision=precision, dim=dim,
                           layout=layout).load(
        **kw, db_path=str(tmp_path / "jax.db"))
    keys = _keys(precision)
    got = pm.get_batch(keys)
    assert got.dtype == np.float32 and got.shape == (len(keys), dim)
    np.testing.assert_array_equal(_bits(got), _bits(jm.get_batch(keys)))
    for t, r in keys[:5]:
        np.testing.assert_array_equal(_bits(pm.get(t, r)),
                                      _bits(jm.get(t, r)))
    group = [r for _, r in [(0, 3), (1, 36), (2, 0), (3, 63)]]
    np.testing.assert_array_equal(_bits(pm.request_group(group)),
                                  _bits(jm.request_group(group)))
    if precision == 32:     # the rows themselves, not only JAX's reading
        np.testing.assert_array_equal(
            _bits(got), _bits(np.stack([tables[t][r] for t, r in keys])))
    pm.close()
    jm.close()
    assert pm.store is None


@pytest.mark.parametrize("layout", ["global", "per_table"])
def test_logkv_writes_reopen_and_compact_match_jax(layout, tmp_path):
    """put_rows (an update appends), the live count, reopening (the index
    rebuilt from the log, later records win), compaction and a key never
    written, step by step against the JAX store."""
    sizes, dim = [40, 25], 8
    tables = _tables(dim, seed=5, sizes=sizes)
    bins = str(tmp_path / "bins")
    js.write_ev_tables_binary(tables, bins)
    dbs = {"port": str(tmp_path / "port.log"), "jax": str(tmp_path / "j.log")}
    mods = {"port": ps, "jax": js}

    def both(fn):
        return {k: fn(mods[k].LogKVStore, dbs[k]) for k in mods}

    kv = both(lambda cls, db: cls(db, sizes, dim, layout=layout)
              .create_and_load(bins, sizes))
    newv = np.full((2, dim), 0.5, np.float32)
    for k in kv:
        assert kv[k].count() == sum(sizes)
        kv[k].put_rows(0, np.asarray([3, 5]), newv)
        assert kv[k].count() == sum(sizes)
    keys = [(0, 3), (1, 24), (0, 5), (0, 39), (1, 7)]
    np.testing.assert_array_equal(kv["port"].get_batch(keys),
                                  kv["jax"].get_batch(keys))
    np.testing.assert_array_equal(kv["port"].get(0, 5), newv[1])
    for k in kv:
        kv[k].close()
    kv = both(lambda cls, db: cls(db, sizes, dim, layout=layout))
    sizes_on_disk = {}
    for k in kv:
        assert kv[k].count() == sum(sizes)
        paths = ([dbs[k]] if layout == "global"
                 else [f"{dbs[k]}.t{t}" for t in range(len(sizes))])
        before = sum(os.path.getsize(p) for p in paths)
        sizes_on_disk[k] = (before, kv[k].compact(),
                            sum(os.path.getsize(p) for p in paths))
    assert sizes_on_disk["port"] == sizes_on_disk["jax"]
    before, reclaimed, after = sizes_on_disk["port"]
    assert reclaimed == 2 * (8 + dim * 4) and after == before - reclaimed
    np.testing.assert_array_equal(kv["port"].get_batch(keys),
                                  kv["jax"].get_batch(keys))
    for k in kv:
        kv[k].close()


def test_storage_manager_refuses_what_jax_refuses(tmp_path):
    with pytest.raises(ValueError, match="unknown storage backend"):
        ps.StorageManager("rocksdb")
    with pytest.raises(ValueError, match="unknown storage layout"):
        ps.StorageManager("logkv", layout="bogus")
    with pytest.raises(ValueError, match="native engine"):
        ps.StorageManager("native").load(bin_dir=str(tmp_path),
                                         table_sizes=[1])
    with pytest.raises(ValueError, match="native engine"):
        js.StorageManager("native").load(bin_dir=str(tmp_path),
                                         table_sizes=[1])
    with pytest.raises(ValueError, match="unknown LogKV layout"):
        ps.LogKVStore(str(tmp_path / "x.log"), [4], 4, layout="bogus")


def test_dummy_store_decodes_files_at_its_precision(tmp_path):
    """The dummy store loaded from 4-bit files holds the decoded rows,
    equal to the JAX store's, and its table sizes."""
    tables = _tables(6, seed=9)
    js.write_ev_tables_binary(tables, str(tmp_path), 4)
    pm = ps.StorageManager("dummy", precision=4, dim=6).load(
        bin_dir=str(tmp_path), table_sizes=SIZES)
    jm = js.StorageManager("dummy", precision=4, dim=6).load(
        bin_dir=str(tmp_path), table_sizes=SIZES)
    assert pm.table_sizes() == SIZES
    for a, b in zip(pm.store.tables, jm.store.tables):
        np.testing.assert_array_equal(_bits(a), _bits(b))
