"""The port's Criteo pipeline (`evstore_tpu_torch/data/criteo.py`) against
the JAX package's, on the CPU and the same TSV.

Held byte for byte (no tolerance): the synthetic TSV, every array of every
processed .npz (the zip members; the archives differ only by their
timestamps), the packed records of `numpy_to_binary` and of the streaming
path at `num_workers` 0 and 2, the dictionaries' counts and day offsets,
and every batch of `CriteoDataset` and `CriteoBinDataset`.  The engine's
TSV parser and the Python parser give the same arrays, and an error of the
engine's parser reaches the caller.  `unpack_records_device` on torch
tensors gives the host batches' labels and ids exactly and their dense
features within rtol 1e-6 (log1p of two libraries).
"""

import os
import shutil
import zipfile

import numpy as np
import pytest
import torch

from evstore_tpu.data import criteo as J
from evstore_tpu_torch.data import criteo as P

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")


def _same_npz(a: str, b: str):
    za, zb = zipfile.ZipFile(a), zipfile.ZipFile(b)
    assert za.namelist() == zb.namelist()
    for name in za.namelist():
        assert za.read(name) == zb.read(name), name


def _same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            assert u.dtype == v.dtype and u.shape == v.shape
            np.testing.assert_array_equal(u, v)
    return a


@pytest.fixture(scope="module")
def txt(tmp_path_factory):
    d = tmp_path_factory.mktemp("criteo")
    return P.make_synthetic_criteo_txt(str(d / "train.txt"), n=1400, seed=1,
                                       vocab=120)


def test_synthetic_txt_is_the_jax_packages(tmp_path):
    a = J.make_synthetic_criteo_txt(str(tmp_path / "a"), n=300, seed=4,
                                    vocab=77)
    b = P.make_synthetic_criteo_txt(str(tmp_path / "b"), n=300, seed=4,
                                    vocab=77)
    assert open(a, "rb").read() == open(b, "rb").read()
    # one bound a column keeps each column's ids inside it
    vocab = [3, 1000] * 13
    c = P.make_synthetic_criteo_txt(str(tmp_path / "c"), n=500, seed=4,
                                    vocab=vocab)
    _, _, cats = P._parse_tsv(c)
    assert (cats.max(axis=0) < np.asarray(vocab)).all()
    assert cats[:, 1].max() > 3
    with pytest.raises(ValueError, match="26"):
        P.make_synthetic_criteo_txt(str(tmp_path / "d"), n=1, vocab=[5])


@pytest.mark.parametrize("days,rate,native", [(7, 0.0, True),
                                              (3, 0.5, True),
                                              (7, 0.25, False)])
def test_preprocess_files_are_the_jax_packages(txt, tmp_path, days, rate,
                                               native):
    kw = dict(days=days, sub_sample_rate=rate, seed=5)
    a = J.preprocess_criteo(txt, str(tmp_path / "j"), **kw)
    b = P.preprocess_criteo(txt, str(tmp_path / "p"), use_native=native,
                            **kw)
    assert os.path.basename(a) == os.path.basename(b)
    _same_npz(a, b)
    for d in range(days):
        name = f"kaggle_day_{d}.npz"
        _same_npz(str(tmp_path / "j" / name), str(tmp_path / "p" / name))
    z = np.load(b)
    for t in range(26):          # contiguous ids, every one kept at rate 0
        ids = z["X_cat"][:, t]
        assert ids.max() < z["counts"][t]
        if rate == 0.0:
            assert len(np.unique(ids)) == z["counts"][t] == ids.max() + 1


def test_first_seen_ids():
    ids, n = P.first_seen_ids(np.asarray([7, 3, 7, 9, 3, 0], np.int64))
    assert n == 4 and ids.tolist() == [0, 1, 0, 2, 1, 3]


def _odd_tsv(path):
    """Well-formed lines and the cases a parser must agree on: missing and
    negative dense values, missing categories, a short line, a line with a
    trailing carriage return, a missing final newline."""
    rows = [
        "1\t" + "\t".join(["5", "", "-3"] + ["0"] * 10) + "\t"
        + "\t".join(["a1", "", "ff"] + ["0"] * 23),
        "0\t1\t2",
        "0\t" + "\t".join(["12"] * 13) + "\t" + "\t".join(["1b"] * 26)
        + "\r",
        "1\t" + "\t".join([""] * 13) + "\t" + "\t".join([""] * 26),
    ]
    with open(path, "w") as f:
        f.write("\n".join(rows))
    return str(path)


@pytest.mark.parametrize("which", ["synthetic", "odd"])
def test_native_parser_matches_python(txt, tmp_path, which):
    path = txt if which == "synthetic" else _odd_tsv(tmp_path / "odd.txt")
    a = P._parse_tsv(path, use_native=True)
    b = P._parse_tsv(path, use_native=False)
    c = J._parse_tsv(path, use_native=True)
    assert len(a[0]) == (1400 if which == "synthetic" else 3)
    for x, y, z in zip(a, b, c):
        assert x.dtype == y.dtype == z.dtype
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)


def test_native_parser_errors_reach_the_caller(txt, tmp_path, monkeypatch):
    """The JAX package falls back to Python on any error of the native
    parser; the port's `use_native` means the engine, and its error is
    raised."""
    missing = str(tmp_path / "missing.txt")
    with pytest.raises(FileNotFoundError):
        P._parse_tsv(missing)
    with pytest.raises(FileNotFoundError):
        list(P._chunks_of(missing, 10))
    with pytest.raises(FileNotFoundError):
        P._parse_range(missing, 0, 10, 5)
    import evstore_tpu_torch.native as native

    def broken(*a, **k):
        raise RuntimeError("engine failed")

    for name in ("parse_criteo_tsv_native", "parse_criteo_tsv_chunks",
                 "parse_criteo_tsv_range"):
        monkeypatch.setattr(native, name, broken)
    with pytest.raises(RuntimeError, match="engine failed"):
        P._parse_tsv(txt)
    with pytest.raises(RuntimeError, match="engine failed"):
        list(P._chunks_of(txt, 100))
    with pytest.raises(RuntimeError, match="engine failed"):
        P._parse_range(txt, 0, 100, 5)
    with pytest.raises(RuntimeError, match="engine failed"):
        P.preprocess_criteo(txt, str(tmp_path / "o"))
    # the Python parser is there when asked for
    assert len(P._parse_tsv(txt, use_native=False)[0]) == 1400


@pytest.fixture(scope="module")
def datasets(txt, tmp_path_factory):
    d = tmp_path_factory.mktemp("ds")
    a = J.preprocess_criteo(txt, str(d / "j"), days=7)
    b = P.preprocess_criteo(txt, str(d / "p"), days=7)
    return a, b


@pytest.mark.parametrize("split,bs,fraction,mir,shuffle,drop", [
    ("train", 128, 1.0, 0, False, False), ("test", 32, 0.5, 0, False, True),
    ("val", 50, 1.0, 17, False, False), ("train", 64, 1.0, 0, True, True)])
def test_dataset_batches_are_the_jax_packages(datasets, split, bs, fraction,
                                              mir, shuffle, drop):
    a, b = datasets
    ja, pb = J.CriteoDataset.load(a, mir), P.CriteoDataset.load(b, mir)
    assert ja.splits() == pb.splits()
    assert ja.table_sizes == pb.table_sizes
    assert ja.num_batches(split, bs, fraction) == \
        pb.num_batches(split, bs, fraction)
    kw = dict(batch_size=bs, fraction=fraction, shuffle=shuffle, seed=3,
              drop_last=drop)
    got = _same_batches(pb.batches(split, **kw), ja.batches(split, **kw))
    assert got and got[0][0].dtype == np.float32
    if mir:
        assert max(int(x[1].max()) for x in got) < mir


@pytest.mark.parametrize("mir", [0, 1000])
def test_binary_records_and_bin_dataset(datasets, tmp_path, mir):
    a, b = datasets
    ra = J.numpy_to_binary(a, str(tmp_path / "j.bin"))
    rb = P.numpy_to_binary(b, str(tmp_path / "p.bin"))
    assert open(ra, "rb").read() == open(rb, "rb").read()
    ja = J.CriteoBinDataset(ra, batch_size=100, max_ind_range=mir)
    pb = P.CriteoBinDataset(rb, batch_size=100, max_ind_range=mir)
    assert len(ja) == len(pb) == 14
    _same_batches(pb, ja)
    _same_batches(pb.iter_raw(), ja.iter_raw())


def test_unpack_records_device_matches_host(tmp_path):
    rng = np.random.default_rng(3)
    rec = np.empty((64, P.RECORD_INTS), np.int32)
    rec[:, 0] = rng.integers(0, 2, 64)
    rec[:, 1:14] = rng.integers(-3, 1000, (64, 13))   # negatives clamp to 0
    rec[:, 14:] = rng.integers(0, 1 << 20, (64, 26))
    p = tmp_path / "r.bin"
    rec.tofile(p)
    for mir in (0, 1000):
        ds = P.CriteoBinDataset(str(p), batch_size=64, max_ind_range=mir)
        d_h, i_h, y_h = next(iter(ds))
        raw = torch.tensor(next(ds.iter_raw()))
        d_d, i_d, y_d = P.unpack_records_device(raw, max_ind_range=mir)
        assert d_d.dtype == torch.float32 and i_d.dtype == torch.int32
        np.testing.assert_array_equal(y_d.numpy(), y_h)
        np.testing.assert_allclose(d_d.numpy(), d_h, rtol=1e-6)
        np.testing.assert_array_equal(i_d.numpy(), i_h)


def _records(meta):
    z = np.load(meta)
    return np.fromfile(str(z["bin_path"]), np.int32), z


@pytest.mark.parametrize("workers,rate,native", [(0, 0.0, True),
                                                 (2, 0.5, True),
                                                 (0, 0.5, False),
                                                 (2, 0.0, False)])
def test_streaming_is_the_jax_packages(txt, tmp_path, workers, rate, native):
    kw = dict(days=4, sub_sample_rate=rate, seed=7, chunk_rows=300,
              num_workers=workers)
    ma = J.preprocess_criteo_streaming(txt, str(tmp_path / "j"), **kw)
    mb = P.preprocess_criteo_streaming(txt, str(tmp_path / "p"),
                                       use_native=native, **kw)
    (ra, za), (rb, zb) = _records(ma), _records(mb)
    np.testing.assert_array_equal(ra, rb)
    np.testing.assert_array_equal(za["counts"], zb["counts"])
    np.testing.assert_array_equal(za["day_offsets"], zb["day_offsets"])
    assert za["counts"].dtype == zb["counts"].dtype
    assert za["day_offsets"].dtype == zb["day_offsets"].dtype
    _same_batches(P.CriteoDataset.from_stream(mb).batches("test", 64),
                  J.CriteoDataset.from_stream(ma).batches("test", 64))


def test_streaming_matches_in_memory(txt, tmp_path):
    """The streaming path against the port's in-memory path: the same
    labels, dense values, counts and day offsets, and ids that differ by
    one bijection a table (sorted-within-chunk against first-seen order),
    as in the JAX package."""
    inram = np.load(P.preprocess_criteo(txt, str(tmp_path / "a"), days=4))
    for workers in (0, 2):
        rec, z = _records(P.preprocess_criteo_streaming(
            txt, str(tmp_path / f"s{workers}"), days=4, chunk_rows=257,
            num_workers=workers))
        rec = rec.reshape(-1, P.RECORD_INTS)
        np.testing.assert_array_equal(inram["counts"], z["counts"])
        np.testing.assert_array_equal(inram["day_offsets"],
                                      z["day_offsets"])
        np.testing.assert_array_equal(inram["y"], rec[:, 0])
        np.testing.assert_array_equal(inram["X_int"], rec[:, 1:14])
        for t in range(26):
            a, b = inram["X_cat"][:, t], rec[:, 14 + t]
            fwd = {}
            for x, y in zip(a.tolist(), b.tolist()):
                assert fwd.setdefault(x, y) == y, t
            assert len(set(fwd.values())) == len(fwd), t


def test_streaming_multiday_files(tmp_path):
    paths = [P.make_synthetic_criteo_txt(str(tmp_path / f"day_{d}"),
                                         n=300 + 100 * d, seed=d, vocab=60)
             for d in range(3)]
    for workers in (0, 2):
        ma = J.preprocess_criteo_streaming(paths, str(tmp_path / f"j{workers}"),
                                           chunk_rows=128,
                                           num_workers=workers)
        mb = P.preprocess_criteo_streaming(paths, str(tmp_path / f"p{workers}"),
                                           chunk_rows=128,
                                           num_workers=workers)
        (ra, za), (rb, zb) = _records(ma), _records(mb)
        np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(zb["day_offsets"], [0, 300, 700, 1200])
        ds = P.CriteoDataset.from_stream(mb)
        assert ds.splits() == ((0, 700), (700, 950), (950, 1200))


def test_scan_and_ranges_are_the_jax_packages(txt):
    assert P._scan_chunk_offsets(txt, 500) == J._scan_chunk_offsets(txt, 500)
    tasks = P._scan_chunk_offsets(txt, 500)
    assert [t[2] for t in tasks] == [500, 500, 400]
    whole = list(P._chunks_of(txt, 10_000))[0]
    for native in (True, False):
        parts = [P._parse_range(txt, lo, hi, nl, native)
                 for lo, hi, nl in tasks]
        for k in range(3):
            np.testing.assert_array_equal(
                np.concatenate([p[k] for p in parts]), whole[k])
    chunks = list(P._chunks_of(txt, 333, use_native=False))
    assert [len(c[0]) for c in chunks] == [333, 333, 333, 333, 68]
    for k in range(3):
        np.testing.assert_array_equal(
            np.concatenate([c[k] for c in chunks]), whole[k])
