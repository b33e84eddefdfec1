"""`models/embedding.py::check_ids` against the elementwise signed check it
replaced, kept here as the reference: for each case the same raise or no
raise, and the same message."""

import numpy as np
import pytest

from evstore_tpu_torch.models import embedding
from evstore_tpu_torch.models.embedding import check_ids

I32_MIN = np.iinfo(np.int32).min
I32_MAX = np.iinfo(np.int32).max
I64_MIN = np.iinfo(np.int64).min
KAGGLE = (1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145,
          5683, 8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4,
          7046547, 18, 15, 286181, 105, 142572)


def reference_check_ids(idx, table_sizes):
    """The check as it was: both signed tests over every id."""
    idx = np.asarray(idx)
    sizes = np.asarray(table_sizes, np.int64)
    if idx.ndim < 2 or idx.shape[1] != sizes.size:
        raise ValueError(f"ids of shape {idx.shape} do not match "
                         f"{sizes.size} tables")
    sizes = sizes.reshape(1, -1, *([1] * (idx.ndim - 2)))
    bad = (idx < 0) | (idx >= sizes)
    if bad.any():
        pos = tuple(np.argwhere(bad)[0])
        raise ValueError(f"row id {int(idx[pos])} of table {pos[1]} is "
                         f"outside [0, {int(sizes.flat[pos[1]])})")


def _ids(shape, sizes, dtype=np.int32):
    """Ids in range, each table's column drawn below its size (and below
    the dtype's largest)."""
    rng = np.random.default_rng(0)
    B, rest = shape[0], shape[2:]
    top = int(np.iinfo(dtype).max) + 1
    cols = [rng.integers(0, min(n, top), (B,) + rest) for n in sizes]
    return np.stack(cols, axis=1).astype(dtype)


def _put(idx, flat, value):
    """idx with the id at C-order position `flat` set to `value`."""
    out = idx.copy()
    out[np.unravel_index(flat, out.shape)] = value
    return out


def _case(B, sizes, L=None, dtype=np.int32, put=()):
    shape = (B, len(sizes)) + (() if L is None else (L,))
    idx = _ids(shape, sizes, dtype)
    for flat, value in put:
        idx = _put(idx, flat % idx.size, value)
    return idx


SMALL = (50, 35, 20)
BIG = (3, 2 ** 31 + 5, 2 ** 32 + 7)
N = 4096 * 26
OK, BAD, SHAPE = None, "row id ", "ids of shape "
# name: (ids, table sizes, how the reference check ends)
CASES = {
    # in range: the regrouping, its remainder, B = 1, bags, int64
    "kaggle-int32": (lambda: _case(4096, KAGGLE), KAGGLE, OK),
    "kaggle-int64": (lambda: _case(4096, KAGGLE, dtype=np.int64), KAGGLE,
                     OK),
    "bags-int32": (lambda: _case(333, SMALL, L=5), SMALL, OK),
    "bags-int64": (lambda: _case(333, SMALL, L=5, dtype=np.int64), SMALL,
                   OK),
    "B-1": (lambda: _case(1, SMALL), SMALL, OK),
    "B-1-bags": (lambda: _case(1, SMALL, L=3), SMALL, OK),
    "B-not-divided": (lambda: _case(1000, KAGGLE), KAGGLE, OK),
    "B-zero": (lambda: np.zeros((0, 3), np.int32), SMALL, OK),
    "edges-in-range": (lambda: _case(
        17, SMALL, put=[(0, 49), (1, 34), (2, 19), (3, 0)]), SMALL, OK),
    # the first bad id at the start, the middle and the last element
    "bad-first": (lambda: _case(4096, KAGGLE, put=[(0, -1)]), KAGGLE, BAD),
    "bad-middle": (lambda: _case(4096, KAGGLE, put=[
        (N // 2 + 2, 10131227), (N - 1, -5)]), KAGGLE, BAD),
    "bad-last": (lambda: _case(4096, KAGGLE, put=[(N - 1, 142572)]),
                 KAGGLE, BAD),
    "bad-in-remainder": (lambda: _case(1000, KAGGLE, put=[
        (999 * 26 + 4, 305)]), KAGGLE, BAD),
    "bad-bags-middle": (lambda: _case(333, SMALL, L=5, put=[
        (2500, 36), (2600, 51)]), SMALL, BAD),
    "bad-B-1": (lambda: _case(1, SMALL, put=[(2, 21)]), SMALL, BAD),
    # -1, INT_MIN, size and size + 1
    "minus-one": (lambda: _case(64, SMALL, put=[(70, -1)]), SMALL, BAD),
    "int32-min": (lambda: _case(64, SMALL, put=[(70, I32_MIN)]), SMALL,
                  BAD),
    "int64-min": (lambda: _case(64, SMALL, dtype=np.int64,
                                put=[(70, I64_MIN)]), SMALL, BAD),
    "size": (lambda: _case(64, SMALL, put=[(70, 35)]), SMALL, BAD),
    "size-plus-one": (lambda: _case(64, SMALL, put=[(71, 21)]), SMALL,
                      BAD),
    "size-int64": (lambda: _case(64, SMALL, dtype=np.int64,
                                 put=[(72, 50)]), SMALL, BAD),
    "size-zero": (lambda: _case(8, SMALL), (50, 0, 20), BAD),
    "size-negative": (lambda: _case(8, SMALL), (50, -3, 20), BAD),
    "size-negative-int64": (lambda: _case(8, SMALL, dtype=np.int64),
                            (50, 35, -1), BAD),
    # sizes above 2^31: every int32 id in range, int64 ids not
    "int32-above-2^31": (lambda: _case(64, BIG, put=[(1, I32_MAX)]), BIG,
                         OK),
    "int32-above-2^31-negative": (lambda: _case(
        64, BIG, put=[(1, I32_MAX), (4, -1)]), BIG, BAD),
    "int64-above-2^31": (lambda: _case(64, BIG, dtype=np.int64, put=[
        (1, 2 ** 31 + 4)]), BIG, OK),
    "int64-above-2^31-size": (lambda: _case(64, BIG, dtype=np.int64, put=[
        (4, 2 ** 31 + 5)]), BIG, BAD),
    "int64-above-2^32": (lambda: _case(64, BIG, dtype=np.int64, put=[
        (7, 2 ** 32 + 1)]), BIG, BAD),
    # layouts the regrouping does not take
    "column-slice": (lambda: np.concatenate(
        [_case(512, SMALL)] * 2, axis=1)[:, 1:4], (35, 20, 50), OK),
    "column-slice-bad": (lambda: np.concatenate(
        [_case(512, SMALL, put=[(900, 60)])] * 2, axis=1)[:, 1:4],
        (35, 20, 50), BAD),
    "every-other-row-bad": (lambda: _case(
        512, SMALL, put=[(301, -7), (600, 99)])[::2], SMALL, BAD),
    "fortran-order": (lambda: np.asfortranarray(_case(512, SMALL)), SMALL,
                      OK),
    "fortran-order-bad": (lambda: np.asfortranarray(
        _case(512, SMALL, put=[(1201, 35)])), SMALL, BAD),
    "bags-transposed-bad": (lambda: np.ascontiguousarray(
        _case(40, SMALL, L=4, put=[(33, 35)]).transpose(2, 1, 0)
    ).transpose(2, 1, 0), SMALL, BAD),
    # dtypes the unsigned compare does not take
    "uint32": (lambda: _case(64, SMALL, dtype=np.uint32), SMALL, OK),
    "uint32-bad": (lambda: _case(64, SMALL, dtype=np.uint32,
                                 put=[(5, 20)]), SMALL, BAD),
    "int16": (lambda: _case(64, SMALL, dtype=np.int16), SMALL, OK),
    "int16-bad": (lambda: _case(64, SMALL, dtype=np.int16,
                                put=[(5, -3)]), SMALL, BAD),
    "big-endian-int32-bad": (lambda: _case(
        64, SMALL, put=[(9, -2)]).astype(">i4"), SMALL, BAD),
    "list": (lambda: _case(4, SMALL).tolist(), SMALL, OK),
    # shapes that match no tables
    "tables-mismatch": (lambda: _case(8, SMALL), (50, 35), SHAPE),
    "one-dimensional": (lambda: np.zeros(6, np.int32), SMALL, SHAPE),
}


def _outcome(fn, idx, sizes):
    try:
        fn(idx, sizes)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("name", list(CASES))
def test_check_ids_equals_the_elementwise_check(name):
    make, sizes, ends = CASES[name]
    idx = make()
    want = _outcome(reference_check_ids, idx, sizes)
    assert want is None if ends is OK else want.startswith(ends), want
    assert _outcome(check_ids, idx, sizes) == want


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_the_unsigned_compare_decides_in_range_ids(dtype):
    """Ids in range pass the unsigned compare alone; one id outside its
    table, at any row of a B that the regrouping does not divide, fails
    it; other dtypes go to the elementwise test."""
    sizes = np.asarray(KAGGLE, np.int64)
    idx = _case(1000, KAGGLE, dtype=dtype)
    assert embedding._unsigned_in_range(idx, sizes)
    for row in (0, 500, 999):
        for value in (-1, KAGGLE[3]):
            assert not embedding._unsigned_in_range(
                _put(idx, row * 26 + 3, value), sizes)
    assert not embedding._unsigned_in_range(idx.astype(np.uint32), sizes)
    big = np.asarray(BIG, np.int64)
    assert embedding._unsigned_in_range(_case(64, BIG, dtype=dtype), big)
    assert not embedding._unsigned_in_range(idx, sizes - sizes)
