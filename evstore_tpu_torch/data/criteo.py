"""Criteo preprocessing and datasets.

Port of `evstore_tpu/data/criteo.py`, which follows data_utils.py and
dlrm_data_pytorch.py:

- `preprocess_criteo`: split the raw TSV (`train.txt` for Kaggle) into days
  (getCriteoAdData:876), build per-table dictionaries from categorical
  value to contiguous id over all days, in first-seen order (convertDicts,
  processCriteoAdData:112), clamp missing and negative dense values to 0,
  optionally subsample the negatives (sub_sample_rate, :947-966), and write
  per-day .npz files and a combined one with per-table counts
  (concatCriteoAdData:172).
- `CriteoDataset`: train is every day but the last, whose halves are test
  and val (dlrm_data_pytorch.py:240-284); dense features come out as
  log1p(x) float32 (:342, :365), categorical ids mod max_ind_range
  (:314-321), and `fraction` keeps a leading share (reduceDatasetSize:389).
- `preprocess_criteo_streaming`: the same in two passes over chunks, with
  bounded memory, optionally over a process pool, into packed records.
- `numpy_to_binary` / `CriteoBinDataset`: int32 records [label, 13 dense,
  26 sparse] read through mmap (script/data_loader_terabyte.py:197-368);
  `unpack_records_device` converts a batch of records on the card.

The files written are the JAX package's byte for byte: the same arrays in
the same .npz members, the same records.  Batches are numpy (dense [B, 13]
float32, idx [B, 26] int32, y [B] float32); the train and eval steps check
the ids against the model's tables on the host (`check_ids`).

`use_native` (default) parses with the C++ engine's parser
(`native/__init__.py`), whose errors reach the caller; `use_native=False`
asks for the Python parser, which gives the same arrays.  Nothing falls
back from one to the other.  The streaming path's process pool is spawned,
not forked (the JAX package forks): a parent that holds a card runs
threads, and a spawned worker imports numpy and the engine only, never
torch.  Its pass-2 workers read the dictionaries from .npy files mapped
into memory, which the page cache shares among them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, Sequence, Tuple, Union

import numpy as np

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray]

NUM_DENSE = 13
NUM_SPARSE = 26
RECORD_INTS = 1 + NUM_DENSE + NUM_SPARSE   # 40 int32 a sample


def _parse_line(line: str):
    """One TSV line -> (label, dense [13] int64, cats [26] int64), or None
    for a line without 40 fields.  Missing dense -> 0, negative dense -> 0
    (data_utils.py:1130-1144); categories are hex, missing -> 0
    (:1147-1153).  ValueError for a field that is not a number."""
    parts = line.rstrip("\n").split("\t")
    if len(parts) != 1 + NUM_DENSE + NUM_SPARSE:
        return None
    label = int(parts[0])
    d = np.zeros(NUM_DENSE, np.int64)
    for i, v in enumerate(parts[1:1 + NUM_DENSE]):
        if v:
            x = int(v)
            d[i] = x if x > 0 else 0
    c = np.zeros(NUM_SPARSE, np.int64)
    for i, v in enumerate(parts[1 + NUM_DENSE:]):
        c[i] = int(v, 16) if v else 0
    return label, d, c


def _stack(labels, dense, cats):
    if not labels:
        return (np.empty(0, np.int32), np.empty((0, NUM_DENSE), np.int64),
                np.empty((0, NUM_SPARSE), np.int64))
    return (np.asarray(labels, np.int32), np.stack(dense), np.stack(cats))


def _parse_tsv(path: str, use_native: bool = True
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse a Criteo TSV: -> (labels int32 [n], dense int64 [n, 13], cats
    int64 [n, 26])."""
    if use_native:
        from evstore_tpu_torch.native import parse_criteo_tsv_native
        return parse_criteo_tsv_native(path)
    labels, dense, cats = [], [], []
    with open(path) as f:
        for line in f:
            row = _parse_line(line)
            if row is not None:
                labels.append(row[0])
                dense.append(row[1])
                cats.append(row[2])
    return _stack(labels, dense, cats)


def first_seen_ids(col: np.ndarray) -> Tuple[np.ndarray, int]:
    """Contiguous ids in first-seen order (convertDicts): the i-th distinct
    value met gets id i.  -> (ids int32, count)."""
    _, first, inv = np.unique(col, return_index=True, return_inverse=True)
    rank = np.empty(first.size, np.int32)
    rank[np.argsort(first, kind="stable")] = np.arange(first.size,
                                                        dtype=np.int32)
    return rank[inv.reshape(-1)], int(first.size)


def preprocess_criteo(txt_path: str, out_dir: str, days: int = 7,
                      sub_sample_rate: float = 0.0, seed: int = 123,
                      dataset_name: str = "kaggle",
                      use_native: bool = True) -> str:
    """Split into days, build the categorical dictionaries, write the
    processed .npz files.  Returns the path of the combined .npz."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    y, Xi, Xc = _parse_tsv(txt_path, use_native)
    n = len(y)
    per_day = n // days

    Xc_ids = np.empty_like(Xc, dtype=np.int32)
    counts = np.empty(NUM_SPARSE, np.int32)
    for t in range(NUM_SPARSE):
        Xc_ids[:, t], counts[t] = first_seen_ids(Xc[:, t])

    # optional balanced subsample: keep rand < rate or label == 1
    # (data_utils.py:947-966)
    keep = np.ones(n, bool)
    if sub_sample_rate > 0.0:
        keep = (rng.random(n) < sub_sample_rate) | (y == 1)

    day_rows = []
    for d in range(days):
        lo, hi = d * per_day, (d + 1) * per_day if d < days - 1 else n
        m = keep[lo:hi]
        np.savez_compressed(
            os.path.join(out_dir, f"{dataset_name}_day_{d}.npz"),
            X_int=Xi[lo:hi][m], X_cat=Xc_ids[lo:hi][m], y=y[lo:hi][m])
        day_rows.append(int(m.sum()))

    combined = os.path.join(out_dir, f"{dataset_name}_processed.npz")
    np.savez_compressed(
        combined,
        X_int=Xi[keep], X_cat=Xc_ids[keep], y=y[keep], counts=counts,
        day_offsets=np.asarray([0] + list(np.cumsum(day_rows)), np.int64))
    return combined


@dataclasses.dataclass
class CriteoDataset:
    """Day-split view over a processed .npz
    (dlrm_data_pytorch.CriteoDataset)."""

    X_int: np.ndarray          # [n, 13] int
    X_cat: np.ndarray          # [n, 26] int32
    y: np.ndarray              # [n]
    counts: np.ndarray         # [26] rows per table
    day_offsets: np.ndarray
    max_ind_range: int = 0

    @classmethod
    def load(cls, npz_path: str, max_ind_range: int = 0) -> "CriteoDataset":
        z = np.load(npz_path)
        return cls(z["X_int"], z["X_cat"], z["y"], z["counts"],
                   z["day_offsets"], max_ind_range)

    @classmethod
    def from_stream(cls, meta_path: str, max_ind_range: int = 0
                    ) -> "CriteoDataset":
        """A view over `preprocess_criteo_streaming`'s output: the records
        are memory-mapped, X_int / X_cat / y are views of them, and
        `batches` reads one batch at a time (≙ the reference's memory_map
        mode)."""
        z = np.load(meta_path)
        bin_path = str(z["bin_path"])
        if not os.path.isabs(bin_path) and not os.path.exists(bin_path):
            bin_path = os.path.join(os.path.dirname(meta_path),
                                    os.path.basename(bin_path))
        mm = np.memmap(bin_path, dtype=np.int32, mode="r")
        if mm.shape[0] % RECORD_INTS:
            raise ValueError(f"{bin_path}: {mm.shape[0]} int32 is not a "
                             f"whole number of {RECORD_INTS}-int records")
        rec = mm.reshape(-1, RECORD_INTS)
        return cls(rec[:, 1:1 + NUM_DENSE], rec[:, 1 + NUM_DENSE:],
                   rec[:, 0], z["counts"], z["day_offsets"], max_ind_range)

    @property
    def table_sizes(self) -> Tuple[int, ...]:
        if self.max_ind_range > 0:
            return tuple(int(min(c, self.max_ind_range)) for c in self.counts)
        return tuple(int(c) for c in self.counts)

    def splits(self):
        """train = days 0..D-2; the last day halved into test and val
        (dlrm_data_pytorch.py:240-284)."""
        last_lo = int(self.day_offsets[-2])
        n = len(self.y)
        mid = last_lo + (n - last_lo) // 2
        return ((0, last_lo), (last_lo, mid), (mid, n))  # train, test, val

    def _range(self, split: str, fraction: float) -> Tuple[int, int]:
        lo, hi = dict(zip(("train", "test", "val"), self.splits()))[split]
        n = hi - lo
        if fraction < 1.0:
            n = max(1, int(n * fraction))
        return lo, n

    def batches(self, split: str = "train", batch_size: int = 128,
                shuffle: bool = False, seed: int = 0,
                fraction: float = 1.0, drop_last: bool = False
                ) -> Iterator[Batch]:
        """`fraction` keeps a leading share (reduceDatasetSize:389)."""
        lo, n = self._range(split, fraction)
        order = np.arange(lo, lo + n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for s in range(0, n, batch_size):
            sel = order[s:s + batch_size]
            if drop_last and len(sel) < batch_size:
                break
            xi, xc, yy = self.X_int[sel], self.X_cat[sel], self.y[sel]
            if self.max_ind_range > 0:
                xc = xc % self.max_ind_range
            dense = np.log1p(xi.astype(np.float32))  # log(x+1) (:342)
            yield dense, xc.astype(np.int32), yy.astype(np.float32)

    def num_batches(self, split: str, batch_size: int,
                    fraction: float = 1.0) -> int:
        return -(-self._range(split, fraction)[1] // batch_size)


# ------------------------------------- streaming (Terabyte) preprocessing

class _StreamingDicts:
    """Per-table dictionaries built from each chunk's sorted uniques in
    chunk order (≙ convertDicts merged day by day, data_utils.py:112): ids
    in sorted order within a chunk, chunk order across chunks.  Kept as
    parallel sorted numpy arrays (12 bytes a key)."""

    def __init__(self, n_tables: int = NUM_SPARSE):
        self.keys = [np.empty(0, np.int64) for _ in range(n_tables)]
        self.ids = [np.empty(0, np.int32) for _ in range(n_tables)]

    def absorb(self, t: int, col: np.ndarray) -> None:
        u = np.unique(col)
        pos = np.searchsorted(self.keys[t], u)
        found = np.zeros(len(u), bool)
        in_range = pos < len(self.keys[t])
        found[in_range] = self.keys[t][pos[in_range]] == u[in_range]
        new = u[~found]
        if len(new) == 0:
            return
        start = len(self.keys[t])
        new_ids = np.arange(start, start + len(new), dtype=np.int32)
        ins = np.searchsorted(self.keys[t], new)
        self.keys[t] = np.insert(self.keys[t], ins, new)
        self.ids[t] = np.insert(self.ids[t], ins, new_ids)

    def map(self, t: int, col: np.ndarray) -> np.ndarray:
        return self.ids[t][np.searchsorted(self.keys[t], col)]

    @property
    def counts(self) -> np.ndarray:
        return np.asarray([len(k) for k in self.keys], np.int32)


def _chunks_of(path: str, chunk_rows: int, use_native: bool = True):
    """(labels, dense, cats) chunks of up to `chunk_rows` rows."""
    if use_native:
        from evstore_tpu_torch.native import parse_criteo_tsv_chunks
        yield from parse_criteo_tsv_chunks(path, chunk_rows)
        return
    labels, dense, cats = [], [], []
    with open(path) as f:
        for line in f:
            row = _parse_line(line)
            if row is None:
                continue
            labels.append(row[0])
            dense.append(row[1])
            cats.append(row[2])
            if len(labels) == chunk_rows:
                yield _stack(labels, dense, cats)
                labels, dense, cats = [], [], []
    if labels:
        yield _stack(labels, dense, cats)


# ------------------------------------------ parallel preprocessing workers

def _scan_chunk_offsets(path: str, chunk_rows: int):
    """A newline scan, no parsing -> [(byte_lo, byte_hi, n_lines)] with
    `chunk_rows` lines a task; the ranges partition the file at line
    boundaries."""
    size = os.path.getsize(path)
    tasks = []
    chunk_lo, lines_in_chunk = 0, 0
    off = 0
    last_byte = b""
    with open(path, "rb") as f:
        while True:
            buf = f.read(1 << 24)
            if not buf:
                break
            last_byte = buf[-1:]
            start = 0
            while True:
                i = buf.find(b"\n", start)
                if i < 0:
                    break
                lines_in_chunk += 1
                if lines_in_chunk == chunk_rows:
                    tasks.append((chunk_lo, off + i + 1, chunk_rows))
                    chunk_lo = off + i + 1
                    lines_in_chunk = 0
                start = i + 1
            off += len(buf)
    if chunk_lo < size:
        tail_lines = lines_in_chunk + (0 if last_byte == b"\n" else 1)
        tasks.append((chunk_lo, size, tail_lines))
    return tasks


def _parse_range(path: str, lo: int, hi: int, max_rows: int,
                 use_native: bool = True):
    """Parse the lines that start in [lo, hi)."""
    if use_native:
        from evstore_tpu_torch.native import parse_criteo_tsv_range
        return parse_criteo_tsv_range(path, lo, hi, max_rows)
    with open(path, "rb") as f:
        f.seek(lo)
        text = f.read(hi - lo).decode("utf-8", errors="replace")
    labels, dense, cats = [], [], []
    for line in text.splitlines():
        try:
            row = _parse_line(line)
        except ValueError:
            continue
        if row is not None and len(labels) < max_rows:
            labels.append(row[0])
            dense.append(row[1])
            cats.append(row[2])
    return _stack(labels, dense, cats)


def _pp_pass1_worker(task):
    """Parse a byte range -> (rows, per-table sorted uniques); the parent
    merges the uniques in task order."""
    path, lo, hi, n_lines, _fi, use_native = task
    labels, _, cats = _parse_range(path, lo, hi, n_lines, use_native)
    return len(labels), [np.unique(cats[:, t]) for t in range(NUM_SPARSE)]


# A pass-2 worker's dictionaries, set by `_pp_pass2_init` in the worker.
_PP_DICTS = None


def _save_dicts(dicts: _StreamingDicts, prefix: str) -> List[int]:
    """The dictionaries as two .npy files (keys, ids; the tables one after
    another) -> the tables' offsets."""
    np.save(prefix + "_keys.npy", np.concatenate(dicts.keys))
    np.save(prefix + "_ids.npy", np.concatenate(dicts.ids))
    return [0, *np.cumsum([len(k) for k in dicts.keys]).tolist()]


def _pp_pass2_init(prefix: str, offsets: List[int]) -> None:
    """A pass-2 worker's start: map the dictionaries' files."""
    global _PP_DICTS
    keys = np.load(prefix + "_keys.npy", mmap_mode="r")
    ids = np.load(prefix + "_ids.npy", mmap_mode="r")
    d = _StreamingDicts(0)
    d.keys = [keys[a:b] for a, b in zip(offsets, offsets[1:])]
    d.ids = [ids[a:b] for a, b in zip(offsets, offsets[1:])]
    _PP_DICTS = d


def _pp_pass2_worker(task):
    """Parse a byte range and map its categories through the mapped
    dictionaries; the parent then only subsamples and writes."""
    path, lo, hi, n_lines, _fi, use_native = task
    labels, dense, cats = _parse_range(path, lo, hi, n_lines, use_native)
    mapped = np.empty(cats.shape, np.int32)
    for t in range(NUM_SPARSE):
        mapped[:, t] = _PP_DICTS.map(t, cats[:, t])
    return labels, dense, mapped, True


def preprocess_criteo_streaming(inputs: Union[str, Sequence[str]],
                                out_dir: str, days: int = 7,
                                sub_sample_rate: float = 0.0, seed: int = 123,
                                dataset_name: str = "kaggle",
                                chunk_rows: int = 1_000_000,
                                num_workers: int = 0,
                                use_native: bool = True) -> str:
    """Terabyte-scale preprocessing with bounded memory (≙ data_utils.py
    getCriteoAdData :876, processCriteoAdData :112, concatCriteoAdData
    :172): pass 1 builds the dictionaries (`_StreamingDicts`), pass 2 maps
    the ids, subsamples (keep if rand < rate or label == 1,
    data_utils.py:947-966) and appends packed int32 records [label, 13
    dense, 26 sparse] to one .bin.  Memory is one chunk plus the
    dictionaries.

    `num_workers` > 1 runs both passes on a spawned process pool (≙ the
    reference's dataset_multiprocessing, data_utils.py:876) over
    `chunk_rows`-line byte ranges from a newline scan; the parent merges
    and writes in task order, so on well-formed input the output is the
    sequential path's byte for byte.

    `inputs`: one TSV (cut into `days` row slices, Kaggle style) or a list
    of per-day files (Terabyte's `day_*`).  Returns the path of a meta
    .npz holding {bin_path, counts, day_offsets}, which
    `CriteoDataset.from_stream` reads."""
    os.makedirs(out_dir, exist_ok=True)
    paths = [inputs] if isinstance(inputs, str) else list(inputs)
    dicts = _StreamingDicts()
    parallel = bool(num_workers and num_workers > 1)
    if parallel:
        import multiprocessing as mp
        import tempfile
        ctx = mp.get_context("spawn")
        tasks = [(p, lo, hi, nl, fi, use_native)
                 for fi, p in enumerate(paths)
                 for lo, hi, nl in _scan_chunk_offsets(p, chunk_rows)]

    # pass 1: dictionaries and the row count
    n_total = 0
    if parallel:
        with ctx.Pool(num_workers) as pool:
            for n, uniqs in pool.imap(_pp_pass1_worker, tasks, chunksize=1):
                n_total += n
                for t in range(NUM_SPARSE):
                    dicts.absorb(t, uniqs[t])
    else:
        for p in paths:
            for labels, _, cats in _chunks_of(p, chunk_rows, use_native):
                n_total += len(labels)
                for t in range(NUM_SPARSE):
                    dicts.absorb(t, cats[:, t])
    if n_total == 0:
        raise ValueError(f"no parseable rows in {paths}")

    # day boundaries: one file a day, or row slices of one file
    if len(paths) > 1:
        days = len(paths)
        per_day = None
    else:
        per_day = n_total // days

    bin_path = os.path.join(out_dir, f"{dataset_name}_stream.bin")
    rng = np.random.default_rng(seed)
    day_counts = np.zeros(days, np.int64)
    row = 0

    def chunk_source():
        if parallel:
            with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
                prefix = os.path.join(tmp, "dicts")
                offsets = _save_dicts(dicts, prefix)
                with ctx.Pool(num_workers, initializer=_pp_pass2_init,
                              initargs=(prefix, offsets)) as pool:
                    for task, parsed in zip(tasks,
                                            pool.imap(_pp_pass2_worker,
                                                      tasks, chunksize=1)):
                        yield task[4], parsed
            return
        for fi, p in enumerate(paths):
            for lab, den, cat in _chunks_of(p, chunk_rows, use_native):
                yield fi, (lab, den, cat, False)

    with open(bin_path, "wb") as out:
        for fi, (labels, dense, cats, pre_mapped) in chunk_source():
            n = len(labels)
            keep = np.ones(n, bool)
            if sub_sample_rate > 0.0:
                keep = (rng.random(n) < sub_sample_rate) | (labels == 1)
            rec = np.empty((n, RECORD_INTS), np.int32)
            rec[:, 0] = labels
            rec[:, 1:1 + NUM_DENSE] = dense
            if pre_mapped:
                rec[:, 1 + NUM_DENSE:] = cats
            else:
                for t in range(NUM_SPARSE):
                    rec[:, 1 + NUM_DENSE + t] = dicts.map(t, cats[:, t])
            if per_day is None:
                rec[keep].tofile(out)
                day_counts[fi] += int(keep.sum())
            else:
                # a row-sliced day may straddle chunks
                d_lo = min(row // per_day, days - 1)
                d_hi = min((row + n - 1) // per_day, days - 1)
                for d in range(d_lo, d_hi + 1):
                    lo = max(d * per_day, row) - row
                    hi = (n if d == days - 1
                          else min((d + 1) * per_day, row + n) - row)
                    m = keep[lo:hi]
                    rec[lo:hi][m].tofile(out)
                    day_counts[d] += int(m.sum())
            row += n

    meta_path = os.path.join(out_dir, f"{dataset_name}_stream_meta.npz")
    np.savez(meta_path, bin_path=np.asarray(bin_path),
             counts=dicts.counts,
             day_offsets=np.concatenate([[0], np.cumsum(day_counts)]))
    return meta_path


# ------------------------------------------------ binary (Terabyte) format

def numpy_to_binary(npz_path: str, out_bin: str) -> str:
    """Pack processed arrays as int32 records [label, 13 dense, 26 sparse]
    (script/data_loader_terabyte.py numpy_to_binary:243)."""
    z = np.load(npz_path)
    n = z["y"].shape[0]
    rec = np.empty((n, RECORD_INTS), np.int32)
    rec[:, 0] = z["y"]
    rec[:, 1:1 + NUM_DENSE] = z["X_int"]
    rec[:, 1 + NUM_DENSE:] = z["X_cat"]
    rec.tofile(out_bin)
    return out_bin


class CriteoBinDataset:
    """Batched reads over the packed records through mmap
    (script/data_loader_terabyte.py CriteoBinDataset:197)."""

    def __init__(self, bin_path: str, batch_size: int = 2048,
                 max_ind_range: int = 0):
        self.batch_size = batch_size
        self.max_ind_range = max_ind_range
        self.mm = np.memmap(bin_path, dtype=np.int32, mode="r")
        if self.mm.shape[0] % RECORD_INTS:
            raise ValueError(f"{bin_path}: not a whole number of "
                             f"{RECORD_INTS}-int records")
        self.n = self.mm.shape[0] // RECORD_INTS

    def __len__(self):
        return -(-self.n // self.batch_size)

    def iter_raw(self) -> Iterator[np.ndarray]:
        """The packed [b, RECORD_INTS] int32 batches, for
        `unpack_records_device`: one host-to-device copy a step."""
        for s in range(0, self.n, self.batch_size):
            e = min(s + self.batch_size, self.n)
            yield np.asarray(self.mm[s * RECORD_INTS:e * RECORD_INTS]
                             ).reshape(e - s, RECORD_INTS)

    def __iter__(self) -> Iterator[Batch]:
        for rec in self.iter_raw():
            y = rec[:, 0].astype(np.float32)
            dense = np.log1p(np.maximum(rec[:, 1:1 + NUM_DENSE], 0)
                             .astype(np.float32))
            xc = rec[:, 1 + NUM_DENSE:].astype(np.int32)
            if self.max_ind_range > 0:
                xc = xc % self.max_ind_range
            yield dense, xc, y


def unpack_records_device(rec, max_ind_range: int = 0):
    """`CriteoBinDataset.__iter__`'s conversion on the records' device
    (data_loader_terabyte.py:225-231): rec [B, RECORD_INTS] int32 tensor
    -> (dense float32 log1p(max(x, 0)), idx int32, y float32) tensors."""
    import torch
    y = rec[:, 0].to(torch.float32)
    dense = torch.log1p(rec[:, 1:1 + NUM_DENSE].clamp_min(0)
                        .to(torch.float32))
    xc = rec[:, 1 + NUM_DENSE:]
    if max_ind_range > 0:
        xc = torch.remainder(xc, max_ind_range)
    return dense, xc.contiguous(), y


def make_synthetic_criteo_txt(path: str, n: int = 1000, seed: int = 0,
                              vocab: Union[int, Sequence[int]] = 50) -> str:
    """Write a raw-format train.txt of `n` lines from `seed`: labels 1 with
    probability 0.25, dense values in [-2, 100) (10% missing), categories
    in [0, vocab) as hex (5% missing).  `vocab` is one bound for every
    column, or one a column (26), e.g. the model's table sizes capped,
    so that every table's ids stay inside it.  With one bound the file is
    the JAX package's byte for byte."""
    rng = np.random.default_rng(seed)
    vocabs = ([int(vocab)] * NUM_SPARSE if np.ndim(vocab) == 0
              else [int(v) for v in vocab])
    if len(vocabs) != NUM_SPARSE:
        raise ValueError(f"{len(vocabs)} vocabularies for {NUM_SPARSE} "
                         "categorical columns")
    with open(path, "w") as f:
        for _ in range(n):
            label = int(rng.random() < 0.25)
            dense = [str(int(rng.integers(-2, 100))) if rng.random() > 0.1
                     else "" for _ in range(NUM_DENSE)]
            cats = [format(int(rng.integers(0, v)), "x")
                    if rng.random() > 0.05 else "" for v in vocabs]
            f.write("\t".join([str(label)] + dense + cats) + "\n")
    return path
