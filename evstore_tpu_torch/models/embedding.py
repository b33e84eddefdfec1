"""Embedding tables: initialization, lookup, bags, and the qr/md tricks.

Port of `evstore_tpu/models/embedding.py`.  Each plain table is
initialised U(-sqrt(1/n), sqrt(1/n)) (dlrm_s_pytorch.py:278-283); the qr
tables (tricks/qr_embedding_bag.py) and md tables with their projection
(tricks/md_embedding_bag.py) follow the JAX package's laws, drawn from a
numpy generator.  A table is one of three kinds, as in the JAX package's
`table_t` entries: `kind_plain` (a tensor [n, D]), `kind_qr` (`QRTable`,
q and r) and `kind_md` (`MDTable`, table and an optional proj); a plain
table may carry per-row pooling weights `pool_w` [n, 1].

A lookup reads ids [B, T] (one-hot) or [B, T, L] (multi-hot bags, padded
with id 0 and weight 0, sum-pooled with optional bag weights [B, T, L]),
or, under a config's `multi_hot_sizes` L_t, [B, sum L_t]: table t's bag
in its L_t consecutive columns, in table order, with no padded slot
(MLPerf's DLRM-DCNv2 bags: 214 ids a sample, where padding every table to
the longest bag would read 2,600).
Every row it reads comes from a table through the grouped row-gather
kernel (`ops/cuda_gather.py`): the ids of the bags of every table become
one [B·L, S] index over the S row sources (a plain table, q, r, an md
table, pool_w), and the sources of one width go through one launch.  The
combination (pool_w, the qr op, the md projection as a `torch.matmul`,
the pooling) is plain PyTorch, as it is XLA in the JAX package.  The
gathered rows are not differentiable in the tables: the train step
(`train/train_loop.py`) differentiates with respect to them and applies
row updates.

Ids outside [0, N) are a deliberate departure from the JAX package, which
is not consistent with itself there (its `take_rows` clips them, its
one-hot lookup gives a zero row, its `row_update` wraps negative ids, its
tier engine raises).  The port's rule: where ids are still numpy arrays on
the host (`run_inference`, the device caches' `lookup_batch`, `train`,
`evaluate`), `check_ids` raises `ValueError`, at no device sync.  On device
tensors nothing is checked: a gather gives a zero row (kernels and plain
versions alike) and a row update leaves the table alone.
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from evstore_tpu_torch.ops.cuda_gather import gather_rows_grouped
from evstore_tpu_torch.ops.table_desc import column_tables

# the parts of a factorised (qr or md) table, which the JAX package
# updates with its dense branch
FACT_PARTS = ("q", "r", "md")


def _uniform(rng: np.random.Generator, shape, bound: float) -> np.ndarray:
    """U(-bound, bound) float32, built in place (no float64 temporary)."""
    t = rng.random(shape, dtype=np.float32)
    t *= np.float32(2 * bound)
    t -= np.float32(bound)
    return t


def init_embedding_tables(table_sizes: Sequence[int], dim: int,
                          rng: np.random.Generator) -> List[np.ndarray]:
    """Float32 [n, dim] tables drawn from `rng`, U(-sqrt(1/n), sqrt(1/n)).
    Built in place, so a multi-GB table needs no float64 temporary."""
    return [_uniform(rng, (n, dim), np.sqrt(1.0 / n)) for n in table_sizes]


# the ids a regrouped row of `_unsigned_in_range` holds, about: numpy's
# reduction then runs along a long inner loop
_RUN = 2048


def _unsigned_in_range(idx: np.ndarray, sizes: np.ndarray) -> bool:
    """True if idx [B, C, ...] is int32 or int64 and every id, viewed as
    the unsigned type of its width, is below the limit of its column;
    False otherwise (an id outside its table, or another dtype).  `sizes`
    holds one limit per column of idx's second axis: a table's size for
    one id a table ([B, T]) or bags padded to one L ([B, T, L]), and for
    bags of a length per table ([B, sum L_t]) the size of the table that
    owns the column.

    A negative id viewed unsigned is at least 2^31 (2^63), above every size
    of that width, so one unsigned compare covers both ends of [0, N).  A
    size is clamped at 0 and, for int32 ids, at 2^31 (a larger table holds
    every int32 id).  A C-contiguous array is read as rows of about `_RUN`
    ids (k of its rows each; the last B mod k rows apart), and its column
    maxima, folded to the r ids of one of its rows, meet the limits in
    that compare, each column's limit repeated over the r / C ids that the
    trailing axes give the column: numpy's reduction runs along long rows,
    reads the ids once and writes no temporary of their size.  Any other
    layout is compared elementwise with the limits broadcast."""
    if idx.dtype == np.int32:
        utype, lim = np.uint32, np.clip(sizes, 0, 2 ** 31)
    elif idx.dtype == np.int64:
        utype, lim = np.uint64, np.maximum(sizes, 0)
    else:
        return False
    if idx.size == 0:
        return True
    u, lim = idx.view(utype), lim.astype(utype)
    if not u.flags.c_contiguous:
        shape = (1, -1) + (1,) * (idx.ndim - 2)
        return bool(np.less(u, lim.reshape(shape)).all())
    B = u.shape[0]
    rows = u.reshape(B, -1)
    r = rows.shape[1]
    k = max(1, min(B, _RUN // r))
    m = B // k
    top = rows[:m * k].reshape(m, k * r).max(axis=0)
    top = top.reshape(k, r).max(axis=0)
    if m * k < B:
        np.maximum(top, rows[m * k:].max(axis=0), out=top)
    # the limit of each of a row's r ids: its column's, over the trailing
    # axes
    return bool(np.less(top, np.repeat(lim, r // lim.size)).all())


def check_ids(idx: np.ndarray, table_sizes: Sequence[int],
              bag_sizes: Sequence[int] = ()) -> None:
    """Raise ValueError unless every id of idx (host numpy) lies in
    [0, table_sizes[t]) for its table t: idx [B, T, ...], or with
    `bag_sizes` (a length L_t per table) idx [B, sum L_t], whose columns
    [sum_{s<t} L_s, sum_{s<=t} L_s) hold table t's bag.

    Signed 32- and 64-bit ids take one unsigned compare against each
    column's limit (`_unsigned_in_range`), at about the speed of reading
    them.  Where that finds an id outside its table, and for every other
    dtype, the signed test `(idx < 0) | (idx >= N)` over every id finds the
    first one in C order, for the message, which names its table."""
    idx = np.asarray(idx)
    sizes = np.asarray(table_sizes, np.int64)
    if bag_sizes:
        cols = np.repeat(np.arange(sizes.size), np.asarray(bag_sizes))
        if idx.ndim != 2 or idx.shape[1] != cols.size or \
                len(bag_sizes) != sizes.size:
            raise ValueError(f"ids of shape {idx.shape} do not match "
                             f"{sizes.size} tables' bags of "
                             f"{tuple(bag_sizes)}, {cols.size} ids a sample")
    else:
        cols = np.arange(sizes.size)
        if idx.ndim < 2 or idx.shape[1] != sizes.size:
            raise ValueError(f"ids of shape {idx.shape} do not match "
                             f"{sizes.size} tables")
    limits = sizes[cols]
    if _unsigned_in_range(idx, limits):
        return
    limits = limits.reshape(1, -1, *([1] * (idx.ndim - 2)))
    bad = (idx < 0) | (idx >= limits)
    if bad.any():
        pos = tuple(np.argwhere(bad)[0])
        t = int(cols[pos[1]])
        raise ValueError(f"row id {int(idx[pos])} of table {t} is "
                         f"outside [0, {int(sizes[t])})")


def pool_bags(rows: torch.Tensor, weights: Optional[torch.Tensor]
              ) -> torch.Tensor:
    """Sum-pool multi-hot bags: rows [B, L, D] (+ optional weights
    [B, L]) -> [B, D], `EmbeddingBag(mode="sum", per_sample_weights=w)`
    with a static bag size L (dlrm_s_pytorch.py:407-459); or every table
    at once, rows [B, L, T, D] and weights [B, L, T] -> [B, T, D]."""
    if weights is not None:
        rows = rows * weights[..., None].to(rows.dtype)
    return rows.sum(dim=1)


# ------------------------------------------------------------ QR trick

def init_qr_tables(num_rows: int, dim: int, collisions: int,
                   operation: str, rng: np.random.Generator
                   ) -> Dict[str, np.ndarray]:
    """Quotient-remainder tables (tricks/qr_embedding_bag.py:25-185): q
    has ceil(n/c) rows, r has c rows; concat splits the width."""
    num_q = -(-num_rows // collisions)
    dq = dim // 2 if operation == "concat" else dim
    dr = dim - dq if operation == "concat" else dim
    return {"q": _uniform(rng, (num_q, dq), np.sqrt(1.0 / num_q)),
            "r": _uniform(rng, (collisions, dr), np.sqrt(1.0 / collisions))}


def qr_combine(q: torch.Tensor, r: torch.Tensor, operation: str
               ) -> torch.Tensor:
    if operation == "mult":
        return q * r
    if operation == "add":
        return q + r
    if operation == "concat":
        return torch.cat([q, r], dim=-1)
    raise ValueError(f"unsupported qr operation {operation}")


def qr_lookup(qr, idx: torch.Tensor, collisions: int,
              operation: str = "mult") -> torch.Tensor:
    """idx [K] -> [K, D] (tricks/qr_embedding_bag.py:156-174); `qr` is a
    `QRTable` or a mapping with "q" and "r"."""
    q, r = (qr.q, qr.r) if isinstance(qr, nn.Module) else (qr["q"], qr["r"])
    idx = idx.long()
    return qr_combine(torch.index_select(q, 0, idx // collisions),
                      torch.index_select(r, 0, idx % collisions), operation)


# ------------------------------------------------------------ MD trick

def md_solver(sizes: np.ndarray, alpha: float, d0: Optional[int] = None,
              round_dim: bool = False) -> np.ndarray:
    """Mixed-dimension alpha-power rule (tricks/md_embedding_bag.py:20-61):
    d_i = d0 * (n_i / n_max)^alpha capped at d0 and at least 1, n sorted
    descending.  A copy of the JAX package's function, sign convention
    included: `init_sparse_arch` passes alpha = -md_temperature, so the
    default temperature 0.3 gives every table d0."""
    sizes = np.asarray(sizes, dtype=np.float64)
    order = np.argsort(-sizes)
    n_sorted = sizes[order]
    if d0 is None:
        raise ValueError("d0 (base dim) required")
    p = n_sorted / n_sorted[0]
    d = d0 * np.power(p, alpha)
    d = np.maximum(d, 1)
    if round_dim:
        d = np.power(2, np.round(np.log2(d))).astype(np.int64)
    d = np.minimum(d, d0).astype(np.int64)
    out = np.empty_like(d)
    out[order] = d
    return out


def init_md_table(num_rows: int, base_dim: int, md_dim: int,
                  rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """PrEmbeddingBag (tricks/md_embedding_bag.py:63-81): [n, md_dim] and,
    below the base width, a [md_dim, base_dim] projection (no bias)."""
    tab = _uniform(rng, (num_rows, md_dim), np.sqrt(1.0 / num_rows))
    if md_dim == base_dim:
        return {"table": tab}
    return {"table": tab, "proj": _uniform(
        rng, (md_dim, base_dim), np.sqrt(2.0 / (md_dim + base_dim)))}


def md_lookup(md, idx: torch.Tensor) -> torch.Tensor:
    """idx [K] -> [K, D]: the md row, times proj where there is one."""
    table, proj = ((md.table, md.proj) if isinstance(md, nn.Module)
                   else (md["table"], md.get("proj")))
    rows = torch.index_select(table, 0, idx.long())
    return rows if proj is None else torch.matmul(rows, proj)


# ------------------------------------------------ the sparse arch's kinds

def table_kinds(cfg) -> List[Tuple[str, int]]:
    """Per table: ("plain" | "qr" | "md", its row width), by the JAX
    package's rule (`init_sparse_arch`): qr above qr_threshold rows, else md
    above md_threshold, else plain.  An md table's width comes from
    `md_solver(sizes, -md_temperature)`; a qr table's is q's."""
    md_dims = (md_solver(np.asarray(cfg.table_sizes), -cfg.md_temperature,
                         d0=cfg.embedding_dim, round_dim=cfg.md_round_dims)
               if cfg.md_flag else None)
    out = []
    for t, n in enumerate(cfg.table_sizes):
        if cfg.qr_flag and n > cfg.qr_threshold:
            out.append(("qr", cfg.embedding_dim // 2
                        if cfg.qr_operation == "concat"
                        else cfg.embedding_dim))
        elif cfg.md_flag and n > cfg.md_threshold:
            out.append(("md", int(md_dims[t])))
        else:
            out.append(("plain", cfg.embedding_dim))
    return out


def init_sparse_arch(cfg, rng: np.random.Generator) -> List[Dict]:
    """The sparse side as numpy arrays in the JAX package's per-table layout
    ({"kind_plain": [n, D][, "pool_w": [n, 1]]}, {"kind_qr": {"q", "r"}},
    {"kind_md": {"table"[, "proj"]}}), drawn from `rng` table by table.
    `pool_w` starts at ones (dlrm_s_pytorch.py:284-293)."""
    out = []
    for n, (kind, dim) in zip(cfg.table_sizes, table_kinds(cfg)):
        if kind == "qr":
            out.append({"kind_qr": init_qr_tables(
                n, cfg.embedding_dim, cfg.qr_collisions, cfg.qr_operation,
                rng)})
        elif kind == "md":
            out.append({"kind_md": init_md_table(n, cfg.embedding_dim, dim,
                                                 rng)})
        else:
            entry = {"kind_plain": _uniform(rng, (n, cfg.embedding_dim),
                                            np.sqrt(1.0 / n))}
            if cfg.weighted_pooling:
                entry["pool_w"] = np.ones((n, 1), np.float32)
            out.append(entry)
    return out


class QRTable(nn.Module):
    """JAX `kind_qr`: q [ceil(n/c), dq] and r [c, dr], updated by rows."""

    def __init__(self, q: torch.Tensor, r: torch.Tensor):
        super().__init__()
        self.q = nn.Parameter(q, requires_grad=False)
        self.r = nn.Parameter(r, requires_grad=False)


class MDTable(nn.Module):
    """JAX `kind_md`: table [n, md_dim], updated by rows, and, below the
    base width, proj [md_dim, D], trained by autograd with the MLPs."""

    def __init__(self, table: torch.Tensor, proj: Optional[torch.Tensor]):
        super().__init__()
        self.table = nn.Parameter(table, requires_grad=False)
        self.proj = None if proj is None else nn.Parameter(proj)


# ------------------------------------------------------ the row sources

class RowSource(NamedTuple):
    """One table the lookup gathers rows from.  `name` is its parameter's
    name in the `DLRM` (and its optimizer state's key); a row of table
    `table`'s id k is row (k // div) % mod of `param` (mod 0: none)."""
    name: str
    table: int
    part: str                   # plain | q | r | md | pool_w
    rows: int
    width: int
    div: int = 1
    mod: int = 0
    param: Optional[torch.Tensor] = None


def row_sources(cfg, entries: Optional[Sequence] = None,
                pool_w: Optional[Dict[int, torch.Tensor]] = None
                ) -> List[RowSource]:
    """The row sources of the sparse arch, table by table (plain; q, r;
    md), then the pooling weights.  `entries` holds per table a tensor
    (plain), a `QRTable` or an `MDTable`, with `pool_w` {t: [n, 1]}; with
    no entries, the shapes come from `cfg` and `param` is None."""
    out: List[RowSource] = []
    n_plain = 0
    kinds = table_kinds(cfg)
    for t, (n, (kind, dim)) in enumerate(zip(cfg.table_sizes, kinds)):
        e = None if entries is None else entries[t]
        if isinstance(e, QRTable) or (e is None and kind == "qr"):
            c = cfg.qr_collisions
            for part, p, rows, w, div, mod in (
                    ("q", None if e is None else e.q, -(-n // c), dim, c, 0),
                    ("r", None if e is None else e.r, c,
                     cfg.embedding_dim - dim if cfg.qr_operation == "concat"
                     else dim, 1, c)):
                if p is not None:
                    rows, w = p.shape
                out.append(RowSource(f"qr.{t}.{part}", t, part, rows, w, div,
                                     mod, p))
        elif isinstance(e, MDTable) or (e is None and kind == "md"):
            p = None if e is None else e.table
            rows, w = (n, dim) if p is None else p.shape
            out.append(RowSource(f"md.{t}.table", t, "md", rows, w, param=p))
        else:
            rows, w = (n, cfg.embedding_dim) if e is None else e.shape
            out.append(RowSource(f"tables.{n_plain}", t, "plain", rows, w,
                                 param=e))
            n_plain += 1
    if entries is None:
        pool = ({t: None for t, (k, _) in enumerate(kinds) if k == "plain"}
                if cfg.weighted_pooling else {})
    else:
        pool = pool_w or {}
    for t, p in sorted(pool.items()):
        out.append(RowSource(f"pool_w.{t}", t, "pool_w",
                             cfg.table_sizes[t] if p is None else p.shape[0],
                             1, param=p))
    return out


def gather_groups(sources: Sequence[RowSource]) -> List[List[int]]:
    """The sources gathered together: one group for each width (the
    pooling weights in a group of their own), in order of first
    appearance; within a group, the plain tables' rows before the
    factorised ones', each in table order."""
    groups: Dict[Tuple[int, bool], List[int]] = {}
    for i, s in enumerate(sources):
        groups.setdefault((s.width, s.part == "pool_w"), []).append(i)
    return [sorted(m, key=lambda i: sources[i].part in FACT_PARTS)
            for m in groups.values()]


def bag_columns(cfg, idx) -> Tuple[int, ...]:
    """The table of each column of idx under bags of a length per table
    (`cfg.multi_hot_sizes` and a 2-D idx), () otherwise; ValueError for a
    2-D idx of another width."""
    cols = cfg.bag_columns() if idx.ndim == 2 else ()
    if cols and idx.shape[1] != len(cols):
        raise ValueError(f"ids of shape {tuple(idx.shape)} do not match the "
                         f"bags of {tuple(cfg.multi_hot_sizes)}, "
                         f"{len(cols)} ids a sample")
    return cols


def flat_ids(idx: torch.Tensor) -> torch.Tensor:
    """[B, T] ids as they are, or [B, T, L] bags as [B·L, T] (row b·L + l
    holds slot l of sample b), int32 and contiguous."""
    if idx.dim() == 3:
        idx = idx.transpose(1, 2).reshape(-1, idx.shape[1])
    return idx.to(torch.int32).contiguous()


def group_ids(sources: Sequence[RowSource], members: Sequence[int],
              flat: torch.Tensor, columns: Sequence[int] = ()
              ) -> torch.Tensor:
    """The int32 index [R, S] of one gather group.  Each run of members
    that read consecutive columns of `flat` alike (one div and mod) is one
    slice of it, so a group of every table's plain rows is `flat` itself.
    Under bags of a length per table (`columns`, the table of each of
    flat's columns), the one group of every plain table takes `flat`
    whole."""
    if columns:
        return flat
    runs: List[List[RowSource]] = []
    for s in (sources[i] for i in members):
        p = runs[-1][-1] if runs else None
        if p is not None and (s.table, s.div, s.mod) == (p.table + 1, p.div,
                                                         p.mod):
            runs[-1].append(s)
        else:
            runs.append([s])
    blocks = []
    for run in runs:
        s = run[0]
        ids = flat[:, s.table:s.table + len(run)]
        if s.div != 1:
            ids = torch.div(ids, s.div, rounding_mode="floor")
        if s.mod:
            ids = torch.remainder(ids, s.mod)
        blocks.append(ids)
    return (blocks[0] if len(blocks) == 1
            else torch.cat(blocks, dim=1)).contiguous()


def gather_rows_of(sources: Sequence[RowSource],
                   groups: Sequence[Sequence[int]],
                   ids_of: Sequence[torch.Tensor],
                   use_kernel: bool,
                   columns: Sequence[int] = ()) -> List[torch.Tensor]:
    """One tensor [R, S, width] per gather group, from its index
    (`group_ids`): one launch of the grouped row-gather kernel each, or
    with `use_kernel` off an `index_select` per source.  Under bags of a
    length per table (`columns`), column c of the index reads member
    columns[c]: the tables' list repeats each table once a column, and
    the [R, sum L_t] index gathers [R, sum L_t, width] rows, one a slot."""
    out = []
    for members, ids in zip(groups, ids_of):
        params = [sources[i].param for i in members]
        if columns:
            params = [params[t] for t in columns]
        if use_kernel:
            out.append(gather_rows_grouped(params, ids))
        else:
            out.append(torch.stack([
                torch.index_select(p, 0, ids[:, j].long())
                for j, p in enumerate(params)], dim=1))
    return out


@functools.lru_cache(maxsize=16)
def _bag_lengths(sizes: Tuple[int, ...], B: int, dev: torch.device
                 ) -> torch.Tensor:
    """The [B, T] bag lengths `torch.segment_reduce` takes, on `dev`."""
    return torch.tensor(sizes, dtype=torch.int64,
                        device=dev).expand(B, -1).contiguous()


class _PoolColumns(torch.autograd.Function):
    """rows [B, sum L_t, D] -> [B, T, D], each table's L_t consecutive
    rows summed in order (`torch.segment_reduce`, no atomics); the
    backward hands each slot its table's cotangent."""

    @staticmethod
    def forward(ctx, rows, sizes):
        if rows.shape[1] != sum(sizes):
            raise ValueError(f"rows of {rows.shape[1]} slots a sample for "
                             f"bags of {sizes}")
        ctx.cols = column_tables(
            tuple(t for t, n in enumerate(sizes) for _ in range(n)),
            rows.device)
        # the lengths are checked above, on the host: `unsafe` skips
        # segment_reduce's own check, which reads them back from the
        # device and so waits for it
        return torch.segment_reduce(
            rows, "sum", lengths=_bag_lengths(sizes, rows.shape[0],
                                              rows.device), axis=1,
            unsafe=True)

    @staticmethod
    def backward(ctx, g):
        return g.index_select(1, ctx.cols), None


def pool_columns(rows: torch.Tensor, sizes: Sequence[int],
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum-pool bags of a length per table: rows [B, sum L_t, D], table
    t's L_t slots consecutive in table order (+ optional weights
    [B, sum L_t]) -> [B, T, D].  Bags of one id each are the rows as they
    are."""
    if weights is not None:
        rows = rows * weights[..., None].to(rows.dtype)
    if rows.shape[1] == len(sizes):
        return rows
    return _PoolColumns.apply(rows, tuple(int(n) for n in sizes))


def combine_rows(cfg, sources: Sequence[RowSource],
                 groups: Sequence[Sequence[int]],
                 gathered: Sequence[torch.Tensor], entries: Sequence,
                 shape: Tuple[int, ...],
                 bag_weights: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """The gathered rows -> [B, T, D] (`shape` is idx's): pool_w, the qr
    op and the md projection per table, then the bags' weighted sums, as
    the JAX package's `sparse_arch_lookup` computes them; under bags of a
    length per table (an idx [B, sum L_t] and `cfg.multi_hot_sizes`), the
    one group's [B, sum L_t, D] rows pooled table by table.
    Differentiable in `gathered` and the md projections."""
    if len(shape) == 2 and cfg.multi_hot_sizes:
        return pool_columns(gathered[0], cfg.multi_hot_sizes, bag_weights)
    T = cfg.num_tables
    col = {}
    for members, got in zip(groups, gathered):
        for i, c in zip(members, got.unbind(1)):
            col[(sources[i].table, sources[i].part)] = c
    weighted = [t for t in range(T) if (t, "pool_w") in col]
    if weighted:        # the pooling weights of all tables in one product
        prod = (torch.stack([col[(t, "plain")] for t in weighted], dim=1)
                * torch.stack([col[(t, "pool_w")] for t in weighted], dim=1))
        for t, c in zip(weighted, prod.unbind(1)):
            col[(t, "plain")] = c
    per_table = []
    for t in range(T):
        e = entries[t]
        if isinstance(e, QRTable):
            r = qr_combine(col[(t, "q")], col[(t, "r")], cfg.qr_operation)
        elif isinstance(e, MDTable):
            r = col[(t, "md")]
            if e.proj is not None:
                r = torch.matmul(r, e.proj)
        else:
            r = col[(t, "plain")]
        per_table.append(r)
    rows = torch.stack(per_table, dim=1)
    if len(shape) == 2:
        return rows
    B, _, L = shape
    return pool_bags(rows.reshape(B, L, T, -1), None if bag_weights is None
                     else bag_weights.transpose(1, 2))


def sparse_arch_lookup(tables: Sequence, idx: torch.Tensor, cfg,
                       bag_weights: Optional[torch.Tensor] = None,
                       pool_w: Optional[Dict[int, torch.Tensor]] = None
                       ) -> torch.Tensor:
    """idx [B, T] (or [B, T, L] bags with optional bag_weights [B, T, L],
    or under `cfg.multi_hot_sizes` [B, sum L_t] bags of a length per table
    with optional bag_weights of that shape) -> [B, T, D].  `tables` holds
    per table a tensor [n, D] (plain), a `QRTable` or an `MDTable`;
    `pool_w` {t: [n, 1]} weighs plain tables' rows.  With
    `use_gather_kernel` on, one launch of the grouped gather kernel per
    width; off, an `index_select` per source."""
    if idx.dim() not in (2, 3):
        raise ValueError(f"idx must be [B, T] or [B, T, L], got "
                         f"{tuple(idx.shape)}")
    sources = row_sources(cfg, tables, pool_w)
    groups = gather_groups(sources)
    flat = flat_ids(idx)
    cols = bag_columns(cfg, idx)
    gathered = gather_rows_of(sources, groups,
                              [group_ids(sources, m, flat, cols)
                               for m in groups],
                              cfg.use_gather_kernel, cols)
    return combine_rows(cfg, sources, groups, gathered, tables,
                        tuple(idx.shape), bag_weights)
