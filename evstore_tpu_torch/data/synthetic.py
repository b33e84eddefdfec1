"""Random request streams for serving and training.

A copy of `RandomDataConfig`, `random_batches` and `learnable_batches` from
`evstore_tpu/data/synthetic.py`: one-hot or multi-hot bags
(`num_indices_per_lookup`, with bag sizes U[1, L] or exactly L), uniform or
gaussian dense features.  The same config and seed give the same batches
as the JAX package: the calls on the numpy generator are the same, in the
same order.  The `zipf` and `grouped_zipf` streams carry the skew EVStore's
cache exploits; `grouped_zipf` draws one popularity rank per request (and
bag slot) and shares it across all tables (cache_algo/EvLFU_C1.py:97-161).
The `gaussian` stream draws ids from N(mu, sigma) clipped to [min, max]
(generate_dist_input_batch, dlrm_data_pytorch.py:1046-1051); in a bag, a
slot that repeats an earlier slot's id gets weight 0, the static-shape form
of the reference's `np.unique` of each bag.

The trace streams are copies too: `trace_profile` (an access trace's LRU
stack-distance CDF), `trace_generate_lru` (a trace drawn from such a CDF),
`trace_batches` (batches whose ids follow one such trace per table, the
reference's `--data-generation=synthetic`) and `quality_fixture` (the
tier-quality workload: piecewise-smooth tables, alt keys at each bucket's
representative, grouped_zipf ids, labels from a hidden score).  Numpy
only; the same arguments give the JAX package's arrays bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

# (dense, idx [B, T], labels), or with bags (dense, idx [B, T, L],
# bag_weights [B, T, L], labels)
Batch = Tuple[np.ndarray, ...]


@dataclasses.dataclass
class RandomDataConfig:
    num_dense: int = 13
    table_sizes: Sequence[int] = (4, 3, 2)
    batch_size: int = 128
    num_batches: int = 100
    seed: int = 123
    # uniform | zipf | grouped_zipf | gaussian
    distribution: str = "uniform"
    zipf_alpha: float = 1.05
    # grouped_zipf: resample a table's id independently with this probability
    group_noise: float = 0.1
    rand_data_mu: float = -1.0        # reference --rand-data-* flags
    rand_data_sigma: float = 1.0
    # the gaussian ids' bounds: mu == -1 means (min + max) / 2, max == -1
    # means the table's last row
    rand_data_min: float = 0.0
    rand_data_max: float = -1.0
    dense_dist: str = "uniform"       # uniform | gaussian (|N(mu, sigma)|)
    # multi-hot bags (reference --num-indices-per-lookup[-fixed],
    # dlrm_data_pytorch.py:1062-1120): L > 1 yields (dense, idx [B, T, L],
    # bag_weights [B, T, L], labels), bag sizes U[1, L] (exactly L when
    # fixed), padded with weight 0
    num_indices_per_lookup: int = 1
    num_indices_per_lookup_fixed: bool = False


def _sample_indices(rng: np.random.Generator, n: int, size: int,
                    cfg: RandomDataConfig) -> np.ndarray:
    if cfg.distribution == "uniform" or size <= 2:
        return rng.integers(0, size, n, dtype=np.int64)
    if cfg.distribution == "gaussian":
        lo = cfg.rand_data_min
        hi = cfg.rand_data_max if cfg.rand_data_max >= 0 else float(size - 1)
        hi = min(hi, float(size - 1))
        mu = cfg.rand_data_mu if cfg.rand_data_mu != -1 else (lo + hi) / 2.0
        r = rng.normal(mu, cfg.rand_data_sigma, n)
        return np.clip(r, lo, hi).astype(np.int64)
    # bounded Zipf via the continuous inverse-CDF approximation
    a = cfg.zipf_alpha
    if abs(a - 1.0) < 1e-6:
        a = 1.0 + 1e-6
    u = rng.random(n)
    n_pow = float(size) ** (1.0 - a)
    r = ((n_pow - 1.0) * u + 1.0) ** (1.0 / (1.0 - a)) - 1.0
    return np.clip(r.astype(np.int64), 0, size - 1)


def random_batches(cfg: RandomDataConfig) -> Iterator[Batch]:
    """Yields (dense [B, num_dense] f32, idx [B, T] int32, labels [B] f32),
    or with bags (dense, idx [B, T, L] int32, bag_weights [B, T, L] f32,
    labels)."""
    if cfg.distribution not in ("uniform", "zipf", "grouped_zipf",
                                "gaussian"):
        raise ValueError(f"unsupported distribution {cfg.distribution!r}")
    if cfg.dense_dist not in ("uniform", "gaussian"):
        raise ValueError(f"unsupported dense_dist {cfg.dense_dist!r}")
    rng = np.random.default_rng(cfg.seed)
    sizes = list(cfg.table_sizes)
    # per-table rank -> id scattering for the zipf modes: a permutation for
    # small tables, r*p mod n (gcd(p, n) = 1) for huge ones
    perms = None
    if cfg.distribution in ("zipf", "grouped_zipf"):
        perms = []
        for s in sizes:
            if s <= (1 << 20):
                perms.append(("perm", rng.permutation(s)))
            else:
                p = 1_000_003
                while np.gcd(p, s) != 1:
                    p += 2
                perms.append(("mul", p))
    L = max(int(cfg.num_indices_per_lookup), 1)
    for _ in range(cfg.num_batches):
        if cfg.dense_dist == "gaussian":
            dense = np.abs(rng.normal(cfg.rand_data_mu, cfg.rand_data_sigma,
                                      (cfg.batch_size, cfg.num_dense)))
        else:
            dense = rng.random((cfg.batch_size, cfg.num_dense))
        idx = np.empty((cfg.batch_size, len(sizes), L), dtype=np.int32)
        shared_rank = None
        if cfg.distribution == "grouped_zipf":
            # one popularity rank per (sample, bag slot), shared by tables
            shared_rank = _sample_indices(rng, cfg.batch_size * L,
                                          max(sizes), cfg)
        for t, s in enumerate(sizes):
            if shared_rank is not None:
                raw = shared_rank % s
                if cfg.group_noise > 0.0:
                    flip = rng.random(raw.shape[0]) < cfg.group_noise
                    raw = np.where(flip,
                                   _sample_indices(rng, raw.shape[0], s, cfg),
                                   raw)
            else:
                raw = _sample_indices(rng, cfg.batch_size * L, s, cfg)
            if perms is not None:
                kind, p = perms[t]
                if kind == "perm":
                    raw = p[np.minimum(raw, s - 1)]
                else:
                    raw = (raw * p) % s
            idx[:, t, :] = raw.astype(np.int32).reshape(cfg.batch_size, L)
        labels = rng.integers(0, 2, cfg.batch_size).astype(np.float32)
        if L == 1:
            yield dense.astype(np.float32), idx[:, :, 0], labels
            continue
        if cfg.num_indices_per_lookup_fixed:
            bag_w = np.ones((cfg.batch_size, len(sizes), L), np.float32)
        else:
            sz = rng.integers(1, L + 1, (cfg.batch_size, len(sizes)))
            bag_w = (np.arange(L)[None, None, :] < sz[..., None]
                     ).astype(np.float32)
        if cfg.distribution == "gaussian":
            # weight 0 for a slot that repeats an earlier slot's id
            dup = ((idx[:, :, :, None] == idx[:, :, None, :])
                   & (np.arange(L)[None, None, :, None]
                      > np.arange(L)[None, None, None, :])).any(axis=3)
            bag_w = bag_w * (~dup)
        yield dense.astype(np.float32), idx, bag_w, labels


def learnable_batches(cfg: RandomDataConfig, hidden_seed: int = 42
                      ) -> Iterator[Batch]:
    """Random inputs with labels drawn from a hidden linear model, so that a
    DLRM can reduce its loss: the fixture of the 'training learns' checks.
    The hidden model comes from `hidden_seed`, independent of `cfg.seed`, so
    train and eval streams with different data seeds share it."""
    hidden = np.random.default_rng(hidden_seed)
    w_dense = hidden.normal(0, 1, (cfg.num_dense,))
    tables = [hidden.normal(0, 1.5, (s,)) for s in cfg.table_sizes]
    rng = np.random.default_rng(cfg.seed + 1)
    for dense, idx, _ in random_batches(cfg):
        score = dense @ w_dense
        for t, tab in enumerate(tables):
            score = score + tab[idx[:, t]]
        p = 1.0 / (1.0 + np.exp(-score))
        labels = (rng.random(cfg.batch_size) < p).astype(np.float32)
        yield dense, idx, labels


def trace_profile(trace: Sequence[int], max_unique: Optional[int] = None):
    """LRU stack-distance profile of an access trace
    (dlrm_data_pytorch.trace_profile:1221): (distances, cdf), the empirical
    CDF of the reuse stack distances, a cold miss at distance len(stack).
    With `max_unique` the stack drops its oldest entry past that size."""
    stack: list = []
    pos = {}
    distances = []
    for x in trace:
        if x in pos:
            i = stack.index(x)            # depth from the top
            d = len(stack) - 1 - i
            stack.pop(i)
            stack.append(x)
            distances.append(d)
        else:
            distances.append(len(stack))  # cold
            stack.append(x)
            pos[x] = True
        if max_unique and len(stack) > max_unique:
            victim = stack.pop(0)
            del pos[victim]
    vals, counts = np.unique(distances, return_counts=True)
    cdf = np.cumsum(counts) / len(distances)
    return vals, cdf


def trace_generate_lru(line_accesses: np.ndarray, dist_vals: np.ndarray,
                       dist_cdf: np.ndarray, n: int, seed: int = 0
                       ) -> np.ndarray:
    """A trace of `n` accesses with the LRU stack-distance CDF (dist_vals,
    dist_cdf) over the pool `line_accesses`
    (dlrm_data_pytorch.trace_generate_lru:1168): each access draws a
    distance; within the stack it reuses that depth (moved to the top),
    beyond it takes the pool's next fresh address, or a random one of the
    pool once every address was used."""
    rng = np.random.default_rng(seed)
    pool = list(line_accesses)
    stack: list = []
    out = np.empty(n, np.int64)
    fresh = 0
    for i in range(n):
        u = rng.random()
        d = int(dist_vals[np.searchsorted(dist_cdf, u, side="left")
                          % len(dist_vals)])
        if d < len(stack):
            x = stack.pop(len(stack) - 1 - d)
        elif fresh < len(pool):
            x = pool[fresh]
            fresh += 1
        else:
            x = pool[rng.integers(0, len(pool))]
            if x in stack:
                stack.remove(x)
        stack.append(x)
        out[i] = x
    return out


def trace_batches(cfg: RandomDataConfig, dist_vals=None, dist_cdf=None
                  ) -> Iterator[Batch]:
    """(dense, idx [B, T] int32, labels) batches whose ids follow one LRU
    stack-distance trace per table (the reference's
    --data-generation=synthetic, dlrm_data_pytorch.py:1011-1345).  The
    default CDF puts 80% of reuses within the top 64 stack entries."""
    if dist_vals is None:
        dist_vals = np.array([0, 1, 2, 4, 8, 16, 32, 64, 256, 1 << 30])
        dist_cdf = np.array([0.2, 0.35, 0.45, 0.55, 0.65, 0.72, 0.78, 0.83,
                             0.92, 1.0])
    rng = np.random.default_rng(cfg.seed)
    n_total = cfg.batch_size * cfg.num_batches
    cols = []
    for t, s in enumerate(cfg.table_sizes):
        pool = rng.permutation(s)
        cols.append(trace_generate_lru(pool, dist_vals, dist_cdf, n_total,
                                       seed=cfg.seed + t))
    idx_all = np.stack(cols, axis=1).astype(np.int32)
    for b in range(cfg.num_batches):
        dense = rng.random((cfg.batch_size, cfg.num_dense)).astype(np.float32)
        labels = rng.integers(0, 2, cfg.batch_size).astype(np.float32)
        yield (dense, idx_all[b * cfg.batch_size:(b + 1) * cfg.batch_size],
               labels)


def quality_fixture(table_sizes: Sequence[int], dim: int = 36,
                    bucket: int = 32, scale: float = 4.0, seed: int = 0,
                    batch_size: int = 512, num_batches: int = 60,
                    zipf_alpha: float = 1.05, group_noise: float = 0.1,
                    label_seed: int = 7):
    """The tier-quality workload, whose exact rows reach an AUC of about
    0.80 (the reference anchors its accuracy at ~0.8056,
    experiments.md:959-981), so that a tier's approximation shows in it:

    - row r of a table is its bucket's centroid (r // bucket) plus noise,
      so C3's alt key at the bucket's first row is a true near neighbour;
    - ids are grouped_zipf, one popularity rank per request for all tables;
    - labels ~ Bernoulli(sigmoid(score)), score = the mean of the exact
      rows @ a hidden vector * `scale`.

    Returns (tables, altkeys, batches, labels, score_fn), with
    score_fn(rows [n, T, dim]) -> scores.  Alt keys are uint32
    (`esv_load_altkeys`), rowId * 100 + t: a table of 42.9M rows or more
    would wrap them into other buckets, so it raises ValueError."""
    rng = np.random.default_rng(seed)
    tables = []
    for s in table_sizes:
        cent = rng.uniform(-0.9, 0.9,
                           ((s + bucket - 1) // bucket, dim)).astype(np.float32)
        tables.append((np.repeat(cent, bucket, axis=0)[:s]
                       + rng.normal(0, 0.02, (s, dim)).astype(np.float32)))
    for s in table_sizes:
        if s * 100 >= 2 ** 32:
            raise ValueError(
                f"quality_fixture: table size {s} overflows the uint32 "
                "alt-key space (rowId*100 encoding); use <= 42.9M rows")
    altkeys = [np.asarray(((np.arange(s) // bucket) * bucket) * 100 + t,
                          np.uint32)
               for t, s in enumerate(table_sizes)]
    u = rng.normal(0, 1, dim)

    dcfg = RandomDataConfig(num_dense=1, table_sizes=list(table_sizes),
                            batch_size=batch_size, num_batches=num_batches,
                            seed=seed + 3, distribution="grouped_zipf",
                            zipf_alpha=zipf_alpha, group_noise=group_noise)
    batches = [idx for _, idx, _ in random_batches(dcfg)]

    def score_fn(rows: np.ndarray) -> np.ndarray:
        return rows.mean(axis=1) @ u * scale

    scores_true = np.concatenate([
        score_fn(np.stack([tables[t][idx[:, t]]
                           for t in range(len(table_sizes))], axis=1))
        for idx in batches])
    labels = (np.random.default_rng(label_seed).random(len(scores_true))
              < 1.0 / (1.0 + np.exp(-scores_true))).astype(np.float32)
    return tables, altkeys, batches, labels, score_fn
