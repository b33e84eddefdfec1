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
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence, Tuple

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
