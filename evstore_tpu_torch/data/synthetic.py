"""Random request streams for serving and training (one-hot).

A copy of `RandomDataConfig`, `random_batches` and `learnable_batches` from
`evstore_tpu/data/synthetic.py`, for bag size 1 and uniform dense features.
The same config and seed give the same batches as the JAX package: the
calls on the numpy generator are the same, in the same order.  The
`zipf` and `grouped_zipf` streams carry the skew EVStore's cache exploits;
`grouped_zipf` draws one popularity rank per request and shares it across
all tables (cache_algo/EvLFU_C1.py:97-161).  Multi-hot bags and the
gaussian stream are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence, Tuple

import numpy as np

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray]


@dataclasses.dataclass
class RandomDataConfig:
    num_dense: int = 13
    table_sizes: Sequence[int] = (4, 3, 2)
    batch_size: int = 128
    num_batches: int = 100
    seed: int = 123
    distribution: str = "uniform"     # uniform | zipf | grouped_zipf
    zipf_alpha: float = 1.05
    # grouped_zipf: resample a table's id independently with this probability
    group_noise: float = 0.1


def _sample_indices(rng: np.random.Generator, n: int, size: int,
                    cfg: RandomDataConfig) -> np.ndarray:
    if cfg.distribution == "uniform" or size <= 2:
        return rng.integers(0, size, n, dtype=np.int64)
    # bounded Zipf via the continuous inverse-CDF approximation
    a = cfg.zipf_alpha
    if abs(a - 1.0) < 1e-6:
        a = 1.0 + 1e-6
    u = rng.random(n)
    n_pow = float(size) ** (1.0 - a)
    r = ((n_pow - 1.0) * u + 1.0) ** (1.0 / (1.0 - a)) - 1.0
    return np.clip(r.astype(np.int64), 0, size - 1)


def random_batches(cfg: RandomDataConfig) -> Iterator[Batch]:
    """Yields (dense [B, num_dense] f32, idx [B, T] int32, labels [B] f32)."""
    if cfg.distribution not in ("uniform", "zipf", "grouped_zipf"):
        raise NotImplementedError(
            f"the {cfg.distribution!r} stream is not ported yet")
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
    for _ in range(cfg.num_batches):
        dense = rng.random((cfg.batch_size, cfg.num_dense))
        idx = np.empty((cfg.batch_size, len(sizes)), dtype=np.int32)
        shared_rank = None
        if cfg.distribution == "grouped_zipf":
            shared_rank = _sample_indices(rng, cfg.batch_size, max(sizes),
                                          cfg)
        for t, s in enumerate(sizes):
            if shared_rank is not None:
                raw = shared_rank % s
                if cfg.group_noise > 0.0:
                    flip = rng.random(raw.shape[0]) < cfg.group_noise
                    raw = np.where(flip,
                                   _sample_indices(rng, raw.shape[0], s, cfg),
                                   raw)
            else:
                raw = _sample_indices(rng, cfg.batch_size, s, cfg)
            if perms is not None:
                kind, p = perms[t]
                if kind == "perm":
                    raw = p[np.minimum(raw, s - 1)]
                else:
                    raw = (raw * p) % s
            idx[:, t] = raw.astype(np.int32)
        labels = rng.integers(0, 2, cfg.batch_size).astype(np.float32)
        yield dense.astype(np.float32), idx, labels


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
