"""Configuration dataclasses for the PyTorch/CUDA port.

The port keeps its own copy of the JAX package's configuration
(`evstore_tpu/config.py`) so that it imports nothing of that package.
Field names and defaults are the same for what the port reads, with one
rename: the
JAX package's `use_pallas_interaction` / `use_pallas_gather` select Pallas
kernels that do not exist here; their counterparts `use_interaction_kernel` /
`use_gather_kernel` select the port's hand-written CUDA kernels
(`ops/cuda_interaction.py`, `ops/cuda_gather.py`) and default to on.
`TrainConfig.use_update_kernel` is the counterpart of the JAX package's
`ESV_PALLAS_SWEEP` switch; here it sends the row updates of every
optimizer through the grouped kernel path (`ops/cuda_update.py`).
"""

from __future__ import annotations

import dataclasses
import functools
import json
from typing import Optional, Sequence, Tuple


def _tuple(xs) -> Tuple[int, ...]:
    return tuple(int(x) for x in xs)


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    """Model architecture (the reference's --arch-* flags)."""

    embedding_dim: int = 36
    table_sizes: Tuple[int, ...] = (4, 3, 2)
    mlp_bot: Tuple[int, ...] = (4, 3, 2)     # input dim first
    mlp_top: Tuple[int, ...] = (8, 4, 2, 1)  # output dim last
    interaction_op: str = "dot"              # dot | cat | dcn
    interaction_itself: bool = False
    # the low-rank cross network of DCN V2 (interaction_op "dcn"; torchrec's
    # LowRankCrossNet): its layers and the rank of each layer's V and W
    dcn_num_layers: int = 3
    dcn_low_rank_dim: int = 512
    # per-table bag lengths L_t: a batch's ids are [B, sum L_t], table t's
    # bag in its L_t consecutive columns, in table order; () for one id a
    # table ([B, T]) or bags padded to one L ([B, T, L])
    multi_hot_sizes: Tuple[int, ...] = ()
    # md/qr compressed-table tricks (tricks/{md,qr}_embedding_bag.py)
    qr_flag: bool = False
    qr_operation: str = "mult"               # mult | add | concat
    qr_collisions: int = 4
    qr_threshold: int = 200
    md_flag: bool = False
    md_threshold: int = 200
    md_temperature: float = 0.3
    md_round_dims: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # the dot interaction through the CUDA kernel (csrc/interaction_fwd.cu)
    use_interaction_kernel: bool = True
    # plain-table row lookups through the CUDA kernel (csrc/gather_rows.cu)
    use_gather_kernel: bool = True
    # per-row pooling weights v_W (dlrm_s_pytorch.py:284-293):
    # None | "learned" | "fixed"
    weighted_pooling: Optional[str] = None
    loss_threshold: float = 0.0

    @property
    def num_tables(self) -> int:
        return len(self.table_sizes)

    @property
    def num_dense_features(self) -> int:
        return self.mlp_bot[0]

    def top_mlp_input_dim(self) -> int:
        d = self.mlp_bot[-1]
        n = self.num_tables
        if self.interaction_op == "dot":
            ni = n + 1
            offset = 1 if self.interaction_itself else 0
            return d + (ni * (ni - 1)) // 2 + offset * ni
        if self.interaction_op in ("cat", "dcn"):
            return d * (n + 1)
        raise ValueError(f"unsupported interaction op {self.interaction_op}")

    def bag_columns(self) -> Tuple[int, ...]:
        """The table of each column of a [B, sum L_t] batch under
        `multi_hot_sizes`, () without them."""
        return _bag_columns(tuple(self.multi_hot_sizes))

    def validate(self) -> None:
        if self.mlp_bot[-1] != self.embedding_dim and not self.md_flag:
            raise ValueError(
                f"bottom MLP output dim {self.mlp_bot[-1]} must equal "
                f"embedding dim {self.embedding_dim} for "
                f"'{self.interaction_op}' interaction")
        if self.mlp_top[0] != self.top_mlp_input_dim():
            raise ValueError(
                f"top MLP input dim {self.mlp_top[0]} != interaction output "
                f"{self.top_mlp_input_dim()}")
        if self.interaction_op == "dcn" and (self.dcn_num_layers < 1
                                             or self.dcn_low_rank_dim < 1):
            raise ValueError(f"the cross network needs at least one layer "
                             f"of rank at least 1, got "
                             f"{self.dcn_num_layers} layers of rank "
                             f"{self.dcn_low_rank_dim}")
        if self.multi_hot_sizes:
            if len(self.multi_hot_sizes) != self.num_tables or \
                    min(self.multi_hot_sizes) < 1:
                raise ValueError(f"multi_hot_sizes {self.multi_hot_sizes} "
                                 f"must give a bag length of at least 1 to "
                                 f"each of the {self.num_tables} tables")
            if self.qr_flag or self.md_flag or self.weighted_pooling:
                raise ValueError("bags of a length per table take plain "
                                 "tables without pooling weights")


@functools.lru_cache(maxsize=None)
def _bag_columns(sizes: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple(t for t, n in enumerate(sizes) for _ in range(n))


def make_dlrm_config(embedding_dim: int, table_sizes: Sequence[int],
                     mlp_bot_hidden: Sequence[int],
                     mlp_top_hidden: Sequence[int],
                     num_dense: int = 13, **kw) -> DLRMConfig:
    """Build a config with the top-MLP input dim derived automatically."""
    mlp_bot = _tuple([num_dense, *mlp_bot_hidden, embedding_dim])
    cfg = DLRMConfig(embedding_dim=embedding_dim,
                     table_sizes=_tuple(table_sizes), mlp_bot=mlp_bot,
                     mlp_top=(1,), **kw)
    mlp_top = _tuple([cfg.top_mlp_input_dim(), *mlp_top_hidden, 1])
    cfg = dataclasses.replace(cfg, mlp_top=mlp_top)
    cfg.validate()
    return cfg


KAGGLE_TABLE_SIZES = (1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3,
                      93145, 5683, 8351593, 3194, 27, 14992, 5461306, 10,
                      5652, 2173, 4, 7046547, 18, 15, 286181, 105, 142572)


def kaggle_dlrm_config(**kw) -> DLRMConfig:
    """Criteo Kaggle: emb dim 36, bot 13-512-256-64-36, top 512-256-1
    (bench/dlrm_s_criteo_kaggle.sh:24)."""
    return make_dlrm_config(36, KAGGLE_TABLE_SIZES, (512, 256, 64),
                            (512, 256), **kw)


def kaggle_small_dlrm_config(max_rows: int = 100_000, **kw) -> DLRMConfig:
    """Kaggle model shape with tables clipped to max_rows."""
    sizes = tuple(min(s, max_rows) for s in KAGGLE_TABLE_SIZES)
    return make_dlrm_config(36, sizes, (512, 256, 64), (512, 256), **kw)


# Criteo Terabyte's vocabularies (bench/dlrm_s_criteo_terabyte.sh), which
# the MLPerf recipe shares
TERABYTE_TABLE_SIZES = (227605432, 39060, 17295, 7424, 20265, 3, 7122, 1543,
                        63, 130229467, 3067956, 405282, 10, 2209, 11938, 155,
                        4, 976, 14, 292775614, 40790948, 187188510, 590152,
                        12973, 108, 36)


def terabyte_dlrm_config(max_ind_range: int = 10_000_000, **kw) -> DLRMConfig:
    """emb dim 64, bot 13-512-256-64, top 512-512-256-1
    (bench/dlrm_s_criteo_terabyte.sh:24), tables capped at max_ind_range."""
    sizes = tuple(min(s, max_ind_range) for s in TERABYTE_TABLE_SIZES)
    return make_dlrm_config(64, sizes, (512, 256), (512, 512, 256), **kw)


def mlperf_dlrm_config(max_ind_range: int = 40_000_000, **kw) -> DLRMConfig:
    """The MLPerf recipe: emb dim 128, top 1024-1024-512-256-1
    (bench/run_and_time.sh:17), tables capped at max_ind_range."""
    sizes = tuple(min(s, max_ind_range) for s in TERABYTE_TABLE_SIZES)
    return make_dlrm_config(128, sizes, (512, 256), (1024, 1024, 512, 256),
                            **kw)


# the MLPerf DLRM-DCNv2 recipe's bag lengths (mlcommons/training,
# recommendation_v2/torchrec_dlrm README: --multi_hot_sizes): 214 ids a sample
MLPERF_MULTI_HOT_SIZES = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1,
                          1, 1, 12, 100, 27, 10, 3, 1, 1)


def mlperf_dcnv2_config(max_ind_range: int = 40_000_000,
                        table_sizes: Optional[Sequence[int]] = None,
                        **kw) -> DLRMConfig:
    """MLPerf Training's DLRM-DCNv2 (mlcommons/training,
    recommendation_v2/torchrec_dlrm): emb dim 128, bot 13-512-256-128, three
    low-rank cross layers of rank 512 over the 27 x 128 features, top
    3456-1024-1024-512-256-1, the recipe's multi-hot bag lengths; tables
    capped at max_ind_range, or the rows a chip holds (`table_sizes`)."""
    sizes = (tuple(min(s, max_ind_range) for s in TERABYTE_TABLE_SIZES)
             if table_sizes is None else table_sizes)
    kw["multi_hot_sizes"] = _tuple(kw.get("multi_hot_sizes",
                                          MLPERF_MULTI_HOT_SIZES))
    return make_dlrm_config(128, sizes, (512, 256), (1024, 1024, 512, 256),
                            interaction_op="dcn", dcn_num_layers=3,
                            dcn_low_rank_dim=512, **kw)


def tiny_dlrm_config(**kw) -> DLRMConfig:
    """CPU-sized fixture (the reference's tiny default model)."""
    return make_dlrm_config(4, (40, 30, 20), (8,), (8,), num_dense=4, **kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters: the JAX package's fields (reference flags
    dlrm_s_pytorch.py:952-1018), with the same names and defaults.
    `pack_gather` is not ported: the packed [N/P, P*D] table layout is a
    TPU lowering of the row gather, and the port's gather kernel reads the
    logical [N, D] layout directly.  `train` and `evaluate` take the size
    of the batches they are given; `batch_size` and `test_batch_size` are
    what the CLI makes them with."""

    batch_size: int = 128
    test_batch_size: int = 128
    learning_rate: float = 0.1
    optimizer: str = "sgd"                 # sgd | adagrad | rwsadagrad
    # mse | wbce; any other name is BCE, as in the JAX package
    loss_function: str = "bce"
    loss_weights: Tuple[float, float] = (1.0, 1.0)
    nepochs: int = 1
    numpy_rand_seed: int = 123
    # LR policy (LRPolicyScheduler, dlrm_s_pytorch.py:168-202)
    lr_num_warmup_steps: int = 0
    lr_decay_start_step: int = 0
    lr_num_decay_steps: int = 0
    # eval cadence (steps; <= 0: only the final eval) and the MLPerf
    # early-exit thresholds (0: off)
    test_freq: int = -1
    mlperf_acc_threshold: float = 0.0
    mlperf_auc_threshold: float = 0.0
    print_freq: int = 1024
    # checkpoint directories (the CLI's --save-model / --load-model)
    save_model: str = ""
    load_model: str = ""
    # the grouped row updates of every optimizer through the CUDA kernel
    # (csrc/row_update.cu)
    use_update_kernel: bool = True


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Cache configuration: the JAX package's fields that the caches and
    the tier engine read, with the same names and defaults.  The reference
    splits them between runtime flags (dlrm_s_pytorch_C1.py:1248-1268) and
    the C++ engine's compile-time #defines
    (mixed_precs_caching/cache_manager.cpp:13-20).  `storage_backend` and
    `storage_path` record the CLI's --emb-stor and --ev-table-path, and
    `n_warmup_requests` is the JAX package's field, which nothing reads
    there either.  The JAX package's `c3_n_batch`, which nothing reads, is
    left out."""

    policy: str = "evlfu"                  # evlfu | lfu | lru
    n_caching_layers: int = 1              # 1 (C1), 2 (C1+C2), 3 (C1+C2+C3)
    total_size: int = 64_000               # entry budget at main precision
    size_proportion: Tuple[int, int, int] = (48, 48, 4)   # C1-C2-C3 split
    # C1: 32 | 16 | 8 | 4 in the host tiers; 32 or 8 in the device caches
    main_precision: int = 32
    secondary_precision: int = 8           # C2: 32 | 16 | 8 | 4
    flush_rate: float = 0.3                # EvLFU perfect-set flush share
    perfect_item_cap: float = 0.95         # EvLFU perfect-set trigger
    # C1/C2 miss-splitting heuristic (mixed_precs_caching/evlfu_8.hpp:70)
    high_agghit_threshold: int = 23
    # C3 (aprx_embedding.hpp:30-32)
    c3_io_batch: int = 50
    c3_eviction: str = "recency"           # fifo | recency
    # the host C1's approximate-embedding short-circuit (EvLFU_C1.py:
    # 122-152): a request with at least this many C1 hits serves its misses
    # a stand-in row; -1 turns it off
    approx_emb_threshold: int = -1
    # the store behind the cache: dummy | file | mmap | sqlite | logkv |
    # native, and its .bin directory
    storage_backend: str = "dummy"
    storage_path: str = ""
    n_warmup_requests: int = 0

    def tier_capacities(self) -> Tuple[int, int, int]:
        """Entry capacity per tier.  The reference scales entry counts by
        the precision ratio against C1 (evlfu_8.cpp:57-100): a budget in
        main-precision entries buys main/p more entries at precision p, and
        a C3 alt-key entry is 4 bytes against a 144-byte fp32 row."""
        if self.n_caching_layers == 1:
            return (self.total_size, 0, 0)
        ratio = self.main_precision / max(self.secondary_precision, 1)
        if self.n_caching_layers == 2:
            p1, p2, _ = self.size_proportion
            return (int(self.total_size * p1 / (p1 + p2)),
                    int(self.total_size * p2 / (p1 + p2) * ratio), 0)
        p1, p2, p3 = self.size_proportion
        tot = p1 + p2 + p3
        return (int(self.total_size * p1 / tot),
                int(self.total_size * p2 / tot * ratio),
                int(self.total_size * p3 / tot * 36))


def to_json(cfg) -> str:
    """A config dataclass as JSON."""
    return json.dumps(dataclasses.asdict(cfg))


def from_json(cls, s: str):
    """The inverse of `to_json` for the dataclass `cls` (JSON lists become
    tuples)."""
    d = json.loads(s)
    for k, v in list(d.items()):
        if isinstance(v, list):
            d[k] = tuple(v)
    return cls(**d)
