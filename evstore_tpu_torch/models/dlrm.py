"""DLRM as an `nn.Module`.

Port of `evstore_tpu/models/dlrm.py`: bottom MLP (a ReLU after every layer)
-> embedding rows -> pairwise interaction -> top MLP (linear last layer) ->
logits.  Beyond the JAX package, the interaction may be DCN V2's low-rank
cross network (`interaction_op="dcn"`, MLPerf's DLRM-DCNv2): the dense
vector and the T pooled rows concatenated into x0 [B, (T + 1) D], then
`dcn_num_layers` cross layers (`LowRankCrossNet`, K8 in
`ops/cuda_cross.py`).  `forward` takes pre-looked-up rows (`emb_rows`), which is how the
device C1 cache and the train step splice into the model, as in the JAX
package; it is differentiable with respect to `emb_rows` and the MLPs.
The MLPs are `nn.Linear` layers, whose weight is [out, in]; the JAX package
stores [in, out] (see `convert.py`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from evstore_tpu_torch.config import DLRMConfig
from evstore_tpu_torch.models.embedding import (MDTable, QRTable, RowSource,
                                                init_sparse_arch, row_sources,
                                                sparse_arch_lookup,
                                                table_kinds)
from evstore_tpu_torch.ops.cuda_cross import LowRankCross
from evstore_tpu_torch.ops.cuda_interaction import DotInteraction
from evstore_tpu_torch.ops.interaction import cat_interaction, dot_interaction
from evstore_tpu_torch.parallel.mesh import shard_rows
from evstore_tpu_torch.utils.device import resolve_device
from evstore_tpu_torch.utils.profiling import span

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _mlp_draws(dims, rng: np.random.Generator):
    """The reference's init: W ~ N(0, sqrt(2/(m+n))), b ~ N(0, sqrt(1/n))
    (dlrm_s_pytorch.py:215-240), as (w [n, m], b [n]) a layer."""
    out = []
    for m, n in zip(dims[:-1], dims[1:]):
        w = rng.normal(0.0, np.sqrt(2.0 / (m + n)), (n, m))
        out.append((w, rng.normal(0.0, np.sqrt(1.0 / n), (n,))))
    return out


def _mlp(dims, rng: np.random.Generator, dtype) -> nn.ModuleList:
    layers = nn.ModuleList()
    for (m, n), (w, b) in zip(zip(dims[:-1], dims[1:]),
                              _mlp_draws(dims, rng)):
        lin = nn.Linear(m, n, dtype=dtype)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(w))
            lin.bias.copy_(torch.from_numpy(b))
        layers.append(lin)
    return layers


def _cross_draws(cfg: DLRMConfig, rng: np.random.Generator):
    """The cross network's init as torchrec's `LowRankCrossNet` draws it:
    V [r, N] and W [N, r] xavier-normal, N(0, sqrt(2 / (N + r))), b [N]
    zero; as (V, W, b) a layer."""
    N, r = cfg.top_mlp_input_dim(), cfg.dcn_low_rank_dim
    std = np.sqrt(2.0 / (N + r))
    return [(rng.normal(0.0, std, (r, N)), rng.normal(0.0, std, (N, r)),
             np.zeros(N)) for _ in range(cfg.dcn_num_layers)]


class LowRankCrossNet(nn.Module):
    """DCN V2's low-rank cross network (torchrec's `LowRankCrossNet`):
    x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l, V_l [r, N] with no bias,
    W_l [N, r] with bias b_l [N].  The products follow `_apply_mlp`'s
    compute-dtype rule; the elementwise part is K8 (`ops/cuda_cross.py`),
    or its plain version with `use_kernel` off.  The forward is the span
    `dlrm.cross` (every layer, products included)."""

    def __init__(self, draws, dtype, compute_dtype, use_kernel: bool):
        super().__init__()

        def param(a):
            return nn.Parameter(torch.as_tensor(a, dtype=dtype))

        self.V = nn.ParameterList(param(V) for V, _, _ in draws)
        self.W = nn.ParameterList(param(W) for _, W, _ in draws)
        self.b = nn.ParameterList(param(b) for _, _, b in draws)
        self.compute_dtype = compute_dtype
        self.use_kernel = use_kernel

    def layers(self):
        """[(V, W, b)] a layer."""
        return list(zip(self.V, self.W, self.b))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        """x0 [B, N] -> [B, N], float32."""
        with span("dlrm.cross"):
            params = [p for layer in self.layers() for p in layer]
            return LowRankCross.apply(x0.float().contiguous(),
                                      self.compute_dtype, self.use_kernel,
                                      *params)


def _flat_entry(entry: Dict) -> Dict[str, np.ndarray]:
    """A table's entry in the JAX layout, one level deep: {"kind_plain",
    "pool_w", "q", "r", "table", "proj"} -> array."""
    out = {}
    for k, v in entry.items():
        if isinstance(v, dict):
            out.update(v)
        else:
            out[k] = v
    return out


def _expected(cfg: DLRMConfig) -> List[Dict[str, tuple]]:
    """The shapes of each table's entry, by `_flat_entry`'s keys."""
    out = [{} for _ in range(cfg.num_tables)]
    for s in row_sources(cfg):
        key = {"plain": "kind_plain", "md": "table"}.get(s.part, s.part)
        out[s.table][key] = (s.rows, s.width)
    for t, (kind, dim) in enumerate(table_kinds(cfg)):
        if kind == "md" and dim != cfg.embedding_dim:
            out[t]["proj"] = (dim, cfg.embedding_dim)
    return out


def init_host_tables(cfg: DLRMConfig, seed: int = 0) -> List[np.ndarray]:
    """The plain tables `DLRM(cfg, seed=seed)` draws, as float32 numpy
    arrays in host memory, without building them on a device: the masters
    of cached training (`cache/trainable.py`)."""
    rng = np.random.default_rng(seed)
    _mlp_draws(cfg.mlp_bot, rng)
    _mlp_draws(cfg.mlp_top, rng)
    if cfg.interaction_op == "dcn":
        _cross_draws(cfg, rng)
    return [e["kind_plain"] for e in init_sparse_arch(cfg, rng)]


class DLRM(nn.Module):
    """Dense arch, interaction and the sparse arch.

    The sparse arch's parameters are laid out as the JAX package's
    `table_t` entries: `tables` holds the plain tables (`kind_plain`) in
    table order, and `plain_ids` their table numbers (every table, for a
    model without qr or md tables); `qr` and `md` hold a `QRTable` or an
    `MDTable` under the table's number, and `pool_w` the pooling weights
    [n, 1] of each plain table under weighted pooling.

    `tables` is True to draw the sparse arch from `seed`
    (`init_sparse_arch`), False when the rows live elsewhere (the EVStore
    store behind the device cache; `forward` then needs `emb_rows`), or a
    sequence of one entry per table to copy onto the device (the caller's
    arrays are not changed by training): an [n, D] float32 array (numpy,
    or a tensor) for a plain table (with `pool_w` at ones under weighted
    pooling), or the table's entry in the JAX layout
    (`{"kind_plain": ..., "pool_w": ...}`, `{"kind_qr": {"q", "r"}}`,
    `{"kind_md": {"table", "proj"}}`).

    `row_shard` (m, n_model) keeps of each plain table only model shard
    m's rows [m·Nl, (m+1)·Nl), Nl = ceil(N / n_model), zero-padded past N
    (`parallel/sharded.py`): the tables are given or drawn whole and cut
    here; the pooling weights, qr and md tables and MLPs stay whole.  Such
    a model looks rows up only through the sharded step's exchange, so its
    `forward` needs `emb_rows`."""

    def __init__(self, cfg: DLRMConfig, *, device=None, seed: int = 0,
                 tables: Union[bool, Sequence] = True,
                 row_shard: Tuple[int, int] = (0, 1)):
        super().__init__()
        cfg.validate()
        if cfg.interaction_op not in ("dot", "cat", "dcn"):
            raise ValueError(f"unsupported interaction op "
                             f"{cfg.interaction_op}")
        self.cfg = cfg
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        dev = resolve_device(device)
        dtype = _DTYPES[cfg.param_dtype]
        rng = np.random.default_rng(seed)
        self.bot = _mlp(cfg.mlp_bot, rng, dtype)
        self.top = _mlp(cfg.mlp_top, rng, dtype)
        self.cross = (LowRankCrossNet(_cross_draws(cfg, rng), dtype,
                                      self.compute_dtype,
                                      cfg.use_interaction_kernel)
                      if cfg.interaction_op == "dcn" else None)
        self.tables = nn.ParameterList()
        self.qr = nn.ModuleDict()
        self.md = nn.ModuleDict()
        self.pool_w = nn.ParameterDict()
        if tables is True:
            tables = init_sparse_arch(cfg, rng)
        elif tables is False:
            tables = []
        if len(tables) not in (0, cfg.num_tables):
            raise ValueError(f"{len(tables)} table entries for "
                             f"{cfg.num_tables} tables")

        def param(a, grad=False):
            t = a if isinstance(a, torch.Tensor) else \
                torch.from_numpy(np.asarray(a))
            return nn.Parameter(t.to(device=dev, dtype=dtype, copy=True
                                     ).contiguous(), requires_grad=grad)

        plain_ids = []
        for t, (e, src) in enumerate(zip(tables, _expected(cfg))):
            if not isinstance(e, dict):
                e = {"kind_plain": e}
            got = {k: tuple(v.shape) if isinstance(v, torch.Tensor)
                   else np.shape(v) for k, v in _flat_entry(e).items()}
            if cfg.weighted_pooling and "kind_plain" in e:
                got.setdefault("pool_w", src["pool_w"])
            if got != src:
                raise ValueError(f"the tables' shapes do not match the "
                                 f"config: table {t} has {got}, the config "
                                 f"gives {src}")
            if "kind_qr" in e:
                self.qr[str(t)] = QRTable(param(e["kind_qr"]["q"]),
                                          param(e["kind_qr"]["r"]))
            elif "kind_md" in e:
                proj = e["kind_md"].get("proj")
                self.md[str(t)] = MDTable(
                    param(e["kind_md"]["table"]),
                    None if proj is None else param(proj, grad=True))
            else:
                plain_ids.append(t)
                self.tables.append(param(shard_rows(e["kind_plain"],
                                                    *row_shard)))
                if cfg.weighted_pooling:
                    self.pool_w[str(t)] = param(
                        e.get("pool_w", np.ones((cfg.table_sizes[t], 1),
                                                np.float32)))
        self.plain_ids = tuple(plain_ids)
        self.row_shard = tuple(row_shard)
        self.to(dev)

    def has_sparse(self) -> bool:
        """Whether the model holds its sparse arch (not `tables=False`)."""
        return len(self.tables) + len(self.qr) + len(self.md) > 0

    def entries(self) -> List:
        """Per table: its plain tensor, `QRTable` or `MDTable`."""
        plain = dict(zip(self.plain_ids, self.tables))
        return [plain[t] if t in plain else
                self.qr[str(t)] if str(t) in self.qr else self.md[str(t)]
                for t in range(self.cfg.num_tables)]

    def pool_weights(self) -> Dict[int, torch.Tensor]:
        return {int(t): w for t, w in self.pool_w.items()}

    def row_sources(self) -> List[RowSource]:
        """The sparse arch's row sources (`models/embedding.py`), each with
        its parameter and its name in `named_parameters()`."""
        return row_sources(self.cfg, self.entries(), self.pool_weights())

    def _apply_mlp(self, layers: nn.ModuleList, x: torch.Tensor,
                   last_linear: bool) -> torch.Tensor:
        """As the JAX package's `_apply_mlp`: the operands rounded to the
        compute dtype, their products summed in float32
        (`preferred_element_type=float32`), the bias added in float32, and
        the compute dtype again between layers.  The matmul runs on the
        operands upcast to float32 (TF32 off): a product of two bf16 values
        is exact in float32, so this is the JAX sum, where a bf16 matmul
        would round every output to bf16."""
        cdt = self.compute_dtype
        h = x.to(cdt)
        for i, lin in enumerate(layers):
            h = torch.matmul(h.float(), lin.weight.to(cdt).float().t()) + \
                lin.bias.float()
            if last_linear and i == len(layers) - 1:
                break
            h = torch.relu(h).to(cdt)
        return h

    def bottom_mlp(self, dense_x: torch.Tensor) -> torch.Tensor:
        return self._apply_mlp(self.bot, dense_x, last_linear=False)

    def interact(self, x: torch.Tensor, ly: torch.Tensor) -> torch.Tensor:
        if self.cfg.interaction_op == "cat":
            return cat_interaction(x, ly)
        if self.cfg.interaction_op == "dcn":
            return self.cross(cat_interaction(x, ly))
        dot = (DotInteraction.apply if self.cfg.use_interaction_kernel
               else dot_interaction)
        return dot(x.contiguous(), ly.contiguous(),
                   self.cfg.interaction_itself)

    def top_mlp(self, z: torch.Tensor) -> torch.Tensor:
        return self._apply_mlp(self.top, z, last_linear=True)[..., 0].float()

    def forward(self, dense_x: torch.Tensor,
                idx: Optional[torch.Tensor] = None,
                emb_rows: Optional[torch.Tensor] = None,
                bag_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """dense_x [B, num_dense], idx [B, T] int or [B, T, L] bags with
        optional bag_weights [B, T, L] (under `multi_hot_sizes`, [B, sum
        L_t] bags of a length per table, with weights of that shape), or
        emb_rows [B, T, D] in place of the lookup -> logits [B]."""
        x = self.bottom_mlp(dense_x)
        if emb_rows is None:
            if not self.has_sparse():
                raise ValueError("this DLRM holds no tables; pass emb_rows")
            if self.row_shard[1] > 1:
                raise ValueError("this DLRM holds one row shard of its "
                                 "tables; look rows up through "
                                 "parallel/sharded.py")
            emb_rows = sparse_arch_lookup(self.entries(), idx, self.cfg,
                                          bag_weights, self.pool_weights())
        return self.top_mlp(self.interact(x, emb_rows.to(x.dtype)))

    def predict(self, dense_x, idx=None, emb_rows=None,
                bag_weights=None) -> torch.Tensor:
        """Click probability with the reference's loss_threshold clamp
        (dlrm_s_pytorch.py:605-611)."""
        p = torch.sigmoid(self(dense_x, idx, emb_rows, bag_weights))
        if self.cfg.loss_threshold > 0.0:
            p = p.clamp(self.cfg.loss_threshold,
                        1.0 - self.cfg.loss_threshold)
        return p


def dlrm_loss(logits: torch.Tensor, targets: torch.Tensor,
              loss_function: str = "bce",
              loss_weights=(1.0, 1.0)) -> torch.Tensor:
    """BCE (with logits, the same math as the reference's sigmoid +
    nn.BCELoss), MSE, or weighted BCE (dlrm_s_pytorch.py:297-312,150-167).
    Any other name is BCE, as in the JAX package, whose CLI passes
    `--loss-function` through unchecked."""
    t = targets.float()
    if loss_function == "mse":
        return torch.mean((torch.sigmoid(logits) - t) ** 2)
    # log-sigmoid BCE
    per = -(t * F.logsigmoid(logits) + (1.0 - t) * F.logsigmoid(-logits))
    if loss_function == "wbce":
        w = torch.where(t > 0.5, loss_weights[1], loss_weights[0])
        return torch.sum(w * per) / torch.sum(w)
    return torch.mean(per)
