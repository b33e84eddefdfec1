"""DLRM as an `nn.Module`.

Port of `evstore_tpu/models/dlrm.py`: bottom MLP (a ReLU after every layer)
-> embedding rows -> pairwise interaction -> top MLP (linear last layer) ->
logits.  `forward` takes pre-looked-up rows (`emb_rows`), which is how the
device C1 cache and the train step splice into the model, as in the JAX
package; it is differentiable with respect to `emb_rows` and the MLPs.
The MLPs are `nn.Linear` layers, whose weight is [out, in]; the JAX package
stores [in, out] (see `convert.py`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from evstore_tpu_torch.config import DLRMConfig
from evstore_tpu_torch.models.embedding import (init_embedding_tables,
                                                sparse_arch_lookup)
from evstore_tpu_torch.ops.cuda_interaction import DotInteraction
from evstore_tpu_torch.ops.interaction import cat_interaction, dot_interaction
from evstore_tpu_torch.utils.device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _mlp(dims, rng: np.random.Generator, dtype) -> nn.ModuleList:
    """The reference's init: W ~ N(0, sqrt(2/(m+n))), b ~ N(0, sqrt(1/n))
    (dlrm_s_pytorch.py:215-240)."""
    layers = nn.ModuleList()
    for m, n in zip(dims[:-1], dims[1:]):
        lin = nn.Linear(m, n, dtype=dtype)
        w = rng.normal(0.0, np.sqrt(2.0 / (m + n)), (n, m))
        b = rng.normal(0.0, np.sqrt(1.0 / n), (n,))
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(w))
            lin.bias.copy_(torch.from_numpy(b))
        layers.append(lin)
    return layers


class DLRM(nn.Module):
    """Dense arch, interaction and the plain embedding tables.  `tables` is
    True to draw the tables from `seed`, a sequence of [n, D] float32 numpy
    arrays to copy onto the device (the caller's arrays are not changed by
    training), or False when the rows live elsewhere (the EVStore store
    behind the device cache); `forward` then needs `emb_rows`."""

    def __init__(self, cfg: DLRMConfig, *, device=None, seed: int = 0,
                 tables: Union[bool, Sequence[np.ndarray]] = True):
        super().__init__()
        cfg.validate()
        if cfg.interaction_op not in ("dot", "cat"):
            raise ValueError(f"unsupported interaction op "
                             f"{cfg.interaction_op}")
        self.cfg = cfg
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        dev = resolve_device(device)
        dtype = _DTYPES[cfg.param_dtype]
        rng = np.random.default_rng(seed)
        self.bot = _mlp(cfg.mlp_bot, rng, dtype)
        self.top = _mlp(cfg.mlp_top, rng, dtype)
        self.tables = nn.ParameterList()
        if tables is True:
            tables = init_embedding_tables(cfg.table_sizes,
                                           cfg.embedding_dim, rng)
        elif tables is False:
            tables = []
        elif [np.shape(t) for t in tables] != [
                (n, cfg.embedding_dim) for n in cfg.table_sizes]:
            raise ValueError("the tables' shapes do not match the config")
        for t in tables:
            self.tables.append(nn.Parameter(
                torch.from_numpy(t).to(device=dev, dtype=dtype, copy=True),
                requires_grad=False))
        self.to(dev)

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
        dot = (DotInteraction.apply if self.cfg.use_interaction_kernel
               else dot_interaction)
        return dot(x.contiguous(), ly.contiguous(),
                   self.cfg.interaction_itself)

    def top_mlp(self, z: torch.Tensor) -> torch.Tensor:
        return self._apply_mlp(self.top, z, last_linear=True)[..., 0].float()

    def forward(self, dense_x: torch.Tensor,
                idx: Optional[torch.Tensor] = None,
                emb_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """dense_x [B, num_dense], idx [B, T] int, optional emb_rows
        [B, T, D] -> logits [B]."""
        x = self.bottom_mlp(dense_x)
        if emb_rows is None:
            if len(self.tables) == 0:
                raise ValueError("this DLRM holds no tables; pass emb_rows")
            emb_rows = sparse_arch_lookup(list(self.tables), idx, self.cfg)
        return self.top_mlp(self.interact(x, emb_rows.to(x.dtype)))

    def predict(self, dense_x, idx=None, emb_rows=None) -> torch.Tensor:
        """Click probability with the reference's loss_threshold clamp
        (dlrm_s_pytorch.py:605-611)."""
        p = torch.sigmoid(self(dense_x, idx, emb_rows))
        if self.cfg.loss_threshold > 0.0:
            p = p.clamp(self.cfg.loss_threshold,
                        1.0 - self.cfg.loss_threshold)
        return p


def dlrm_loss(logits: torch.Tensor, targets: torch.Tensor,
              loss_function: str = "bce",
              loss_weights=(1.0, 1.0)) -> torch.Tensor:
    """BCE (with logits, the same math as the reference's sigmoid +
    nn.BCELoss), MSE, or weighted BCE (dlrm_s_pytorch.py:297-312,150-167)."""
    t = targets.float()
    if loss_function == "mse":
        return torch.mean((torch.sigmoid(logits) - t) ** 2)
    if loss_function not in ("bce", "wbce"):
        raise ValueError(f"unsupported loss function {loss_function}")
    # log-sigmoid BCE
    per = -(t * F.logsigmoid(logits) + (1.0 - t) * F.logsigmoid(-logits))
    if loss_function == "wbce":
        w = torch.where(t > 0.5, loss_weights[1], loss_weights[0])
        return torch.sum(w * per) / torch.sum(w)
    return torch.mean(per)
