"""The plain reference of the DLRM that both configurations run.

Written from the model's definition (facebookresearch/dlrm,
dlrm_s_pytorch.py: `apply_mlp`, `interact_features` with the dot
interaction and no self-interaction, `create_mlp`'s ReLU after every layer
but the top MLP's last, BCE over sigmoid), in plain PyTorch on float32
with TF32 off, and imports nothing of the program:

- `forward(w, dense, rows)`: logits [B] from dense [B, nd], rows
  [B, T, D] and the MLP weights {"bot": [(W [n, m], b [n]), ...], "top":
  [...]};
- `sgd_steps(...)`: SGD on the MLPs and on the rows a batch gathered (the
  gradient of a row summed over the batch in float64, the row moved once),
  one step a batch, returning each step's loss and the states after each
  step.

With `tf32=True` every product of a matmul (the MLPs, the interaction's
Gram matrix, forward and backward) takes operands rounded to TF32, the
precision a float32 matmul falls to when TF32 is on: the control that the
check has to tell from the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F


def exact_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value (10 explicit mantissa bits,
    ties to even), kept in float32."""
    i = x.contiguous().view(torch.int32)
    r = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return r.view(torch.float32)


class _TF32Matmul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, forward and backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(to_tf32(a), to_tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = to_tf32(g)
        return (torch.matmul(g, to_tf32(b).transpose(-1, -2)),
                torch.matmul(to_tf32(a).transpose(-1, -2), g))


def _matmul(tf32: bool):
    return _TF32Matmul.apply if tf32 else torch.matmul


def pairs(n_features: int) -> Tuple[List[int], List[int]]:
    """The dot interaction's pairs (i, j), j < i, in the reference's
    order: li = [i for i in range(ni) for j in range(i)]."""
    li = [i for i in range(n_features) for _ in range(i)]
    lj = [j for i in range(n_features) for j in range(i)]
    return li, lj


def forward(w: Dict, dense: torch.Tensor, rows: torch.Tensor,
            tf32: bool = False) -> torch.Tensor:
    mm = _matmul(tf32)
    x = dense
    for W, b in w["bot"]:
        x = torch.relu(mm(x, W.t()) + b)
    feats = torch.cat([x[:, None, :], rows], dim=1)
    gram = mm(feats, feats.transpose(1, 2))
    li, lj = pairs(feats.shape[1])
    z = torch.cat([x, gram[:, li, lj]], dim=1)
    top = w["top"]
    for k, (W, b) in enumerate(top):
        z = mm(z, W.t()) + b
        if k < len(top) - 1:
            z = torch.relu(z)
    return z[:, 0]


def bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(logits, labels)


def sgd_steps(w: Dict, table: torch.Tensor, batches: Sequence, lr: float,
              tf32: bool = False, half_batch: bool = False):
    """SGD steps from MLP weights `w` and one [U, D] table of the rows the
    batches touch (`batches` give (dense [B, nd], ids [B, T] into it,
    labels [B])).  Returns (losses, states), states[k] the (MLPs, table)
    after step k + 1.  `half_batch` takes the loss over the first half of
    each batch alone: a fault the check has to catch."""
    w = {p: [(W.clone(), b.clone()) for W, b in w[p]] for p in w}
    table = table.clone()
    losses, states = [], []
    for dense, ids, labels in batches:
        if half_batch:
            h = dense.shape[0] // 2
            dense, ids, labels = dense[:h], ids[:h], labels[:h]
        leaves = [t for p in ("bot", "top") for W, b in w[p] for t in (W, b)]
        for t in leaves:
            t.requires_grad_(True)
        rows = table[ids.long()].requires_grad_(True)
        loss = bce(forward(w, dense, rows, tf32), labels)
        loss.backward()
        with torch.no_grad():
            for t in leaves:
                t -= lr * t.grad
                t.grad = None
                t.requires_grad_(False)
            # each row's gradient summed over the batch in float64, so
            # that the sum does not depend on the order of the adds
            g = torch.zeros(table.shape, dtype=torch.float64,
                            device=table.device).index_add_(
                0, ids.reshape(-1).long(),
                rows.grad.reshape(-1, table.shape[1]).double())
            table -= (lr * g).float()
        losses.append(float(loss.detach()))
        states.append(({p: [(W.clone(), b.clone()) for W, b in w[p]]
                        for p in w}, table.clone()))
    return losses, states
