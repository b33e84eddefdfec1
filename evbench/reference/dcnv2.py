"""The benchmark's plain reference of its row-wise Adagrad cells: MLPerf's
DLRM-DCNv2 (bags of a length per table, the low-rank cross network) and
the DLRM of `dlrm.py` (one id a table, the dot interaction) under the same
optimizer.  Plain PyTorch on float32 with TF32 off; it imports nothing of
the program and no JAX.  The dot forward is `dlrm.py`'s.

Written from the recipe (mlcommons/training, recommendation_v2/
torchrec_dlrm: `dlrm_main.py` and its README's run command) and DCN V2's
low-rank cross layer (arXiv:2008.13535, torchrec's `LowRankCrossNet`):

- ids [B, sum L_t], table t's bag in its L_t consecutive columns, every
  slot's row gathered and the slots of a table pooled by `index_add` (one
  id a table is bags of 1);
- dcn: x0 = [bottom MLP output, the T pooled rows] flattened, then
  x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l; the top MLP; BCE;
- row-wise Adagrad on the tables: state[r] += mean(G_r^2), w_r -= lr G_r /
  (sqrt(state[r]) + eps), G_r the row's gradient summed over every slot
  that reads it, in float64, before the state moves; plain Adagrad on the
  MLPs and the cross network.

Departures from the recipe: eps 1e-10 (FBGEMM's default is 1e-8); b_l
drawn nonzero (the recipe's is zero), so that its gradient is tested; a
constant learning rate.

With `tf32` every matmul takes operands rounded to TF32 (`dlrm.py`'s
control); `half_batch`, `drop_slot` (each bag's last slot left out) and
`no_residual` (the cross layers without their `+ x_l`) are the faults the
check has to tell from the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from evbench.reference import dlrm

EPS = 1e-10


def _columns(bag_sizes: Sequence[int], device) -> torch.Tensor:
    return torch.tensor([t for t, n in enumerate(bag_sizes)
                         for _ in range(n)], dtype=torch.int64, device=device)


def gather(tables: Sequence[torch.Tensor], ids: torch.Tensor,
           bag_sizes: Sequence[int]) -> torch.Tensor:
    """Every slot's row, ids [B, sum L_t] -> [B, sum L_t, D]."""
    out, off = [], 0
    for t, n in enumerate(bag_sizes):
        out.append(tables[t][ids[:, off:off + n].long()])
        off += n
    return torch.cat(out, dim=1)


def without_last_slot(ids: torch.Tensor, bag_sizes: Sequence[int]):
    """(ids, bag sizes) with each bag's last slot left out."""
    cols, off = [], 0
    for n in bag_sizes:
        cols.append(ids[:, off:off + n - 1])
        off += n
    return torch.cat(cols, dim=1), [n - 1 for n in bag_sizes]


def pool(slots: torch.Tensor, bag_sizes: Sequence[int]) -> torch.Tensor:
    """[B, sum L_t, D] slot rows -> [B, T, D]: `index_add` in float64,
    rounded to float32 once, so that the order of the device's atomic adds
    does not move the sum."""
    B, _, D = slots.shape
    return torch.zeros((B, len(bag_sizes), D), dtype=torch.float64,
                       device=slots.device).index_add(
        1, _columns(bag_sizes, slots.device), slots.double()).float()


def forward(w: Dict, dense: torch.Tensor, rows: torch.Tensor, op: str,
            tf32: bool = False, no_residual: bool = False) -> torch.Tensor:
    """Logits [B] from dense [B, nd] and pooled rows [B, T, D]."""
    if op == "dot":
        return dlrm.forward(w, dense, rows, tf32)
    mm = dlrm._matmul(tf32)
    x = dense
    for W, b in w["bot"]:
        x = torch.relu(mm(x, W.t()) + b)
    x0 = torch.cat([x[:, None, :], rows], dim=1).reshape(x.shape[0], -1)
    z = x0
    for V, W, b in w["cross"]:
        z = x0 * (mm(mm(z, V.t()), W.t()) + b) + (0.0 if no_residual else z)
    top = w["top"]
    for k, (W, b) in enumerate(top):
        z = mm(z, W.t()) + b
        if k < len(top) - 1:
            z = torch.relu(z)
    return z[:, 0]


def leaves(w: Dict) -> List[torch.Tensor]:
    """The MLPs' weights and biases, then the cross network's V, W, b."""
    return [t for part in ("bot", "top", "cross") for layer in w.get(part, [])
            for t in layer]


def _copy(w: Dict) -> Dict:
    return {p: [tuple(t.clone() for t in layer) for layer in w[p]]
            for p in w}


def rwsadagrad_steps(w: Dict, tables: Sequence[torch.Tensor], batches,
                     bag_sizes: Sequence[int], lr: float, op: str,
                     eps: float = EPS, keep: Sequence[int] = (0, 2),
                     tf32: bool = False, half_batch: bool = False,
                     drop_slot: bool = False, no_residual: bool = False):
    """One step a batch (dense, ids [B, sum L_t] into `tables`, labels)
    from weights `w` and `tables` (one [n_t, D] each) with every sum at
    zero.  Returns (losses, {k: state after step k + 1 for k in keep}),
    a state {"leaves", "tables", "dense_sums" (one a leaf), "row_sums"
    (one [n_t] a table)}."""
    w = _copy(w)
    tables = [t.clone() for t in tables]
    sums = [torch.zeros_like(t) for t in leaves(w)]
    row_sums = [torch.zeros(t.shape[0], dtype=torch.float32,
                            device=t.device) for t in tables]
    losses, states = [], {}
    sizes = list(bag_sizes)
    for k, (dense, ids, labels) in enumerate(batches):
        if half_batch:
            h = dense.shape[0] // 2
            dense, ids, labels = dense[:h], ids[:h], labels[:h]
        if drop_slot:
            ids, bag_sizes = without_last_slot(ids, sizes)
        ls = leaves(w)
        for t in ls:
            t.requires_grad_(True)
        slots = gather(tables, ids, bag_sizes).requires_grad_(True)
        loss = dlrm.bce(forward(w, dense, pool(slots, bag_sizes), op, tf32,
                                no_residual), labels)
        loss.backward()
        with torch.no_grad():
            for t, s in zip(ls, sums):
                s += t.grad * t.grad
                t -= lr * t.grad / (torch.sqrt(s) + eps)
                t.grad = None
                t.requires_grad_(False)
            off = 0
            for t, n in enumerate(bag_sizes):
                rows = ids[:, off:off + n].reshape(-1).long()
                g = slots.grad[:, off:off + n].reshape(-1, slots.shape[2])
                off += n
                uniq, inv = torch.unique(rows, return_inverse=True)
                G = torch.zeros((uniq.numel(), g.shape[1]),
                                dtype=torch.float64,
                                device=g.device).index_add_(0, inv,
                                                            g.double())
                del g
                st = (row_sums[t][uniq].double() + (G * G).mean(dim=1)
                      ).float()
                row_sums[t][uniq] = st
                upd = lr * G / (torch.sqrt(st.double()) + eps)[:, None]
                tables[t][uniq] = (tables[t][uniq].double() - upd).float()
                del G, upd
        losses.append(float(loss.detach()))
        if k in keep:
            states[k] = {"leaves": [t.clone() for t in leaves(w)],
                         "tables": [t.clone() for t in tables],
                         "dense_sums": [s.clone() for s in sums],
                         "row_sums": [s.clone() for s in row_sums]}
    return losses, states
