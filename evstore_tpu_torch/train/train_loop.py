"""Training and evaluation steps and the training loop.

Port of `evstore_tpu/train/train_loop.py`.  Reference: the epoch loop of
dlrm_s_pytorch.py:1574-1854 (forward, BCE loss, backward, optimizer step,
LR policy, eval).

As in the JAX package, the step gathers the batch's embedding rows outside
autograd, differentiates the loss with respect to those rows, the MLPs and
the md projections (the interaction's forward and backward kernels), and
applies row updates to what it gathered.  Every row comes through the
grouped row-gather kernel, one launch per width (`models/embedding.py`:
plain tables, q and r, md tables, pooling weights; a multi-hot batch
[B, T, L] is B·L lookups per table), and every row update through the
row-update kernel, one sort per update group (the sources of one width
under one row rule, `train/optim.py::update_groups`) and one call of
it (under adagrad two: the run sums, then the update), with
the optimizer state as one flat buffer a group.  The q, r and md tables
take the JAX package's dense branch (elementwise adagrad under adagrad
and rwsadagrad) on the rows the batch touched, which equals the dense
update: the other rows have a zero gradient.  No update waits for the
device.  With `use_update_kernel` off each table takes the plain
coalescing update (`dedup_rows`).  The embedding gradient never exists as
a dense [N, D] array.  The step updates the model and the optimizer state
in place; the gathered rows are a copy, so the in-place table update is
invisible to autograd.  Not ported: the packed table layout (a TPU
lowering).  Checkpoints are `utils/checkpoint.py`'s, and the driver with
periodic eval and resume is `drivers/train.py::run_training`.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from evstore_tpu_torch.config import DLRMConfig, TrainConfig
from evstore_tpu_torch.models.dlrm import DLRM, dlrm_loss
from evstore_tpu_torch.models.embedding import (bag_columns, check_ids,
                                                combine_rows, flat_ids,
                                                gather_groups, gather_rows_of,
                                                group_ids)
from evstore_tpu_torch.train.metrics import binary_metrics
from evstore_tpu_torch.train.optim import (OptState, dense_parameters,
                                           flat_row_state, lr_schedule,
                                           make_optimizer, row_update,
                                           update_groups)
from evstore_tpu_torch.utils.profiling import span


def init_opt_state(model: DLRM, tcfg: TrainConfig) -> OptState:
    return make_optimizer(tcfg.optimizer)[0](model)


def unpack_batch(batch):
    """A batch as (dense, idx, labels, bag_weights): 3-tuples are (dense,
    idx, y) with no bag weights; 4-tuples are (dense, idx, bag_weights of
    idx's shape, y).  idx is [B, T], one id a table; or [B, T, L], bags
    padded to one L (id 0, weight 0); or, under the config's
    `multi_hot_sizes` L_t, [B, sum L_t], table t's bag in its L_t
    consecutive columns in table order, no slot padded."""
    if len(batch) == 4:
        d, i, w, y = batch
        return d, i, y, w
    d, i, y = batch
    return d, i, y, None


def _check(model: DLRM, cfg: DLRMConfig) -> torch.device:
    if model.cfg != cfg:
        raise ValueError("the model was built from another DLRMConfig")
    if not model.has_sparse():
        raise ValueError("the model holds no tables; training needs them")
    return next(model.parameters()).device


def _tensor(a, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device=dev, dtype=dtype)


def _checked_ids(idx, cfg: DLRMConfig):
    """Ids [B, T], bags [B, T, L] or bags of a length per table
    [B, sum L_t] where they lie.  Ids still on the host are checked there
    (`check_ids`: ValueError outside [0, N) of the column's table, one
    unsigned compare for int32 and int64 ids); a tensor's shape alone is
    checked.  Nothing waits for the device, so the train step runs it
    before its first copy."""
    if not isinstance(idx, torch.Tensor):
        idx = np.asarray(idx)
    if idx.ndim not in (2, 3):
        raise ValueError(f"idx must be [B, T] or [B, T, L], got "
                         f"{tuple(idx.shape)}")
    bag_columns(cfg, idx)
    if isinstance(idx, np.ndarray):
        check_ids(idx, cfg.table_sizes,
                  cfg.multi_hot_sizes if idx.ndim == 2 else ())
    return idx


def _ids(idx, cfg: DLRMConfig, dev: torch.device) -> torch.Tensor:
    """Ids [B, T] or bags [B, T, L], checked, as an int32 tensor."""
    return _tensor(_checked_ids(idx, cfg), dev, torch.int32)


def _copy(a, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """`_tensor` in the train step's span for its host-to-device copies."""
    with span("train_step.inputs.copy"):
        return _tensor(a, dev, dtype)


def _bag_weights(w, idx: torch.Tensor, dev: torch.device,
                 cfg: DLRMConfig = None):
    if w is None:
        return None
    w = _tensor(w, dev, torch.float32)
    bags = idx.dim() == 3 or (idx.dim() == 2 and cfg is not None
                              and bool(cfg.multi_hot_sizes))
    if not bags or tuple(w.shape) != tuple(idx.shape):
        raise ValueError(f"bag weights {tuple(w.shape)} need bags idx of "
                         f"the same shape, got {tuple(idx.shape)}")
    return w


def make_train_step(cfg: DLRMConfig, tcfg: TrainConfig):
    """Builds the train step: (model, opt_state, dense_x [B, nd], idx [B, T],
    [B, T, L] or under `multi_hot_sizes` [B, sum L_t] (`unpack_batch`),
    labels [B], bag_weights of idx's shape or None) -> loss.

    The inputs are numpy arrays or tensors.  The step updates the model's
    parameters and `opt_state` in place and returns the loss as a 0-d tensor
    on the model's device (reading it waits for the device).  While a
    profiler runs, the step is the span `train_step`; inside it
    `train_step.inputs` brings the batch to the device (its host id check
    `train_step.inputs.check` and each copy `train_step.inputs.copy`), and
    the four stages are `train_step.<stage>`.  The prologue checks the
    host ids before its first copy: a copy from pageable memory waits for
    the device's previous step, so the check runs while the device still
    works, and a bad id raises before any copy or update.  With the
    kernels on, the gather is one launch per width and the row update one
    call per update group (for a one-hot batch over plain tables, one each
    for all tables; bags of a length per table gather B x sum L_t rows and
    coalesce a row's entries from all its bags in the one sort), a launch of the row-update kernel under sgd and two
    under adagrad and rwsadagrad; the grouped updates need `opt_state`'s
    sums to be the views of one flat buffer a group that `init_opt_state` and
    `opt_state_from_jax` build (ValueError otherwise).  Under
    `weighted_pooling="learned"` the pooling weights take the optimizer's
    row update; "fixed" leaves them alone."""
    name = tcfg.optimizer.lower()
    _, dense_update, _ = make_optimizer(name)
    learned = cfg.weighted_pooling == "learned"
    lr_fn = lr_schedule(tcfg.learning_rate, tcfg.lr_num_warmup_steps,
                        tcfg.lr_decay_start_step, tcfg.lr_num_decay_steps)

    def train_step(model: DLRM, opt_state: OptState, dense_x, idx,
                   labels, bag_weights=None) -> torch.Tensor:
        with span("train_step"):
            return step(model, opt_state, dense_x, idx, labels, bag_weights)

    def step(model, opt_state, dense_x, idx, labels, bag_weights):
        dev = _check(model, cfg)
        with span("train_step.inputs"):
            with span("train_step.inputs.check"):
                idx = _checked_ids(idx, cfg)
            dense_x = _copy(dense_x, dev, torch.float32)
            idx = _copy(idx, dev, torch.int32)
            labels = _copy(labels, dev, torch.float32)
            if bag_weights is not None:
                bag_weights = _copy(bag_weights, dev, torch.float32)
            bw = _bag_weights(bag_weights, idx, dev, cfg)
        sources = model.row_sources()
        groups = gather_groups(sources)
        updates = [u for u in update_groups(sources, name)
                   if learned or sources[u.members[0]].part != "pool_w"]
        # checked before anything is updated
        flats = [flat_row_state(opt_state.sparse,
                                [sources[i].param for i in u.members],
                                [sources[i].name for i in u.members])
                 if tcfg.use_update_kernel and u.rule != "sgd" else None
                 for u in updates]
        flat = flat_ids(idx)
        cols = bag_columns(cfg, idx)
        with span("train_step.gather"), torch.no_grad():
            ids_of = [group_ids(sources, m, flat, cols) for m in groups]
            gathered = gather_rows_of(sources, groups, ids_of,
                                      cfg.use_gather_kernel, cols)
        for g in {u.gather for u in updates}:
            gathered[g].requires_grad_(True)
        params = dense_parameters(model)
        with span("train_step.forward_backward"):
            for p in params.values():
                p.grad = None
            emb = combine_rows(cfg, sources, groups, gathered,
                               model.entries(), tuple(idx.shape), bw)
            loss = dlrm_loss(model(dense_x, None, emb_rows=emb), labels,
                             tcfg.loss_function, tcfg.loss_weights)
            loss.backward()
        lr = lr_fn(opt_state.step)
        with span("train_step.dense_update"):
            dense_update(opt_state.dense, params, lr)
        with span("train_step.row_update"), torch.no_grad():
            for u, st in zip(updates, flats):
                ids, grads = ids_of[u.gather], gathered[u.gather].grad
                if not cols and (u.lo, u.hi) != (0, ids.shape[1]):
                    ids, grads = ids[:, u.lo:u.hi], grads[:, u.lo:u.hi]
                tabs = [sources[i].param for i in u.members]
                if tcfg.use_update_kernel:
                    row_update(u.rule, st, tabs, ids, grads, lr,
                               columns=cols)
                    continue
                for j, i in enumerate(u.members):
                    # table j's columns: its one, or its bag's L_j
                    sel = [c for c, t in enumerate(cols) if t == j] or [j]
                    row_update(u.rule, opt_state.sparse.get(sources[i].name),
                               tabs[j], ids[:, sel].reshape(-1),
                               grads[:, sel].reshape(-1, grads.shape[-1]),
                               lr, use_kernel=False)
        opt_state.step += 1
        return loss.detach()

    return train_step


def make_eval_step(cfg: DLRMConfig):
    def eval_step(model: DLRM, dense_x, idx, bag_weights=None
                  ) -> torch.Tensor:
        dev = _check(model, cfg)
        idx = _ids(idx, cfg, dev)
        with torch.inference_mode():
            return torch.sigmoid(model(
                _tensor(dense_x, dev, torch.float32), idx,
                bag_weights=_bag_weights(bag_weights, idx, dev, cfg)))
    return eval_step


def evaluate(model: DLRM, cfg: DLRMConfig, batches: Iterable,
             eval_step=None) -> Dict[str, float]:
    """Run inference over batches (one-hot 3-tuples or multi-hot 4-tuples
    with bag weights) and compute the reference's metric block
    (dlrm_s_pytorch.py:760-866).  `eval_step` is `make_eval_step(cfg)`'s
    function unless the caller passes its own."""
    if eval_step is None:
        eval_step = make_eval_step(cfg)
    scores, labels = [], []
    for batch in batches:
        dense_x, idx, y, bw = unpack_batch(batch)
        scores.append(eval_step(model, dense_x, idx, bw))
        labels.append(np.asarray(y))
    return binary_metrics(torch.cat(scores).cpu().numpy(),
                          np.concatenate(labels))


def train(model: DLRM, cfg: DLRMConfig, tcfg: TrainConfig,
          train_batches: Iterable, test_batches=None,
          log_fn=print) -> Tuple[DLRM, OptState, Dict]:
    """A simple epoch loop (the big loop of dlrm_s_pytorch.py:1574-1854).
    train_batches: iterable of one-hot (dense, idx, labels) or multi-hot
    (dense, idx, bag_weights, labels) numpy batches.  Returns the trained
    model (the same object), the optimizer state and a history with the
    loss every `print_freq` steps and the steps per second."""
    step_fn = make_train_step(cfg, tcfg)
    opt_state = init_opt_state(model, tcfg)
    dev = _check(model, cfg)
    losses = []
    t0 = time.perf_counter()
    n = 0
    for batch in train_batches:
        dense_x, idx, y, bw = unpack_batch(batch)
        loss = step_fn(model, opt_state, dense_x, idx, y, bw)
        n += 1
        if n % max(tcfg.print_freq, 1) == 0:
            lv = float(loss)
            losses.append(lv)
            log_fn(f"step {n}: loss {lv:.6f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    history = {"loss": losses,
               "it_per_s": n / dt if dt > 0 else float("inf")}
    if test_batches is not None:
        history["eval"] = evaluate(model, cfg, test_batches)
    return model, opt_state, history
