"""Training and evaluation steps and the training loop.

Port of `evstore_tpu/train/train_loop.py` for plain tables and one-hot
batches.  Reference: the epoch loop of dlrm_s_pytorch.py:1574-1854
(forward, BCE loss, backward, optimizer step, LR policy, eval).

As in the JAX package, the step gathers the batch's embedding rows outside
autograd (the row-gather kernel), differentiates the loss with respect to
those rows and the MLP parameters (the interaction's forward and backward
kernels), and applies the sparse row updates: rwsadagrad with its kernel on
updates every table in one grouped call (one sort, one row-update kernel
launch, the accumulators as one flat buffer); sgd, adagrad and the plain
rwsadagrad update table by table.  The embedding gradient never exists as
a dense [N, D] array.  The step updates the model and the optimizer state in place; the
gathered rows are a copy, so the in-place table update is invisible to
autograd.  Not ported yet: qr/md tables, multi-hot bags, weighted pooling,
the packed table layout and checkpoints.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from evstore_tpu_torch.config import DLRMConfig, TrainConfig
from evstore_tpu_torch.models.dlrm import DLRM, dlrm_loss
from evstore_tpu_torch.models.embedding import (check_ids,
                                                sparse_arch_lookup)
from evstore_tpu_torch.ops.cuda_update import rwsadagrad_row_update
from evstore_tpu_torch.train.metrics import binary_metrics
from evstore_tpu_torch.train.optim import (OptState, dense_parameters,
                                           flat_row_state, lr_schedule,
                                           make_optimizer, row_update)

span = torch.profiler.record_function


def init_opt_state(model: DLRM, tcfg: TrainConfig) -> OptState:
    return make_optimizer(tcfg.optimizer)[0](model)


def unpack_batch(batch):
    """(dense, idx, labels) of a one-hot batch.  A 4-tuple is a multi-hot
    batch with bag weights, which is not ported yet."""
    if len(batch) == 4:
        raise NotImplementedError(
            "multi-hot batches with bag weights are not ported yet")
    return batch


def _check(model: DLRM, cfg: DLRMConfig) -> torch.device:
    if model.cfg != cfg:
        raise ValueError("the model was built from another DLRMConfig")
    if len(model.tables) != cfg.num_tables:
        raise ValueError("the model holds no tables; training needs them")
    return model.tables[0].device


def _tensor(a, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device=dev, dtype=dtype)


def _ids(idx, cfg: DLRMConfig, dev: torch.device) -> torch.Tensor:
    """One-hot ids [B, T] as an int32 tensor.  Ids still on the host are
    checked there (`check_ids`: ValueError outside [0, N)); a tensor is
    taken as it is."""
    if not isinstance(idx, torch.Tensor):
        idx = np.asarray(idx)
    if idx.ndim != 2:
        raise NotImplementedError(
            "multi-hot [B, T, L] bags are not ported yet; idx must be [B, T]")
    if isinstance(idx, np.ndarray):
        check_ids(idx, cfg.table_sizes)
    return _tensor(idx, dev, torch.int32)


def make_train_step(cfg: DLRMConfig, tcfg: TrainConfig):
    """Builds the train step:
    (model, opt_state, dense_x [B, nd], idx [B, T], labels [B]) -> loss.

    The inputs are numpy arrays or tensors.  The step updates the model's
    parameters and `opt_state` in place and returns the loss as a 0-d tensor
    on the model's device (reading it waits for the device).  Its four
    stages are `torch.profiler` spans named `train_step.<stage>`.  With the
    kernels on, the gather is one launch for every table, and so is
    rwsadagrad's row update, which needs `opt_state`'s accumulators to be
    the views of one flat buffer that `init_opt_state` and
    `opt_state_from_jax` build (ValueError otherwise)."""
    _, dense_update, _ = make_optimizer(tcfg.optimizer)
    grouped = (tcfg.optimizer.lower() == "rwsadagrad"
               and tcfg.use_update_kernel)
    lr_fn = lr_schedule(tcfg.learning_rate, tcfg.lr_num_warmup_steps,
                        tcfg.lr_decay_start_step, tcfg.lr_num_decay_steps)

    def train_step(model: DLRM, opt_state: OptState, dense_x, idx,
                   labels) -> torch.Tensor:
        dev = _check(model, cfg)
        dense_x = _tensor(dense_x, dev, torch.float32)
        idx = _ids(idx, cfg, dev)
        labels = _tensor(labels, dev, torch.float32)
        tables = list(model.tables)
        # checked before anything is updated
        flat = flat_row_state(opt_state.sparse, tables) if grouped else None
        with span("train_step.gather"), torch.no_grad():
            emb = sparse_arch_lookup(tables, idx, cfg)
        emb.requires_grad_(True)
        params = dense_parameters(model)
        with span("train_step.forward_backward"):
            for p in params.values():
                p.grad = None
            loss = dlrm_loss(model(dense_x, None, emb_rows=emb), labels,
                             tcfg.loss_function, tcfg.loss_weights)
            loss.backward()
        lr = lr_fn(opt_state.step)
        with span("train_step.dense_update"):
            dense_update(opt_state.dense, params, lr)
        with span("train_step.row_update"):
            if grouped:      # one sort and one kernel launch for all tables
                with torch.no_grad():
                    rwsadagrad_row_update(flat, tables, idx, emb.grad, lr)
            else:
                for t, tab in enumerate(tables):
                    row_update(tcfg.optimizer,
                               opt_state.sparse.get(f"tables.{t}"), tab,
                               idx[:, t], emb.grad[:, t], lr,
                               use_kernel=tcfg.use_update_kernel)
        opt_state.step += 1
        return loss.detach()

    return train_step


def make_eval_step(cfg: DLRMConfig):
    def eval_step(model: DLRM, dense_x, idx) -> torch.Tensor:
        dev = _check(model, cfg)
        with torch.inference_mode():
            return torch.sigmoid(model(
                _tensor(dense_x, dev, torch.float32),
                _ids(idx, cfg, dev)))
    return eval_step


def evaluate(model: DLRM, cfg: DLRMConfig, batches: Iterable
             ) -> Dict[str, float]:
    """Run inference over batches and compute the reference's metric block
    (dlrm_s_pytorch.py:760-866)."""
    eval_step = make_eval_step(cfg)
    scores, labels = [], []
    for batch in batches:
        dense_x, idx, y = unpack_batch(batch)
        scores.append(eval_step(model, dense_x, idx))
        labels.append(np.asarray(y))
    return binary_metrics(torch.cat(scores).cpu().numpy(),
                          np.concatenate(labels))


def train(model: DLRM, cfg: DLRMConfig, tcfg: TrainConfig,
          train_batches: Iterable, test_batches=None,
          log_fn=print) -> Tuple[DLRM, OptState, Dict]:
    """A simple epoch loop (the big loop of dlrm_s_pytorch.py:1574-1854).
    train_batches: iterable of (dense, idx, labels) numpy batches.  Returns
    the trained model (the same object), the optimizer state and a history
    with the loss every `print_freq` steps and the steps per second."""
    step_fn = make_train_step(cfg, tcfg)
    opt_state = init_opt_state(model, tcfg)
    dev = _check(model, cfg)
    losses = []
    t0 = time.perf_counter()
    n = 0
    for batch in train_batches:
        dense_x, idx, y = unpack_batch(batch)
        loss = step_fn(model, opt_state, dense_x, idx, y)
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
