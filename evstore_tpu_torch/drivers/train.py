"""Training driver: the DLRM train and eval loop with checkpoints and the
EV export.

Port of `evstore_tpu/drivers/train.py::run_training`.  Reference:
dlrm_s_pytorch.py run() (:922-1990): the epoch loop, the periodic eval
(test_freq), a checkpoint and the per-table EV export on every new best
eval, the MLPerf threshold early exit, and resume with the skip-upto fast
forward.

The model is the port's own init from `seed` (`DLRM(cfg, seed=seed)`), or
the caller's `model` (for example the JAX package's weights through
`convert.params_from_jax`: torch cannot replay `jax.random`).  It trains on
`device` (the card unless the caller says otherwise).  Not ported: the mesh
options (`mesh`, the butterfly and alltoall exchanges, `dedup_exchange`;
ROADMAP queue 1 item 8) and `run_cached_training` (item 7).

Besides the JAX package's log lines, the driver logs the seconds and GB/s
of every checkpoint save, the restore and every EV export, and the steps
per second of the loop without its evals and saves.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Callable, Iterable, Optional

import torch

from evstore_tpu_torch.config import DLRMConfig, TrainConfig
from evstore_tpu_torch.models.dlrm import DLRM
from evstore_tpu_torch.train.optim import OptState
from evstore_tpu_torch.train.train_loop import (evaluate, init_opt_state,
                                                make_eval_step,
                                                make_train_step,
                                                unpack_batch)
from evstore_tpu_torch.utils.checkpoint import (checkpoint_path,
                                                export_ev_tables,
                                                latest_step,
                                                restore_checkpoint,
                                                save_checkpoint)
from evstore_tpu_torch.utils.logging import MLPerfLogger

MESH_ITEM = "ROADMAP queue 1 item 8 (multi-GPU)"


@dataclasses.dataclass
class TrainResult:
    model: DLRM
    opt_state: OptState
    best_metric: float
    steps: int
    history: dict


def _fence(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_training(cfg: DLRMConfig, tcfg: TrainConfig,
                 make_train_batches: Callable[[], Iterable],
                 make_test_batches: Optional[Callable[[], Iterable]] = None,
                 ckpt_dir: Optional[str] = None,
                 ev_export_dir: Optional[str] = None,
                 resume: bool = False,
                 seed: int = 0,
                 mesh=None,
                 dedup_exchange: bool = False,
                 alltoall_impl: str = "psum",
                 multihot: bool = False,
                 log_fn=print,
                 model: Optional[DLRM] = None,
                 device=None) -> TrainResult:
    """A full training run.  make_*_batches are zero-argument callables
    that return a fresh batch iterator (each epoch iterates again).
    `multihot` is accepted for the JAX signature: the step takes one-hot
    and bagged batches by their shape.  The model is trained in place."""
    if mesh is not None or alltoall_impl != "psum" or dedup_exchange:
        raise NotImplementedError(
            f"mesh training (mesh, alltoall_impl={alltoall_impl!r}, "
            f"dedup_exchange) is not ported yet: {MESH_ITEM}")
    del multihot
    mll = MLPerfLogger(log_fn=log_fn)
    mll.event("init_start")
    if model is None:
        model = DLRM(cfg, device=device, seed=seed)
    elif model.cfg != cfg:
        raise ValueError("the model was built from another DLRMConfig")
    dev = next(model.parameters()).device
    opt_state = init_opt_state(model, tcfg)
    start_step = 0
    if resume and ckpt_dir:
        s = latest_step(ckpt_dir)
        if s is not None:
            t0 = time.perf_counter()
            restore_checkpoint(ckpt_dir, s, model, opt_state)
            _fence(dev)
            dt = time.perf_counter() - t0
            gb = os.path.getsize(checkpoint_path(ckpt_dir, s)) / 1e9
            start_step = s
            log_fn(f"resumed from checkpoint step {s} ({gb:.3f} GB in "
                   f"{dt:.3f} s, {gb / max(dt, 1e-9):.3f} GB/s)")

    step_fn = make_train_step(cfg, tcfg)
    eval_step = make_eval_step(cfg) if make_test_batches else None
    best = -float("inf")
    history = {"loss": [], "eval": []}
    step = 0
    should_stop = False
    t_aside = 0.0     # evals, checkpoints and exports, off the step rate

    def new_best(metrics):
        """Checkpoint and export on a new best eval (dlrm_s_pytorch.py:
        1755-1796)."""
        nonlocal best
        score = metrics["auc"] if not math.isnan(metrics["auc"]) \
            else metrics["accuracy"]
        if score <= best:
            return
        best = score
        if ckpt_dir:
            t0 = time.perf_counter()
            path = save_checkpoint(ckpt_dir, step, model, opt_state,
                                   extra={"metrics": metrics})
            dt = time.perf_counter() - t0
            gb = os.path.getsize(path) / 1e9
            log_fn(f"checkpoint step_{step}: {gb:.3f} GB in {dt:.3f} s "
                   f"({gb / max(dt, 1e-9):.3f} GB/s)")
        if ev_export_dir:
            t0 = time.perf_counter()
            paths = export_ev_tables(model, ev_export_dir,
                                     table_sizes=cfg.table_sizes)
            dt = time.perf_counter() - t0
            gb = sum(os.path.getsize(p) for p in paths) / 1e9
            log_fn(f"EV tables exported: {gb:.3f} GB in {dt:.3f} s "
                   f"({gb / max(dt, 1e-9):.3f} GB/s)")

    def run_eval():
        nonlocal t_aside
        t0 = time.perf_counter()
        metrics = evaluate(model, cfg, make_test_batches(), eval_step)
        history["eval"].append((step, metrics))
        new_best(metrics)
        t_aside += time.perf_counter() - t0
        return metrics

    mll.event("init_stop")
    mll.event("run_start")
    t_run = t0 = time.perf_counter()
    n_since = n_run = 0
    for epoch in range(tcfg.nepochs):
        mll.event("epoch_start", {"epoch": epoch})
        for batch in make_train_batches():
            dense_x, idx, y, bw = unpack_batch(batch)
            step += 1
            if step <= start_step:
                continue   # skip-upto fast-forward (dlrm_s_pytorch.py:1605)
            loss = step_fn(model, opt_state, dense_x, idx, y, bw)
            n_since += 1
            n_run += 1
            if step % max(tcfg.print_freq, 1) == 0:
                lv = float(loss)
                dt = time.perf_counter() - t0
                history["loss"].append((step, lv))
                log_fn(f"step {step}: loss {lv:.6f} "
                       f"({n_since * dense_x.shape[0] / max(dt, 1e-9):.0f} "
                       "examples/s)")
                t0, n_since = time.perf_counter(), 0
            if (make_test_batches and tcfg.test_freq > 0
                    and step % tcfg.test_freq == 0):
                metrics = run_eval()
                mll.event("eval_accuracy", {"step": step, **metrics})
                log_fn(f"eval @ {step}: auc {metrics['auc']:.4f} "
                       f"acc {metrics['accuracy']:.4f}")
                if (tcfg.mlperf_auc_threshold > 0
                        and metrics["auc"] >= tcfg.mlperf_auc_threshold):
                    mll.event("run_stop", {"status": "success"})
                    log_fn(f"hit target AUC {tcfg.mlperf_auc_threshold}")
                    should_stop = True
                if (tcfg.mlperf_acc_threshold > 0
                        and metrics["accuracy"]
                        >= tcfg.mlperf_acc_threshold):
                    should_stop = True
            if should_stop:
                break
        mll.event("epoch_stop", {"epoch": epoch})
        if should_stop:
            break
    _fence(dev)
    dt = time.perf_counter() - t_run - t_aside
    log_fn(f"trained {n_run} steps in {dt:.3f} s "
           f"({n_run / max(dt, 1e-9):.2f} steps/s)")

    # the final eval, with its checkpoint and export on a new best
    if make_test_batches:
        run_eval()
    mll.event("run_stop", {"status": "done"})
    return TrainResult(model=model, opt_state=opt_state, best_metric=best,
                       steps=step, history=history)
