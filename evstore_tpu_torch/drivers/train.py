"""Training drivers: the DLRM train and eval loop with checkpoints and the
EV export, and the same loop through the device-memory-bounded cache.

Port of `evstore_tpu/drivers/train.py`: `run_training` and
`run_cached_training` with its helpers.  Reference:
dlrm_s_pytorch.py run() (:922-1990): the epoch loop, the periodic eval
(test_freq), a checkpoint and the per-table EV export on every new best
eval, the MLPerf threshold early exit, and resume with the skip-upto fast
forward.

The model is the port's own init from `seed` (`DLRM(cfg, seed=seed)`), or
the caller's `model` (for example the JAX package's weights through
`convert.params_from_jax`: torch cannot replay `jax.random`).  It trains on
`device` (the card unless the caller says otherwise).

With a `mesh` (`parallel/mesh.py`, one process per rank, every rank
calling `run_training` with the same arguments and batches) it trains
SPMD: `alltoall_impl="psum"` row-shards the plain tables over the model
axis (`parallel/sharded.py`, optionally with `dedup_exchange`);
"butterfly" or "alltoall" places whole tables on the ranks of the world,
as `parallel/planner.py::plan_table_shards` orders them, and exchanges
with all-to-alls (`parallel/butterfly.py`).  Evaluation scores come back
whole on every rank, so every rank takes the same decisions.  Checkpoints
and EV exports of a mesh run are the single-device files, written by rank
0 after the tables are gathered one at a time, so any run resumes them at
any mesh shape; a resumed run carries its optimizer state and step on
every route.  Only rank 0 logs.

`run_cached_training` trains through `cache/trainable.py::
TrainableDeviceCache`: the tables stay in host memory (or on disk, mapped
from the EV .bin files), and the card holds the cache's cells and the
MLPs.  Its checkpoint on a new best eval is the cache's `table_<t>.npy` /
`mom_<t>.npy` files beside `dense_params.npz` (the MLPs and their sums
under the JAX package's `p...` / `s...` keys, weights [in, out]) and
`best.json`, the JAX package's files, which either package restores.  A
run with no eval writes `dense_params.npz` and `best.json` at its end
(the JAX driver writes no MLPs there), beside the table files where the
masters are in memory; mapped masters are the flushed .bin files.
With a mesh it trains through `ShardedTrainableDeviceCache`, one batch at
a time as the JAX driver drives its sharded class; rank 0 holds the
masters, scores the evals and broadcasts their metrics, and alone writes
the files, which are the one-device run's.

Besides the JAX package's log lines, the driver logs the seconds and GB/s
of every checkpoint save, the restore and every EV export, and the steps
per second of the loop without its evals and saves.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from evstore_tpu_torch.config import DLRMConfig, TrainConfig
from evstore_tpu_torch.convert import mlps_from_jax, mlps_to_numpy
from evstore_tpu_torch.models.dlrm import DLRM, init_host_tables
from evstore_tpu_torch.train.metrics import binary_metrics
from evstore_tpu_torch.train.optim import OptState
from evstore_tpu_torch.train.train_loop import (evaluate, init_opt_state,
                                                make_eval_step,
                                                make_train_step,
                                                unpack_batch)
from evstore_tpu_torch.utils.checkpoint import (DENSE_NPZ,
                                                checkpoint_path,
                                                export_ev_tables,
                                                latest_step, npz_dense_tree,
                                                npz_key, restore_checkpoint,
                                                save_checkpoint)
from evstore_tpu_torch.utils.device import resolve_device
from evstore_tpu_torch.utils.logging import MLPerfLogger, quiet

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


class _Route:
    """How `run_training` steps, scores and snapshots its state: on one
    device, row-sharded over a mesh, or through the butterfly."""

    def __init__(self, cfg, tcfg, model, opt_state, mesh, alltoall_impl,
                 dedup_exchange, log_fn):
        self.cfg, self.tcfg, self.mesh = cfg, tcfg, mesh
        if mesh is None:
            self.kind = "single"
            self.model, self.opt = model, opt_state
            self._step = make_train_step(cfg, tcfg)
            self._eval = make_eval_step(cfg)
        elif alltoall_impl in ("butterfly", "alltoall"):
            from evstore_tpu_torch.parallel import butterfly as bf
            from evstore_tpu_torch.parallel.planner import plan_table_shards
            self.kind = "butterfly"
            # LPT-balanced placement (the reference splits contiguously);
            # a layout choice, numerically the same
            order, imb = plan_table_shards(cfg.table_sizes, mesh.world)
            log_fn(f"butterfly placement: order {order} (imbalance "
                   f"{imb:.2f})")
            self.model = bf.init_butterfly_state(model, tcfg, mesh, order,
                                                 opt_state)
            self.opt = None
            self._step = bf.make_butterfly_train_step(
                cfg, tcfg, mesh, dedup_exchange=dedup_exchange,
                table_order=order)
            self._eval = bf.make_butterfly_eval_step(cfg, mesh, order)
        else:
            from evstore_tpu_torch.parallel import sharded as sh
            self.kind = "psum"
            self.model, self.opt = sh.shard_dlrm_params(model, mesh,
                                                        opt_state)
            self._step = sh.make_sharded_train_step(
                cfg, tcfg, mesh, dedup_exchange=dedup_exchange)
            self._eval = sh.make_sharded_eval_step(
                cfg, mesh, dedup_exchange=dedup_exchange)

    def step(self, dense_x, idx, y, bw):
        if self.kind == "butterfly":
            return self._step(self.model, dense_x, idx, y, bw)
        return self._step(self.model, self.opt, dense_x, idx, y, bw)

    def evaluate(self, batches):
        return evaluate(self.model, self.cfg, batches, self._eval)

    def snapshot(self):
        """The single-device model and optimizer state: the trained ones
        without a mesh; over a mesh, gathered to the host of rank 0 one
        table at a time, and (None, None) on the other ranks (collective
        over the mesh's ranks)."""
        if self.kind == "single":
            return self.model, self.opt
        if self.kind == "butterfly":
            from evstore_tpu_torch.parallel.butterfly import unstack_state
            return unstack_state(self.model, self.cfg, self.mesh, self.tcfg,
                                 "cpu", dst=0)
        from evstore_tpu_torch.parallel.sharded import unshard_dlrm_params
        return unshard_dlrm_params(self.model, self.mesh, self.opt, "cpu",
                                   dst=0)


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
    and bagged batches by their shape.  Without a mesh the model is
    trained in place; with one (see the module's docstring) the result
    holds, on rank 0, the single-device model and optimizer state gathered
    from the ranks to its host (CPU), and on the other ranks None for both;
    the gather passes one table at a time through rank 0's card.  `alltoall_impl` and `dedup_exchange` choose a
    mesh's exchange: without one they raise ValueError."""
    from evstore_tpu_torch.parallel.mesh import Mesh
    del multihot
    if alltoall_impl not in ("psum", "butterfly", "alltoall"):
        raise ValueError(f"unknown alltoall_impl {alltoall_impl!r}")
    if mesh is None and (alltoall_impl != "psum" or dedup_exchange):
        raise ValueError(f"alltoall_impl={alltoall_impl!r} and "
                         f"dedup_exchange={dedup_exchange} choose a mesh's "
                         "exchange; pass a mesh (parallel/mesh.py)")
    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        device = mesh.device
        if mesh.rank != 0:
            log_fn = quiet
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

    route = _Route(cfg, tcfg, model, opt_state, mesh, alltoall_impl,
                   dedup_exchange, log_fn)
    if route.kind != "single":
        model = opt_state = None      # the route holds the rank's copy
    writer = mesh is None or mesh.rank == 0
    best = -float("inf")
    history = {"loss": [], "eval": []}
    step = 0
    should_stop = False
    t_aside = 0.0     # evals, checkpoints and exports, off the step rate

    def new_best(metrics):
        """Checkpoint and export on a new best eval (dlrm_s_pytorch.py:
        1755-1796); over a mesh, by rank 0 from the state gathered to its
        host."""
        nonlocal best
        score = metrics["auc"] if not math.isnan(metrics["auc"]) \
            else metrics["accuracy"]
        if score <= best:
            return
        best = score
        if not (ckpt_dir or ev_export_dir):
            return
        snap, snap_opt = route.snapshot()
        if not writer:
            return
        if ckpt_dir:
            t0 = time.perf_counter()
            path = save_checkpoint(ckpt_dir, step, snap, snap_opt,
                                   extra={"metrics": metrics})
            dt = time.perf_counter() - t0
            gb = os.path.getsize(path) / 1e9
            log_fn(f"checkpoint step_{step}: {gb:.3f} GB in {dt:.3f} s "
                   f"({gb / max(dt, 1e-9):.3f} GB/s)")
        if ev_export_dir:
            t0 = time.perf_counter()
            paths = export_ev_tables(snap, ev_export_dir,
                                     table_sizes=cfg.table_sizes)
            dt = time.perf_counter() - t0
            gb = sum(os.path.getsize(p) for p in paths) / 1e9
            log_fn(f"EV tables exported: {gb:.3f} GB in {dt:.3f} s "
                   f"({gb / max(dt, 1e-9):.3f} GB/s)")

    def run_eval():
        nonlocal t_aside
        t0 = time.perf_counter()
        metrics = route.evaluate(make_test_batches())
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
            loss = route.step(dense_x, idx, y, bw)
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
    model, opt_state = route.snapshot()
    return TrainResult(model=model, opt_state=opt_state, best_metric=best,
                       steps=step, history=history)


# --------------------------------------------------------- cached training

def _cached_eval(tc, cfg: DLRMConfig, model: DLRM,
                 make_test_batches: Callable[[], Iterable], mesh=None
                 ) -> Dict[str, float]:
    """Eval through the cached trainer: write the cache back to the masters,
    then score the test batches with their rows read from the masters on
    the host and handed to the forward, so that no table goes to the card
    (as run_training's periodic eval, dlrm_s_pytorch.py:1743-1796).  Over
    a mesh (collective) rank 0, which holds the masters, scores and
    broadcasts the metrics."""
    tc.flush_to_host()
    if mesh is None:
        return _score_from_masters(tc, cfg, model, make_test_batches)
    import torch.distributed as dist
    out = [_score_from_masters(tc, cfg, model, make_test_batches)
           if mesh.rank == 0 else None]
    dist.broadcast_object_list(out, src=0, group=mesh.group)
    return out[0]


def _score_from_masters(tc, cfg: DLRMConfig, model: DLRM,
                        make_test_batches: Callable[[], Iterable]
                        ) -> Dict[str, float]:
    dev = next(model.parameters()).device
    scores, labels = [], []
    with torch.inference_mode():
        for batch in make_test_batches():
            dense_x, idx, y = batch[0], np.asarray(batch[1]), batch[-1]
            rows = np.stack([tc.host_tables[t][idx[:, t]]
                             for t in range(cfg.num_tables)], axis=1)
            logits = model(torch.from_numpy(np.asarray(
                dense_x, np.float32)).to(dev), None,
                emb_rows=torch.from_numpy(rows).to(dev))
            scores.append(torch.sigmoid(logits).cpu().numpy())
            labels.append(np.asarray(y))
    return binary_metrics(np.concatenate(scores), np.concatenate(labels))


def _save_dense_npz(model: DLRM, dstate: Dict[str, torch.Tensor],
                    out_dir: str, step: int, metrics) -> None:
    """`dense_params.npz` and `best.json` beside the cache's `save` files:
    with them, the whole state of cached training at its best eval, or at
    its end (`metrics` None) where no eval ran."""
    os.makedirs(out_dir, exist_ok=True)
    flat = {}
    for prefix, state in (("p", dict(model.named_parameters())),
                          ("s", dstate)):
        for part, layers in mlps_to_numpy(state, model.cfg).items():
            for name, leaves in layers.items():
                for leaf, arr in leaves.items():
                    flat[npz_key(prefix, part, int(name[6:]), leaf)] = arr
    np.savez(os.path.join(out_dir, DENSE_NPZ), **flat)
    with open(os.path.join(out_dir, "best.json"), "w") as f:
        json.dump({"step": step, "metrics": metrics}, f)


def restore_dense_npz(model: DLRM, dstate: Dict[str, torch.Tensor],
                      out_dir: str):
    """The inverse of `_save_dense_npz`, in place: -> (model, dstate)."""
    cfg = model.cfg
    dev = next(model.parameters()).device
    with np.load(os.path.join(out_dir, DENSE_NPZ)) as z:
        for prefix, state in (("p", dict(model.named_parameters())),
                              ("s", dstate)):
            tree = npz_dense_tree(z, cfg, prefix)
            with torch.no_grad():
                for name, value in mlps_from_jax(tree, cfg, dev).items():
                    state[name].copy_(value)
    return model, dstate


def run_cached_training(cfg: DLRMConfig, tcfg: TrainConfig, ccfg,
                        make_train_batches: Callable[[], Iterable],
                        tables=None, ev_table_dir: Optional[str] = None,
                        table_sizes=None,
                        save_dir: Optional[str] = None,
                        mesh=None,
                        seed: int = 0,
                        make_test_batches: Optional[Callable] = None,
                        ev_export_dir: Optional[str] = None,
                        log_fn=print,
                        model: Optional[DLRM] = None,
                        device=None) -> TrainResult:
    """Training with device memory bounded by the cache tier (the reference
    forbids training with EVStore, dlrm_s_pytorch_C1.py:1321-1323).  The
    masters are `tables`, the mapped `ev-table-<t+1>.bin` files of
    `ev_table_dir` (with `table_sizes`) when that directory holds them, or
    the tables `DLRM(cfg, seed=seed)` draws, made in host memory; the
    model's MLPs come from `model` (the caller's, e.g. the JAX package's
    weights through `convert.py`; its tables, if any, are the masters when
    `tables` is None) or from the same seed.

    Batches stream through `TrainableDeviceCache.train_batches`, the
    pipelined driver.  With make_test_batches and tcfg.test_freq > 0 the
    stream is cut every test_freq batches for an eval through the cache,
    and a new best writes the cache's files and the dense npz into
    `save_dir` and the EV tables into `ev_export_dir`; a last eval follows
    the loop.  Without an eval the run's end writes the dense npz and
    `best.json` (the last step, no metrics) into `save_dir`, beside the
    cache's files (masters in memory) or with the tables in the flushed
    `ev_table_dir` files.  The model is trained in place; the
    result holds its dense sums as `opt_state.dense`.

    With a `mesh` (`parallel/mesh.py`; every rank calls with the same
    arguments and batches) the cells shard over its model axis
    (`ShardedTrainableDeviceCache`), which trains one batch at a time, as
    the JAX driver drives it, and the eval comes every test_freq steps.
    Rank 0 holds the masters (`tables` and the files are read there),
    scores the evals and broadcasts their metrics, so every rank takes the
    same decisions; only rank 0 logs and writes."""
    from evstore_tpu_torch.cache.trainable import (
        ShardedTrainableDeviceCache, TrainableDeviceCache, init_dense_state)
    from evstore_tpu_torch.parallel.mesh import Mesh
    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        device = mesh.device
        if mesh.rank != 0:
            log_fn = quiet
    dev = resolve_device(device)
    if model is None:
        model = DLRM(cfg, device=dev, seed=seed, tables=False)
    elif model.cfg != cfg:
        raise ValueError("the model was built from another DLRMConfig")
    if ev_table_dir and not os.path.exists(
            os.path.join(ev_table_dir, "ev-table-1.bin")):
        ev_table_dir = None   # no .bin masters there: masters in memory
    host = mesh is None or mesh.rank == 0
    cls, kw = ((TrainableDeviceCache, {"device": dev}) if mesh is None
               else (ShardedTrainableDeviceCache, {"mesh": mesh}))
    if ev_table_dir:
        tc = cls.from_files(cfg, tcfg, ccfg, ev_table_dir, table_sizes, **kw)
    else:
        copy = True
        if tables is None and model.has_sparse():
            tables = list(model.tables)
        elif tables is None:
            tables = init_host_tables(cfg, seed) if host else None
            copy = False
        tc = cls(cfg, tcfg, ccfg, tables if host else None,
                 copy_tables=copy, **kw)
    dstate = init_dense_state(model)
    history = {"loss": [], "eval": []}
    step = 0
    best = -float("inf")
    do_eval = make_test_batches is not None and tcfg.test_freq > 0
    t0 = t_run = time.perf_counter()
    t_aside = 0.0     # evals and saves, off the step rate
    n_since = 0

    def eval_and_track():
        nonlocal best, t_aside
        t1 = time.perf_counter()
        metrics = _cached_eval(tc, cfg, model, make_test_batches, mesh)
        history["eval"].append((step, metrics))
        log_fn(f"eval @ {step}: auc {metrics['auc']:.4f} "
               f"acc {metrics['accuracy']:.4f}")
        score = (metrics["auc"] if not np.isnan(metrics["auc"])
                 else metrics["accuracy"])
        if score > best:
            best = score
            if save_dir:
                tc.save(save_dir)
                if host:
                    _save_dense_npz(model, dstate, save_dir, step, metrics)
            if ev_export_dir:
                tc.export_ev_tables(ev_export_dir)
        t_aside += time.perf_counter() - t1
        return metrics

    def progress(loss, bsize):
        nonlocal t0, n_since
        last = float(loss)
        dt = time.perf_counter() - t0
        history["loss"].append((step, last))
        if host:
            s = tc.stats()
            log_fn(f"step {step}: loss {last:.6f} "
                   f"({n_since * bsize / max(dt, 1e-9):.0f}"
                   f" examples/s, hit rate {s['hit_rate']:.3f}, "
                   f"cache hbm {s['hbm_bytes'] / 1e6:.1f} MB)")
        t0, n_since = time.perf_counter(), 0

    for _ in range(tcfg.nepochs):
        if mesh is not None:
            # one batch at a time, the eval every test_freq steps
            for dense_x, idx, y in make_train_batches():
                step += 1
                _, _, loss = tc.train_batch(model, dstate, step, dense_x,
                                            idx, y)
                n_since += 1
                if step % max(tcfg.print_freq, 1) == 0:
                    progress(loss, np.asarray(dense_x).shape[0])
                if do_eval and step % tcfg.test_freq == 0:
                    eval_and_track()
            continue
        # the stream is cut at test_freq batches for the periodic eval; a
        # driver drained at a cut has landed all its write-backs
        batch_iter = iter(make_train_batches())
        while True:
            if do_eval:
                chunk = list(itertools.islice(batch_iter, tcfg.test_freq))
                if not chunk:
                    break
            else:
                chunk = batch_iter
            for _, _, loss in tc.train_batches(model, dstate, chunk,
                                               start_step=step + 1):
                step += 1
                n_since += 1
                if step % max(tcfg.print_freq, 1) == 0:
                    progress(loss, tcfg.batch_size)
            if not do_eval:
                break
            eval_and_track()
    _fence(dev)
    dt = time.perf_counter() - t_run - t_aside
    log_fn(f"trained {step} steps in {dt:.3f} s "
           f"({step / max(dt, 1e-9):.2f} steps/s)")
    if do_eval:  # the last eval, as run_training's
        eval_and_track()
    if ev_table_dir:
        tc.flush_files()
    elif save_dir and not do_eval:
        tc.save(save_dir)
    else:
        tc.flush_to_host()
    if save_dir and not do_eval and host:
        # no eval wrote the MLPs: the run's end does (the JAX driver drops
        # them, ROADMAP queue 3)
        _save_dense_npz(model, dstate, save_dir, step, None)
    stats = tc.stats()
    tc.close()
    best = best if best > -float("inf") else float("nan")
    log_fn(f"cached training done: steps={step} cache={stats} "
           f"best={best:.4f}")
    return TrainResult(model=model, opt_state=OptState(step, dstate, {}),
                       best_metric=best, steps=step, history=history)
