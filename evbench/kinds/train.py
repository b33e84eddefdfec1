"""Training cells: `train/train_loop.py::train` over the `DLRM` with its
tables on the card.

Set-up draws a pool of distinct batches (`mix["pool_batches"]`, cycled by
the window, as epochs repeat data), the MLPs and the tables, on the device
from the seed.  The tables are handed to `DLRM` one at a time as they are
drawn, so the card holds the model's copy and one table more.  The model
is the one object that set-up drives and the window trains.  Set-up runs
the pool's first three batches, then `mix["warm_steps"]` more, then the
window runs; each is one call of `train` with the window's `TrainConfig`,
fed numpy batches from host memory by the window's `Feed`, as a data loader
feeds it, so nothing waits for the device between the checked steps.
Each checked step's loss is kept as the tensor the step returns, with no
read on the host, and the state after the first step is copied aside on
the device as the feed gives out the second batch.

The window is one `train` call.  Each pull of a batch is timed; the feed
ends at the pull that finds `--seconds` over, and `train` then waits for
the device.  Samples per second are the window's steps times the batch
over the time from the first pull to the end of that wait.

Once the window has closed, the check: the reference follows the first
three steps from the same MLPs, rows and batches, and the program's losses,
first gradient (worked out from its state after one step) and change
after three steps are held to it leaf by leaf.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from evbench import check, inputs, tracing
from evbench.program import build_model
from evbench.reference import dlrm as ref
from evbench.traffic import streams

N_CHECKED = 3


class Feed:
    """Pool batches from `start` on, cycled: `steps` of them, or until a
    pull finds `seconds` over.  Each hook is called at every pull with its
    index."""

    def __init__(self, batches, start: int, seconds: Optional[float] = None,
                 steps: Optional[int] = None, hooks=(), span=None):
        self.dense, self.idx, self.labels = batches
        self.start, self.seconds, self.steps = start, seconds, steps
        self.hooks, self.span = list(hooks), span
        self.pulls: List[float] = []
        self.order: List[int] = []

    def __iter__(self):
        n_pool = len(self.idx)
        while True:
            now = time.perf_counter()
            self.pulls.append(now)
            for hook in self.hooks:
                hook(len(self.pulls) - 1)
            if (self.steps is not None and len(self.order) == self.steps) \
                    or (self.seconds is not None
                        and now - self.pulls[0] >= self.seconds):
                if self.span is not None:
                    self.span.close()
                return
            if self.span is not None:
                self.span.open("evbench.step")
            k = (self.start + len(self.order)) % n_pool
            self.order.append(k)
            yield self.dense[k], self.idx[k], self.labels[k]

    @property
    def served(self) -> int:
        return len(self.order)


class DrawnTables:
    """The tables as `DLRM` takes them, each drawn when it is reached; the
    rows the checked steps touch are kept aside as they are drawn."""

    def __init__(self, seed, sizes, dim, device, touched):
        self.seed, self.sizes, self.dim = seed, sizes, dim
        self.device, self.touched = device, touched
        self.rows: List[torch.Tensor] = []

    def __len__(self):
        return len(self.sizes)

    def __iter__(self):
        for t, n in enumerate(self.sizes):
            tab = inputs.table(self.seed, t, n, self.dim, self.device)
            self.rows.append(tab[self.touched[t]].clone())
            yield tab
            del tab


@contextlib.contextmanager
def losses_kept(into: List[torch.Tensor]):
    """Inside, every step that `train` builds keeps a copy of the loss it
    returns in `into`, on the device and unread."""
    from evstore_tpu_torch.train import train_loop

    make = train_loop.make_train_step

    def keeping(cfg, tcfg):
        step = make(cfg, tcfg)

        def run(*args, **kwargs):
            loss = step(*args, **kwargs)
            into.append(torch.as_tensor(loss).detach().clone())
            return loss
        return run

    train_loop.make_train_step = keeping
    try:
        yield
    finally:
        train_loop.make_train_step = make


def _leaves(model, touched) -> List[torch.Tensor]:
    """The MLPs' weights and biases, then each table's touched rows."""
    out = [t.detach().clone() for part in ("bot", "top")
           for lin in getattr(model, part) for t in (lin.weight, lin.bias)]
    return out + [model.tables[t][touched[t]].clone()
                  for t in range(len(touched))]


def run(ctx) -> Dict:
    from evstore_tpu_torch.config import TrainConfig
    from evstore_tpu_torch.train.train_loop import train

    dev, mix, seed = ctx.device, ctx.mix, ctx.seed
    dims = inputs.model_dims(ctx.config)
    sizes, D = dims["table_sizes"], dims["dim"]
    B, lr = int(mix["batch_size"]), float(ctx.config["learning_rate"])
    quiet = lambda *a, **k: None  # noqa: E731

    # --- the benchmark's inputs, from the seed
    batches = streams.make_batches(mix, sizes, dims["mlp_bot"][0], seed,
                                   int(mix["pool_batches"]), dev)
    dense, idx, labels = batches
    w = inputs.mlp_weights(seed, dims, dev)
    ctx.note(f"inputs drawn: {len(idx)} batches of {B}")
    touched = [torch.unique(torch.from_numpy(
        idx[:N_CHECKED, :, t].ravel()).to(dev).long())
        for t in range(len(sizes))]

    # --- the program: one model, driven from the seed, then timed
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    drawn = DrawnTables(seed, sizes, D, dev, touched)
    dcfg, model = build_model(dims, w, dev, tables=drawn)
    ctx.note("program built")
    tcfg = TrainConfig(batch_size=B, learning_rate=lr, optimizer="sgd",
                       loss_function="bce",
                       print_freq=int(mix["print_freq"]))

    # the checked steps: one call, as the window's
    kept: List[torch.Tensor] = []
    after1: List[torch.Tensor] = []

    def after_first(k):
        # step 1 is enqueued and step 2 not yet: the state after one step
        if k == 1:
            after1.extend(_leaves(model, touched))

    with losses_kept(kept):
        train(model, dcfg, tcfg,
              Feed(batches, 0, steps=N_CHECKED, hooks=[after_first]),
              log_fn=quiet)
    losses = [float(x) for x in kept]
    after3 = _leaves(model, touched)
    ctx.note(f"checked steps' losses {losses}")
    warm = int(mix["warm_steps"])
    train(model, dcfg, tcfg, Feed(batches, N_CHECKED, steps=warm),
          log_fn=quiet)

    stretch = span = None
    if ctx.trace:
        stretch = tracing.Stretch(int(mix["trace_skip"]),
                                  int(mix["trace_steps"]), dev)
        span = tracing.HostSpan()
    feed = Feed(batches, N_CHECKED + warm, ctx.seconds,
                hooks=[stretch.on_pull] if stretch else (), span=span)
    ctx.window_began()
    train(model, dcfg, tcfg, feed, log_fn=quiet)
    t_end = time.perf_counter()
    ctx.note(f"window closed: {feed.served} steps")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    traced = stretch.close(feed.served) if stretch else None
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    n = feed.served
    window_s = t_end - feed.pulls[0]
    record = {"kind": "train", "steps": n, "batch_size": B, "dims": dims,
              "window_s": window_s, "trace": traced}
    if traced is not None:
        order = feed.order[int(mix["trace_skip"]):
                           int(mix["trace_skip"]) + traced["steps"]]
        traced["unique_keys"] = check.unique_keys(idx[order], sizes)

    # --- the check: the reference over the first three steps
    checks = held_to_reference(ctx, drawn.rows, touched, w, batches, lr,
                               losses, after1, after3)
    return {"attempted": n, "failed": 0,
            "e2e": {"train_samples_per_s": n * B / window_s},
            "record": record, "checks": checks,
            "memory_peak_bytes": int(peak)}


def compact_batches(batches, touched, n: int, device):
    """The first n batches with each table's ids as indices into the
    concatenation of the touched rows, on `device`."""
    dense, idx, labels = batches
    offs = np.cumsum([0] + [len(u) for u in touched[:-1]])
    out = []
    for k in range(n):
        ids = torch.from_numpy(idx[k]).to(device).long()
        cid = torch.stack([torch.searchsorted(touched[t],
                                              ids[:, t].contiguous())
                           + offs[t] for t in range(len(touched))], dim=1)
        out.append((torch.from_numpy(dense[k]).to(device), cid,
                    torch.from_numpy(labels[k]).to(device)))
    return out


def reference_leaves(state, sizes_touched) -> List[torch.Tensor]:
    mlps, table = state
    out = [t for part in ("bot", "top") for W, b in mlps[part]
           for t in (W, b)]
    return out + list(torch.split(table, sizes_touched))


def readings(w, rows0, touched, batches, lr, losses, after1, after3,
             device, tf32=False, half_batch=False):
    """(loss_gap, grad_gap, change_gap) of the program's losses and states
    (or of the reference run in its place) against the reference."""
    table0 = torch.cat(rows0)
    n_t = [len(u) for u in touched]
    data = compact_batches(batches, touched, N_CHECKED, device)
    want_l, want_s = ref.sgd_steps(w, table0, data, lr)
    if after1 is None:          # the reference, changed, in the program's place
        losses, st = ref.sgd_steps(w, table0, data, lr, tf32=tf32,
                                   half_batch=half_batch)
        after1, after3 = (reference_leaves(s, n_t) for s in (st[0], st[2]))
    p0 = reference_leaves((w, table0), n_t)
    r1, r3 = (reference_leaves(s, n_t) for s in (want_s[0], want_s[2]))
    loss_gap = (max(abs(a - b) / abs(b) for a, b in zip(losses, want_l))
                if len(losses) == len(want_l) else 1.0)
    grad = check.norm_gap([(a - b) / lr for a, b in zip(p0, after1)],
                          [(a - b) / lr for a, b in zip(p0, r1)])
    change = check.norm_gap([b - a for a, b in zip(p0, after3)],
                            [b - a for a, b in zip(p0, r3)])
    return loss_gap, grad, change


def held_to_reference(ctx, rows0, touched, w, batches, lr, losses, after1,
                      after3) -> List[Dict]:
    loss_gap, grad, change = readings(w, rows0, touched, batches, lr, losses,
                                      after1, after3, ctx.device)
    lim = ctx.limits
    return [check.entry("loss_gap", loss_gap, lim["loss_gap"]),
            check.entry("grad_gap", grad, lim["grad_gap"]),
            check.entry("change_gap", change, lim["change_gap"])]
