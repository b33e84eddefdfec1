"""Training cells under row-wise Adagrad (`rwsadagrad`: row-wise on the
tables, plain Adagrad on the MLPs and the cross network), through
`train/train_loop.py::train` over the `DLRM` with its tables on the card:
the dot interaction with one id a table (a configuration in the script's
flags, `inputs.model_dims`), or MLPerf's DLRM-DCNv2 (a configuration in the
recipe's flags: the low-rank cross network and bags of a length per
table, `traffic/bags.py`).

Set-up, the window and the timing are `kinds/train.py`'s, with its `Feed`
and `DrawnTables`: a pool of distinct batches drawn on the device and
handed to `train` from host memory, the tables drawn one at a time as
`DLRM` takes them, three checked steps and the warm-up steps as one call
each, then the window.  The DCNv2 path builds its model from the port's
`mlperf_dcnv2_config` (held to the file's widths) before it draws
anything, so a program without it fails at once.

The check: the reference (`reference/dcnv2.py`) follows the first three
steps from the same weights, rows and batches.  Under row-wise Adagrad a
first step from a zero state moves each weight by about lr sign(g), so
step 1's gradient is read from the optimizer's sums after it (|g| of a
dense leaf is sqrt(s); a row's RMS gradient is sqrt(state[r])), copied on
the device as the feed gives out the second batch.  Compared: the losses,
those gradients and the change after three steps, leaf by leaf (the MLPs,
the cross network and each table's touched rows).

The record carries `gathered_rows_per_step` (the grouped gather's rows over
the window's steps, as K2's wrapper counts them on the card; None where
nothing was counted), which the run's account states.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from evbench import check, inputs, tracing
from evbench.kinds.train import N_CHECKED, DrawnTables, Feed
from evbench.reference import dcnv2 as ref
from evbench.traffic import bags, streams

# the faults the check has to tell from the program, and the control
FAULTS = ("tf32", "half_batch", "drop_slot", "no_residual")


def model_dims(cfg: Dict) -> Dict:
    """The model a configuration's file states: `inputs.model_dims` for
    the script's flags, with `interaction` "dot" and one id a table; for
    the recipe's flags ("interaction_type" "dcn") the same keys, the top
    MLP's input the (T + 1) D features, the cross network's `dcn_layers`
    and `dcn_rank`, and `bag_sizes`.  The tables are the rows this chip
    holds (`arch_embedding_size`)."""
    if cfg.get("interaction_type") != "dcn":
        d = inputs.model_dims(cfg)
        d.update(interaction="dot", bag_sizes=[1] * len(d["table_sizes"]))
        return d
    D = int(cfg["embedding_dim"])
    sizes = [int(s) for s in cfg["arch_embedding_size"]]
    bot = [int(cfg["num_dense_features"]),
           *(int(x) for x in cfg["dense_arch_layer_sizes"])]
    if bot[-1] != D:
        raise ValueError(f"dense arch ends at {bot[-1]}, not the embedding "
                         f"width {D}")
    return {"dim": D, "table_sizes": sizes, "mlp_bot": bot,
            "mlp_top": [(len(sizes) + 1) * D,
                        *(int(x) for x in cfg["over_arch_layer_sizes"])],
            "interaction": "dcn", "dcn_layers": int(cfg["dcn_num_layers"]),
            "dcn_rank": int(cfg["dcn_low_rank_dim"]),
            "bag_sizes": [int(n) for n in cfg["multi_hot_sizes"]]}


def cross_weights(seed: int, dims: Dict, device) -> List:
    """[(V [r, N], W [N, r], b [N])] a layer: V and W xavier-normal,
    N(0, sqrt(2 / (N + r))), and b N(0, sqrt(1 / N)), nonzero so that its
    gradient is tested; drawn in one call and cut."""
    if dims["interaction"] != "dcn":
        return []
    N, r, L = dims["mlp_top"][0], dims["dcn_rank"], dims["dcn_layers"]
    flat = torch.randn(L * (2 * N * r + N),
                       generator=inputs.generator(seed, "cross", device),
                       device=device)
    out, off, s = [], 0, (2.0 / (N + r)) ** 0.5
    for _ in range(L):
        V = flat[off:off + r * N].view(r, N) * s
        off += r * N
        W = flat[off:off + N * r].view(N, r) * s
        off += N * r
        out.append((V, W, flat[off:off + N] * (1.0 / N) ** 0.5))
        off += N
    return out


def build_model(dims: Dict, w: Dict, device, tables):
    """The program's `DLRM` of these widths with the benchmark's weights."""
    from evstore_tpu_torch.models.dlrm import DLRM
    if dims["interaction"] == "dcn":
        from evstore_tpu_torch.config import mlperf_dcnv2_config
        dcfg = mlperf_dcnv2_config(table_sizes=dims["table_sizes"],
                                   multi_hot_sizes=dims["bag_sizes"])
        got = (dcfg.embedding_dim, list(dcfg.mlp_bot), list(dcfg.mlp_top),
               dcfg.dcn_num_layers, dcfg.dcn_low_rank_dim)
        want = (dims["dim"], dims["mlp_bot"], dims["mlp_top"],
                dims["dcn_layers"], dims["dcn_rank"])
        if got != want:
            raise ValueError(f"the program's DLRM-DCNv2 {got} is not the "
                             f"configuration's {want}")
    else:
        from evstore_tpu_torch.config import make_dlrm_config
        dcfg = make_dlrm_config(dims["dim"], dims["table_sizes"],
                                dims["mlp_bot"][1:-1], dims["mlp_top"][1:-1],
                                num_dense=dims["mlp_bot"][0])
    model = DLRM(dcfg, device=device, seed=0, tables=tables)
    with torch.no_grad():
        for part in ("bot", "top"):
            for lin, (W, b) in zip(getattr(model, part), w[part]):
                lin.weight.copy_(W)
                lin.bias.copy_(b)
        cross = getattr(model, "cross", None)
        for layer, vals in zip(cross.layers() if cross is not None else [],
                               w.get("cross", [])):
            for p, v in zip(layer, vals):
                p.copy_(v)
    return dcfg, model


def dense_names(model) -> List[str]:
    """The dense leaves' names in `reference/dcnv2.py::leaves`' order."""
    names = [f"{part}.{i}.{k}" for part in ("bot", "top")
             for i in range(len(getattr(model, part)))
             for k in ("weight", "bias")]
    cross = getattr(model, "cross", None)
    n = len(cross.V) if cross is not None else 0
    return names + [f"cross.{k}.{i}" for i in range(n) for k in "VWb"]


def columns_of(bag_sizes) -> List[slice]:
    out, off = [], 0
    for n in bag_sizes:
        out.append(slice(off, off + n))
        off += n
    return out


def touched_rows(idx: np.ndarray, bag_sizes, device) -> List[torch.Tensor]:
    """Each table's distinct ids in idx [N, B, sum L_t], sorted."""
    return [torch.unique(torch.from_numpy(np.ascontiguousarray(
        idx[:, :, c]).ravel()).to(device).long())
        for c in columns_of(bag_sizes)]


def unique_keys(idx: np.ndarray, sizes, bag_sizes) -> List[int]:
    """Distinct (table, id) keys of each batch of idx [N, B, sum L_t]."""
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    col_off = np.repeat(offs, bag_sizes)
    return [int(np.unique(b.astype(np.int64) + col_off).size) for b in idx]


class Kept:
    """Inside `with`, every step that `train` builds keeps a copy of the
    loss it returns, and after its first step the optimizer's sums that
    the check reads: each dense leaf's (by name) and each table's row
    state at its touched rows; all on the device and unread."""

    def __init__(self, names, touched):
        self.names, self.touched = names, touched
        self.losses: List[torch.Tensor] = []
        self.dense: List[torch.Tensor] = []
        self.rows: List[torch.Tensor] = []

    def __enter__(self):
        from evstore_tpu_torch.train import train_loop
        self._mod, self._make = train_loop, train_loop.make_train_step

        def keeping(cfg, tcfg):
            step = self._make(cfg, tcfg)

            def run(model, st, *args, **kwargs):
                loss = step(model, st, *args, **kwargs)
                self.losses.append(torch.as_tensor(loss).detach().clone())
                if len(self.losses) == 1:
                    self.dense = [st.dense[n].clone() for n in self.names]
                    self.rows = [st.sparse[f"tables.{t}"][u].clone()
                                 for t, u in enumerate(self.touched)]
                return loss
            return run

        train_loop.make_train_step = keeping
        return self

    def __exit__(self, *exc):
        self._mod.make_train_step = self._make


def program_leaves(model, touched) -> List[torch.Tensor]:
    """The dense leaves in `reference/dcnv2.py::leaves`' order, then each
    table's touched rows."""
    params = dict(model.named_parameters())
    return [params[n].detach().clone() for n in dense_names(model)] + \
        [model.tables[t][u].clone() for t, u in enumerate(touched)]


def draw_batches(mix, dims, seed, n, device):
    sizes, nd = dims["table_sizes"], dims["mlp_bot"][0]
    if dims["interaction"] == "dcn":
        return bags.make_bag_batches(mix, sizes, dims["bag_sizes"], nd, seed,
                                     n, device)
    return streams.make_batches(mix, sizes, nd, seed, n, device)


def run(ctx) -> Dict:
    from evstore_tpu_torch.config import TrainConfig
    from evstore_tpu_torch.ops.cuda_gather import gather_rows_grouped
    from evstore_tpu_torch.train.train_loop import train

    dev, mix, seed = ctx.device, ctx.mix, ctx.seed
    dims = model_dims(ctx.config)
    if dims["interaction"] == "dcn":
        # the program's DLRM-DCNv2 first: one without it fails here
        from evstore_tpu_torch.config import mlperf_dcnv2_config  # noqa
    sizes, D = dims["table_sizes"], dims["dim"]
    B, lr = int(mix["batch_size"]), float(ctx.config["learning_rate"])
    quiet = lambda *a, **k: None  # noqa: E731

    # --- the benchmark's inputs, from the seed
    batches = draw_batches(mix, dims, seed, int(mix["pool_batches"]), dev)
    dense, idx, labels = batches
    w = inputs.mlp_weights(seed, dims, dev)
    w["cross"] = cross_weights(seed, dims, dev)
    ctx.note(f"inputs drawn: {len(idx)} batches of {B}, "
             f"{idx.shape[2]} ids a sample")
    touched = touched_rows(idx[:N_CHECKED], dims["bag_sizes"], dev)

    # --- the program: one model, driven from the seed, then timed
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    drawn = DrawnTables(seed, sizes, D, dev, touched)
    dcfg, model = build_model(dims, w, dev, drawn)
    ctx.note("program built")
    tcfg = TrainConfig(batch_size=B, learning_rate=lr,
                       optimizer=mix["optimizer"], loss_function="bce",
                       print_freq=int(mix["print_freq"]))

    with Kept(dense_names(model), touched) as kept:
        train(model, dcfg, tcfg, Feed(batches, 0, steps=N_CHECKED),
              log_fn=quiet)
    losses = [float(x) for x in kept.losses]
    after3 = program_leaves(model, touched)
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
    # a program whose gather counts no rows reads None
    rows0 = getattr(gather_rows_grouped, "rows", None)
    ctx.window_began()
    train(model, dcfg, tcfg, feed, log_fn=quiet)
    t_end = time.perf_counter()
    n = feed.served
    counted = None if rows0 is None else gather_rows_grouped.rows - rows0
    rows_per_step: Optional[float] = counted / n if counted and n else None
    ctx.note(f"window closed: {n} steps; gathered rows a step "
             f"{rows_per_step} ({B} x {idx.shape[2]} ids a sample = "
             f"{B * idx.shape[2]})")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    traced = stretch.close(n) if stretch else None
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    window_s = t_end - feed.pulls[0]
    record = {"kind": "train_rowwise", "steps": n, "batch_size": B,
              "dims": dims, "window_s": window_s, "trace": traced,
              "gathered_rows_per_step": rows_per_step}
    if traced is not None:
        order = feed.order[int(mix["trace_skip"]):
                           int(mix["trace_skip"]) + traced["steps"]]
        traced["unique_keys"] = unique_keys(idx[order], sizes,
                                            dims["bag_sizes"])

    # --- the check: the reference over the first three steps
    prog = {"losses": losses, "dense_sums": kept.dense,
            "row_sums": kept.rows, "after3": after3}
    got = readings(dims, w, drawn.rows, touched, batches, lr, dev, prog)
    lim = ctx.limits
    checks = [check.entry(k, v, lim[k]) for k, v in got.items()]
    return {"attempted": n, "failed": 0,
            "e2e": {"train_samples_per_s": n * B / window_s},
            "record": record, "checks": checks,
            "memory_peak_bytes": int(peak)}


def compact_batches(batches, touched, bag_sizes, n: int, device):
    """The first n batches with each table's ids as indices into its
    touched rows, on `device`."""
    dense, idx, labels = batches
    out = []
    for k in range(n):
        ids = torch.from_numpy(idx[k]).to(device).long()
        cid = torch.cat([torch.searchsorted(touched[t],
                                            ids[:, c].contiguous())
                         for t, c in enumerate(columns_of(bag_sizes))], 1)
        out.append((torch.from_numpy(dense[k]).to(device), cid,
                    torch.from_numpy(labels[k]).to(device)))
    return out


def _grads(dense_sums, row_sums) -> List[torch.Tensor]:
    """Step 1's gradients as the optimizer's sums give them: |g| of each
    dense leaf, each touched row's RMS gradient."""
    return [torch.sqrt(s) for s in dense_sums] + \
        [torch.sqrt(s) for s in row_sums]


def readings(dims, w, rows0, touched, batches, lr, device,
             prog: Optional[Dict], fault: Optional[str] = None
             ) -> Dict[str, float]:
    """{loss_gap, grad_gap, change_gap} of the program's losses, sums
    after step 1 and leaves after step 3 (`prog`) against the reference;
    with `prog` None, of the reference run with `fault` (one of FAULTS)
    in the program's place."""
    op, bag_sizes = dims["interaction"], dims["bag_sizes"]
    data = compact_batches(batches, touched, bag_sizes, N_CHECKED, device)
    want_l, want = ref.rwsadagrad_steps(w, rows0, data, bag_sizes, lr, op)
    if prog is None:
        losses, st = ref.rwsadagrad_steps(w, rows0, data, bag_sizes, lr, op,
                                          **{fault: True})
        prog = {"losses": losses, "dense_sums": st[0]["dense_sums"],
                "row_sums": st[0]["row_sums"],
                "after3": st[2]["leaves"] + st[2]["tables"]}
    p0 = ref.leaves(w) + list(rows0)
    r3 = want[2]["leaves"] + want[2]["tables"]
    loss_gap = (max(abs(a - b) / abs(b) for a, b in
                    zip(prog["losses"], want_l))
                if len(prog["losses"]) == len(want_l) else 1.0)
    grad = check.norm_gap(_grads(prog["dense_sums"], prog["row_sums"]),
                          _grads(want[0]["dense_sums"], want[0]["row_sums"]))
    change = check.norm_gap([b - a for a, b in zip(p0, prog["after3"])],
                            [b - a for a, b in zip(p0, r3)])
    return {"loss_gap": loss_gap, "grad_gap": grad, "change_gap": change}


def faults_of(dims) -> List[str]:
    """The control and the faults a cell can have: the dropped slot with
    bags longer than one id, the missing residual with the cross network."""
    out = ["tf32", "half_batch"]
    if max(dims["bag_sizes"]) > 1:
        out.append("drop_slot")
    if dims["interaction"] == "dcn":
        out.append("no_residual")
    return out
