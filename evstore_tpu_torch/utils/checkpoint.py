"""Checkpoint and resume, and the EV-table export and import.

Port of `evstore_tpu/utils/checkpoint.py`.  Reference: torch.save of
{state_dict, optimizer state, epoch, iteration, losses, metrics} on every
new-best eval (dlrm_s_pytorch.py:1755-1777); resume restores the optimizer
state and fast-forwards the loader (skip_upto_epoch / skip_upto_batch,
:1447-1504, 1590, 1605).  Separately the trained tables are exported one
file a table ("EV tables", :1780-1796): the handoff to the storage and
cache tiers, which can also be loaded back into a model
(evstore_utils.load_new_ev_table:13-29).

A checkpoint is `<dir>/step_<n>`, one `torch.save` file of
{"model": the DLRM's state_dict, "opt": {"step", "dense", "sparse"}},
written under a temporary name and renamed, beside
`<dir>/step_<n>.meta.json` ({"step", "extra"}), written last: the names
of the JAX package's checkpoints, whose `step_<n>` is an orbax directory.
Neither package reads the other's checkpoints.  The optimizer's sums are
views of one flat buffer per update group (`train/optim.py`);
`torch.save` keeps that sharing, and `restore_checkpoint` copies into the
caller's tensors in place, so the restored state is the same flat buffers.

The EV tables are the JAX package's binary files (`ev-table-<t>.bin`,
`cache/storage.py::write_ev_tables_binary`), byte for byte: either package
reads the other's.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from evstore_tpu_torch.cache.storage import (_decode_rows, row_nbytes,
                                             table_path,
                                             write_ev_tables_binary)
from evstore_tpu_torch.models.dlrm import DLRM
from evstore_tpu_torch.ops import quant as qlib
from evstore_tpu_torch.train.optim import OptState


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")


def save_checkpoint(ckpt_dir: str, step: int, model: DLRM,
                    opt_state: OptState, extra: Optional[dict] = None) -> str:
    """Save the model, the optimizer state and `extra` (JSON) as step
    `step`; returns the checkpoint's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, step)
    state = {"model": model.state_dict(),
             "opt": {"step": int(opt_state.step), "dense": opt_state.dense,
                     "sparse": opt_state.sparse}}
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(state, tmp)
    os.replace(tmp, path)
    with open(os.path.join(ckpt_dir, f"step_{step}.meta.json"), "w") as f:
        json.dump({"step": step, "extra": extra or {}}, f)
    return path


def _copy_into(dst: dict, src: dict, what: str) -> None:
    if set(dst) != set(src):
        raise ValueError(f"the checkpoint's {what} holds {sorted(src)}; "
                         f"the state to restore holds {sorted(dst)}")
    for k, v in dst.items():
        s = src[k]
        if s.shape != v.shape or s.dtype != v.dtype:
            raise ValueError(f"{what} {k}: the checkpoint has "
                             f"{tuple(s.shape)} {s.dtype}, the state "
                             f"{tuple(v.shape)} {v.dtype}")
        v.copy_(s)


@torch.no_grad()
def restore_checkpoint(ckpt_dir: str, step: int, model: DLRM,
                       opt_state: OptState
                       ) -> Tuple[DLRM, OptState, dict]:
    """Copy step `step` into `model` and `opt_state` in place, which must
    have the checkpoint's structure (the same config and optimizer;
    ValueError otherwise).  The file is memory-mapped, so a table passes
    through host memory one page at a time.  -> (model, opt_state,
    extra)."""
    state = torch.load(checkpoint_path(ckpt_dir, step), map_location="cpu",
                       mmap=True, weights_only=True)
    _copy_into(model.state_dict(), state["model"], "model")
    _copy_into(opt_state.dense, state["opt"]["dense"], "optimizer dense")
    _copy_into(opt_state.sparse, state["opt"]["sparse"], "optimizer sparse")
    opt_state.step = int(state["opt"]["step"])
    with open(os.path.join(ckpt_dir, f"step_{step}.meta.json")) as f:
        meta = json.load(f)
    return model, opt_state, meta.get("extra", {})


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and name.endswith(".meta.json"):
            steps.append(int(name[len("step_"):-len(".meta.json")]))
    return max(steps) if steps else None


# ------------------------------------------------------ quantized inference

@torch.no_grad()
def quantize_embeddings(model: DLRM, bits: int) -> DLRM:
    """Round every plain table through the EV codec at `bits`, in place
    (reference --quantize-embedding-with-bit, dlrm_s_pytorch.py:1025-1028,
    1515-1527): the tables hold the decoded values and the model stays
    float32.  qr and md tables are left as they are, as in the JAX
    package.  Returns the model."""
    for tab in model.tables:
        enc = qlib.quantize(tab.float(), bits)
        tab.copy_(qlib.dequantize(enc, bits).to(tab.dtype))
    return model


@torch.no_grad()
def quantize_mlps(model: DLRM, bits: int = 8) -> DLRM:
    """Symmetric int8 rounding of the MLP weights with one scale a tensor,
    max|W| / 127, stored dequantized, in place (reference
    --quantize-mlp-with-bit, dlrm_s_pytorch.py:1515-1527); biases and md
    projections are left as they are.  Returns the model."""
    if bits != 8:
        raise ValueError("mlp quantization supports 8 bits")
    for lin in (*model.bot, *model.top):
        w = lin.weight
        # a 0-d tensor divisor: an IEEE division on the card too
        scale = w.abs().max() / torch.full((), 127.0, device=w.device)
        w.copy_((torch.round(w / scale).clamp(-127, 127) * scale
                 ).to(w.dtype))
    return model


# ------------------------------------------------------- EV-table handoff

def _plain_tables(model: DLRM):
    if len(model.tables) != model.cfg.num_tables:
        raise ValueError("EV export requires plain tables (qr/md tables "
                         "are factorized and have no row-wise EVs)")
    return model.tables


def export_ev_tables(model: DLRM, out_dir: str, precision: int = 32,
                     also_csv: bool = False, table_sizes=None) -> list:
    """Write the model's tables as `ev-table-<t>.bin` files at `precision`
    (dlrm_s_pytorch.py:1780-1796 exports CSVs; `also_csv` writes those
    too), one table at a time through host memory.  `table_sizes` keeps
    each table's first rows.  Returns the .bin paths."""
    tables = _plain_tables(model)

    def host(t):
        tab = tables[t].detach()
        if table_sizes is not None:
            tab = tab[:table_sizes[t]]
        return tab.float().cpu().numpy()

    paths = write_ev_tables_binary((host(t) for t in range(len(tables))),
                                   out_dir, precision)
    if also_csv:
        for t in range(len(tables)):
            np.savetxt(os.path.join(out_dir, f"ev-table-{t + 1}.csv"),
                       host(t), delimiter=",")
    return paths


@torch.no_grad()
def load_ev_tables_into_params(model: DLRM, ev_dir: str,
                               precision: int = 32) -> DLRM:
    """Copy the tables of `ev_dir`'s .bin files (at `precision`) into the
    model's plain tables, in place (evstore_utils.load_new_ev_table:
    13-29).  Returns the model."""
    for t, tab in enumerate(_plain_tables(model)):
        n, d = tab.shape
        raw = np.fromfile(table_path(ev_dir, t), dtype=np.uint8)
        if raw.size != n * row_nbytes(precision, d):
            raise ValueError(f"{table_path(ev_dir, t)} holds {raw.size} "
                             f"bytes; table {t} needs {n} rows of "
                             f"{row_nbytes(precision, d)}")
        rows = _decode_rows(raw.reshape(n, -1), precision, d)
        tab.copy_(torch.from_numpy(rows))
    return model
