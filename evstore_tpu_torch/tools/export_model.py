"""Model export for serving.

Port of `evstore_tpu/tools/export_model.py`.  Reference: --save-onnx
exports the torch model to ONNX (dlrm_s_pytorch.py:1863-1878); the JAX
package serialises its jitted forward with `jax.export` (StableHLO), and
the port with `torch.export`: `export_program` writes one
`ExportedProgram` (`torch.export.save`) of the forward, sigmoid(DLRM)
over dense_x [B, num_dense] float32 and idx [B, T] int32 at a fixed batch
B, the weights and tables baked in.  `load_exported` reads it back as a
callable on the device it was exported from.

The JAX package's artifact carries its Pallas interaction (the config's
`use_pallas_interaction`, on by default), so the port's carries K1: the
interaction is one opaque op, `evstore::dot_interaction`, a
`torch.library` custom op that launches `csrc/interaction_fwd.cu` on the
card and runs the plain `dot_interaction` on the CPU.  A loaded program
therefore needs this module imported (the op's registration), as a JAX
artifact needs a Mosaic runtime.  The lookup is the grouped gather's plain
version (a zero row for an id outside its table, as K2 gives).  Only this
module's forward calls the op; the serving and training paths keep
`DotInteraction`.

Also the weight-truncation tool (misc dissectingmodel.py: keep the first
k rows of each plain table).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import torch
from torch import nn

from evstore_tpu_torch.models.dlrm import DLRM
from evstore_tpu_torch.models.embedding import (combine_rows, flat_ids,
                                                gather_groups, group_ids)
from evstore_tpu_torch.ops.cuda_gather import gather_rows_grouped_ref
from evstore_tpu_torch.ops.cuda_interaction import dot_interaction_kernel
from evstore_tpu_torch.ops.interaction import (cat_interaction,
                                               dot_interaction, num_pairs)


@torch.library.custom_op("evstore::dot_interaction", mutates_args=(),
                         device_types="cuda")
def dot_interaction_op(x: torch.Tensor, ly: torch.Tensor,
                       self_interaction: bool) -> torch.Tensor:
    """K1 (`dot_interaction_kernel`): x [B, D], ly [B, T, D] -> [B, D + P]."""
    return dot_interaction_kernel(x.contiguous(), ly.contiguous(),
                                  self_interaction)


@dot_interaction_op.register_kernel("cpu")
def _dot_interaction_cpu(x, ly, self_interaction):
    return dot_interaction(x, ly, self_interaction)


@dot_interaction_op.register_fake
def _dot_interaction_shape(x, ly, self_interaction):
    return x.new_empty((x.shape[0], x.shape[1]
                        + num_pairs(ly.shape[1] + 1, self_interaction)))


class _Scorer(nn.Module):
    """sigmoid(DLRM(dense_x, idx)): the grouped gather's plain version
    (K2's rows), the interaction through the custom op (K1) where the
    config asks for the kernel."""

    def __init__(self, model: DLRM):
        super().__init__()
        self.model = model

    def forward(self, dense_x: torch.Tensor, idx: torch.Tensor):
        m, cfg = self.model, self.model.cfg
        x = m.bottom_mlp(dense_x)
        sources = m.row_sources()
        groups = gather_groups(sources)
        flat = flat_ids(idx)
        rows = [gather_rows_grouped_ref([sources[i].param for i in g],
                                        group_ids(sources, g, flat))
                for g in groups]
        ly = combine_rows(cfg, sources, groups, rows, m.entries(),
                          tuple(idx.shape), None).to(x.dtype)
        if cfg.interaction_op == "cat":
            z = cat_interaction(x, ly)
        elif cfg.use_interaction_kernel:
            z = dot_interaction_op(x, ly, cfg.interaction_itself)
        else:
            z = dot_interaction(x, ly, cfg.interaction_itself)
        return torch.sigmoid(m.top_mlp(z))


def trace_program(model: DLRM, batch_size: int):
    """The `ExportedProgram` of the model's forward at `batch_size`, on
    the model's device."""
    cfg = model.cfg
    dev = next(model.parameters()).device
    example = (torch.zeros((batch_size, cfg.num_dense_features),
                           dtype=torch.float32, device=dev),
               torch.zeros((batch_size, cfg.num_tables), dtype=torch.int32,
                           device=dev))
    with torch.no_grad():
        return torch.export.export(_Scorer(model).eval(), example)


def export_program(model: DLRM, batch_size: int, out_path: str) -> str:
    """`trace_program` saved to `out_path`; -> the path."""
    program = trace_program(model, batch_size)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    torch.export.save(program, out_path)
    return out_path


def load_exported(path: str) -> Callable:
    """The exported forward as a callable(dense_x, idx) -> scores [B]."""
    program = torch.export.load(path).module()

    def score(dense_x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return program(dense_x, idx)
    return score


def truncate_tables(model: DLRM, keep_rows: int) -> DLRM:
    """A copy of the model, on its device, with each plain table (and its
    pooling weights) cut to its first `keep_rows` rows (misc
    dissectingmodel.py's weight truncation); its config carries the new
    sizes.  Raises ValueError for qr and md tables, whose shapes the
    sizes set."""
    from evstore_tpu_torch.parallel.sharded import _copy_mlps, _entries
    cfg = model.cfg
    if cfg.qr_flag or cfg.md_flag:
        raise ValueError("truncate_tables cuts plain tables; qr and md "
                         "tables take their shapes from the table sizes")
    entries = _entries(model)
    for e in entries:
        e["kind_plain"] = e["kind_plain"][:keep_rows]
        if "pool_w" in e:
            e["pool_w"] = e["pool_w"][:keep_rows]
    small = dataclasses.replace(cfg, table_sizes=tuple(
        min(n, keep_rows) for n in cfg.table_sizes))
    out = DLRM(small, device=next(model.parameters()).device,
               tables=entries)
    _copy_mlps(out, model)
    return out
