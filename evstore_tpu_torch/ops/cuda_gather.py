"""Row gathers through the CUDA kernels `csrc/gather_rows.cu` and
`csrc/gather_rows_dequant_int8.cu`.

`gather_rows` ports the TPU kernel
`evstore_tpu/ops/pallas_gather.py::_gather_kernel`; `gather_rows_grouped`
is the same kernel's grouped form, the lookup of every table of a one-hot
batch in one launch (`out[b, t] = tables[t][idx[b, t]]`); and
`gather_rows_dequant_int8` ports `gather_rows_dequant_int8` of the same
file: the gather of uint8 rows of the 8-bit codec, dequantised to float32
as (v / 254) * 2 - 1 (`ops/quant.py`).  Both have a two-source form for the
device C1 cache: an index below `primary.shape[0]` reads `primary`, a larger
one reads `secondary[idx - primary.shape[0]]`.

Each wrapper launches its kernel for CUDA tensors and takes its plain
version (`*_ref`) only for CPU tensors.  An index outside [0, C + M) gives a
zero row, in the kernels and in the plain versions alike; no index is
checked on the device (that would need a sync).  The callers that take ids
from the host check them there (`models/embedding.py::check_ids`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from evstore_tpu_torch import _build
from evstore_tpu_torch.ops.quant import dequantize_int8
from evstore_tpu_torch.ops.table_desc import table_group


def _take_or_zero(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`index_select` of rows, with a zero row for an index outside
    [0, len(src))."""
    flat = idx.reshape(-1).long()
    ok = (flat >= 0) & (flat < src.shape[0])
    rows = torch.zeros((flat.numel(), src.shape[1]), dtype=src.dtype,
                       device=src.device)
    rows[ok] = torch.index_select(src, 0, flat[ok])
    return rows.reshape(*idx.shape, src.shape[1])


def _sources(primary, secondary):
    return primary if secondary is None else torch.cat([primary, secondary])


def gather_rows_ref(primary: torch.Tensor, idx: torch.Tensor,
                    secondary: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: `index_select` on the concatenated sources."""
    return _take_or_zero(_sources(primary, secondary), idx)


def gather_rows_grouped_ref(tables: Sequence[torch.Tensor],
                            idx: torch.Tensor) -> torch.Tensor:
    """The plain version: `index_select` on each table, then a stack."""
    return torch.stack([_take_or_zero(tab, idx[:, t])
                        for t, tab in enumerate(tables)], dim=1)


def gather_rows_dequant_int8_ref(primary: torch.Tensor, idx: torch.Tensor,
                                 secondary: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """The plain version: `index_select` on the concatenated uint8 sources,
    then `dequantize_int8`; a zero row for an index out of range."""
    src = _sources(primary, secondary)
    ok = ((idx >= 0) & (idx < src.shape[0]))[..., None]
    return torch.where(ok, dequantize_int8(_take_or_zero(src, idx)), 0.0)


def _check_sources(name, primary, idx, secondary, dtypes):
    """The checks both wrappers make on CUDA tensors."""
    tensors = [primary, idx] + ([] if secondary is None else [secondary])
    dev = primary.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one CUDA device "
                         "(or all on the CPU), got "
                         f"{[str(t.device) for t in tensors]}")
    if primary.dtype not in dtypes:
        raise TypeError(f"{name} takes {' or '.join(map(str, dtypes))} rows,"
                        f" got {primary.dtype}")
    if primary.dim() != 2:
        raise ValueError(f"{name} takes [N, D] rows, got "
                         f"{tuple(primary.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{name} takes int32 indices, got {idx.dtype}")
    if secondary is not None and (secondary.dtype != primary.dtype
                                  or secondary.dim() != 2
                                  or secondary.shape[1] != primary.shape[1]):
        raise ValueError(f"secondary {tuple(secondary.shape)} "
                         f"{secondary.dtype} does not match primary "
                         f"{tuple(primary.shape)} {primary.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")


def gather_rows(primary: torch.Tensor, idx: torch.Tensor,
                secondary: Optional[torch.Tensor] = None) -> torch.Tensor:
    """primary [C, D], optional secondary [M, D], idx int32 of any shape ->
    idx.shape + [D] rows, bit-exact."""
    tensors = [primary, idx] + ([] if secondary is None else [secondary])
    if all(t.device.type == "cpu" for t in tensors):
        return gather_rows_ref(primary, idx, secondary)
    _check_sources("gather_rows", primary, idx, secondary,
                   (torch.float32, torch.bfloat16))
    dev = primary.device
    if primary.element_size() * primary.shape[1] % 4:
        raise ValueError(f"gather_rows takes rows of a multiple of 4 bytes, "
                         f"got {tuple(primary.shape)} {primary.dtype}")
    D = primary.shape[1]
    out = torch.empty((*idx.shape, D), dtype=primary.dtype, device=dev)
    if idx.numel() == 0:
        return out
    lib = _build.library()
    rc = lib.gather_rows(
        primary.data_ptr(), primary.shape[0],
        None if secondary is None else secondary.data_ptr(),
        0 if secondary is None else secondary.shape[0],
        idx.data_ptr(), out.data_ptr(), idx.numel(),
        D * primary.element_size(), dev.index,
        _build.stream(dev.index))
    _build.check(rc, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def gather_rows_grouped(tables: Sequence[torch.Tensor],
                        idx: torch.Tensor) -> torch.Tensor:
    """T tables [N_t, D] of one type and width, idx [B, T] int32 -> rows
    [B, T, D] with out[b, t] = tables[t][idx[b, t]], bit-exact; an id outside
    [0, N_t) gives a zero row."""
    if idx.device.type == "cpu" and all(t.device.type == "cpu"
                                        for t in tables):
        return gather_rows_grouped_ref(tables, idx)
    group = table_group("gather_rows_grouped", tables)
    dev = idx.device
    if dev.type != "cuda" or tables[0].device != dev:
        raise ValueError("gather_rows_grouped: all tensors must be on one "
                         f"CUDA device (or all on the CPU), got idx on {dev} "
                         f"and tables on {tables[0].device}")
    if idx.dtype != torch.int32 or idx.dim() != 2 or \
            idx.shape[1] != len(tables) or not idx.is_contiguous():
        raise ValueError(f"gather_rows_grouped takes contiguous int32 idx "
                         f"[B, {len(tables)}], got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    row_bytes = group.dim * tables[0].element_size()
    if row_bytes % 4:
        raise ValueError(f"gather_rows_grouped takes rows of a multiple of 4 "
                         f"bytes, got {group.dim} x {group.dtype}")
    out = torch.empty((*idx.shape, group.dim), dtype=group.dtype, device=dev)
    if idx.numel() == 0:
        return out
    rc = _build.library().gather_rows_grouped(
        group.desc.data_ptr(), len(tables), idx.data_ptr(), out.data_ptr(),
        idx.numel(), row_bytes, group.align, dev.index,
        _build.stream(dev.index))
    _build.check(rc, "gather_rows_grouped")
    gather_rows_grouped.launches += 1
    return out


gather_rows_grouped.launches = 0


def gather_rows_dequant_int8(primary: torch.Tensor, idx: torch.Tensor,
                             secondary: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """primary uint8 [C, D], optional secondary uint8 [M, D], idx int32 of
    any shape -> idx.shape + [D] float32 rows, (v / 254) * 2 - 1, bit for
    bit the plain version's."""
    tensors = [primary, idx] + ([] if secondary is None else [secondary])
    if all(t.device.type == "cpu" for t in tensors):
        return gather_rows_dequant_int8_ref(primary, idx, secondary)
    _check_sources("gather_rows_dequant_int8", primary, idx, secondary,
                   (torch.uint8,))
    dev = primary.device
    D = primary.shape[1]
    out = torch.empty((*idx.shape, D), dtype=torch.float32, device=dev)
    if idx.numel() == 0:
        return out
    lib = _build.library()
    rc = lib.gather_rows_dequant_int8(
        primary.data_ptr(), primary.shape[0],
        None if secondary is None else secondary.data_ptr(),
        0 if secondary is None else secondary.shape[0],
        idx.data_ptr(), out.data_ptr(), idx.numel(), D, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "gather_rows_dequant_int8")
    gather_rows_dequant_int8.launches += 1
    return out


gather_rows_dequant_int8.launches = 0
