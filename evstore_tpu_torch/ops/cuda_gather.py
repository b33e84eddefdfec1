"""Row gather through the CUDA kernel `csrc/gather_rows.cu`.

Port of the TPU kernel `evstore_tpu/ops/pallas_gather.py::_gather_kernel`,
extended to two sources for the device C1 cache: an index below
`primary.shape[0]` reads `primary`, a larger one reads
`secondary[idx - primary.shape[0]]`.  The wrapper launches the kernel for a
CUDA tensor and takes the plain version (`gather_rows_ref`) only for a CPU
tensor.  It checks no index on the device (that would need a sync): callers
validate indices on the host, and the kernel writes a zero row for an index
out of range rather than reading out of bounds.
"""

from __future__ import annotations

from typing import Optional

import torch

from evstore_tpu_torch import _build


def gather_rows_ref(primary: torch.Tensor, idx: torch.Tensor,
                    secondary: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: `index_select` on the concatenated sources."""
    src = primary if secondary is None else torch.cat([primary, secondary])
    rows = torch.index_select(src, 0, idx.reshape(-1).long())
    return rows.reshape(*idx.shape, primary.shape[1])


def gather_rows(primary: torch.Tensor, idx: torch.Tensor,
                secondary: Optional[torch.Tensor] = None) -> torch.Tensor:
    """primary [C, D], optional secondary [M, D], idx int32 of any shape ->
    idx.shape + [D] rows, bit-exact."""
    tensors = [primary, idx] + ([] if secondary is None else [secondary])
    if all(t.device.type == "cpu" for t in tensors):
        return gather_rows_ref(primary, idx, secondary)
    dev = primary.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("gather_rows: all tensors must be on one CUDA device "
                         "(or all on the CPU), got "
                         f"{[str(t.device) for t in tensors]}")
    if primary.dim() != 2 or primary.element_size() * primary.shape[1] % 4:
        raise ValueError(f"gather_rows takes [N, D] rows of a multiple of 4 "
                         f"bytes, got {tuple(primary.shape)} {primary.dtype}")
    if primary.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gather_rows takes float32 or bfloat16 rows, got "
                        f"{primary.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"gather_rows takes int32 indices, got {idx.dtype}")
    if secondary is not None and (secondary.dtype != primary.dtype
                                  or secondary.dim() != 2
                                  or secondary.shape[1] != primary.shape[1]):
        raise ValueError(f"secondary {tuple(secondary.shape)} "
                         f"{secondary.dtype} does not match primary "
                         f"{tuple(primary.shape)} {primary.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gather_rows takes contiguous tensors")
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
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
