"""The dot interaction through the CUDA kernel `csrc/interaction_fwd.cu`.

Port of the TPU kernel `evstore_tpu/ops/pallas_interaction.py::
_blocked_fwd_kernel`.  The wrapper launches the kernel for a CUDA tensor and
takes the plain version (`dot_interaction_ref`) only for a CPU tensor; any
other device, dtype or shape it cannot take raises.  Unlike the TPU kernel,
it takes any batch size and widths up to 128.
"""

from __future__ import annotations

import torch

from evstore_tpu_torch import _build
from evstore_tpu_torch.ops.interaction import dot_interaction, num_pairs

# the plain version the kernel is held to
dot_interaction_ref = dot_interaction

MAX_DIM = 128
# shared memory a block stages (static launch limit, no opt-in needed)
_SMEM_BYTES = 48 * 1024
_MAX_SAMPLES_PER_BLOCK = 8


def samples_per_block(num_features: int, dim: int) -> int:
    """Samples one block stages: as many as fit, at most 8."""
    row = (dim + 1 if dim % 2 == 0 else dim) * 4    # padded f32 row
    return max(1, min(_MAX_SAMPLES_PER_BLOCK,
                      _SMEM_BYTES // (num_features * row)))


def dot_interaction_kernel(x: torch.Tensor, ly: torch.Tensor,
                           self_interaction: bool = False) -> torch.Tensor:
    """x [B, D], ly [B, T, D] (f32 or bf16) -> [B, D + P]."""
    if x.device.type == "cpu" and ly.device.type == "cpu":
        return dot_interaction_ref(x, ly, self_interaction)
    if x.device.type != "cuda" or ly.device != x.device:
        raise ValueError(f"dot_interaction_kernel: x on {x.device}, ly on "
                         f"{ly.device}; both must be on one CUDA device "
                         "(or both on the CPU)")
    if x.dtype not in (torch.float32, torch.bfloat16) or ly.dtype != x.dtype:
        raise TypeError(f"dot_interaction_kernel takes float32 or bfloat16, "
                        f"got {x.dtype} and {ly.dtype}")
    if x.dim() != 2 or ly.dim() != 3 or ly.shape[0] != x.shape[0] \
            or ly.shape[2] != x.shape[1]:
        raise ValueError(f"shapes x {tuple(x.shape)}, ly {tuple(ly.shape)}: "
                         "expected [B, D] and [B, T, D]")
    if not (x.is_contiguous() and ly.is_contiguous()):
        raise ValueError("dot_interaction_kernel takes contiguous tensors")
    B, D = x.shape
    T = ly.shape[1]
    F = T + 1
    if not 1 <= D <= MAX_DIM or T < 1:
        raise ValueError(f"dot_interaction_kernel takes 1 <= D <= {MAX_DIM} "
                         f"and T >= 1, got D={D}, T={T}")
    dp = D + 1 if D % 2 == 0 else D
    if F * dp * 4 > _SMEM_BYTES:
        raise ValueError(f"{F} features of width {D} exceed one block's "
                         "shared memory")
    out = torch.empty((B, D + num_pairs(F, self_interaction)),
                      dtype=x.dtype, device=x.device)
    if B == 0:
        return out
    lib = _build.library()
    rc = lib.interaction_fwd(
        x.data_ptr(), ly.data_ptr(), out.data_ptr(), B, T, D,
        int(bool(self_interaction)), int(x.dtype == torch.bfloat16),
        samples_per_block(F, D), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "interaction_fwd")
    dot_interaction_kernel.launches += 1
    return out


dot_interaction_kernel.launches = 0
