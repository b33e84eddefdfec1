"""The dot interaction and its VJP through the CUDA kernels
`csrc/interaction_fwd.cu`, `csrc/interaction_bwd.cu` and
`csrc/interaction_gram.cu`.

Ports of the TPU kernels `evstore_tpu/ops/pallas_interaction.py::
_blocked_fwd_kernel`, `_blocked_bwd_kernel` and `_interaction_kernel`.
Each wrapper launches its kernel for CUDA tensors and takes its plain
version (`dot_interaction_ref`, `dot_interaction_bwd_ref`) only for CPU
tensors; any other device, dtype or shape it cannot take raises.  Unlike
the TPU kernels, they take any batch size and widths up to 128 (the TPU
lowering's `tile_b` and `interpret` have no counterpart).

- `DotInteraction` is the autograd Function whose forward is the one-stage
  kernel and whose backward is the backward kernel.  Its backward is the
  true VJP: a self-interaction pair carries twice its cotangent, where the
  TPU backward kernel carries it once.  The model's dot interaction goes
  through it.
- `DotInteractionGram` is the port of the JAX package's
  `dot_interaction_pallas`: its forward is the two-stage kernel (each
  sample's lower-triangle Gram, then the pairs through an index table),
  and its backward is the plain `dot_interaction_bwd`, as the reference's
  backward is plain XLA.  No configuration routes the model through it,
  as none does in the JAX package; it is the A/B of the two forwards.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from evstore_tpu_torch import _build
from evstore_tpu_torch.ops.interaction import (_tril_indices,
                                               dot_interaction,
                                               dot_interaction_bwd, num_pairs)

# the plain versions the kernels are held to
dot_interaction_ref = dot_interaction
dot_interaction_bwd_ref = dot_interaction_bwd

MAX_DIM = 128
# shared memory a block stages (static launch limit, no opt-in needed)
_SMEM_BYTES = 48 * 1024
_MAX_SAMPLES_PER_BLOCK = 8


def _odd(n: int) -> int:
    """A row stride of odd length, so that rows start in distinct banks."""
    return n + 1 if n % 2 == 0 else n


def _sample_bytes(num_features: int, dim: int, backward: bool) -> int:
    """Shared memory one sample takes: the forward stages the F x D
    features, the backward also the F x F cotangent (f32, odd strides)."""
    row = _odd(dim) + (_odd(num_features) if backward else 0)
    return num_features * row * 4


def samples_per_block(num_features: int, dim: int,
                      backward: bool = False) -> int:
    """Samples one block stages: as many as fit, at most 8."""
    return max(1, min(_MAX_SAMPLES_PER_BLOCK, _SMEM_BYTES // _sample_bytes(
        num_features, dim, backward)))


def _on_card(name: str, *tensors: torch.Tensor) -> bool:
    """False for CPU tensors (the plain version runs); True for tensors on
    one CUDA device that the kernel takes; raises otherwise."""
    x, ly = tensors[0], tensors[1]
    if all(t.device.type == "cpu" for t in tensors):
        return False
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: tensors on "
                         f"{[str(t.device) for t in tensors]}; all must be "
                         "on one CUDA device (or all on the CPU)")
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            any(t.dtype != x.dtype for t in tensors):
        raise TypeError(f"{name} takes float32 or bfloat16, got "
                        f"{[t.dtype for t in tensors]}")
    if x.dim() != 2 or ly.dim() != 3 or ly.shape[0] != x.shape[0] \
            or ly.shape[2] != x.shape[1]:
        raise ValueError(f"shapes x {tuple(x.shape)}, ly {tuple(ly.shape)}: "
                         "expected [B, D] and [B, T, D]")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    D, T = x.shape[1], ly.shape[1]
    if not 1 <= D <= MAX_DIM or T < 1:
        raise ValueError(f"{name} takes 1 <= D <= {MAX_DIM} and T >= 1, got "
                         f"D={D}, T={T}")
    if _sample_bytes(T + 1, D, len(tensors) > 2) > _SMEM_BYTES:
        raise ValueError(f"{T + 1} features of width {D} exceed one block's "
                         "shared memory")
    return True


def dot_interaction_kernel(x: torch.Tensor, ly: torch.Tensor,
                           self_interaction: bool = False) -> torch.Tensor:
    """x [B, D], ly [B, T, D] (f32 or bf16) -> [B, D + P]."""
    if not _on_card("dot_interaction_kernel", x, ly):
        return dot_interaction_ref(x, ly, self_interaction)
    B, D = x.shape
    T = ly.shape[1]
    out = torch.empty((B, D + num_pairs(T + 1, self_interaction)),
                      dtype=x.dtype, device=x.device)
    if B == 0:
        return out
    rc = _build.library().interaction_fwd(
        x.data_ptr(), ly.data_ptr(), out.data_ptr(), B, T, D,
        int(bool(self_interaction)), int(x.dtype == torch.bfloat16),
        samples_per_block(T + 1, D), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "interaction_fwd")
    dot_interaction_kernel.launches += 1
    return out


dot_interaction_kernel.launches = 0


def dot_interaction_bwd_kernel(x: torch.Tensor, ly: torch.Tensor,
                               g: torch.Tensor,
                               self_interaction: bool = False):
    """x [B, D], ly [B, T, D], cotangent g [B, D + P] (one dtype, f32 or
    bf16) -> (dx [B, D], dly [B, T, D])."""
    if not _on_card("dot_interaction_bwd_kernel", x, ly, g):
        return dot_interaction_bwd_ref(x, ly, g, self_interaction)
    B, D = x.shape
    T = ly.shape[1]
    if tuple(g.shape) != (B, D + num_pairs(T + 1, self_interaction)):
        raise ValueError(f"cotangent {tuple(g.shape)} does not match the "
                         f"output of x {tuple(x.shape)}, ly "
                         f"{tuple(ly.shape)}")
    dx = torch.empty_like(x)
    dly = torch.empty_like(ly)
    if B == 0:
        return dx, dly
    rc = _build.library().interaction_bwd(
        x.data_ptr(), ly.data_ptr(), g.data_ptr(), dx.data_ptr(),
        dly.data_ptr(), B, T, D, int(bool(self_interaction)),
        int(x.dtype == torch.bfloat16),
        samples_per_block(T + 1, D, backward=True), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "interaction_bwd")
    dot_interaction_bwd_kernel.launches += 1
    return dx, dly


dot_interaction_bwd_kernel.launches = 0


class DotInteraction(torch.autograd.Function):
    """`dot_interaction` with the forward kernel and the backward kernel:
    `DotInteraction.apply(x, ly, self_interaction)`."""

    @staticmethod
    def forward(ctx, x, ly, self_interaction: bool = False):
        ctx.self_interaction = bool(self_interaction)
        ctx.save_for_backward(x, ly)
        return dot_interaction_kernel(x, ly, self_interaction)

    @staticmethod
    def backward(ctx, g):
        x, ly = ctx.saved_tensors
        dx, dly = dot_interaction_bwd_kernel(x, ly, g.contiguous(),
                                             ctx.self_interaction)
        return dx, dly, None


# ------------------------------------------- the two-stage (Gram) forward

def gram_pair_table(num_features: int, self_interaction: bool) -> np.ndarray:
    """int32 [P]: the place of pair p, (li[p], lj[p]) in np.tril_indices
    order, in the packed lower triangle (diagonal included) that the
    kernel's first stage fills: li (li + 1) / 2 + lj.  It stands for the
    TPU kernel's 0/1 selectors (`_row_selectors`)."""
    li, lj = _tril_indices(num_features, self_interaction)
    return (li * (li + 1) // 2 + lj).astype(np.int32)


def _gram_bytes(num_features: int, dim: int, self_interaction: bool,
                spb: int) -> int:
    """Shared memory of one block: the pair table, then per sample the
    F x D features (odd stride) and the packed lower triangle."""
    F = num_features
    return 4 * (num_pairs(F, self_interaction)
                + spb * (F * _odd(dim) + F * (F + 1) // 2))


def gram_samples_per_block(num_features: int, dim: int,
                           self_interaction: bool = False) -> int:
    """Samples one block of the Gram kernel stages: as many as fit, at
    most 8; 0 when not even one does."""
    for spb in range(_MAX_SAMPLES_PER_BLOCK, 0, -1):
        if _gram_bytes(num_features, dim, self_interaction, spb) \
                <= _SMEM_BYTES:
            return spb
    return 0


@functools.lru_cache(maxsize=None)
def _pair_table_on(num_features: int, self_interaction: bool,
                   device: torch.device) -> torch.Tensor:
    return torch.from_numpy(gram_pair_table(num_features,
                                            self_interaction)).to(device)


def dot_interaction_gram_kernel(x: torch.Tensor, ly: torch.Tensor,
                                self_interaction: bool = False
                                ) -> torch.Tensor:
    """x [B, D], ly [B, T, D] (f32 or bf16) -> [B, D + P] through the
    two-stage kernel; the same function as `dot_interaction_kernel`."""
    if not _on_card("dot_interaction_gram_kernel", x, ly):
        return dot_interaction_ref(x, ly, self_interaction)
    B, D = x.shape
    T = ly.shape[1]
    F = T + 1
    P = num_pairs(F, self_interaction)
    spb = gram_samples_per_block(F, D, bool(self_interaction))
    if spb < 1:
        raise ValueError(f"{F} features of width {D} exceed one block's "
                         "shared memory in the Gram kernel")
    out = torch.empty((B, D + P), dtype=x.dtype, device=x.device)
    if B == 0:
        return out
    tab = _pair_table_on(F, bool(self_interaction), x.device)
    rc = _build.library().interaction_gram(
        x.data_ptr(), ly.data_ptr(), tab.data_ptr(), out.data_ptr(), B, T,
        D, P, int(x.dtype == torch.bfloat16), spb, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "interaction_gram")
    dot_interaction_gram_kernel.launches += 1
    return out


dot_interaction_gram_kernel.launches = 0


class DotInteractionGram(torch.autograd.Function):
    """The port of `dot_interaction_pallas`: the two-stage forward kernel
    and the plain VJP, `DotInteractionGram.apply(x, ly, self_interaction)`."""

    @staticmethod
    def forward(ctx, x, ly, self_interaction: bool = False):
        ctx.self_interaction = bool(self_interaction)
        ctx.save_for_backward(x, ly)
        return dot_interaction_gram_kernel(x, ly, self_interaction)

    @staticmethod
    def backward(ctx, g):
        x, ly = ctx.saved_tensors
        dx, dly = dot_interaction_bwd(x, ly, g.contiguous(),
                                      ctx.self_interaction)
        return dx, dly, None
