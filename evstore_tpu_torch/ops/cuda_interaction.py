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
import math
from typing import NamedTuple, Optional, Tuple

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
# the shapes the interaction kernels take (`_sample_bytes`, below)
_SMEM_BYTES = 48 * 1024

# K1, K4 and K6 (`csrc/interaction_fwd.cu`, `csrc/interaction_bwd.cu`,
# `csrc/interaction_gram.cu`): a block of THREADS walks groups of
# consecutive samples; its dynamic shared memory holds a two-stage ring of
# the groups' input spans, then K1's output span, K4's S or K6's packed
# Gram triangles (`smem_bytes`, `gram_smem_bytes`).
THREADS = 256
MAX_SAMPLES_PER_GROUP = 8
SMEM_TARGET = 76800          # a group's size stays below this: 3 blocks/SM
SMEM_MAX = 232448            # the most one block can have (227 KB)
SMEM_PER_SM = 233472         # 228 KB, of which each block reserves 1 KB
TILE = 4                     # K1, K6: a thread owns a TILE x TILE tile
# K6's __launch_bounds__(THREADS, 3): its registers hold three blocks an SM,
# so a persistent grid of more (bf16's smaller ring would allow five) would
# run its last blocks in a second wave
GRAM_BLOCKS_PER_SM = 3
ROWS_PER_THREAD = 6          # K4: a thread owns 6 rows f x 4 columns d


def _odd(n: int) -> int:
    """A row stride of odd length, so that rows start in distinct banks."""
    return n + 1 if n % 2 == 0 else n


def _sample_bytes(num_features: int, dim: int, backward: bool) -> int:
    """The rule for the shapes K1 and K4 take, kept from their first design:
    a sample's F x D features (and, backward, its F x F cotangent) at odd
    f32 strides within 48 KB.  Every such shape fits the current kernels
    with one sample a group (`interaction_geometry`)."""
    row = _odd(dim) + (_odd(num_features) if backward else 0)
    return num_features * row * 4


def _span(nbytes: int) -> int:
    """Shared memory of one staged span: 16-byte units plus room for its
    phase (`common.cuh::span_bytes`)."""
    return (nbytes + 15) // 16 * 16 + 16


def smem_bytes(spg: int, num_features: int, dim: int, itemsize: int,
               self_interaction: bool, backward: bool,
               stage_out: bool = True) -> int:
    """Dynamic shared memory of a block for groups of `spg` samples, as the
    C launchers compute it.  Forward: two stages of the x span and of each
    sample's ly region (`_sample_stride`), then the output span
    ([x, pairs]) when `stage_out`.  Backward: two stages of the x, ly and
    cotangent spans, then each sample's f32 [F, F] S at a row stride of F
    rounded up to 4."""
    T = num_features - 1
    W = dim + num_pairs(num_features, self_interaction)
    x = _span(spg * dim * itemsize)
    out = _span(spg * W * itemsize)
    if backward:
        ly = _span(spg * T * dim * itemsize)
        return 2 * (x + ly + out) + spg * num_features * _s_stride(
            num_features) * 4
    ly = spg * _sample_stride(T * dim * itemsize)
    return 2 * (x + ly) + (out if stage_out else 0)


def _sample_stride(nbytes: int) -> int:
    """K1's region of one sample's ly rows: an odd number of 16-byte
    units (`interaction_fwd.cu::sample_stride`)."""
    s = _span(nbytes)
    return s if s // 16 % 2 else s + 16


def _s_stride(num_features: int) -> int:
    """K4's row stride of S: F rounded up to a multiple of 4."""
    return (num_features + 3) // 4 * 4


class Geometry(NamedTuple):
    samples_per_group: int
    groups: int
    blocks: int
    smem_bytes: int
    stage_out: bool


@functools.lru_cache(maxsize=4096)
def interaction_geometry(batch: int, num_features: int, dim: int,
                         itemsize: int = 4, self_interaction: bool = False,
                         backward: bool = False,
                         num_sms: int = 132) -> Geometry:
    """The launch of K1 (or K4 with `backward`) for a batch (`_fit`):
    samples per group, groups, blocks of the persistent grid (of THREADS
    each), shared memory, and whether the forward stages its output rows.
    The forward stores its pairs straight to global memory when one
    sample's output row does not fit beside the ring."""
    F, D = num_features, dim
    stage_out = backward or smem_bytes(1, F, D, itemsize, self_interaction,
                                       False) <= SMEM_MAX
    return Geometry(*_fit(batch, num_sms, lambda s: smem_bytes(
        s, F, D, itemsize, self_interaction, backward, stage_out)),
        stage_out)


def _fit(batch: int, num_sms: int, size, max_per_sm: int = 2048 // THREADS):
    """(samples a group, groups, blocks, shared memory) for groups whose
    block needs size(samples) bytes of shared memory.  A group takes up to
    8 samples, but no more than batch // num_sms, so that at the train
    (128) and serve (2048) batches every SM gets a group where the batch
    has enough samples, and no more than keep its shared memory within
    SMEM_TARGET (three blocks an SM), one at the least.  The grid is as
    many blocks as there are groups, at most as many as the SMs hold at
    once by shared memory and `max_per_sm`."""
    fill = max(1, min(MAX_SAMPLES_PER_GROUP, batch // num_sms))
    spg = next((s for s in range(fill, 0, -1) if size(s) <= SMEM_TARGET), 1)
    smem = size(spg)
    groups = -(-batch // spg)
    per_sm = max(1, min(max_per_sm, SMEM_PER_SM // (smem + 1024)))
    return spg, groups, max(1, min(groups, num_sms * per_sm)), smem


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# The kernels' index arithmetic, which the CPU tests pin.

def tile_of(t: int) -> Tuple[int, int]:
    """Tile t of the lower triangle of K1's tile grid, row-major:
    t = ti (ti + 1) / 2 + tj, tj <= ti (`pair_of(t, 1)` in the kernel)."""
    ti = (math.isqrt(8 * t + 1) - 1) // 2
    return ti, t - ti * (ti + 1) // 2


def pair_column(i: int, j: int, self_interaction: bool) -> int:
    """The column after x of pair (i, j), j < i (j <= i with
    self_interaction), in np.tril_indices order."""
    return (i * (i + 1) // 2 if self_interaction else i * (i - 1) // 2) + j


def cotangent_index(f: int, j: int, self_interaction: bool):
    """(p, scale): K4 builds S[f, j] as scale * g_pair[p]; p is -1 (scale
    0) on the diagonal without self_interaction."""
    i, k = max(f, j), min(f, j)
    if i == k:
        return (pair_column(i, i, True), 2.0) if self_interaction \
            else (-1, 0.0)
    return pair_column(i, k, self_interaction), 1.0


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
        raise ValueError(f"{T + 1} features of width {D} exceed what the "
                         "interaction kernels take")
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
    dev = x.device.index
    geo = interaction_geometry(B, T + 1, D, x.element_size(),
                               bool(self_interaction), False, _num_sms(dev))
    rc = _build.library().interaction_fwd(
        x.data_ptr(), ly.data_ptr(), out.data_ptr(), B, T, D,
        int(bool(self_interaction)), int(x.dtype == torch.bfloat16),
        geo.samples_per_group, geo.blocks, int(geo.stage_out), dev,
        _build.stream(dev))
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
    dev = x.device.index
    geo = interaction_geometry(B, T + 1, D, x.element_size(),
                               bool(self_interaction), True, _num_sms(dev))
    rc = _build.library().interaction_bwd(
        x.data_ptr(), ly.data_ptr(), g.data_ptr(), dx.data_ptr(),
        dly.data_ptr(), B, T, D, int(bool(self_interaction)),
        int(x.dtype == torch.bfloat16), geo.samples_per_group, geo.blocks,
        dev, _build.stream(dev))
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


def gram_stride(num_features: int) -> int:
    """f32 entries of one sample's packed lower triangle in K6's shared
    memory: F (F + 1) / 2, rounded up to an odd number against bank
    conflicts."""
    return (num_features * (num_features + 1) // 2) | 1


def gram_smem_bytes(spg: int, num_features: int, dim: int, itemsize: int,
                    self_interaction: bool) -> int:
    """K6's dynamic shared memory for groups of `spg` samples, as its C
    launcher computes it: two stages of the x span and of each sample's ly
    region (`_sample_stride`, as K1), then each sample's f32 triangle and
    the int32 pair table.  The output is not staged."""
    x = _span(spg * dim * itemsize)
    ly = spg * _sample_stride((num_features - 1) * dim * itemsize)
    return 2 * (x + ly) + 4 * (spg * gram_stride(num_features)
                               + num_pairs(num_features, self_interaction))


@functools.lru_cache(maxsize=4096)
def gram_geometry(batch: int, num_features: int, dim: int,
                  itemsize: int = 4, self_interaction: bool = False,
                  num_sms: int = 132) -> Optional[Geometry]:
    """The launch of K6 for a batch, by K1's rule (`_fit`): groups of up to
    8 samples, no more than batch // num_sms, within SMEM_TARGET; a
    persistent grid.  None when not even one sample's ring, triangle and
    pair table fit a block (SMEM_MAX): no design of the two-stage kernel
    stages that shape."""
    F, D, si = num_features, dim, self_interaction
    if gram_smem_bytes(1, F, D, itemsize, si) > SMEM_MAX:
        return None
    return Geometry(*_fit(batch, num_sms, lambda s: gram_smem_bytes(
        s, F, D, itemsize, si), GRAM_BLOCKS_PER_SM), False)


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
    dev = x.device.index
    geo = gram_geometry(B, F, D, x.element_size(), bool(self_interaction),
                        _num_sms(dev))
    if geo is None:
        raise ValueError(f"{F} features of width {D} exceed one block's "
                         "shared memory in the Gram kernel")
    out = torch.empty((B, D + P), dtype=x.dtype, device=x.device)
    if B == 0:
        return out
    tab = _pair_table_on(F, bool(self_interaction), x.device)
    rc = _build.library().interaction_gram(
        x.data_ptr(), ly.data_ptr(), tab.data_ptr(), out.data_ptr(), B, T,
        D, P, int(x.dtype == torch.bfloat16), geo.samples_per_group,
        geo.blocks, dev, _build.stream(dev))
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
