"""The 8-bit embedding codec of the int8 C1 cache.

Port of the 8-bit part of `evstore_tpu/ops/quant.py` (the reference's
script/reduce_precision.py:270,283 and mixed_precs_caching/evlfu_8.cpp:
370-378): encode round(((x + 1) / 2) * 254), decode (v / 254) * 2 - 1, for
values in [-1, 1].

- `np_quantize_int8` is the host encoder, copied as it is: numpy's `round`
  rounds half to even.  (The C++ engine's C2 encoder uses `roundf`, half
  away from zero; both stay as their packages have them.)
- `dequantize_int8` is the decoder, with an IEEE division by 254, as the
  codec's formula reads and as numpy and the engine's `dec8` compute it.
  The int8 gather kernel (`ops/cuda_gather.py`) computes the same, bit for
  bit.  A reciprocal multiply differs from it on 10 of the 256 codes.

The 16-bit and 4-bit codecs come with the tiers that use them on the
Python side; the engine has its own copies.
"""

from __future__ import annotations

import numpy as np
import torch


def np_quantize_int8(x: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> uint8 codes 0..254."""
    return np.clip(np.round(((x.astype(np.float32) + 1.0) / 2.0) * 254.0),
                   0, 254).astype(np.uint8)


def dequantize_int8(v: torch.Tensor) -> torch.Tensor:
    """uint8 codes -> float32 (v / 254) * 2 - 1.  The divisor is a tensor on
    v's device: PyTorch's CUDA division by a Python scalar multiplies by the
    reciprocal instead."""
    div = torch.full((), 254.0, dtype=torch.float32, device=v.device)
    return (v.float() / div) * 2.0 - 1.0
