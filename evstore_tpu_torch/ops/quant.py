"""Mixed-precision embedding codecs.

Port of `evstore_tpu/ops/quant.py` (the reference's offline precision
reduction, script/reduce_precision.py, and the in-cache decoders of
mixed_precs_caching/evlfu_{4,8,16}.cpp), for values in [-1, 1]:

- 8-bit: encode round(((x + 1) / 2) * 254), decode (v / 254) * 2 - 1;
- 16-bit: the reference's ushort codec, not IEEE fp16.  [-0.65, 0.65] maps
  linearly onto 0..65000; an outlier |x| > 0.65 is stored as
  65000 + int(100 (|x| - 0.65)), its sign in the parity (odd negative);
- 4-bit: a posit-like bracket map onto 15 codes (0..14, code 7 is 0.0),
  decoded through a fixed table.

Each codec comes twice: on torch tensors (`quantize_*`, `dequantize_*`,
dispatched by `quantize` / `dequantize`) and on numpy arrays (`np_*`, the
host tiers' hot path, as in the JAX package).  Both compute each formula
one IEEE operation at a time, as eager JAX and numpy do: divisions are true
divisions (a torch divisor is a 0-d tensor on the input's device, because
PyTorch's CUDA division by a Python scalar multiplies by the reciprocal)
and nothing is contracted into an FMA.  The two versions give the same
codes and values bit for bit.  Jitted XLA may contract a decode into an
FMA and then differs by one f32 ulp on some codes.

- `np_quantize_int8` rounds half to even (numpy's `round`); the C++
  engine's C2 encoder uses `roundf`, half away from zero.  Both stay as
  their packages have them.
- The int8 gather kernel (`ops/cuda_gather.py`) computes
  `dequantize_int8` bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

# decode table of the 4-bit codec (reduce_precision.py:174-177); index 15 is
# never produced and mirrors 14
_POSIT4_DECODE = np.array(
    [1.0, 0.8, 0.6, 0.4, 0.0625, 0.00390625, 0.0000153, 0.0,
     -0.0000153, -0.00390625, -0.0625, -0.4, -0.6, -0.8, -1.0, -1.0],
    dtype=np.float32)
# encode brackets (reduce_precision.py:140-172)
_POS_BRACKETS = np.array([0.8, 0.6, 0.4, 0.25, 0.015, 0.00025, 0.0],
                         dtype=np.float32)
_NEG_BRACKETS = np.array([-1.0, -0.8, -0.6, -0.4, -0.25, -0.015, -0.00025],
                         dtype=np.float32)


def _div(v: torch.Tensor, d: float) -> torch.Tensor:
    """v / d as an IEEE division on any device."""
    return v / torch.full((), d, dtype=torch.float32, device=v.device)


# ---------------------------------------------------------------- 8-bit codec

def quantize_int8(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float -> uint8 codes 0..254 (round half to even)."""
    v = torch.round(_div(x.float() + 1.0, 2.0) * 254.0)
    return v.clamp(0, 254).to(torch.uint8)


def dequantize_int8(v: torch.Tensor) -> torch.Tensor:
    """uint8 codes -> float32 (v / 254) * 2 - 1."""
    return _div(v.float(), 254.0) * 2.0 - 1.0


def np_quantize_int8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.round(((x.astype(np.float32) + 1.0) / 2.0) * 254.0),
                   0, 254).astype(np.uint8)


def np_dequantize_int8(v: np.ndarray) -> np.ndarray:
    return (v.astype(np.float32) / 254.0) * 2.0 - 1.0


# --------------------------------------------------------------- 16-bit codec

def quantize_ushort(x: torch.Tensor) -> torch.Tensor:
    """The ushort codec: dense [-0.65, 0.65] -> 0..65000, outliers above
    65000 with the sign in the parity.  uint16 codes."""
    xf = x.float()
    dense = (_div(xf + 0.65, 1.3) * 65000.0).to(torch.int32)
    neg_left = (-100.0 * (0.65 + xf)).to(torch.int32)
    neg_left = torch.where(neg_left % 2 == 0, neg_left + 1, neg_left)
    pos_left = (100.0 * (xf - 0.65)).to(torch.int32)
    pos_left = torch.where(pos_left % 2 == 1, pos_left - 1, pos_left)
    out = torch.where(xf < -0.65, 65000 + neg_left,
                      torch.where(xf > 0.65, 65000 + pos_left, dense))
    return out.clamp(0, 65535).to(torch.uint16)


def dequantize_ushort(v: torch.Tensor) -> torch.Tensor:
    vi = v.to(torch.int32)
    diff = _div((vi - 65000).float(), 100.0)
    outlier = torch.where(vi % 2 == 1, -(0.65 + diff), 0.65 + diff)
    dense = _div(vi.float(), 65000.0) * 1.3 - 0.65
    return torch.where(vi > 65000, outlier, dense)


def np_quantize_ushort(x: np.ndarray) -> np.ndarray:
    xf = x.astype(np.float32)
    dense = ((xf + np.float32(0.65)) / np.float32(1.3)
             * 65000.0).astype(np.int32)
    neg_left = (np.float32(-100.0) * (np.float32(0.65) + xf)).astype(np.int32)
    neg_left = np.where(neg_left % 2 == 0, neg_left + 1, neg_left)
    pos_left = (np.float32(100.0) * (xf - np.float32(0.65))).astype(np.int32)
    pos_left = np.where(pos_left % 2 == 1, pos_left - 1, pos_left)
    out = np.where(xf < np.float32(-0.65), 65000 + neg_left,
                   np.where(xf > np.float32(0.65), 65000 + pos_left, dense))
    return np.clip(out, 0, 65535).astype(np.uint16)


def np_dequantize_ushort(v: np.ndarray) -> np.ndarray:
    vi = v.astype(np.int32)
    diff = (vi - 65000).astype(np.float32) / 100.0
    outlier = np.where(vi % 2 == 1, -(0.65 + diff), 0.65 + diff)
    dense = ((vi.astype(np.float32) / 65000.0) * np.float32(1.3)
             - np.float32(0.65))
    return np.where(vi > 65000, outlier, dense).astype(np.float32)


# ---------------------------------------------------------------- 4-bit codec

def quantize_int4(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> codes 0..14 (uint8, one code per element; the storage
    layer packs two per byte)."""
    xf = x.float()
    pos = torch.from_numpy(_POS_BRACKETS).to(xf.device)
    neg = torch.from_numpy(_NEG_BRACKETS).to(xf.device)
    # positive: the first bracket with x >= bracket (the last one is 0.0)
    pos_code = torch.argmax((xf[..., None] >= pos).to(torch.int32), dim=-1)
    # negative: 8 plus the number of brackets above x; 8 near zero
    neg_code = 8 + (xf[..., None] < neg).sum(dim=-1)
    neg_code = torch.where(xf >= -0.00025, torch.full_like(neg_code, 8),
                           neg_code)
    code = torch.where(xf == 0.0, torch.full_like(pos_code, 7),
                       torch.where(xf > 0.0, pos_code, neg_code))
    return code.clamp(0, 14).to(torch.uint8)


def dequantize_int4(codes: torch.Tensor) -> torch.Tensor:
    table = torch.from_numpy(_POSIT4_DECODE).to(codes.device)
    return table[codes.long()]


def np_quantize_int4(x: np.ndarray) -> np.ndarray:
    xf = x.astype(np.float32)
    pos_code = np.argmax(xf[..., None] >= _POS_BRACKETS, axis=-1)
    neg_code = 8 + np.sum(xf[..., None] < _NEG_BRACKETS, axis=-1)
    neg_code = np.where(xf >= np.float32(-0.00025), 8, neg_code)
    code = np.where(xf == 0.0, 7, np.where(xf > 0.0, pos_code, neg_code))
    return np.clip(code, 0, 14).astype(np.uint8)


def np_dequantize_int4(codes: np.ndarray) -> np.ndarray:
    return _POSIT4_DECODE[codes.astype(np.int32)]


# ------------------------------------------------------------------ dispatch

def quantize(x: torch.Tensor, bits: int) -> torch.Tensor:
    if bits == 32:
        return x.float()
    if bits == 16:
        return quantize_ushort(x)
    if bits == 8:
        return quantize_int8(x)
    if bits == 4:
        return quantize_int4(x)
    raise ValueError(f"unsupported precision {bits}")


def dequantize(v: torch.Tensor, bits: int) -> torch.Tensor:
    if bits == 32:
        return v.float()
    if bits == 16:
        return dequantize_ushort(v)
    if bits == 8:
        return dequantize_int8(v)
    if bits == 4:
        return dequantize_int4(v)
    raise ValueError(f"unsupported precision {bits}")
