"""Device resolution for the port's entry points.

Every entry point (`run_inference`, `build_cache`, `DeviceC1Cache`,
`NativeDeviceC1Cache`, `DLRM`) runs on the card unless the caller passes `device="cpu"`.  A machine without
a CUDA device raises rather than falling back to the CPU.
"""

from __future__ import annotations

import torch


def exact_float32() -> None:
    """Keep float32 products in float32: no TF32 in matmuls or cuDNN.  The
    JAX reference computes them at Precision.HIGHEST."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """`None` means the card; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    exact_float32()
    return dev
