"""One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its 700 W
limit): float32 outside the tensor cores, and HBM3."""

F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, flops: float, peak_flops: float = F32_FLOPS
            ) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / peak_flops)
