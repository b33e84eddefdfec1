"""K2, `gather_kernel` (`ops/cuda_gather.py`): out[r] = rows[idx[r]], over
one source, two (the device cache and its miss buffer) or a group of
tables, float32."""

from evbench.roofline.peaks import bound_s

KERNELS = ("gather_kernel",)


def cost(R: int, U: int, D: int, row_bytes: int = 4):
    """(bytes, flops) of one call: R int32 indices and the U distinct rows
    they name read once, R rows written."""
    return 4 * R + row_bytes * D * U + 4 * D * R, 0


def bound(R: int, U: int, D: int) -> float:
    return bound_s(*cost(R, U, D))
