"""K4, `interaction_bwd_kernel` (`ops/cuda_interaction.py`): the dot
interaction's backward, from x, ly and the cotangent g [B, D + P] to
dx [B, D] and dly [B, T, D], float32."""

from evbench.roofline.k1 import pairs
from evbench.roofline.peaks import bound_s

KERNELS = ("interaction_bwd_kernel",)


def cost(B: int, T: int, D: int):
    """(bytes, flops) of one call: x, ly and g read, dx and dly written;
    each pair's cotangent scales one feature into the other's gradient and
    back, 4D operations a pair."""
    P = pairs(T)
    return (4 * (2 * (B * D + B * T * D) + B * (D + P)), 4 * B * P * D)


def bound(B: int, T: int, D: int) -> float:
    return bound_s(*cost(B, T, D))
