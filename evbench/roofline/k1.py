"""K1, `interaction_fwd_kernel` (`ops/cuda_interaction.py`): the dot
interaction, out [B, D + P] = concat(x, the P = F(F-1)/2 pairs' dot
products of the F = T + 1 features), float32."""

from evbench.roofline.peaks import bound_s

KERNELS = ("interaction_fwd_kernel",)


def pairs(T: int) -> int:
    return (T + 1) * T // 2


def cost(B: int, T: int, D: int):
    """(bytes, flops) of one call: x [B, D] and ly [B, T, D] read, out
    written; 2D operations a pair."""
    P = pairs(T)
    return 4 * (B * D + B * T * D + B * (D + P)), 2 * B * P * D


def bound(B: int, T: int, D: int) -> float:
    return bound_s(*cost(B, T, D))
