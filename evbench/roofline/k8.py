"""K8, `cross_fwd_kernel`, `cross_bwd_kernel` and `cross_bias_sum_kernel`
(`ops/cuda_cross.py`): the elementwise part of a low-rank cross layer,
float32, x0, u, x_l and the cotangents [B, N], b [N].  The bytes are what
the fused layer requires, whatever implements it: each input once and
each output once."""

from evbench.roofline.peaks import bound_s

KERNELS = ("cross_fwd_kernel", "cross_bwd_kernel", "cross_bias_sum_kernel")


def forward_cost(B: int, N: int):
    """(bytes, flops): x0, u, x_l and b read, y = x0 (u + b) + x_l
    written; 3 operations an element."""
    return 4 * (4 * B * N + N), 3 * B * N


def backward_cost(B: int, N: int, accumulate: bool = True):
    """(bytes, flops): g, x0, u and b read, gu = g x0 and gb (its column
    sums) written, g (u + b) added into x0's gradient (read where it
    accumulates, written); 5 operations an element."""
    return (4 * ((5 + int(accumulate)) * B * N + 2 * N), 5 * B * N)


def step_bound(B: int, N: int, layers: int) -> float:
    """The least time of a train step's K8 work: each layer's forward and
    backward, the backward of the last layer writing x0's gradient and
    the others adding to it."""
    fwd = bound_s(*forward_cost(B, N))
    return layers * fwd + bound_s(*backward_cost(B, N, False)) + \
        (layers - 1) * bound_s(*backward_cost(B, N, True))
