"""A DLRM-DCNv2 train step's model operations: the MLPs' matmuls, the
cross layers' two matmuls and their elementwise part, forward and the
backward the step needs (every weight's gradient, every activation's but
the dense input's), at widths from a record's dims."""

from evbench.roofline import k8
from evbench.roofline.step import _macs


def cross_width(dims) -> int:
    return (len(dims["table_sizes"]) + 1) * dims["dim"]


def train_flops(dims, B: int) -> float:
    bot, top = _macs(dims["mlp_bot"]), _macs(dims["mlp_top"])
    mlp = sum(bot) + sum(top)
    N, r, L = cross_width(dims), dims["dcn_rank"], dims["dcn_layers"]
    cross = L * 2 * N * r                      # V x_l, then W (V x_l)
    forward = 2.0 * B * (mlp + cross) + L * k8.forward_cost(B, N)[1]
    # the backward: weight gradients and input gradients of every product
    # (the first bottom layer's input gradient excepted), and K8's part
    backward = 2.0 * B * (mlp + cross) + 2.0 * B * (mlp - bot[0] + cross) \
        + L * k8.backward_cost(B, N)[1]
    return forward + backward
