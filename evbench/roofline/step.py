"""A DLRM step's model operations: the MLPs' matmuls and the dot
interaction, forward, and for training the backward that the step needs
(every weight's gradient, every activation's but the dense input's)."""

from evbench.roofline.k1 import pairs


def _macs(widths):
    return [m * n for m, n in zip(widths[:-1], widths[1:])]


def forward_flops(dims, B: int) -> float:
    T, D = len(dims["table_sizes"]), dims["dim"]
    mlp = sum(_macs(dims["mlp_bot"])) + sum(_macs(dims["mlp_top"]))
    return 2.0 * B * mlp + 2.0 * B * pairs(T) * D


def train_flops(dims, B: int) -> float:
    T, D = len(dims["table_sizes"]), dims["dim"]
    bot, top = _macs(dims["mlp_bot"]), _macs(dims["mlp_top"])
    mlp = sum(bot) + sum(top)
    backward = 2.0 * B * mlp + 2.0 * B * (mlp - bot[0])
    return forward_flops(dims, B) + backward + 4.0 * B * pairs(T) * D
