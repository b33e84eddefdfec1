"""K4's share of its roofline over the training stretch, in %."""

from evbench.readers import roofline, shapes
from evbench.roofline import k4


def read(record):
    return roofline(record, k4.KERNELS,
                    lambda r, k: k4.bound(*shapes(r)))
