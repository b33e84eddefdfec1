"""K1's share of its roofline over the training stretch, in %."""

from evbench.readers import roofline, shapes
from evbench.roofline import k1


def read(record):
    return roofline(record, k1.KERNELS,
                    lambda r, k: k1.bound(*shapes(r)))
