"""K5's share of its roofline over the training stretch, in %: each step's
grouped row update of B x T sorted entries, the distinct rows read and
written once."""

from evbench.readers import roofline, shapes
from evbench.roofline import k5


def read(record):
    def bound(r, k):
        B, T, D = shapes(r)
        return k5.bound(B * T, r["trace"]["unique_keys"][k], D)
    return roofline(record, k5.KERNELS, bound)
