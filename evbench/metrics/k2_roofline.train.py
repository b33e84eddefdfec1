"""K2's share of its roofline over the training stretch, in %: each step's
grouped gather of B x T rows over the tables, the distinct rows read
once."""

from evbench.readers import roofline, shapes
from evbench.roofline import k2


def read(record):
    def bound(r, k):
        B, T, D = shapes(r)
        return k2.bound(B * T, r["trace"]["unique_keys"][k], D)
    return roofline(record, k2.KERNELS, bound)
