"""K5's share of its roofline over a training stretch with bags of a
length per table, in %: each step's K5 launches (two under the row-wise
rule: the run sums, then the update), each at `roofline/k5.py`'s bound of
one call over K = B x (ids a sample) sorted entries (214 with MLPerf's
bags) and the U distinct (table, row) keys."""

from evbench.readers import roofline
from evbench.roofline import k5


def read(record):
    def bound(r, k):
        d = r["dims"]
        return k5.bound(r["batch_size"] * sum(d["bag_sizes"]),
                        r["trace"]["unique_keys"][k], d["dim"])
    return roofline(record, k5.KERNELS, bound)
