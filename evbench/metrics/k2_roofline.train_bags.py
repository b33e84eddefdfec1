"""K2's share of its roofline over a training stretch with bags of a
length per table, in %: each step's grouped gather of B x (ids a sample)
rows, one a bag's slot (214 with MLPerf's bags), the distinct (table, row)
keys read once."""

from evbench.readers import roofline
from evbench.roofline import k2


def read(record):
    def bound(r, k):
        d = r["dims"]
        return k2.bound(r["batch_size"] * sum(d["bag_sizes"]),
                        r["trace"]["unique_keys"][k], d["dim"])
    return roofline(record, k2.KERNELS, bound)
