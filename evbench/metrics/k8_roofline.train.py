"""K8's share of its roofline over the training stretch, in %: each step's
cross layers, forward and backward (`roofline/k8.py`), against the device
time of K8's three kernels; one call is a layer's forward launch."""

from evbench.readers import roofline
from evbench.roofline import k8
from evbench.roofline.dcnv2 import cross_width


def read(record):
    d = record.get("dims", {})
    if d.get("interaction") != "dcn":
        return None

    def bound(r, k):
        L = d["dcn_layers"]
        return k8.step_bound(r["batch_size"], cross_width(d), L) / L
    return roofline(record, k8.KERNELS, bound)
