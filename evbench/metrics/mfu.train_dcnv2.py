"""The whole DLRM-DCNv2 train step's share of the f32 peak, in %: the
step's model operations (the MLPs, the cross layers' products and their
elementwise part, forward and the backward the step needs;
`roofline/dcnv2.py`) times the window's steps over the window."""

from evbench.readers import mfu
from evbench.roofline.dcnv2 import train_flops


def read(record):
    if record.get("dims", {}).get("interaction") != "dcn":
        return None
    return mfu(record, train_flops(record["dims"], record["batch_size"]))
