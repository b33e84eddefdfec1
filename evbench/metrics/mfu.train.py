"""The whole train step's share of the f32 peak, in %: the step's model
operations times the window's steps over the window."""

from evbench.readers import mfu
from evbench.roofline.step import train_flops


def read(record):
    return mfu(record, train_flops(record["dims"], record["batch_size"]))
