"""The share of the traced training stretch in which no kernel, copy or
set ran on the device, in %."""

from evbench.readers import idle


def read(record):
    return idle(record)
