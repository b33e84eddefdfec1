"""Kernels, copies and sets the device ran a step, over the traced
stretch."""


def read(record):
    tr = record.get("trace")
    if not tr or not tr.get("steps") or not tr["device_ops_n"]:
        return None
    return tr["device_ops_n"] / tr["steps"]
