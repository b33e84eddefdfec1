"""What the per-layer readers (`metrics/<name>.py`) share: each reads the
record a run's kind leaves (`kinds/*.py`) and returns a number, or None
where the run has nothing to read."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from evbench.roofline.peaks import F32_FLOPS


def roofline(record, kernels: Sequence[str],
             bound_of: Callable[[dict, int], float]) -> Optional[float]:
    """The bound's share of the kernel's device time, in %, over the
    traced stretch: `bound_of(record, k)` is the least time of the stretch's
    k-th step's call, and every launch of the stretch is one call."""
    tr = record.get("trace")
    if not tr or not tr.get("steps"):
        return None
    seen = [kernel(tr, k) for k in kernels]
    if seen[0] is None:
        return None
    calls = seen[0]["launches"]
    secs = sum(k["seconds"] for k in seen if k is not None)
    if not calls or secs <= 0:
        return None
    steps = tr["steps"]
    mean = sum(bound_of(record, k) for k in range(steps)) / steps
    return 100.0 * mean * calls / secs


def kernel(trace, name: str) -> Optional[dict]:
    """The trace's launches and seconds of the kernel `name`, whatever
    namespace the compiler put it in."""
    for k, v in trace["kernels"].items():
        if k == name or k.endswith("::" + name):
            return v
    return None


def shapes(record):
    d = record["dims"]
    return record["batch_size"], len(d["table_sizes"]), d["dim"]


def mfu(record, flops_per_step: float) -> Optional[float]:
    n = record.get("steps")
    if not n or record.get("window_s", 0) <= 0:
        return None
    return 100.0 * flops_per_step * n / record["window_s"] / F32_FLOPS


def idle(record) -> Optional[float]:
    tr = record.get("trace")
    if not tr or tr.get("window_s", 0) <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
