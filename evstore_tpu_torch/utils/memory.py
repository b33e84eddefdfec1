"""Memory introspection and device ballast.

Port of `evstore_tpu/utils/memory.py`.  Reference: check_available_mem
shells out to `free -h` (dlrm_s_pytorch_C1.py:278-297), and the lock-gpu
driver allocates an "extra-mem-load" tensor to shrink the memory the run
can use (dlrm_s_pytorch_lock_gpu_C1.py:1819-1829).  Host RAM comes from
/proc/meminfo, the card's memory from `torch.cuda.mem_get_info` and the
caching allocator's counters.
"""

from __future__ import annotations

from typing import Dict

import torch

from evstore_tpu_torch.utils.device import resolve_device


def host_memory() -> Dict[str, int]:
    """Available, free and total host RAM in bytes (≙ check_available_mem)."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            k, v = line.split(":", 1)
            if k in ("MemTotal", "MemAvailable", "MemFree"):
                out[k] = int(v.strip().split()[0]) * 1024
    return out


def device_memory(device=None) -> Dict[str, int]:
    """The card's memory in bytes: `bytes_limit` (its total), `bytes_free`,
    and this process's `bytes_in_use` and `peak_bytes_in_use` (the caching
    allocator's).  Empty for a CPU device."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {}
    free, total = torch.cuda.mem_get_info(dev)
    return {"bytes_limit": int(total), "bytes_free": int(free),
            "bytes_in_use": int(torch.cuda.memory_allocated(dev)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(dev))}


class HBMBallast:
    """Holds `mb` megabytes of the card's memory (≙ --extra-mem-load)
    until `release()` or the object's end."""

    def __init__(self, mb: int, device=None):
        self.mb = mb
        self._buf = None
        if mb > 0:
            dev = resolve_device(device)
            # written, so that the pages are really taken
            self._buf = torch.ones(mb * 1024 * 1024 // 4,
                                   dtype=torch.float32, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def release(self):
        self._buf = None
