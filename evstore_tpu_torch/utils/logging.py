"""MLPerf-style structured logging.

Port of `evstore_tpu/utils/logging.py`.  Reference: mlperf_logger.py wraps
mlperf_logging.mllog with rank-0 gating and submission metadata (:21-118).
The logger writes the same one-line `:::MLLOG {json}` records itself, with
the event keys and init/run/epoch blocks of the call sites in
dlrm_s_pytorch.py:1077-1860.
"""

from __future__ import annotations

import json
import time
from typing import Optional


def quiet(*_args, **_kw) -> None:
    """A log_fn that prints nothing (the ranks other than 0 of a mesh)."""


class MLPerfLogger:
    def __init__(self, benchmark: str = "dlrm", log_fn=print,
                 enabled: bool = True, rank: int = 0):
        self.benchmark = benchmark
        self.log_fn = log_fn
        self.enabled = enabled and rank == 0   # rank-0 gating (:36-49)

    def event(self, key: str, metadata: Optional[dict] = None,
              value=None) -> None:
        if not self.enabled:
            return
        # *_start / *_stop keys are interval markers (mllog's event types)
        if key.endswith("_start"):
            etype = "INTERVAL_START"
        elif key.endswith("_stop"):
            etype = "INTERVAL_END"
        else:
            etype = "POINT_IN_TIME"
        payload = {
            "namespace": self.benchmark,
            "time_ms": int(time.time() * 1000),
            "event_type": etype,
            "key": key,
            "value": value,
            "metadata": metadata or {},
        }
        self.log_fn(":::MLLOG " + json.dumps(payload, default=float))

    def submission_metadata(self, platform: Optional[str] = None,
                            org: str = "evstore_tpu_torch",
                            division: str = "closed",
                            status: str = "onprem") -> None:
        """The submission block (mlperf_logger.py:80-118).  `platform`
        defaults to the card's name, `torch.cuda.get_device_name(0)` with
        dashes for spaces, or "cpu" without a card."""
        if platform is None:
            import torch
            platform = (torch.cuda.get_device_name(0).replace(" ", "-")
                        if torch.cuda.is_available() else "cpu")
        for k, v in {
            "submission_benchmark": self.benchmark,
            "submission_org": org,
            "submission_division": division,
            "submission_status": status,
            "submission_platform": platform,
            "submission_entry": {"framework": "pytorch/cuda",
                                 "hardware": platform},
        }.items():
            self.event(k, value=v)
