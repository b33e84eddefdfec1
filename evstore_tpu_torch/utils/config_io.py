"""Store and read the derived training config, so that inference need not
derive it again.

Port of `evstore_tpu/utils/config_io.py`.  Reference:
evstore_utils.store_training_config / read_training_config
(evstore_utils.py:31-52) write nbatches, ln_emb and m_den to
training_config.txt; here one JSON file carries the whole DLRMConfig and
the dataset's facts, in the JAX package's format.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

from evstore_tpu_torch.config import DLRMConfig


def store_training_config(path: str, cfg: DLRMConfig, nbatches: int,
                          extra: dict = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "model": dataclasses.asdict(cfg),
        "nbatches": int(nbatches),
        "extra": extra or {},
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)


def read_training_config(path: str) -> Tuple[DLRMConfig, int, dict]:
    with open(path) as f:
        payload = json.load(f)
    d = payload["model"]
    for k, v in list(d.items()):
        if isinstance(v, list):
            d[k] = tuple(v)
    return DLRMConfig(**d), payload["nbatches"], payload.get("extra", {})
