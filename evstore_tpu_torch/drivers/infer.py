"""EVStore inference driver: the device C1 cache feeding the DLRM on the card.

Port of `evstore_tpu/drivers/infer.py` for the device-cache path
(`use_device_cache=True`): build the cache, run the warm-up pass, then per
batch look the rows up in the cache (they stay on the card) and score
`sigmoid(model(dense, idx, emb_rows=rows))`.  Per-request latency is the
fenced batch time (`torch.cuda.synchronize()` inside the timed region)
divided over the batch's requests; at batch size 1 it is the true
per-request time.

Not ported yet: the host `TieredCache` (use_device_cache=False), the C++
tier engine (use_native), prefetch pipelining (pipeline_depth > 0), the
sharded cache (mesh), alt-key C3 and workload tracing.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from evstore_tpu_torch.cache.device_cache import DeviceC1Cache
from evstore_tpu_torch.cache.storage import StorageManager
from evstore_tpu_torch.config import CacheConfig, DLRMConfig
from evstore_tpu_torch.train.metrics import binary_metrics
from evstore_tpu_torch.utils.device import resolve_device
from evstore_tpu_torch.utils.trace import LatencyRecorder


@dataclasses.dataclass
class InferenceResult:
    metrics: Dict[str, float]
    cache_stats: dict
    latency: dict
    elapsed_s: float
    requests: int
    scores: Optional[np.ndarray] = None   # the served click probabilities
    cache: Any = None        # the cache the run went through, for inspection


def build_cache(ccfg: CacheConfig, cfg: DLRMConfig, storage: StorageManager,
                use_device_cache: bool = False, device=None) -> DeviceC1Cache:
    if not use_device_cache:
        raise NotImplementedError(
            "the host TieredCache is not ported yet; pass "
            "use_device_cache=True for the device C1 cache")
    if ccfg.policy != "evlfu" or ccfg.n_caching_layers != 1:
        raise NotImplementedError(
            f"the device cache runs EvLFU over C1 only, got policy "
            f"{ccfg.policy!r} with {ccfg.n_caching_layers} layers")
    return DeviceC1Cache(ccfg, storage, cfg.num_tables, cfg.embedding_dim,
                         device=device)


def run_inference(model: torch.nn.Module, cfg: DLRMConfig, ccfg: CacheConfig,
                  batches: Iterable, storage: StorageManager, *,
                  warmup_batches: Optional[Iterable] = None,
                  ev_lookup_only: bool = False,
                  cdf_path: Optional[str] = None,
                  use_device_cache: bool = False,
                  pipeline_depth: int = 0,
                  device=None,
                  log_fn=print) -> InferenceResult:
    """Serve `batches` of (dense, idx, labels) numpy arrays through the
    device C1 cache and `model` (a `DLRM` on `device`)."""
    if pipeline_depth > 0:
        raise NotImplementedError(
            "pipeline_depth > 0 (the prefetch thread over the C++ tier "
            "engine) is not ported yet")
    dev = resolve_device(device)
    mdev = next(model.parameters()).device
    if mdev.type != dev.type or (dev.index is not None and mdev != dev):
        raise ValueError(f"model is on {mdev}, inference on {dev}")
    dev = mdev
    cache = build_cache(ccfg, cfg, storage, use_device_cache, dev)
    fence = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    lat = LatencyRecorder()

    with torch.inference_mode():
        # warm-up pass: populate the cache without scoring
        if warmup_batches is not None:
            n = 0
            for _, idx, _ in warmup_batches:
                cache.lookup_batch(np.asarray(idx))
                n += idx.shape[0]
            fence()
            log_fn(f"warm-up done: {n} requests; stats={cache.stats()}")

        scores, labels = [], []
        t_start = time.perf_counter()
        n_req = 0
        B = None
        for dense_x, idx, y in batches:
            idx = np.asarray(idx)
            B = idx.shape[0]
            t0 = time.perf_counter()
            rows = cache.lookup_batch(idx)             # stays on the card
            if not ev_lookup_only:
                dense_t = torch.from_numpy(
                    np.ascontiguousarray(dense_x, np.float32)).to(dev)
                scores.append(torch.sigmoid(model(dense_t, None,
                                                  emb_rows=rows)))
                labels.append(np.asarray(y))
            fence()
            dt = time.perf_counter() - t0
            for _ in range(B):
                lat.record(dt / B)
            n_req += B
        elapsed = time.perf_counter() - t_start

    if cdf_path is not None:
        lat.write_cdf(cdf_path,
                      method=("true-per-request (bs=1, fenced)" if B == 1
                              else "fenced batch-time/B approximation"))
    scores = torch.cat(scores).cpu().numpy() if scores else None
    metrics = (binary_metrics(scores, np.concatenate(labels))
               if scores is not None else {})
    res = InferenceResult(metrics=metrics, cache_stats=cache.stats(),
                          latency=lat.summary(), elapsed_s=elapsed,
                          requests=n_req, scores=scores, cache=cache)
    log_fn(f"inference: {n_req} requests in {elapsed:.2f}s "
           f"({n_req / max(elapsed, 1e-9):.0f} req/s); "
           f"perfect hits = {res.cache_stats.get('perfect_hits')}")
    return res
