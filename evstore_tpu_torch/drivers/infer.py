"""EVStore inference driver: the device C1 cache feeding the DLRM on the card.

Port of `evstore_tpu/drivers/infer.py` for the device-cache path
(`use_device_cache=True`): build the cache, run the warm-up pass, then per
batch look the rows up in the cache (they stay on the card) and score
`sigmoid(model(dense, idx, emb_rows=rows))`.  Per-request latency is the
fenced batch time (`torch.cuda.synchronize()` inside the timed region)
divided over the batch's requests; at batch size 1 it is the true
per-request time.

As in the JAX package, `build_cache` builds `NativeDeviceC1Cache`, the C++
tier engine's device cache: C1 only, or the hybrid with the engine's host
C2 and C3 at `n_caching_layers` 2-3.  With `pipeline_depth` > 0 the lookup
(the engine's assign and the device apply) runs on a prefetch thread, one
or more batches ahead of the scoring.  Both threads launch on the same
stream (the device's default), and the fence in the timed region waits for
both.

Not ported yet: the host `TieredCache` (use_device_cache=False), the
engine's host path (use_native), the LFU/LRU baselines, the file-backed
stores, the sharded cache (mesh) and workload tracing.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from evstore_tpu_torch.cache.device_cache import NativeDeviceC1Cache
from evstore_tpu_torch.cache.storage import DummyStore, StorageManager
from evstore_tpu_torch.cache.tiers import AltKeyResolver
from evstore_tpu_torch.config import CacheConfig, DLRMConfig
from evstore_tpu_torch.data.loader import PrefetchIterator
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


def build_cache(ccfg: CacheConfig, cfg: DLRMConfig, storage: StorageManager,
                altkey_resolver: Optional[AltKeyResolver] = None,
                use_native: bool = False, use_device_cache: bool = False,
                device=None) -> NativeDeviceC1Cache:
    """The tier engine's device C1 cache over the dummy store's tables,
    with the alt keys for C3 when `n_caching_layers` >= 3."""
    if use_native:
        raise NotImplementedError(
            "the engine's host lookup path (use_native) is not ported yet; "
            "pass use_device_cache=True alone for the device C1 cache")
    if not use_device_cache:
        raise NotImplementedError(
            "the Python TieredCache host path is not ported yet; pass "
            "use_device_cache=True for the device C1 cache")
    if ccfg.policy != "evlfu":
        raise NotImplementedError(
            f"the {ccfg.policy!r} baseline is not ported yet; the device "
            f"cache runs EvLFU")
    if not isinstance(storage.store, DummyStore):
        raise ValueError("the device cache loads its tables from a loaded "
                         "dummy store")
    dc = NativeDeviceC1Cache(ccfg, cfg.num_tables, cfg.embedding_dim,
                             device=device)
    dc.load_tables(storage.store.tables)
    if altkey_resolver is not None and ccfg.n_caching_layers >= 3:
        dc.load_altkeys(altkey_resolver.tables)
    return dc


def run_inference(model: torch.nn.Module, cfg: DLRMConfig, ccfg: CacheConfig,
                  batches: Iterable, storage: StorageManager, *,
                  altkey_resolver: Optional[AltKeyResolver] = None,
                  warmup_batches: Optional[Iterable] = None,
                  ev_lookup_only: bool = False,
                  cdf_path: Optional[str] = None,
                  use_native: bool = False,
                  use_device_cache: bool = False,
                  pipeline_depth: int = 0,
                  cache: Optional[NativeDeviceC1Cache] = None,
                  device=None,
                  log_fn=print) -> InferenceResult:
    """Serve `batches` of (dense, idx, labels) numpy arrays through the
    device C1 cache and `model` (a `DLRM` on `device`).

    The run builds its cache with `build_cache` and closes it (and so its
    engine) when it ends, also when it raises.  A caller that wants to look
    into the cache afterwards builds it with `build_cache`, passes it as
    `cache` and closes it itself.  With `pipeline_depth` > 0 the lookups run
    on a prefetch thread that is joined when the run ends."""
    dev = resolve_device(device)
    mdev = next(model.parameters()).device
    if mdev.type != dev.type or (dev.index is not None and mdev != dev):
        raise ValueError(f"model is on {mdev}, inference on {dev}")
    dev = mdev
    owned = cache is None
    if owned:
        cache = build_cache(ccfg, cfg, storage, altkey_resolver,
                            use_native, use_device_cache, dev)
    try:
        return _serve(model, cache, batches, dev, warmup_batches,
                      ev_lookup_only, cdf_path, pipeline_depth, log_fn)
    finally:
        if owned:
            cache.close()


def _serve(model, cache, batches, dev, warmup_batches, ev_lookup_only,
           cdf_path, pipeline_depth, log_fn) -> InferenceResult:
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

    def lookup(b):
        # the worker thread's own inference mode: the flag is per thread
        with torch.inference_mode():
            idx = np.asarray(b[1])
            return b[0], idx, b[2], cache.lookup_batch(idx)

    stream = (PrefetchIterator(batches, pipeline_depth, transform=lookup)
              if pipeline_depth > 0
              else ((d, np.asarray(i), y, None) for d, i, y in batches))
    scores, labels = [], []
    n_req = 0
    B = None
    try:
        with torch.inference_mode():
            t_start = time.perf_counter()
            for dense_x, idx, y, rows in stream:
                B = idx.shape[0]
                t0 = time.perf_counter()
                if rows is None:
                    rows = cache.lookup_batch(idx)     # stays on the card
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
    finally:
        if pipeline_depth > 0:
            stream.close()

    if cdf_path is not None:
        lat.write_cdf(cdf_path,
                      method=("true-per-request (bs=1, fenced)" if B == 1
                              else "fenced batch-time/B approximation"))
    scores = torch.cat(scores).cpu().numpy() if scores else None
    metrics = (binary_metrics(scores, np.concatenate(labels))
               if scores is not None else {})
    res = InferenceResult(metrics=metrics, cache_stats=cache.stats(),
                          latency=lat.summary(), elapsed_s=elapsed,
                          requests=n_req, scores=scores)
    log_fn(f"inference: {n_req} requests in {elapsed:.2f}s "
           f"({n_req / max(elapsed, 1e-9):.0f} req/s); "
           f"perfect hits = {res.cache_stats.get('perfect_hits')}")
    return res
