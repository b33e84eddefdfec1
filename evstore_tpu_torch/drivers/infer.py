"""EVStore inference driver: the tiered embedding lookup feeding the DLRM.

Port of `evstore_tpu/drivers/infer.py` (the reference's
dlrm_s_pytorch_C1{,_C2,_C2_C3}.py: the tiered lookup in place of apply_emb,
dlrm_s_pytorch_C1.py:227; the warm-up pass, :2226-2242; ev-lookup-only
mode, :2205-2222; the per-request latency CDF, :299-330; perfect hits,
:136,2272; the workload trace, :987-996).

`build_cache` chooses the cache as the JAX driver does:

- `policy` lfu or lru at one tier, on the host: the Python baselines
  (`make_cache_from_policy`, `SimpleCacheFrontend`);
- `use_device_cache=True`: `NativeDeviceC1Cache`, the C1 rows on the card
  and its policy and miss reads in the C++ tier engine, with the engine's
  host C2 and C3 behind it at `n_caching_layers` 2-3;
- `use_native=True`: the engine's host path, `NativeTieredCache`, which
  runs EvLFU, LFU or LRU and the host tiers in C++;
- otherwise the Python `TieredCache` (1-3 tiers at 32/16/8/4 bits).

The host caches hand back numpy rows; `run_inference` copies them to the
card (`torch.from_numpy(rows).to(device)`) inside the timed region.  The
device cache's rows stay on the card.  Then it scores
`sigmoid(model(dense, emb_rows=rows))`.  Per-request latency is the fenced
batch time divided over the batch's requests; at batch size 1, with no
prefetch, each request is timed alone and fenced by a real device-to-host
copy of its score, and the CDF file's header says which method made it.
With `pipeline_depth` > 0 the lookup (and the host rows' copy to the card)
runs on a prefetch thread, one or more batches ahead of the scoring, on the
same stream, and the timed region covers only the scoring.

With a `mesh` (`parallel/mesh.py`) and `use_device_cache`, the cache is
`ShardedDeviceC1Cache`, its slots sharded over the mesh's ranks.  Every
rank runs the serving loop on the same batches (the lookups are
collective, the rows come back whole on every rank); rank 0 logs.

Departures from the JAX driver, where it ignores an option: the device
cache runs EvLFU only, so `use_device_cache=True` with policy lfu or lru
raises, and so does `use_native=True` beside `use_device_cache=True`.  The
stores behind the engine are its own (`open_table_files`): as in the JAX
driver, a file-backed store raises there, and the caller opens the files
on the cache and passes it as `cache=`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from evstore_tpu_torch.cache.device_cache import (NativeDeviceC1Cache,
                                                  ShardedDeviceC1Cache)
from evstore_tpu_torch.cache.storage import DummyStore, StorageManager
from evstore_tpu_torch.cache.tiers import (AltKeyResolver, TieredCache,
                                           make_cache_from_policy)
from evstore_tpu_torch.config import CacheConfig, DLRMConfig
from evstore_tpu_torch.data.loader import PrefetchIterator
from evstore_tpu_torch.models.embedding import check_ids
from evstore_tpu_torch.native import NativeTieredCache
from evstore_tpu_torch.train.metrics import binary_metrics
from evstore_tpu_torch.utils.device import resolve_device
from evstore_tpu_torch.utils.logging import quiet
from evstore_tpu_torch.utils.trace import LatencyRecorder, WorkloadTracer

TRUE_PER_REQUEST = "true-per-request (bs=1, fenced transfer)"
BATCH_APPROX = "fenced batch-time/B approximation"


@dataclasses.dataclass
class InferenceResult:
    metrics: Dict[str, float]
    cache_stats: dict
    latency: dict
    elapsed_s: float
    requests: int
    scores: Optional[np.ndarray] = None   # the served click probabilities
    # host seconds over the scored batches: the cache's lookup, the host
    # rows' copy to the device, and the forward with its fence
    host_s: Dict[str, float] = dataclasses.field(default_factory=dict)


def build_cache(ccfg: CacheConfig, cfg: DLRMConfig, storage: StorageManager,
                altkey_resolver: Optional[AltKeyResolver] = None,
                use_native: bool = False, use_device_cache: bool = False,
                device=None, mesh=None):
    """The cache `run_inference` serves through (see the module's
    docstring); `device` is the device cache's, `mesh` shards its slots."""
    if (ccfg.policy in ("lfu", "lru") and ccfg.n_caching_layers == 1
            and not use_native and not use_device_cache):
        # the Python baselines (reference cache_algo/LFU.py, LRU.py); with
        # use_native the engine runs the same policies
        return make_cache_from_policy(ccfg.policy, ccfg.total_size,
                                      cfg.num_tables, storage,
                                      cfg.embedding_dim)
    alts = (altkey_resolver.tables
            if altkey_resolver is not None and ccfg.n_caching_layers >= 3
            else None)
    if use_device_cache:
        if use_native:
            raise ValueError("use_native and use_device_cache are "
                             "exclusive: the device cache runs its own "
                             "engine")
        if ccfg.policy != "evlfu":
            raise ValueError(f"the device cache runs EvLFU; the "
                             f"{ccfg.policy!r} baseline runs on the host "
                             f"(use_device_cache=False) or in the engine "
                             f"(use_native=True)")
        if not isinstance(storage.store, DummyStore):
            raise ValueError("device cache file mode: the device cache "
                             "loads its tables from a loaded dummy store; "
                             "use NativeDeviceC1Cache.open_table_files "
                             "directly")
        if mesh is not None:
            dc = ShardedDeviceC1Cache(ccfg, cfg.num_tables,
                                      cfg.embedding_dim, mesh)
        else:
            dc = NativeDeviceC1Cache(ccfg, cfg.num_tables,
                                     cfg.embedding_dim, device=device)
        dc.load_tables(storage.store.tables)
        if alts is not None:
            dc.load_altkeys(alts)
        return dc
    if use_native:
        if not isinstance(storage.store, DummyStore):
            raise ValueError("native engine file mode: the engine loads its "
                             "tables from a loaded dummy store; use "
                             "NativeTieredCache.open_table_files directly")
        nc = NativeTieredCache(ccfg, cfg.num_tables, cfg.embedding_dim)
        nc.load_tables(storage.store.tables)
        if alts is not None:
            nc.load_altkeys([np.asarray(t, np.uint32) for t in alts])
        return nc
    return TieredCache(ccfg, storage, cfg.num_tables, cfg.embedding_dim,
                       altkey_resolver)


def run_inference(model: torch.nn.Module, cfg: DLRMConfig, ccfg: CacheConfig,
                  batches: Iterable, storage: StorageManager, *,
                  altkey_resolver: Optional[AltKeyResolver] = None,
                  warmup_batches: Optional[Iterable] = None,
                  ev_lookup_only: bool = False,
                  trace_dir: Optional[str] = None,
                  cdf_path: Optional[str] = None,
                  use_native: bool = False,
                  use_device_cache: bool = False,
                  pipeline_depth: int = 0,
                  cache=None,
                  device=None,
                  mesh=None,
                  log_fn=print) -> InferenceResult:
    """Serve `batches` of (dense, idx, labels) numpy arrays through the
    tiered cache and `model` (a `DLRM` on `device`).

    The run builds its cache with `build_cache` and closes it (and so any
    engine it holds) when it ends, also when it raises.  A caller that
    wants to look into the cache afterwards, or to serve from a file-backed
    engine, builds the cache itself, passes it as `cache` and closes it
    itself.  With `pipeline_depth` > 0 the lookups run on a prefetch thread
    that is joined when the run ends.  `trace_dir` receives the requests'
    row ids, one `trace-table-<t>.csv` per table.  With `mesh` and
    `use_device_cache` the cache is sharded over the mesh's ranks: every
    rank calls this with the same batches, and only rank 0 logs."""
    if mesh is not None:
        device = mesh.device if device is None else device
        if mesh.rank != 0:
            log_fn = quiet
    dev = resolve_device(device)
    mdev = next(model.parameters()).device
    if mdev.type != dev.type or (dev.index is not None and mdev != dev):
        raise ValueError(f"model is on {mdev}, inference on {dev}")
    dev = mdev
    owned = cache is None
    if owned:
        cache = build_cache(ccfg, cfg, storage, altkey_resolver,
                            use_native, use_device_cache, dev, mesh)
    try:
        return _serve(model, cfg, cache, batches, dev, warmup_batches,
                      ev_lookup_only, trace_dir, cdf_path, pipeline_depth,
                      log_fn)
    finally:
        if owned and hasattr(cache, "close"):
            cache.close()


def _serve(model, cfg, cache, batches, dev, warmup_batches, ev_lookup_only,
           trace_dir, cdf_path, pipeline_depth, log_fn) -> InferenceResult:
    fence = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    lat = LatencyRecorder()
    # the device cache hands back rows on the card; the host caches numpy
    device_rows = hasattr(cache, "lookup_batch")
    host_s = {"lookup": 0.0, "copy": 0.0, "forward": 0.0}

    def rows_of(idx):
        """The batch's rows on the device, timed into host_s."""
        t0 = time.perf_counter()
        if device_rows:
            rows = cache.lookup_batch(idx)         # stays on the card
            host_s["lookup"] += time.perf_counter() - t0
            return rows
        check_ids(idx, cfg.table_sizes)
        host = cache.request_batch(idx)
        t1 = time.perf_counter()
        rows = torch.from_numpy(host).to(dev)
        host_s["lookup"] += t1 - t0
        host_s["copy"] += time.perf_counter() - t1
        return rows

    with torch.inference_mode():
        # the warm-up pass fills the tiers without scoring
        if warmup_batches is not None:
            n = 0
            for _, idx, _ in warmup_batches:
                idx = np.asarray(idx)
                if device_rows:
                    cache.lookup_batch(idx)
                else:
                    check_ids(idx, cfg.table_sizes)
                    cache.request_batch(idx)
                n += idx.shape[0]
            fence()
            log_fn(f"warm-up done: {n} requests; stats={cache.stats()}")

    def lookup(b):
        # the worker thread's own inference mode: the flag is per thread
        with torch.inference_mode():
            idx = np.asarray(b[1])
            return b[0], idx, b[2], rows_of(idx)

    tracer = (WorkloadTracer(trace_dir, cfg.num_tables)
              if trace_dir is not None else None)
    stream = (PrefetchIterator(batches, pipeline_depth, transform=lookup)
              if pipeline_depth > 0
              else ((d, np.asarray(i), y, None) for d, i, y in batches))
    scores, labels = [], []
    n_req = 0
    true_per_request = None
    try:
        with torch.inference_mode():
            t_start = time.perf_counter()
            for dense_x, idx, y, rows in stream:
                B = idx.shape[0]
                if true_per_request is None:
                    true_per_request = B == 1 and rows is None
                t0 = time.perf_counter()
                if rows is None:
                    rows = rows_of(idx)
                t1 = time.perf_counter()
                if not ev_lookup_only:
                    dense_t = torch.from_numpy(
                        np.ascontiguousarray(dense_x, np.float32)).to(dev)
                    s = torch.sigmoid(model(dense_t, None, emb_rows=rows))
                    if true_per_request:
                        s = s.cpu()    # a real transfer: the honest fence
                    scores.append(s)
                    labels.append(np.asarray(y))
                elif true_per_request:
                    rows.cpu()         # fence the lookup the same way
                if not true_per_request:
                    fence()
                t2 = time.perf_counter()
                host_s["forward"] += t2 - t1
                for _ in range(B):
                    lat.record((t2 - t0) / B)
                if tracer is not None:
                    for b in range(B):
                        tracer.record(idx[b])
                n_req += B
            elapsed = time.perf_counter() - t_start
    finally:
        if pipeline_depth > 0:
            stream.close()
        if tracer is not None:
            tracer.close()

    if cdf_path is not None:
        lat.write_cdf(cdf_path, method=(TRUE_PER_REQUEST if true_per_request
                                        else BATCH_APPROX))
    scores = torch.cat(scores).cpu().numpy() if scores else None
    metrics = (binary_metrics(scores, np.concatenate(labels))
               if scores is not None else {})
    res = InferenceResult(metrics=metrics, cache_stats=cache.stats(),
                          latency=lat.summary(), elapsed_s=elapsed,
                          requests=n_req, scores=scores, host_s=host_s)
    log_fn(f"inference: {n_req} requests in {elapsed:.2f}s "
           f"({n_req / max(elapsed, 1e-9):.0f} req/s); "
           f"perfect hits = {res.cache_stats.get('perfect_hits')}")
    return res
