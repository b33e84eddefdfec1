#!/usr/bin/env python3
"""On-card check of evstore_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py [--seed N]

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc.  It runs phase by phase, each under a time budget
(SIGALRM), prints each phase's seconds, and exits non-zero on any failure:

0. environment: the card's name and power limit (nvidia-smi), torch and
   nvcc versions, the TF32 switches (off);
1. build: one nvcc call compiles every kernel of the port (or reuses the
   library built from the same sources);
2. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes and larger ones, with times (CUDA events, median
   of 20 after warm-up) beside the least time the card could take;
3. the main path: the full-width Criteo Kaggle DLRM (26 tables, 33.8M rows,
   dim 36) served through the device C1 cache (EvLFU, 64,000 entries) by
   `run_inference`, with the tables in host RAM and random weights from
   --seed; the kernels' launch counts over this phase must be above 0, the
   cache's rows must equal the store's bit for bit and the scores must equal
   those of the plain versions;
4. the kernels' launch counts and one JSON line describing every kernel;
5. as the last line: {"ok": true, "device": {...}}.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
PHASE_BUDGET_S = {"0 environment": 60, "1 build": 300,
                  "2 kernels vs plain": 240, "3 main path": 480,
                  "4 kernels line": 30}


class Phase:
    """Times one phase and cuts it with SIGALRM when it overruns."""

    def __init__(self, name: str):
        self.name = name
        self.budget = PHASE_BUDGET_S[name]

    def _expire(self, signum, frame):
        raise TimeoutError(f"phase {self.name} exceeded its budget of "
                           f"{self.budget} s")

    def __enter__(self):
        print(f"== phase {self.name} (budget {self.budget} s)", flush=True)
        signal.signal(signal.SIGALRM, self._expire)
        signal.alarm(self.budget)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        signal.alarm(0)
        print(f"phase {self.name}: {time.perf_counter() - self.t0:.2f} s",
              flush=True)
        return False


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median over `reps` calls of the device time between CUDA events
    around one call (host launch overhead included where it stalls the
    device)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    return times[len(times) // 2]


def bound_ms(nbytes: float, ops: float, dtype: str):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    from evstore_tpu_torch import _build
    from evstore_tpu_torch.cache.storage import StorageManager
    from evstore_tpu_torch.config import CacheConfig, kaggle_dlrm_config
    from evstore_tpu_torch.data.synthetic import (RandomDataConfig,
                                                  random_batches)
    from evstore_tpu_torch.drivers.infer import run_inference
    from evstore_tpu_torch.models.dlrm import DLRM
    from evstore_tpu_torch.models.embedding import init_embedding_tables
    from evstore_tpu_torch.ops.cuda_gather import gather_rows, gather_rows_ref
    from evstore_tpu_torch.ops.cuda_interaction import (
        dot_interaction_kernel, dot_interaction_ref)
    from evstore_tpu_torch.ops.interaction import num_pairs
    from evstore_tpu_torch.utils.device import exact_float32

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    exact_float32()
    dev = torch.device("cuda")
    t_all = time.perf_counter()

    # ------------------------------------------------------ 0 environment
    with Phase("0 environment"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
        card = smi[0].strip()
        print(card)
        nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                              capture_output=True, text=True, timeout=30,
                              check=True).stdout.strip().splitlines()[-1]
        print(f"torch {torch.__version__} (CUDA {torch.version.cuda}); "
              f"nvcc: {nvcc}; devices: {torch.cuda.device_count()}; "
              f"{torch.cuda.get_device_name(0)}")
        print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
              f"cudnn {torch.backends.cudnn.allow_tf32}")
        if torch.backends.cuda.matmul.allow_tf32 or \
                torch.backends.cudnn.allow_tf32:
            raise RuntimeError("TF32 must be off")

    # ------------------------------------------------------------ 1 build
    with Phase("1 build"):
        t0 = time.perf_counter()
        fresh = not os.path.exists(_build.library_path())
        path = _build.build()
        _build.library()
        print(f"kernel library {os.path.relpath(path)} "
              f"({'built' if fresh else 'reused'} in "
              f"{time.perf_counter() - t0:.2f} s, one nvcc call)")
        log = path[:-3] + ".log"
        if os.path.exists(log):
            with open(log) as f:
                for line in f:
                    if "registers" in line or "spill" in line:
                        print("  ptxas:", line.strip())

    # ----------------------------------------------- 2 kernels vs plain
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    report = {}
    with Phase("2 kernels vs plain"):
        # K1: f32 |d| <= 1e-5 (1 + |ref|) (summation order);
        # bf16: one bf16 ulp of ref plus that f32 allowance
        k1_cases = [(B, T, D, dt, False)
                    for (B, T, D) in [(1, 26, 36), (1000, 26, 36),
                                      (2048, 26, 36), (65536, 26, 36),
                                      (4096, 26, 64), (4096, 26, 128),
                                      (256, 3, 4)]
                    for dt in ("float32", "bfloat16")]
        k1_cases += [(2048, 26, 36, dt, True)
                     for dt in ("float32", "bfloat16")]
        for B, T, D, dt, si in k1_cases:
            tdt = getattr(torch, dt)
            x = torch.randn(B, D, generator=gen, device=dev).to(tdt)
            ly = torch.randn(B, T, D, generator=gen, device=dev).to(tdt)
            got = dot_interaction_kernel(x, ly, si)
            ref = dot_interaction_ref(x, ly, si)
            torch.cuda.synchronize()
            diff = (got.float() - ref.float()).abs()
            allow = 1e-5 * (1 + ref.float().abs())
            if dt == "bfloat16":
                mag = ref.float().abs().clamp_min(2.0 ** -126)
                allow = allow + torch.exp2(torch.floor(torch.log2(mag)) - 7)
            err = float(diff.max())
            if got.shape != ref.shape or not bool((diff <= allow).all()):
                raise AssertionError(
                    f"interaction_fwd disagrees at B={B} T={T} D={D} {dt} "
                    f"self={si}: max|d| {err}")
            P = num_pairs(T + 1, si)
            es = x.element_size()
            bms, by = bound_ms((B * (T + 1) * D + B * (D + P)) * es,
                               2.0 * B * P * D, dt)
            k_ms = time_ms(torch, lambda: dot_interaction_kernel(x, ly, si))
            p_ms = time_ms(torch, lambda: dot_interaction_ref(x, ly, si))
            print(f"interaction_fwd B={B} T={T} D={D} {dt} self={si}: "
                  f"max|d| {err:.3e} kernel_ms {k_ms:.4f} plain_ms "
                  f"{p_ms:.4f} bound_us {bms * 1e3:.2f} ({by}) "
                  f"library_ms none (no single PyTorch call computes it) "
                  f"[{card}]", flush=True)
            if (B, T, D, dt, si) == (2048, 26, 36, "float32", False):
                report["interaction_fwd"] = dict(
                    max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bms,
                    bound_by=by, library_ms=None)
            del x, ly, got, ref, diff, allow

        # K2: bit-exact
        def k2_case(C, M, R, D, dt, label):
            tdt = getattr(torch, dt)
            primary = torch.randn(C, D, generator=gen, device=dev).to(tdt)
            secondary = (torch.randn(M, D, generator=gen, device=dev).to(tdt)
                         if M else None)
            idx = torch.randint(0, C + M, (R,), generator=gen, device=dev,
                                dtype=torch.int32)
            if M:       # cache slots, buffer rows and repeats, all mixed
                q = R // 4
                idx[:q] = idx[q:2 * q]
                idx[R // 2: R // 2 + M] = torch.arange(
                    C, C + M, device=dev, dtype=torch.int32)
            got = gather_rows(primary, idx, secondary)
            ref = gather_rows_ref(primary, idx, secondary)
            torch.cuda.synchronize()
            iv = torch.int16 if primary.element_size() == 2 else torch.int32
            if not torch.equal(got.view(iv), ref.view(iv)):
                raise AssertionError(f"gather_rows differs at {label}")
            err = float((got.float() - ref.float()).abs().max())
            rb = D * primary.element_size()
            uniq = int(torch.unique(idx).numel())
            bms, by = bound_ms(uniq * rb + R * 4 + R * rb, 0.0, dt)
            combined = (primary if secondary is None
                        else torch.cat([primary, secondary]))
            k_ms = time_ms(torch, lambda: gather_rows(primary, idx, secondary))
            p_ms = time_ms(torch,
                           lambda: gather_rows_ref(primary, idx, secondary))
            l_ms = time_ms(torch,
                           lambda: torch.index_select(combined, 0, idx))
            print(f"gather_rows {label}: bit-exact, kernel_ms {k_ms:.4f} "
                  f"plain_ms {p_ms:.4f} bound_us {bms * 1e3:.2f} ({by}) "
                  f"library_ms {l_ms:.4f} (index_select on one table) "
                  f"[{card}]", flush=True)
            return dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bms,
                        bound_by=by, library_ms=l_ms)

        report["gather_rows"] = k2_case(
            64000, 512, 2048 * 26, 36, "float32",
            "cache 64000x36 + buffer 512, R=2048*26 f32")
        k2_case(64000, 512, 65536 * 26, 36, "float32",
                "cache 64000x36 + buffer 512, R=65536*26 f32")
        k2_case(10131227, 0, 65536, 36, "float32",
                "table 10131227x36, R=65536 f32")
        k2_case(64000, 512, 2048 * 26, 36, "bfloat16",
                "cache 64000x36 + buffer 512, R=2048*26 bf16 (4-byte path)")
        torch.cuda.empty_cache()

    # ------------------------------------------------------- 3 main path
    with Phase("3 main path"):
        cfg = kaggle_dlrm_config()
        t0 = time.perf_counter()
        tables = init_embedding_tables(cfg.table_sizes, cfg.embedding_dim,
                                       np.random.default_rng(args.seed))
        host_gb = sum(t.nbytes for t in tables) / 1e9
        storage = StorageManager("dummy", dim=cfg.embedding_dim).load(
            tables=tables)
        model = DLRM(cfg, device=dev, seed=args.seed, tables=False)
        ccfg = CacheConfig(policy="evlfu", n_caching_layers=1,
                           total_size=64000, main_precision=32)
        batches = list(random_batches(RandomDataConfig(
            num_dense=cfg.num_dense_features, table_sizes=cfg.table_sizes,
            batch_size=2048, num_batches=2 + 8 + 1, seed=args.seed + 1,
            distribution="grouped_zipf", zipf_alpha=1.05, group_noise=0.1)))
        warmup, scored, extra = batches[:2], batches[2:10], batches[10]
        print(f"set-up: {len(tables)} tables, "
              f"{sum(cfg.table_sizes)} rows, {host_gb:.2f} GB in host RAM, "
              f"{time.perf_counter() - t0:.2f} s")

        with tempfile.TemporaryDirectory() as tmp:
            cdf = os.path.join(tmp, "cdf.csv")
            dot_interaction_kernel.launches = 0
            gather_rows.launches = 0
            res = run_inference(model, cfg, ccfg, scored, storage,
                                warmup_batches=warmup, cdf_path=cdf,
                                use_device_cache=True, device=dev)
            launches = {"interaction_fwd": dot_interaction_kernel.launches,
                        "gather_rows": gather_rows.launches}
            with open(cdf) as f:
                cdf_lines = sum(1 for _ in f)
        if min(launches.values()) < 1:
            raise AssertionError(f"a kernel of the path never ran: "
                                 f"{launches}")
        if res.scores is None or res.scores.shape != (8 * 2048,) or \
                not np.isfinite(res.scores).all():
            raise AssertionError("scores missing, misshapen or not finite")
        if cdf_lines < 3:
            raise AssertionError("latency CDF file is empty")

        # one more batch through the same cache, held to the store and to
        # the plain versions (not counted above)
        dense, idx, _ = extra
        with torch.inference_mode():
            rows = res.cache.lookup_batch(idx)
            store_rows = torch.from_numpy(np.stack(
                [tables[t][idx[:, t]] for t in range(cfg.num_tables)],
                axis=1)).to(dev)
            if not torch.equal(rows.view(torch.int32),
                               store_rows.view(torch.int32)):
                raise AssertionError("cache rows differ from the store's")
            dense_t = torch.from_numpy(dense).to(dev)
            got = torch.sigmoid(model(dense_t, None, emb_rows=rows))
            x = model.bottom_mlp(dense_t)
            ref = torch.sigmoid(model.top_mlp(dot_interaction_ref(
                x, store_rows)))
            sdiff = float((got - ref).abs().max())
            if not bool(((got - ref).abs()
                         <= 1e-5 * (1 + ref.abs())).all()):
                raise AssertionError(f"scores differ from the plain "
                                     f"versions': max|d| {sdiff}")
        s = res.cache_stats
        print(f"main path [{card}]: {res.requests} requests in "
              f"{res.elapsed_s:.3f} s = {res.requests / res.elapsed_s:.1f} "
              f"requests/s; p50 {res.latency['p50_s'] * 1e6:.2f} us, p99 "
              f"{res.latency['p99_s'] * 1e6:.2f} us per request "
              f"(fenced batch time / 2048)")
        print(f"cache [{card}]: hit_rate {s['hit_rate']:.6f} perfect_hits "
              f"{s['perfect_hits']} segments {s['segments']} bytes_shipped "
              f"{s['bytes_shipped']} size {s['size']} requests "
              f"{s['requests']}")
        print(f"check: rows bit-exact vs store; scores vs plain max|d| "
              f"{sdiff:.3e}; auc {res.metrics['auc']:.4f} (random weights "
              f"and labels)")

    # ---------------------------------------------------- 4 kernels line
    with Phase("4 kernels line"):
        print(f"kernels: {json.dumps(launches)}")
        sources = {
            "interaction_fwd": ("evstore_tpu_torch/csrc/interaction_fwd.cu",
                                "evstore_tpu/ops/pallas_interaction.py:178"),
            "gather_rows": ("evstore_tpu_torch/csrc/gather_rows.cu",
                            "evstore_tpu/ops/pallas_gather.py:34"),
        }
        line = {"kernels": [
            {"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": launches[name], **report[name]}
            for name, (src, rep) in sources.items()]}
        print(f"total: {time.perf_counter() - t_all:.2f} s")
        print(json.dumps(line))

    # ------------------------------------------------------ 5 last line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
