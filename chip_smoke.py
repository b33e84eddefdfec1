#!/usr/bin/env python3
"""On-card check of evstore_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py [--seed N]

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc.  It runs phase by phase, each under a time budget
(SIGALRM), prints each phase's seconds, and exits non-zero on any failure:

0. environment: the card's name and power limit (nvidia-smi), torch and
   nvcc versions, the TF32 switches (off);
1. build: one nvcc per source compiles the port's kernels, all at once,
   while g++ builds the port's copy of the C++ tier engine beside them (or
   reuses the libraries built from the same sources);
2. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes and larger ones, with times (CUDA events, median
   of 20 after warm-up) beside the least time the card could take; the
   two-stage Gram forward (K6) also against the one-stage forward (K1) on
   the same inputs, and its op `DotInteractionGram`, forward and backward,
   against `DotInteraction` and the plain forward and VJP; the grouped
   gather (K2 over the 26 Kaggle tables at idx [128, 26]) bit for bit; K5
   on Zipf ids, on the cases that break a chunked design (one run of all
   entries, runs from chunk boundaries, K=1, K = E*m +- 1, all PAD_ROW; f32
   and bf16), each launched twice on copies of one table (bitwise equal),
   and grouped over the 26 tables at K = 3,328; beside each K2 and K5 time,
   the kernel's device time (profiler) and the wrapper's host time;
3. the serving path: the full-width Criteo Kaggle DLRM (26 tables, 33.8M
   rows, dim 36) served by `run_inference` through the tier engine's
   device C1 cache (`NativeDeviceC1Cache`, EvLFU, 64,000 fp32 entries),
   with the tables in host RAM and random weights from --seed, warmed up
   until C1 is full and then scored over 64 batches of 2048, once with
   `pipeline_depth` 0 and once with 2, which must give the same scores and
   cache stats; the kernels' launch counts over the first run must be
   above 0, the cache's rows must equal the store's bit for bit and the
   scores must equal those of the plain versions; then the Python
   `DeviceC1Cache` at fp32 and at int8 for a few batches, held to the
   store's rows and to their int8 round trip;
3c. the published three-tier configuration (int8 C1, 4-bit C2, alt-key C3,
   48-48-4, 75,425 entries), warmed up until all three tiers are full
   and then scored over 64 batches through `run_inference` with
   `pipeline_depth` 2: the int8 gather's launch count must be above 0, C2
   and C3 must be live, and one more batch's int8 rows must equal the
   plain version's on the same cache state and miss buffer, on the int8
   grid;
3d. the host tiers, over the same tables written to 26 .bin files in a
   temporary directory: (a) the published C1 as the reference's driver
   runs it, the Python `TieredCache` (EvLFU, 64,000 fp32) over an
   `MmapStore`, 16 scored batches, held to the plain forward on the
   store's rows; (b) the published C1+C2+C3 through the engine's host path
   (`use_native`), reading the files and the alt keys' .bin files, 64
   batches; (c) the LFU and LRU baselines at 64,000, Python (4 batches)
   and in the engine (64); (d) 256 requests of batch size 1 through (b)'s
   engine, each timed alone; (e) the A/B of the two interaction forwards
   on (b)'s rows: the bottom MLP, `DotInteractionGram` (K6) and the top
   MLP must give (b)'s scores; (g) the engine's host path at phase 3's C1
   with the tables in RAM; (f) the TCP service in batched mode over a
   fresh fp32 C1 of the engine, its rows equal to the store's; each run
   prints requests/s, p50/p99, stats and its host split;
3b. the training path: the same model with phase 3's tables on the card,
   trained at the reference recipe's batch of 128 and lr 0.1 by
   `make_train_step` and `train` (rwsadagrad, then sgd), with steps/s and a
   profile of where a step's time goes; each of five rwsadagrad steps with
   every kernel on must equal a step with every kernel switched off taken
   from the same state, and so must five more that compound from one
   state; then `evaluate`; the four kernels' launch counts over this phase
   must be above 0, with one grouped gather per train or eval step and one
   grouped row update per rwsadagrad step; kernels and copies per step and
   the rwsadagrad / sgd rate;
4. the kernels' launch counts by path (serve, serve_int8, serve_host,
   gram_ab, train) and one JSON line describing every kernel, each of
   which must have launched on some path;
5. as the last line: {"ok": true, "device": {...}}.

Each serving phase closes its caches, and so their engines (each holds a
copy of the 4.86 GB of tables, or reads the files), its stores and its
temporary files before the next one starts.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
PHASE_BUDGET_S = {"0 environment": 30, "1 build": 180,
                  "2 kernels vs plain": 150, "3 main path": 200,
                  "3c three tiers int8": 200, "3d host tiers": 240,
                  "3b train": 240, "4 kernels line": 30}


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


def device_host_us(torch, fn, reps: int = 20, calls: int = 200):
    """(device us per call, host us per call): the device time of every
    kernel `fn` launches, summed over `reps` calls traced by torch.profiler
    (the CUDA activity alone, so no op is counted twice); time.perf_counter
    over `calls` unsynchronised calls.  The host time is what the call
    costs before the device sees its launches."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    dev_us = sum(e.device_time_total for e in prof.key_averages()
                 if e.device_type == cuda) / reps
    if dev_us <= 0:
        raise AssertionError("the profiler saw no kernel")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return dev_us, host_us


def within(got, ref, rel: float, bf16_ulp: bool = False):
    """(all |got - ref| <= rel (1 + |ref|) [+ one bf16 ulp of ref], max|d|)."""
    import torch
    diff = (got.float() - ref.float()).abs()
    allow = rel * (1 + ref.float().abs())
    if bf16_ulp:
        mag = ref.float().abs().clamp_min(2.0 ** -126)
        allow += torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool((diff <= allow).all()), float(diff.max()) if diff.numel() \
        else 0.0


def within_own(got, ref, rel: float):
    """(all |got - ref| <= rel (|ref| + m), max |got - ref| / (|ref| + m))
    with m the mean magnitude of ref's nonzero entries: a tensor whose
    entries are far from 1, such as an optimizer's sums of squared
    gradients, held to its own size."""
    got, ref = got.float(), ref.float()
    nz = ref != 0
    if not bool(nz.any()):          # an all-zero reference: equal or not
        d = float((got - ref).abs().max()) if got.numel() else 0.0
        return d == 0.0, d
    scaled = (got - ref).abs() / (ref.abs() + ref[nz].abs().mean())
    return bool((scaled <= rel).all()), float(scaled.max())


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

    import dataclasses

    import numpy as np
    import torch

    from concurrent.futures import ThreadPoolExecutor

    from evstore_tpu_torch import _build
    from evstore_tpu_torch.cache.device_cache import DeviceC1Cache
    from evstore_tpu_torch.cache.storage import StorageManager
    from evstore_tpu_torch.cache.service import (EmbeddingClient,
                                                 EmbeddingServer)
    from evstore_tpu_torch.cache.storage import write_ev_tables_binary
    from evstore_tpu_torch.cache.tiers import (AltKeyResolver, altkey_encode,
                                               write_altkeys_binary)
    from evstore_tpu_torch.drivers.infer import TRUE_PER_REQUEST
    from evstore_tpu_torch.native import NativeTieredCache
    from evstore_tpu_torch.config import (CacheConfig, TrainConfig,
                                          kaggle_dlrm_config)
    from evstore_tpu_torch.data.synthetic import (RandomDataConfig,
                                                  random_batches)
    from evstore_tpu_torch.drivers.infer import build_cache, run_inference
    from evstore_tpu_torch.models.dlrm import DLRM
    from evstore_tpu_torch.models.embedding import init_embedding_tables
    from evstore_tpu_torch.native import build as engine_build
    from evstore_tpu_torch.ops.cuda_gather import (
        gather_rows, gather_rows_dequant_int8, gather_rows_dequant_int8_ref,
        gather_rows_grouped, gather_rows_grouped_ref, gather_rows_ref)
    from evstore_tpu_torch.ops.cuda_interaction import (
        DotInteraction, DotInteractionGram, dot_interaction_bwd_kernel,
        dot_interaction_bwd_ref, dot_interaction_gram_kernel,
        dot_interaction_kernel, dot_interaction_ref)
    from evstore_tpu_torch.ops.cuda_update import (
        CHUNK, scatter_sub_sorted, scatter_sub_sorted_grouped_ref,
        scatter_sub_sorted_ref)
    from evstore_tpu_torch.ops.interaction import num_pairs
    from evstore_tpu_torch.ops.quant import (dequantize, dequantize_int8,
                                             np_quantize_int8)
    from evstore_tpu_torch.train.optim import PAD_ROW, dense_parameters
    from evstore_tpu_torch.train.train_loop import (evaluate, init_opt_state,
                                                    make_train_step, train)
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
        # nvcc (the kernels) and g++ (the tier engine) run side by side
        def timed(build, path):
            fresh = not os.path.exists(path)
            t0 = time.perf_counter()
            build()
            return fresh, time.perf_counter() - t0

        with ThreadPoolExecutor(max_workers=2) as ex:
            k_fut = ex.submit(timed, _build.build, _build.library_path())
            e_fut = ex.submit(timed, engine_build.build,
                              engine_build.library_path())
            (k_fresh, k_s), (e_fresh, e_s) = k_fut.result(), e_fut.result()
        path = _build.library_path()
        _build.library()
        print(f"kernel library {os.path.relpath(path)} "
              f"({'built' if k_fresh else 'reused'} in {k_s:.2f} s, one "
              f"nvcc per source side by side, then a link)")
        print(f"tier engine {os.path.relpath(engine_build.library_path())} "
              f"({'built' if e_fresh else 'reused'} in {e_s:.2f} s, g++ "
              f"{' '.join(engine_build.FLAGS)})")
        log = path[:-3] + ".log"
        if os.path.exists(log):
            with open(log) as f:
                for line in f:
                    if "registers" in line or "spill" in line:
                        print("  ptxas:", line.strip())

    # ----------------------------------------------- 2 kernels vs plain
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    report = {}
    wrappers = {"interaction_fwd": dot_interaction_kernel,
                "interaction_bwd": dot_interaction_bwd_kernel,
                "interaction_gram": dot_interaction_gram_kernel,
                "gather_rows": gather_rows,
                "gather_rows_grouped": gather_rows_grouped,
                "gather_rows_dequant_int8": gather_rows_dequant_int8,
                "scatter_sub_sorted": scatter_sub_sorted}

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    def read_counts():
        return {name: w.launches for name, w in wrappers.items()}

    with Phase("2 kernels vs plain"):
        # K1: f32 |d| <= 1e-5 (1 + |ref|) (summation order);
        # bf16: one bf16 ulp of ref plus that f32 allowance
        k1_cases = [(B, T, D, dt, False)
                    for (B, T, D) in [(1, 26, 36), (128, 26, 36),
                                      (1000, 26, 36),
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
            ok, err = within(got, ref, 1e-5, dt == "bfloat16")
            if got.shape != ref.shape or not ok:
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
            del x, ly, got, ref

        # K4: as K1, f32 |d| <= 1e-5 (1 + |ref|); bf16 adds one bf16 ulp
        T, D = 26, 36
        for B, dt, si in [(128, "float32", False), (2048, "float32", False),
                          (65536, "float32", False),
                          (65536, "bfloat16", False),
                          (2048, "float32", True)]:
            tdt = getattr(torch, dt)
            P = num_pairs(T + 1, si)
            x = torch.randn(B, D, generator=gen, device=dev).to(tdt)
            ly = torch.randn(B, T, D, generator=gen, device=dev).to(tdt)
            g = torch.randn(B, D + P, generator=gen, device=dev).to(tdt)
            got = dot_interaction_bwd_kernel(x, ly, g, si)
            ref = dot_interaction_bwd_ref(x, ly, g, si)
            torch.cuda.synchronize()
            checks = [within(a, b, 1e-5, dt == "bfloat16")
                      for a, b in zip(got, ref)]
            err = max(e for _, e in checks)
            if not all(ok for ok, _ in checks) or any(
                    a.shape != b.shape or a.dtype != b.dtype
                    for a, b in zip(got, ref)):
                raise AssertionError(
                    f"interaction_bwd disagrees at B={B} T={T} D={D} {dt} "
                    f"self={si}: max|d| {err}")
            es = x.element_size()
            F = T + 1
            bms, by = bound_ms((2 * B * F * D + B * (D + P)) * es,
                               2.0 * B * F * F * D + B * D, dt)
            k_ms = time_ms(torch,
                           lambda: dot_interaction_bwd_kernel(x, ly, g, si))
            p_ms = time_ms(torch,
                           lambda: dot_interaction_bwd_ref(x, ly, g, si))
            print(f"interaction_bwd B={B} T={T} D={D} {dt} self={si}: "
                  f"max|d| {err:.3e} kernel_ms {k_ms:.4f} plain_ms "
                  f"{p_ms:.4f} bound_us {bms * 1e3:.2f} ({by}) "
                  f"library_ms none (no single PyTorch call computes it) "
                  f"[{card}]", flush=True)
            if (B, dt, si) == (128, "float32", False):
                report["interaction_bwd"] = dict(
                    max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bms,
                    bound_by=by, library_ms=None)
            del x, ly, g, got, ref

        # K6, the two-stage (Gram) forward: K1's rules, against the plain
        # version and against K1 on the same inputs (the same function)
        for B, dt, si in [(128, "float32", False), (2048, "float32", False),
                          (65536, "float32", False),
                          (65536, "bfloat16", False),
                          (2048, "float32", True)]:
            tdt = getattr(torch, dt)
            x = torch.randn(B, D, generator=gen, device=dev).to(tdt)
            ly = torch.randn(B, T, D, generator=gen, device=dev).to(tdt)
            got = dot_interaction_gram_kernel(x, ly, si)
            ref = dot_interaction_ref(x, ly, si)
            k1 = dot_interaction_kernel(x, ly, si)
            torch.cuda.synchronize()
            ok, err = within(got, ref, 1e-5, dt == "bfloat16")
            ok1, err1 = within(got, k1, 1e-5, dt == "bfloat16")
            if got.shape != ref.shape or got.dtype != ref.dtype or not ok \
                    or not ok1:
                raise AssertionError(
                    f"interaction_gram disagrees at B={B} T={T} D={D} {dt} "
                    f"self={si}: max|d| {err} vs plain, {err1} vs K1")
            P = num_pairs(T + 1, si)
            es = x.element_size()
            bms, by = bound_ms((B * (T + 1) * D + B * (D + P)) * es,
                               2.0 * B * P * D, dt)
            k_ms = time_ms(torch,
                           lambda: dot_interaction_gram_kernel(x, ly, si))
            k1_ms = time_ms(torch, lambda: dot_interaction_kernel(x, ly, si))
            p_ms = time_ms(torch, lambda: dot_interaction_ref(x, ly, si))
            print(f"interaction_gram B={B} T={T} D={D} {dt} self={si}: "
                  f"max|d| {err:.3e} vs plain, {err1:.3e} vs K1; kernel_ms "
                  f"{k_ms:.4f} K1_ms {k1_ms:.4f} plain_ms {p_ms:.4f} "
                  f"bound_us {bms * 1e3:.2f} ({by}) library_ms none (no "
                  f"single PyTorch call computes it) [{card}]", flush=True)
            if (B, dt, si) == (2048, "float32", False):
                report["interaction_gram"] = dict(
                    max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bms,
                    bound_by=by, library_ms=None)
            del x, ly, got, ref, k1

        # the op: DotInteractionGram (K6 and the plain VJP) against
        # DotInteraction (K1 and K4) and the plain forward and VJP, B=128
        B = 128
        P = num_pairs(T + 1, False)
        x0 = torch.randn(B, D, generator=gen, device=dev)
        ly0 = torch.randn(B, T, D, generator=gen, device=dev)
        g0 = torch.randn(B, D + P, generator=gen, device=dev)
        outs = {}
        for name, op in (("gram", DotInteractionGram.apply),
                         ("K1+K4", DotInteraction.apply)):
            a = x0.clone().requires_grad_(True)
            b = ly0.clone().requires_grad_(True)
            out = op(a, b, False)
            out.backward(g0)
            outs[name] = (out.detach(), a.grad, b.grad)
        outs["plain"] = (dot_interaction_ref(x0, ly0),
                         *dot_interaction_bwd_ref(x0, ly0, g0))
        torch.cuda.synchronize()
        op_err = 0.0
        for other in ("K1+K4", "plain"):
            for u, v in zip(outs["gram"], outs[other]):
                ok, err = within(u, v, 1e-5)
                op_err = max(op_err, err)
                if not ok:
                    raise AssertionError(f"DotInteractionGram differs from "
                                         f"{other}: max|d| {err}")
        print(f"DotInteractionGram B=128 T={T} D={D} f32, forward and "
              f"backward: max|d| {op_err:.3e} against DotInteraction (K1 "
              f"and K4) and the plain forward and VJP", flush=True)
        del x0, ly0, g0, outs

        # K2: bit-exact.  Beside each case's event time, the kernel's device
        # time (profiler) and the wrapper's host time per call
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
            call = lambda: gather_rows(primary, idx, secondary)  # noqa: E731
            k_ms = time_ms(torch, call)
            dev_us, host_us = device_host_us(torch, call)
            p_ms = time_ms(torch,
                           lambda: gather_rows_ref(primary, idx, secondary))
            lib = lambda: torch.index_select(combined, 0, idx)  # noqa: E731
            l_ms = time_ms(torch, lib)
            l_dev, l_host = device_host_us(torch, lib)
            print(f"gather_rows {label}: bit-exact, kernel_ms {k_ms:.4f} "
                  f"device_us {dev_us:.2f} host_us {host_us:.2f} plain_ms "
                  f"{p_ms:.4f} bound_us {bms * 1e3:.2f} ({by}, "
                  f"{100 * bms * 1e3 / dev_us:.0f}% of it on the device) "
                  f"library_ms {l_ms:.4f} device_us {l_dev:.2f} host_us "
                  f"{l_host:.2f} (index_select on one table) [{card}]",
                  flush=True)
            return dict(max_abs_err=err, ms=k_ms, device_ms=dev_us / 1e3,
                        plain_ms=p_ms, bound_ms=bms, bound_by=by,
                        library_ms=l_ms)

        report["gather_rows"] = k2_case(
            64000, 4096, 2048 * 26, 36, "float32",
            "cache 64000x36 + buffer 4096, R=2048*26 f32")
        k2_case(64000, 4096, 65536 * 26, 36, "float32",
                "cache 64000x36 + buffer 4096, R=65536*26 f32")
        k2_case(10131227, 0, 128, 36, "float32",
                "table 10131227x36, R=128 f32 (one table of a training step)")
        k2_case(10131227, 0, 65536, 36, "float32",
                "table 10131227x36, R=65536 f32")
        k2_case(64000, 4096, 2048 * 26, 36, "bfloat16",
                "cache 64000x36 + buffer 4096, R=2048*26 bf16 (8-byte path)")
        torch.cuda.empty_cache()

        # the grouped K2 over the 26 Kaggle tables at the training step's
        # idx [128, 26] (its ids, from the training stream's seed), bit-exact
        kcfg = kaggle_dlrm_config()
        kb = [float(np.sqrt(1.0 / n)) for n in kcfg.table_sizes]
        ktabs = [torch.empty(n, kcfg.embedding_dim, device=dev).uniform_(
            -b, b, generator=gen) for n, b in zip(kcfg.table_sizes, kb)]
        kidx = next(random_batches(RandomDataConfig(
            num_dense=1, table_sizes=kcfg.table_sizes, batch_size=128,
            num_batches=1, seed=args.seed + 3, distribution="grouped_zipf",
            zipf_alpha=1.05, group_noise=0.1)))[1]
        kidx_d = torch.from_numpy(kidx.astype(np.int32)).to(dev)
        got = gather_rows_grouped(ktabs, kidx_d)
        ref = gather_rows_grouped_ref(ktabs, kidx_d)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError("gather_rows_grouped differs at [128, 26]")
        rb = kcfg.embedding_dim * 4
        uniq = sum(len(np.unique(kidx[:, t])) for t in range(kidx.shape[1]))
        bms, by = bound_ms(uniq * rb + kidx.size * 4 + kidx.size * rb, 0.0,
                           "float32")
        call = lambda: gather_rows_grouped(ktabs, kidx_d)  # noqa: E731
        k_ms = time_ms(torch, call)
        dev_us, host_us = device_host_us(torch, call)
        p_ms = time_ms(torch, lambda: gather_rows_grouped_ref(ktabs, kidx_d))
        print(f"gather_rows_grouped 26 Kaggle tables (33,762,577 x 36 f32), "
              f"idx [128, 26] (one training step): bit-exact, kernel_ms "
              f"{k_ms:.4f} device_us {dev_us:.2f} host_us {host_us:.2f} "
              f"plain_ms {p_ms:.4f} bound_us {bms * 1e3:.2f} ({by}) "
              f"library_ms none (no single PyTorch call gathers 26 tables) "
              f"[{card}]", flush=True)
        report["gather_rows_grouped"] = dict(
            max_abs_err=0.0, ms=k_ms, device_ms=dev_us / 1e3, plain_ms=p_ms,
            bound_ms=bms, bound_by=by, library_ms=None)
        del got, ref

        # K3: bit for bit (IEEE division in both); the int8 C1 cache of the
        # three-tier configuration holds 36,204 rows
        def k3_case(C, M, R, D, label):
            cache = torch.randint(0, 256, (C, D), generator=gen, device=dev,
                                  dtype=torch.uint8)
            buf = torch.randint(0, 256, (M, D), generator=gen, device=dev,
                                dtype=torch.uint8)
            idx = torch.randint(0, C + M, (R,), generator=gen, device=dev,
                                dtype=torch.int32)
            q = R // 4
            idx[:q] = idx[q:2 * q]
            idx[R // 2: R // 2 + M] = torch.arange(C, C + M, device=dev,
                                                   dtype=torch.int32)
            got = gather_rows_dequant_int8(cache, idx, buf)
            ref = gather_rows_dequant_int8_ref(cache, idx, buf)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
                raise AssertionError(f"gather_rows_dequant_int8 differs at "
                                     f"{label}")
            err = float((got - ref).abs().max())
            uniq = int(torch.unique(idx).numel())
            bms, by = bound_ms(uniq * D + R * 4 + R * D * 4, 3.0 * R * D,
                               "float32")
            k_ms = time_ms(torch,
                           lambda: gather_rows_dequant_int8(cache, idx, buf))
            p_ms = time_ms(torch, lambda: gather_rows_dequant_int8_ref(
                cache, idx, buf))
            print(f"gather_rows_dequant_int8 {label}: bit-exact, kernel_ms "
                  f"{k_ms:.4f} plain_ms {p_ms:.4f} bound_us {bms * 1e3:.2f} "
                  f"({by}) library_ms none (no single PyTorch call computes "
                  f"it) [{card}]", flush=True)
            return dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bms,
                        bound_by=by, library_ms=None)

        report["gather_rows_dequant_int8"] = k3_case(
            36204, 4096, 2048 * 26, 36,
            "cache 36204x36 u8 + buffer 4096, R=2048*26")
        k3_case(36204, 4096, 65536 * 26, 36,
                "cache 36204x36 u8 + buffer 4096, R=65536*26")
        k3_case(36204, 4096, 2048 * 26, 7,
                "cache 36204x7 u8 + buffer 4096, R=2048*26 (byte path)")
        torch.cuda.empty_cache()

        # K5: |d| <= 1e-6 (1 + |ref|) over the whole table (the kernel's
        # fixed-order f32 run sums against the plain version's float64
        # index_add_); a bf16 table adds one bf16 ulp (each side rounds
        # once, at the store).  Beside the event time, the kernel's device
        # time (its two kernels, profiler) and the wrapper's host time
        N5, D5 = kcfg.table_sizes[2], 36
        bound5 = float(np.sqrt(1.0 / N5))
        base = (torch.rand(N5, D5, generator=gen, device=dev) * 2 - 1) \
            * bound5
        nrng = np.random.default_rng(args.seed + 5)
        zipf = next(random_batches(RandomDataConfig(
            num_dense=1, table_sizes=(N5,), batch_size=65536, num_batches=1,
            seed=args.seed + 6, distribution="zipf",
            zipf_alpha=1.05)))[1][:, 0]
        zipf[nrng.random(zipf.size) < 0.05] = PAD_ROW

        def k5_check(dt, ids, label):
            """The kernel on two copies of one table (bitwise equal: the
            sum order is fixed) against the plain version."""
            tdt = getattr(torch, dt)
            rows = torch.from_numpy(np.sort(ids).astype(np.int32)).to(dev)
            vals = torch.randn(rows.numel(), D5, generator=gen,
                               device=dev) * 1e-2
            tab = base.to(tdt, copy=True)
            tab2, tab_ref = tab.clone(), tab.clone()
            scatter_sub_sorted(tab, rows, vals)
            scatter_sub_sorted(tab2, rows, vals)
            scatter_sub_sorted_ref(tab_ref, rows, vals)
            torch.cuda.synchronize()
            ok, err = within(tab, tab_ref, 1e-6, dt == "bfloat16")
            if not ok:
                raise AssertionError(f"scatter_sub_sorted disagrees at "
                                     f"{label}: max|d| {err}")
            if not torch.equal(tab, tab2):
                raise AssertionError(f"scatter_sub_sorted is not "
                                     f"deterministic at {label}")
            return rows, vals, tab, tab_ref, err

        def k5_case(dt, ids, label):
            rows, vals, tab, tab_ref, err = k5_check(dt, ids, label)
            tdt = tab.dtype
            K = rows.numel()
            keep = (rows >= 0) & (rows < N5)
            uniq, counts = torch.unique(rows[keep], return_counts=True)
            es = tab.element_size()
            bms, by = bound_ms(K * 4 + K * D5 * 4 + 2 * uniq.numel() * D5
                               * es, float(K * D5 + uniq.numel() * D5),
                               "float32")
            lib_rows = rows[keep].long()
            lib_vals = (-vals[keep]).to(tdt)
            call = lambda: scatter_sub_sorted(tab, rows, vals)  # noqa: E731
            k_ms = time_ms(torch, call)
            dev_us, host_us = device_host_us(torch, call)
            p_ms = time_ms(torch,
                           lambda: scatter_sub_sorted_ref(tab_ref, rows, vals))
            lib = lambda: tab_ref.index_add_(0, lib_rows,  # noqa: E731
                                             lib_vals)
            l_ms = time_ms(torch, lib)
            l_dev, l_host = device_host_us(torch, lib)
            print(f"scatter_sub_sorted {label}: {uniq.numel()} rows, longest "
                  f"run {int(counts.max())}, max|d| {err:.3e}, two launches "
                  f"bitwise equal; kernel_ms {k_ms:.4f} device_us "
                  f"{dev_us:.2f} host_us {host_us:.2f} plain_ms {p_ms:.4f} "
                  f"bound_us {bms * 1e3:.2f} ({by}) library_ms {l_ms:.4f} "
                  f"device_us {l_dev:.2f} host_us {l_host:.2f} "
                  f"(index_add_ of the valid entries"
                  f"{', values in bf16' if dt == 'bfloat16' else ''})"
                  f" [{card}]", flush=True)
            return dict(max_abs_err=err, ms=k_ms, device_ms=dev_us / 1e3,
                        plain_ms=p_ms, bound_ms=bms, bound_by=by,
                        library_ms=l_ms)

        k5_case("float32", nrng.integers(0, N5, 128),
                f"table {N5}x{D5} f32, K=128 (one table of a recipe step)")
        k5_case("float32", zipf,
                f"table {N5}x{D5} f32, K=65536 zipf(1.05), 5% PAD_ROW")
        k5_case("bfloat16", zipf,
                f"table {N5}x{D5} bf16, K=65536 zipf(1.05), 5% PAD_ROW")
        # the cases that break a chunked design (CHUNK sorted entries a
        # block), checked and not timed
        E = CHUNK
        adversarial = {
            "one run of all 65536 entries": np.full(65536, 12345),
            f"runs of {E} starting at every chunk boundary":
                np.repeat(nrng.choice(N5, 64, replace=False), E),
            f"runs of {E // 2}, {E} and {3 * E} from chunk boundaries":
                np.concatenate([np.repeat(np.arange(8), E // 2),
                                np.repeat(np.arange(8, 12), E),
                                np.repeat(np.arange(12, 15), 3 * E)]),
            "K=1": np.asarray([7]),
            f"K={5 * E + 1} (E*5+1)": nrng.integers(0, 40, 5 * E + 1),
            f"K={5 * E - 1} (E*5-1)": nrng.integers(0, 40, 5 * E - 1),
            "all PAD_ROW": np.full(1000, PAD_ROW),
        }
        for dt in ("float32", "bfloat16"):
            for label, ids in adversarial.items():
                _, _, _, _, err = k5_check(dt, ids, label)
                print(f"scatter_sub_sorted {dt} {label}: max|d| {err:.3e}, "
                      f"two launches bitwise equal", flush=True)
        del base
        torch.cuda.empty_cache()

        # the grouped K5 at the training step's shape: the 26 Kaggle
        # tables, K = 128 x 26 = 3,328 global ids of the training stream's
        # first batch (each table's ids offset by its base), values as a
        # rwsadagrad step scales them
        kbase = np.concatenate([[0], np.cumsum(kcfg.table_sizes)])[:-1]
        grows = torch.from_numpy(np.sort(
            (kidx + kbase).reshape(-1)).astype(np.int32)).to(dev)
        K = grows.numel()
        gvals = torch.randn(K, D5, generator=gen, device=dev) * 1e-3
        ref_tabs = [t.clone() for t in ktabs]
        twice = [t.clone() for t in ktabs]
        scatter_sub_sorted(ktabs, grows, gvals)
        scatter_sub_sorted(twice, grows, gvals)
        scatter_sub_sorted_grouped_ref(ref_tabs, grows, gvals)
        torch.cuda.synchronize()
        err = 0.0
        for t, (a_, b_, c_) in enumerate(zip(ktabs, ref_tabs, twice)):
            ok, e_ = within(a_, b_, 1e-6)
            err = max(err, e_)
            if not ok or not torch.equal(a_, c_):
                raise AssertionError(f"grouped scatter_sub_sorted differs or "
                                     f"is not deterministic at table {t}: "
                                     f"max|d| {e_}")
        del ref_tabs, twice
        uniq = int(torch.unique(grows).numel())
        bms, by = bound_ms(K * 4 + K * D5 * 4 + 2 * uniq * D5 * 4,
                           float(K * D5 + uniq * D5), "float32")
        call = lambda: scatter_sub_sorted(ktabs, grows, gvals)  # noqa: E731
        k_ms = time_ms(torch, call)
        dev_us, host_us = device_host_us(torch, call)
        ref_tabs = [t.clone() for t in ktabs]
        p_ms = time_ms(torch, lambda: scatter_sub_sorted_grouped_ref(
            ref_tabs, grows, gvals))
        print(f"scatter_sub_sorted grouped, 26 Kaggle tables (33,762,577 x 36"
              f" f32), K=3328 (one training step): {uniq} rows, max|d| "
              f"{err:.3e}, two launches bitwise equal; kernel_ms {k_ms:.4f} "
              f"device_us {dev_us:.2f} host_us {host_us:.2f} plain_ms "
              f"{p_ms:.4f} bound_us {bms * 1e3:.2f} ({by}) library_ms none "
              f"(no single PyTorch call updates 26 tables) [{card}]",
              flush=True)
        report["scatter_sub_sorted"] = dict(
            max_abs_err=err, ms=k_ms, device_ms=dev_us / 1e3, plain_ms=p_ms,
            bound_ms=bms, bound_by=by, library_ms=None)
        del ktabs, ref_tabs
        torch.cuda.empty_cache()

    # ------------------------------------------------------- 3 main path
    N_SCORED = 64           # scored batches of 2048 per serving run
    WARM_CAP = 200          # warm-up batches allowed for the tiers to fill

    def serve_line(label, res, split):
        """Rates, latency and the host time per scored batch."""
        n_b = res.latency["count"] // 2048
        per = {k: 1e3 * v / n_b for k, v in split.items()}
        batch_ms = 1e3 * res.elapsed_s / n_b
        print(f"{label} [{card}]: {res.requests} requests in "
              f"{res.elapsed_s:.3f} s = {res.requests / res.elapsed_s:.1f} "
              f"requests/s; p50 {res.latency['p50_s'] * 1e6:.2f} us, p99 "
              f"{res.latency['p99_s'] * 1e6:.2f} us per request (fenced "
              f"batch time / 2048)", flush=True)
        print(f"  host ms per batch of 2048: {batch_ms:.3f} in all; engine "
              f"assign {per['assign']:.3f}; pad and quantise "
              f"{per['pack']:.3f}; wait for the stream's queued work "
              f"{per['wait']:.3f}; H2D copies and the apply's launches "
              f"{per['copy']:.3f}; the rest (forward launches and the "
              f"fenced wait for the device) "
              f"{batch_ms - sum(per.values()):.3f}"
              + (" (the lookups ran on the prefetch thread, beside the "
                 "rest)" if label.endswith("depth 2") else ""))

    def serve_stream():
        """The request stream of the serving phases, from --seed."""
        return random_batches(RandomDataConfig(
            num_dense=cfg.num_dense_features, table_sizes=cfg.table_sizes,
            batch_size=2048, num_batches=WARM_CAP + N_SCORED + 1,
            seed=args.seed + 1, distribution="grouped_zipf", zipf_alpha=1.05,
            group_noise=0.1))

    def warm_up(cache, full, n_scored=N_SCORED):
        """run_inference's warm-up pass, done here on the stream until
        `full(cache.stats())` holds, so that the scored batches see the
        tiers in steady state and the host split counts them only.
        Returns the warm-up batches, the scored ones and one more."""
        it = serve_stream()
        warm = []
        look = getattr(cache, "lookup_batch", None) or cache.request_batch
        with torch.inference_mode():
            for b in it:
                look(b[1])
                warm.append(b)
                if full(cache.stats()):
                    break
                if len(warm) == WARM_CAP:
                    raise AssertionError(f"the tiers were not full after "
                                         f"{WARM_CAP} warm-up batches: "
                                         f"{cache.stats()}")
        torch.cuda.synchronize()
        if hasattr(cache, "host_s"):
            cache.host_s = dict.fromkeys(cache.host_s, 0.0)
        return warm, [next(it) for _ in range(n_scored)], next(it)

    def seeded_altkeys():
        """C3's alt keys: for each row, `altkey_encode` of one uniform row
        of the same table, from --seed."""
        arng = np.random.default_rng(args.seed + 4)
        return [altkey_encode(t, arng.integers(0, n, n)).astype(np.uint32)
                for t, n in enumerate(cfg.table_sizes)]

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
        print(f"set-up: {len(tables)} tables, "
              f"{sum(cfg.table_sizes)} rows, {host_gb:.2f} GB in host RAM, "
              f"{time.perf_counter() - t0:.2f} s")

        # run 1, pipeline_depth 0, through a cache built here, so that it
        # can be looked into after the run
        t0 = time.perf_counter()
        cache = build_cache(ccfg, cfg, storage, use_device_cache=True,
                            device=dev)
        print(f"NativeDeviceC1Cache: engine loaded in "
              f"{time.perf_counter() - t0:.2f} s")
        warmup, scored, extra = warm_up(
            cache, lambda s: s["size"] >= s["capacity"])
        print(f"warm-up: {len(warmup)} batches of 2048 until C1 held "
              f"{cache.stats()['size']} of {cache.capacity} entries; "
              f"{N_SCORED} scored batches follow")
        with tempfile.TemporaryDirectory() as tmp:
            cdf = os.path.join(tmp, "cdf.csv")
            reset_counts()
            res = run_inference(model, cfg, ccfg, scored, storage,
                                cdf_path=cdf, use_device_cache=True,
                                cache=cache, device=dev)
            serve_launches = read_counts()
            with open(cdf) as f:
                cdf_lines = sum(1 for _ in f)
        split = dict(cache.host_s)
        serve_launches = {k: serve_launches[k]
                          for k in ("interaction_fwd", "gather_rows")}
        if min(serve_launches.values()) < 1:
            raise AssertionError(f"a kernel of the path never ran: "
                                 f"{serve_launches}")
        if res.scores is None or res.scores.shape != (N_SCORED * 2048,) or \
                not np.isfinite(res.scores).all():
            raise AssertionError("scores missing, misshapen or not finite")
        if cdf_lines < 3:
            raise AssertionError("latency CDF file is empty")

        # one more batch through the same cache, held to the store and to
        # the plain versions (not counted above)
        dense, idx, _ = extra
        with torch.inference_mode():
            rows = cache.lookup_batch(idx)
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
        cache.close()
        del cache, rows, store_rows

        # run 2, pipeline_depth 2: run_inference builds, warms up and closes
        # its own cache; the same scores and stats as run 1
        reset_counts()
        res2 = run_inference(model, cfg, ccfg, scored, storage,
                             warmup_batches=warmup, use_device_cache=True,
                             pipeline_depth=2, device=dev)
        depth2_launches = read_counts()
        if not np.array_equal(res2.scores, res.scores):
            raise AssertionError("pipeline_depth 2 changed the scores")
        if res2.cache_stats != res.cache_stats:
            raise AssertionError(f"pipeline_depth 2 changed the cache stats:"
                                 f" {res2.cache_stats} != {res.cache_stats}")
        s = res.cache_stats
        serve_line("main path, NativeDeviceC1Cache fp32, pipeline_depth 0",
                   res, split)
        print(f"main path, pipeline_depth 2 [{card}]: {res2.requests} "
              f"requests in {res2.elapsed_s:.3f} s = "
              f"{res2.requests / res2.elapsed_s:.1f} requests/s; p50 "
              f"{res2.latency['p50_s'] * 1e6:.2f} us, p99 "
              f"{res2.latency['p99_s'] * 1e6:.2f} us per request; scores "
              f"and stats equal to depth 0's; launches "
              f"{json.dumps(depth2_launches)}")
        print(f"cache [{card}]: hit_rate {s['hit_rate']:.6f} perfect_hits "
              f"{s['perfect_hits']} bytes_shipped {s['bytes_shipped']} size "
              f"{s['size']} requests {s['requests']}")
        print(f"check: rows bit-exact vs store; scores vs plain max|d| "
              f"{sdiff:.3e}; auc {res.metrics['auc']:.4f} (random weights "
              f"and labels)")

        # the Python DeviceC1Cache, at fp32 and int8, for two batches each:
        # rows equal to the store's, or to their int8 round trip
        for prec in (32, 8):
            pc = DeviceC1Cache(dataclasses.replace(ccfg, main_precision=prec),
                               storage, cfg.num_tables, cfg.embedding_dim,
                               device=dev)
            t0 = time.perf_counter()
            for _, idx, _ in warmup[:2]:
                with torch.inference_mode():
                    rows = pc.lookup_batch(idx)
                want = np.stack([tables[t][idx[:, t]]
                                 for t in range(cfg.num_tables)], axis=1)
                if prec == 8:
                    want = dequantize_int8(torch.from_numpy(
                        np_quantize_int8(want))).numpy()
                if not np.array_equal(rows.cpu().numpy().view(np.int32),
                                      want.view(np.int32)):
                    raise AssertionError(f"DeviceC1Cache rows at "
                                         f"main_precision={prec} differ")
            ps = pc.stats()
            print(f"DeviceC1Cache main_precision={prec} [{card}]: 2 batches "
                  f"of 2048 in {time.perf_counter() - t0:.3f} s, rows "
                  f"bit-exact vs the store's"
                  f"{' int8 round trip' if prec == 8 else ''}; segments "
                  f"{ps['segments']} bytes_shipped {ps['bytes_shipped']}")
            del pc
        torch.cuda.empty_cache()

    # ------------------------------------------ 3c three tiers, int8
    with Phase("3c three tiers int8"):
        # bench/dlrm_s_criteo_kaggle_C1_C2_C3.sh: int8 C1, 4-bit C2,
        # alt-key C3, 48-48-4, 75,425 entries.  The alt keys are a listed
        # cut: one uniform row of the same table for each row, from --seed
        # (the reference's come from an offline kNN).
        ccfg3 = CacheConfig(policy="evlfu", n_caching_layers=3,
                            total_size=75425, main_precision=8,
                            secondary_precision=4, size_proportion=(48, 48, 4))
        t0 = time.perf_counter()
        resolver = AltKeyResolver(seeded_altkeys())
        cache = build_cache(ccfg3, cfg, storage, resolver,
                            use_device_cache=True, device=dev)
        print(f"set-up: tiers {ccfg3.tier_capacities()}, alt keys and "
              f"engine in {time.perf_counter() - t0:.2f} s")
        caps = ccfg3.tier_capacities()
        warmup3, scored3, extra3 = warm_up(
            cache, lambda s: (s["size"] >= caps[0] and s["c2"]["size"] >= caps[1]
                              and s["c3"]["size"] >= caps[2]))
        s_start = cache.stats()
        print(f"warm-up: {len(warmup3)} batches of 2048 until C1, C2 and "
              f"C3 were full: {s_start}; {N_SCORED} scored batches follow")
        reset_counts()
        res3 = run_inference(model, cfg, ccfg3, scored3, storage,
                             altkey_resolver=resolver, use_device_cache=True,
                             pipeline_depth=2, cache=cache, device=dev)
        int8_launches = read_counts()
        split3 = dict(cache.host_s)
        int8_launches = {k: int8_launches[k] for k in
                         ("interaction_fwd", "gather_rows_dequant_int8")}
        if min(int8_launches.values()) < 1:
            raise AssertionError(f"a kernel of the path never ran: "
                                 f"{int8_launches}")
        s3 = res3.cache_stats
        if not (s3["c2"]["hit_rate"] > 0 and s3["c3"]["size"] > 0):
            raise AssertionError(f"C2 or C3 is not live: {s3}")
        if res3.scores is None or res3.scores.shape != (N_SCORED * 2048,) or \
                not np.isfinite(res3.scores).all():
            raise AssertionError("scores missing, misshapen or not finite")

        # one more batch: the int8 apply's rows against the plain version
        # on the same cache state and miss buffer (not counted above)
        _, idx, _ = extra3
        assign = cache.assigner.assign_batch(idx)
        with torch.inference_mode():
            rows = cache._apply_assign(assign)
            slots, _, _, buf = assign
            bk = cache.insert_bucket
            buf_q = np.zeros((max(bk, -(-len(buf) // bk) * bk),
                              cfg.embedding_dim), np.float32)
            buf_q[:len(buf)] = buf
            ref = gather_rows_dequant_int8_ref(
                cache.cache_values, torch.from_numpy(slots).to(dev),
                torch.from_numpy(np_quantize_int8(buf_q)).to(dev))
            grid = dequantize_int8(torch.arange(256, device=dev,
                                                dtype=torch.uint8))
            if not torch.equal(rows.view(torch.int32), ref.view(torch.int32)):
                raise AssertionError("the int8 apply's rows differ from the "
                                     "plain version's")
            if not bool(torch.isin(rows, grid).all()):
                raise AssertionError("an int8 row value is off the grid")
        serve_line("three tiers, NativeDeviceC1Cache int8, pipeline_depth 2",
                   res3, split3)
        n_req = s3["requests"] - s_start["requests"]
        c1_hr = (s3["hit_rate"] * s3["requests"] - s_start["hit_rate"]
                 * s_start["requests"]) / n_req
        print(f"cache [{card}]: over the {n_req} scored requests (every "
              f"tier full at their start): C1 hit_rate {c1_hr:.6f}, C3 "
              f"hits {s3['c3']['hits'] - s_start['c3']['hits']}; C2 "
              f"cumulative hit_rate {s_start['c2']['hit_rate']:.6f} at the "
              f"start, {s3['c2']['hit_rate']:.6f} at the end; at the end: "
              f"C1 {s3['size']} of {s3['capacity']}, C2 {s3['c2']}, C3 "
              f"{s3['c3']}, perfect_hits {s3['perfect_hits']}, "
              f"bytes_shipped {s3['bytes_shipped']}, requests "
              f"{s3['requests']} (warm-up included)")
        print(f"check: the extra batch's int8 rows bit-exact vs the plain "
              f"version on the same state and buffer, all on the int8 grid;"
              f" auc {res3.metrics['auc']:.4f} (random weights and labels)")
        cache.close()
        del cache, rows, ref, resolver, warmup3, scored3
        torch.cuda.empty_cache()

    # ------------------------------------------------- 3d host tiers
    def host_line(label, res, n_batches, B=2048):
        """Rates, latency, stats and the host split per batch of a run
        through a cache that hands back host rows."""
        per = {k: 1e3 * v / n_batches for k, v in res.host_s.items()}
        print(f"{label} [{card}]: {res.requests} requests in "
              f"{res.elapsed_s:.3f} s = {res.requests / res.elapsed_s:.1f} "
              f"requests/s; p50 {res.latency['p50_s'] * 1e6:.2f} us, p99 "
              f"{res.latency['p99_s'] * 1e6:.2f} us per request; host ms "
              f"per batch of {B}: {1e3 * res.elapsed_s / n_batches:.3f} in "
              f"all; the cache's request_batch {per['lookup']:.3f}; H2D "
              f"copy of the rows {per['copy']:.3f}; forward and fence "
              f"{per['forward']:.3f}; stats (warm-up included) "
              f"{json.dumps(res.cache_stats)}", flush=True)

    def store_rows(idx):
        return np.stack([tables[t][idx[:, t]] for t in range(cfg.num_tables)],
                        axis=1)

    def check_plain(res, batches, label):
        """The scores of an fp32 run against the plain forward on the
        store's own rows, 1e-5 (1 + |ref|)."""
        worst = 0.0
        with torch.inference_mode():
            for i, (dense, idx, _) in enumerate(batches):
                dense_t = torch.from_numpy(dense).to(dev)
                ref = torch.sigmoid(model.top_mlp(dot_interaction_ref(
                    model.bottom_mlp(dense_t),
                    torch.from_numpy(store_rows(idx)).to(dev)))).cpu()
                got = torch.from_numpy(res.scores[i * len(idx):
                                                  (i + 1) * len(idx)])
                ok, err = within(got, ref, 1e-5)
                worst = max(worst, err)
                if not ok:
                    raise AssertionError(f"{label}: scores differ from the "
                                         f"plain forward on the store's rows"
                                         f": max|d| {err}")
        return worst

    def served(res, n):
        if res.scores is None or res.scores.shape != (n * 2048,) or \
                not np.isfinite(res.scores).all():
            raise AssertionError("scores missing, misshapen or not finite")

    host_launches = dict.fromkeys(wrappers, 0)

    def serve_host(*a, **kw):
        """run_inference with the launch counts set to 0 just before and
        added to the serve_host path's just after."""
        reset_counts()
        res = run_inference(*a, device=dev, **kw)
        for k, v in read_counts().items():
            host_launches[k] += v
        return res

    with Phase("3d host tiers"):
        tmp3d = tempfile.TemporaryDirectory()
        bins = tmp3d.name
        free = shutil.disk_usage(bins).free
        print(f"files in {bins}: {free / 1e9:.2f} GB free, the tables take "
              f"{host_gb:.2f} GB", flush=True)
        t0 = time.perf_counter()
        write_ev_tables_binary(tables, bins)
        alts = seeded_altkeys()
        write_altkeys_binary(alts, bins)
        print(f"wrote 26 ev-table-<t>.bin and alt-keys-<t>.bin files in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        sizes = list(cfg.table_sizes)
        mm = StorageManager("mmap", dim=cfg.embedding_dim).load(
            bin_dir=bins, table_sizes=sizes)

        # (a) bench/dlrm_s_criteo_kaggle_C1.sh: the Python TieredCache,
        # EvLFU C1 of 64,000 fp32 entries, over the mmap store
        ccfg_a = CacheConfig(policy="evlfu", n_caching_layers=1,
                             total_size=64000, main_precision=32)
        tc = build_cache(ccfg_a, cfg, mm)
        warm_a, scored_a, extra_a = warm_up(
            tc, lambda s: s["c1"]["size"] >= 64000, n_scored=16)
        res_a = serve_host(model, cfg, ccfg_a, scored_a, mm, cache=tc)
        served(res_a, 16)
        err_a = check_plain(res_a, scored_a, "(a) TieredCache C1 fp32")
        rows = tc.request_batch(extra_a[1])
        if not np.array_equal(rows.view(np.int32),
                              store_rows(extra_a[1]).view(np.int32)):
            raise AssertionError("(a): C1 fp32 rows differ from the store's")
        host_line(f"3d(a) the published C1: Python TieredCache EvLFU 64,000 "
                  f"fp32 over the mmap store, {len(warm_a)} warm-up batches",
                  res_a, 16)
        print(f"check (a): scores vs the plain forward on the store's rows "
              f"max|d| {err_a:.3e}; one more batch's rows bit-exact vs the "
              f"store's", flush=True)
        del tc, rows

        # (b) bench/dlrm_s_criteo_kaggle_C1_C2_C3.sh (--cache-algo native):
        # the engine's host path, int8 C1, 4-bit C2, alt-key C3, reading the
        # .bin files; the alt keys read back from alt-keys-<t>.bin
        ccfg_b = CacheConfig(policy="evlfu", n_caching_layers=3,
                             total_size=75425, main_precision=8,
                             secondary_precision=4,
                             size_proportion=(48, 48, 4))
        resolver = AltKeyResolver(bin_dir=bins, table_sizes=sizes)
        if not all(np.array_equal(a, b) for a, b in
                   zip(resolver.tables, alts)):
            raise AssertionError("alt keys read back differ")
        eng = NativeTieredCache(ccfg_b, cfg.num_tables, cfg.embedding_dim)
        eng.open_table_files(bins, sizes)
        eng.load_altkeys(resolver.tables)
        caps = ccfg_b.tier_capacities()
        warm_b, scored_b, extra_b = warm_up(
            eng, lambda s: (s["c1"]["size"] >= caps[0]
                            and s["c2"]["size"] >= caps[1]
                            and s["c3"]["size"] >= caps[2]))
        s_start = eng.stats()

        class Recorder:
            """The engine, with the rows it hands back kept for (e)."""

            def __init__(self, inner):
                self.inner, self.rows = inner, []

            def request_batch(self, idx):
                out = self.inner.request_batch(idx)
                self.rows.append(out)
                return out

            def stats(self):
                return self.inner.stats()

        rec = Recorder(eng)
        res_b = serve_host(model, cfg, ccfg_b, scored_b, mm,
                           altkey_resolver=resolver, use_native=True,
                           cache=rec)
        served(res_b, N_SCORED)
        s_b = res_b.cache_stats
        if not (s_b["c2"]["hit_rate"] > 0 and s_b["c3"]["size"] > 0):
            raise AssertionError(f"C2 or C3 is not live: {s_b}")
        grid = torch.cat([dequantize(torch.arange(n, dtype=torch.uint8),
                                     bits) for n, bits in ((255, 8),
                                                           (15, 4))])
        if not np.isin(rec.rows[-1], grid.numpy()).all():
            raise AssertionError("(b): a row is off the int8 and 4-bit "
                                 "grids")
        host_line(f"3d(b) the published C1+C2+C3: the engine's host path "
                  f"(use_native), int8 C1, 4-bit C2, alt-key C3, tiers "
                  f"{caps}, file-backed, {len(warm_b)} warm-up batches",
                  res_b, N_SCORED)
        print(f"cache (b) over the scored window: C3 hits "
              f"{s_b['c3']['hits'] - s_start['c3']['hits']}, perfect hits "
              f"{s_b['perfect_hits'] - s_start['perfect_hits']}; C2 "
              f"cumulative hit_rate {s_start['c2']['hit_rate']:.6f} -> "
              f"{s_b['c2']['hit_rate']:.6f}; every row on the int8 or 4-bit "
              f"grid", flush=True)

        # (d) batch size 1: 256 requests through (b)'s engine, each timed
        # alone and fenced by a real transfer of its score
        dense_d, idx_d, y_d = extra_b
        singles = [(dense_d[i:i + 1], idx_d[i:i + 1], y_d[i:i + 1])
                   for i in range(256)]
        cdf = os.path.join(bins, "cdf-bs1.csv")
        res_d = serve_host(model, cfg, ccfg_b, singles, mm,
                           use_native=True, cache=eng, cdf_path=cdf)
        with open(cdf) as f:
            head = f.readline().strip()
        if head != f"# method={TRUE_PER_REQUEST}" or \
                res_d.latency["count"] != 256:
            raise AssertionError(f"(d): CDF header {head!r}, "
                                 f"{res_d.latency['count']} samples")
        if res_d.scores.shape != (256,) or \
                not np.isfinite(res_d.scores).all():
            raise AssertionError("(d): scores missing or not finite")
        print(f"3d(d) batch size 1 through (b)'s engine [{card}]: 256 "
              f"requests, true per-request p50 "
              f"{res_d.latency['p50_s'] * 1e6:.2f} us, p99 "
              f"{res_d.latency['p99_s'] * 1e6:.2f} us; {head}", flush=True)
        eng.close()
        del eng, rec.inner

        # (e) the K6 A/B: (b)'s scored rows through the bottom MLP, the
        # two-stage Gram op and the top MLP, against (b)'s scores (K1)
        reset_counts()
        worst_e = 0.0
        with torch.inference_mode():
            for i, ((dense, _, _), rows) in enumerate(zip(scored_b,
                                                          rec.rows)):
                dense_t = torch.from_numpy(dense).to(dev)
                rows_t = torch.from_numpy(rows).to(dev)
                x = model.bottom_mlp(dense_t)
                got = torch.sigmoid(model.top_mlp(DotInteractionGram.apply(
                    x.contiguous(), rows_t, cfg.interaction_itself))).cpu()
                ref = torch.from_numpy(res_b.scores[i * 2048:(i + 1) * 2048])
                ok, err = within(got, ref, 1e-5)
                worst_e = max(worst_e, err)
                if not ok:
                    raise AssertionError(f"(e): the Gram op's scores differ "
                                         f"from K1's: max|d| {err}")
        gram_launches = {"interaction_gram":
                         read_counts()["interaction_gram"]}
        if gram_launches["interaction_gram"] < 1:
            raise AssertionError(f"K6 never ran in (e): {gram_launches}")
        with torch.inference_mode():
            def fwd_k1():
                return model(dense_t, None, emb_rows=rows_t)

            def fwd_k6():
                return model.top_mlp(DotInteractionGram.apply(
                    model.bottom_mlp(dense_t).contiguous(), rows_t,
                    cfg.interaction_itself))

            ab = [time_ms(torch, f) for f in (fwd_k1, fwd_k6, fwd_k6,
                                              fwd_k1)]
        print(f"3d(e) the K6 A/B over (b)'s {len(rec.rows)} scored batches "
              f"[{card}]: scores vs K1's max|d| {worst_e:.3e} (limit 1e-5 "
              f"(1 + |ref|)); the forward of one batch of 2048 with K1 "
              f"{ab[0]:.4f} / {ab[3]:.4f} ms, with K6 {ab[1]:.4f} / "
              f"{ab[2]:.4f} ms (CUDA events, median of 20, in the order K1, "
              f"K6, K6, K1); launches {json.dumps(gram_launches)}",
              flush=True)
        del rec, dense_t, rows_t

        # (c) the LFU and LRU baselines at 64,000 entries: Python
        # (SimpleCacheFrontend over the mmap store, 4 scored batches) and
        # the engine (its file mode, 64 scored batches)
        for policy in ("lfu", "lru"):
            ccfg_c = CacheConfig(policy=policy, n_caching_layers=1,
                                 total_size=64000, main_precision=32)
            py = build_cache(ccfg_c, cfg, mm)
            warm_c, scored_c, _ = warm_up(
                py, lambda s: s["cache"]["size"] >= 64000, n_scored=4)
            res_c = serve_host(model, cfg, ccfg_c, scored_c, mm, cache=py)
            served(res_c, 4)
            err_c = check_plain(res_c, scored_c, f"(c) Python {policy}")
            host_line(f"3d(c) Python {policy.upper()} 64,000 fp32 over the "
                      f"mmap store, {len(warm_c)} warm-up batches", res_c, 4)
            del py
            nat = NativeTieredCache(ccfg_c, cfg.num_tables,
                                    cfg.embedding_dim)
            nat.open_table_files(bins, sizes)
            warm_n, scored_n, _ = warm_up(
                nat, lambda s: s["c1"]["size"] >= 64000)
            res_n = serve_host(model, cfg, ccfg_c, scored_n, mm,
                               use_native=True, cache=nat)
            nat.close()
            served(res_n, N_SCORED)
            err_n = check_plain(res_n, scored_n, f"(c) native {policy}")
            host_line(f"3d(c) the engine's {policy.upper()} 64,000 fp32, "
                      f"file-backed, {len(warm_n)} warm-up batches", res_n,
                      N_SCORED)
            print(f"check (c) {policy}: scores vs the plain forward on the "
                  f"store's rows max|d| {err_c:.3e} (Python), {err_n:.3e} "
                  f"(engine)", flush=True)
            del nat

        # (g) the engine's host path at phase 3's C1 (EvLFU, 64,000 fp32)
        # with the tables in RAM, as build_cache makes it from the dummy
        # store: the host path against the device cache at the same C1,
        # and against the file-backed runs above
        nat = build_cache(ccfg_a, cfg, storage, use_native=True)
        warm_g, scored_g, _ = warm_up(
            nat, lambda s: s["c1"]["size"] >= 64000)
        res_g = serve_host(model, cfg, ccfg_a, scored_g, storage,
                           use_native=True, cache=nat)
        nat.close()
        served(res_g, N_SCORED)
        err_g = check_plain(res_g, scored_g, "(g) native EvLFU in RAM")
        host_line(f"3d(g) the engine's host path, EvLFU 64,000 fp32, tables "
                  f"in RAM (phase 3's C1 and store), {len(warm_g)} warm-up "
                  f"batches", res_g, N_SCORED)
        print(f"check (g): scores vs the plain forward on the store's rows "
              f"max|d| {err_g:.3e}; at the same C1 the device cache served "
              f"{res.requests / res.elapsed_s:.1f} requests/s in phase 3 "
              f"(depth 0)", flush=True)
        del nat

        # (f) the TCP service in batched mode over a fresh fp32 C1 of the
        # engine, on 127.0.0.1: the rows equal the store's bit for bit
        eng_f = NativeTieredCache(ccfg_a, cfg.num_tables, cfg.embedding_dim)
        eng_f.open_table_files(bins, sizes)
        srv = EmbeddingServer(eng_f, cfg.embedding_dim,
                              mode="batched").start()
        try:
            cli = EmbeddingClient("127.0.0.1", srv.port, cfg.num_tables,
                                  cfg.embedding_dim)
            try:
                t0 = time.perf_counter()
                got_f = [cli.request_batch(idx) for _, idx, _ in
                         scored_a[:4]]
                dt_f = time.perf_counter() - t0
            finally:
                cli.close()
        finally:
            srv.stop()
        for (_, idx, _), rows in zip(scored_a[:4], got_f):
            if not np.array_equal(rows.view(np.int32),
                                  store_rows(idx).view(np.int32)):
                raise AssertionError("(f): the served rows differ from the "
                                     "store's")
        print(f"3d(f) EmbeddingServer batched over a fresh fp32 C1 of the "
              f"engine, 127.0.0.1 [{card}]: 4 batches of 2048 in "
              f"{dt_f:.3f} s = {4 * 2048 / dt_f:.1f} requests/s, rows "
              f"bit-exact vs the store's; engine stats "
              f"{json.dumps(eng_f.stats())}", flush=True)
        eng_f.close()
        mm.close()
        tmp3d.cleanup()
        if host_launches["interaction_fwd"] < 1:
            raise AssertionError(f"K1 never ran on the host tiers' path: "
                                 f"{host_launches}")
        host_launches = {"interaction_fwd": host_launches["interaction_fwd"]}
        del res_a, res_b, res_c, res_d, res_n, res_g, got_f, alts, resolver
        torch.cuda.empty_cache()

    # ------------------------------------------------------ 3b train
    with Phase("3b train"):
        del res, res2, res3, model, storage
        torch.cuda.empty_cache()
        B = 128                 # the reference recipe's batch and lr
        tcfg = TrainConfig(learning_rate=0.1, optimizer="rwsadagrad")
        sgd = dataclasses.replace(tcfg, optimizer="sgd")
        off_cfg = dataclasses.replace(cfg, use_interaction_kernel=False,
                                      use_gather_kernel=False)
        off_tcfg = dataclasses.replace(tcfg, use_update_kernel=False)
        stream = iter(list(random_batches(RandomDataConfig(
            num_dense=cfg.num_dense_features, table_sizes=cfg.table_sizes,
            batch_size=B, num_batches=5 + 5 + 5 + 2 * (3 + 3 * 20) + 2,
            seed=args.seed + 3, distribution="grouped_zipf",
            zipf_alpha=1.05, group_noise=0.1))))

        def take(n):
            return [next(stream) for _ in range(n)]

        reset_counts()
        t0 = time.perf_counter()
        model = DLRM(cfg, device=dev, seed=args.seed, tables=tables)
        plain = DLRM(off_cfg, device=dev, seed=args.seed, tables=tables)
        torch.cuda.synchronize()
        print(f"set-up: two copies of the model on the card in "
              f"{time.perf_counter() - t0:.2f} s, "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")

        # five rwsadagrad steps, every kernel on, each held to a step with
        # every kernel off taken from the same state; then five more from
        # one state, compounding, held to the same rule after every step.
        # The per-step loss sees only the forward (K1, K2); the compounded
        # losses see K4 and K5 through the state they leave behind.
        step_k, step_p = (make_train_step(cfg, tcfg),
                          make_train_step(off_cfg, off_tcfg))
        st_k, st_p = init_opt_state(model, tcfg), init_opt_state(plain,
                                                                 off_tcfg)

        @torch.no_grad()
        def sync():
            plain.load_state_dict(model.state_dict())
            for part in ("dense", "sparse"):
                for k, v in getattr(st_k, part).items():
                    getattr(st_p, part)[k].copy_(v)

        def check(dense, idx, y, worst):
            """One step on each copy; raises if they disagree, and keeps the
            worst loss, weight and accumulator differences in `worst`."""
            lk = float(step_k(model, st_k, dense, idx, y))
            lp = float(step_p(plain, st_p, dense, idx, y))
            worst["loss"] = max(worst["loss"], abs(lk - lp) / abs(lp))
            if not abs(lk - lp) <= 1e-5 * abs(lp):
                raise AssertionError(f"loss {lk} with the kernels, {lp} "
                                     "without")
            pk, pp = dense_parameters(model), dense_parameters(plain)
            pairs = [("mlp", n, pk[n], pp[n]) for n in pk]
            pairs += [("table", t, model.tables[t], plain.tables[t])
                      for t in range(cfg.num_tables)]
            for kind, what, a, b in pairs:
                a, b = a.detach(), b.detach()
                rel = float(((a - b).abs() / (1 + b.abs())).max())
                worst[kind] = max(worst[kind], rel)
                if not rel <= 1e-4:
                    raise AssertionError(f"{kind} {what} differs, kernels on "
                                         f"vs off: max|d|/(1+|ref|) {rel}")
            for part in ("dense", "sparse"):
                for k, v in getattr(st_p, part).items():
                    ok, rel = within_own(getattr(st_k, part)[k], v, 1e-4)
                    worst["acc"] = max(worst["acc"], rel)
                    if not ok:
                        raise AssertionError(
                            f"accumulator {k} differs, kernels on vs off: "
                            f"max|d|/(|ref| + mean nonzero |ref|) {rel}")

        for mode in ("each from one state", "compounded from one state"):
            worst = dict.fromkeys(("loss", "mlp", "table", "acc"), 0.0)
            sync()
            for dense, idx, y in take(5):
                if mode.startswith("each"):
                    sync()
                check(dense, idx, y, worst)
            print(f"kernels on vs off, 5 rwsadagrad steps {mode}: max rel "
                  f"loss diff {worst['loss']:.3e} (limit 1e-5); max|d|/"
                  f"(1+|ref|) MLPs {worst['mlp']:.3e}, tables "
                  f"{worst['table']:.3e} (limit 1e-4); accumulators max|d|/"
                  f"(|ref| + mean nonzero |ref|) {worst['acc']:.3e} (limit "
                  f"1e-4)", flush=True)
        del plain, st_p
        torch.cuda.empty_cache()

        # where a step's time goes: the device's busy time (its kernels and
        # copies) and the host time of the step's four spans, over 5 steps
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for dense, idx, y in take(5):
                step_k(model, st_k, dense, idx, y)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # the spans appear twice: as host ranges and as device-side
        # annotations over their kernels; busy time counts kernels and
        # copies only
        cuda = torch.autograd.DeviceType.CUDA
        events = prof.events()
        spans = {}
        for e in events:
            if e.name.startswith("train_step.") and e.device_type != cuda:
                spans[e.name[11:]] = spans.get(e.name[11:], 0.0) \
                    + e.cpu_time_total / 5e3
        on_card = {}
        for e in events:
            if e.device_type == cuda and not e.name.startswith("train_step."):
                n, t = on_card.get(e.name, (0, 0.0))
                on_card[e.name] = (n + 1, t + e.device_time_total / 1e3)
        busy_ms = sum(t for _, t in on_card.values())
        per_step = sum(n for n, _ in on_card.values()) / 5
        if busy_ms > 0:
            top = sorted(on_card.items(), key=lambda kv: -kv[1][1])[:5]
            print(f"profile of 5 rwsadagrad steps [{card}]: wall "
                  f"{wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
                  f"({100 * busy_ms / wall_ms:.1f}% of the profiled wall "
                  f"time, which includes the profiler's own cost) in "
                  f"{sum(n for n, _ in on_card.values())} kernels and copies "
                  f"({per_step:.1f} a step); host ms per step: " + ", ".join(
                      f"{k} {v:.3f}" for k, v in spans.items())
                  + "; top on the card: " + "; ".join(
                      f"{k[:40]} {t:.3f} ms x{n}" for k, (n, t) in top))
        else:
            print("profile: no device time in the trace; device busy share "
                  "not measured")

        # timed: 3 warm-up steps, then 3 windows of 20 steps each, through
        # train(); the median window and the spread of the three
        rates = {}
        for opt in (tcfg, sgd):
            train(model, cfg, opt, take(3))
            runs = sorted(train(model, cfg, opt, take(20))[2]["it_per_s"]
                          for _ in range(3))
            rates[opt.optimizer] = runs[1]
            print(f"train {opt.optimizer} B={B} lr {opt.learning_rate} "
                  f"[{card}]: {runs[1]:.2f} steps/s, {runs[1] * B:.1f} "
                  f"samples/s (median of 3 windows of 20 steps; windows "
                  f"{', '.join(f'{r:.2f}' for r in runs)} steps/s)",
                  flush=True)
        print(f"rwsadagrad / sgd steps/s in this run: "
              f"{rates['rwsadagrad'] / rates['sgd']:.3f} (rwsadagrad's row "
              f"update is one grouped call, sgd's one per table)")
        if busy_ms > 0:
            step_ms = 1e3 / rates["rwsadagrad"]
            print(f"device busy per rwsadagrad step: {busy_ms / 5:.3f} ms, "
                  f"{100 * busy_ms / wall_ms:.1f}% of a step under the "
                  f"profiler ({wall_ms / 5:.2f} ms), "
                  f"{100 * busy_ms / 5 / step_ms:.1f}% of an unprofiled step "
                  f"({step_ms:.2f} ms, 1 / median steps/s)")
        metrics = evaluate(model, cfg, take(2))
        train_launches = {k: v for k, v in read_counts().items()
                          if k in ("interaction_fwd", "interaction_bwd",
                                   "gather_rows_grouped",
                                   "scatter_sub_sorted")}
        if min(train_launches.values()) < 1:
            raise AssertionError(f"a kernel of the path never ran: "
                                 f"{train_launches}")
        # one grouped gather per train or eval step, one row update per
        # rwsadagrad step with the kernels on: 5 + 5 checked, 5 profiled,
        # 3 + 3 x 20 through train(); sgd the same through train(); 2 eval
        rws_steps = 5 + 5 + 5 + (3 + 3 * 20)
        want = {"gather_rows_grouped": rws_steps + (3 + 3 * 20) + 2,
                "scatter_sub_sorted": rws_steps}
        got = {k: train_launches[k] for k in want}
        if got != want or read_counts()["gather_rows"] != 0:
            raise AssertionError(f"train path launches {read_counts()}, "
                                 f"expected {want} and no flat gather")
        print(f"train path launches: {json.dumps(got)} (one grouped gather "
              f"per train or eval step, one row update per rwsadagrad step)")
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"evaluate gave {metrics}")
        print(f"evaluate over 2 batches: auc {metrics['auc']:.4f}, accuracy "
              f"{metrics['accuracy']:.4f} (random weights and labels)")

    # ---------------------------------------------------- 4 kernels line
    with Phase("4 kernels line"):
        print(f"kernels: serve {json.dumps(serve_launches)}; serve_int8 "
              f"{json.dumps(int8_launches)}; serve_host "
              f"{json.dumps(host_launches)}; gram_ab "
              f"{json.dumps(gram_launches)}; train "
              f"{json.dumps(train_launches)}")
        sources = {
            "interaction_fwd": ("evstore_tpu_torch/csrc/interaction_fwd.cu",
                                "evstore_tpu/ops/pallas_interaction.py:178"),
            "gather_rows": ("evstore_tpu_torch/csrc/gather_rows.cu",
                            "evstore_tpu/ops/pallas_gather.py:34"),
            "gather_rows_grouped": ("evstore_tpu_torch/csrc/gather_rows.cu",
                                    "evstore_tpu/ops/pallas_gather.py:34"),
            "gather_rows_dequant_int8": (
                "evstore_tpu_torch/csrc/gather_rows_dequant_int8.cu",
                "evstore_tpu/ops/pallas_gather.py:88"),
            "interaction_bwd": ("evstore_tpu_torch/csrc/interaction_bwd.cu",
                                "evstore_tpu/ops/pallas_interaction.py:213"),
            "interaction_gram": (
                "evstore_tpu_torch/csrc/interaction_gram.cu",
                "evstore_tpu/ops/pallas_interaction.py:41"),
            "scatter_sub_sorted": ("evstore_tpu_torch/csrc/row_update.cu",
                                   "evstore_tpu/ops/pallas_update.py:60"),
        }
        paths = {"serve": serve_launches, "serve_int8": int8_launches,
                 "serve_host": host_launches, "gram_ab": gram_launches,
                 "train": train_launches}
        by_path = {name: {path: counts.get(name, 0)
                          for path, counts in paths.items()}
                   for name in sources}
        idle = [name for name in sources if not sum(by_path[name].values())]
        if idle or set(sources) != set(wrappers):
            raise AssertionError(f"kernels that launched on no path: {idle}")
        line = {"kernels": [
            {"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": sum(by_path[name].values()),
             "launches_by_path": by_path[name], "device_ms": None,
             **report[name]}
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
