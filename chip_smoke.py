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
   of 20 after warm-up) beside the least time the card could take; K1 bit
   for bit against the two-stage Gram forward (K6) on the same inputs, and
   both against the plain version, at the cases that break their grouped
   designs too (B = 1, 3, 127, 128, 129, 2049, 65,536; D = 4, 7, 64 and
   128; self_interaction; inputs 4 bytes off a 16-byte boundary); K4 at
   the same kind of cases, each launched twice (bitwise equal); beside
   K1's, K4's and K6's f32 times at B = 128, 2048 and 65,536, and K6's
   bf16 time at 65,536, their device and host µs; K3 at R = 2048·26 and
   65,536·26 with its device and host µs, and at the cases that break a
   unit design (R = 1, 3, 1025; D = 4, 7, 8, 36, 64; indices at the two
   sources' edges and out of range; no secondary; sources 1 and 4 bytes
   off a 16-byte boundary), each launched twice, bit for bit; a K1 case
   whose output row is too wide to stage;
   K6's op `DotInteractionGram`, forward and backward,
   against `DotInteraction` and the plain forward and VJP; the grouped
   gather (K2 over the 26 Kaggle tables at idx [128, 26]) bit for bit; K5
   on Zipf ids, on the cases that break a chunked design (one run of all
   entries, runs from chunk boundaries, K=1, K = E*m +- 1, all PAD_ROW; f32
   and bf16), each launched twice on copies of one table (bitwise equal),
   and grouped over the 26 tables at K = 3,328; beside each K2 and K5 time,
   the kernel's device time (profiler) and the wrapper's host time;
2b. K2 grouped bit for bit and K5 grouped against their plain versions at
   the widths phase 3e adds (1: pooling weights; 18: qr concat's q and r;
   md_solver's widths below 36), f32 and bf16 (a bf16 row of odd width
   is K2's 2-byte path), over the Kaggle tables' row counts and one bagged
   batch's index [1280, S], each K5 case launched twice (bitwise equal),
   with event times beside the plain versions';
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
   MLP must give (b)'s scores bit for bit, and K6's interaction K1's; (g)
   the engine's host path at phase 3's C1 with the tables in RAM, and
   beside it the table-partitioned engine (`NativeShardedCache`) over the
   same tables at 1, 2, 4 and 8 workers on the same batches: scores equal
   to the serial engine's bit for bit, rows to the store's, at 1 worker
   the serial engine's stats, at more C1's hit rate within 0.05 of it;
   (f) the TCP service in batched mode over a fresh fp32 C1 of the
   engine, its rows equal to the store's; each run prints requests/s,
   p50/p99, stats and its host split;
3b. the training path: the same model with phase 3's tables on the card,
   trained at the reference recipe's batch of 128 and lr 0.1 by
   `make_train_step` and `train` (rwsadagrad, then sgd), with steps/s and a
   profile of where a step's time goes; each of five rwsadagrad steps with
   every kernel on must equal a step with every kernel switched off taken
   from the same state, and so must five more that compound from one
   state; then `evaluate`; the device µs a step of K1, K2, K4 and K5;
   the four kernels' launch counts over this phase
   must be above 0, with one grouped gather per train or eval step and one
   grouped row update per rwsadagrad step; kernels and copies per step and
   the rwsadagrad / sgd rate (both row updates grouped through K5), sgd's
   rate beside its rate when it updated table by table, and the kernels
   and copies of an sgd step;
3e. factored training at the same widths with bags of up to 10 ids
   (grouped_zipf, B=128, lr 0.1): (a) learned pooling weights under sgd,
   adagrad and rwsadagrad, (b) qr tables (threshold 200, 4 collisions,
   mult, q and r drawn at their own scale) under sgd, (c) md tables
   (threshold 200, temperature -0.3, 17 projections) under rwsadagrad; per
   optimizer one step with every kernel on against one with every kernel
   off from the fresh state (printed), 3 warm-up steps, three such steps
   each from one state held to phase 3b's rule (elementwise for the MLPs
   and md projections) and, for each row-updated parameter, its step
   change held to the plain copy's within 1e-2 of the latter's norm, two 10-step windows (steps/s), one profiled step (kernels and
   copies, device busy share), two steps with every synchronising CUDA
   call an error and torch.unique counted (must be 0); `evaluate` over 2
   bagged batches; exactly one K2 launch per width group and one K5 launch
   per update group a step, K1 and K4 at least once;
3f. the CLI end to end at the full Kaggle width, in this process through
   `evstore_tpu_torch.cli.main`: a synthetic train.txt (100,000 lines,
   categories capped by each table's rows) preprocessed and trained with
   bench/dlrm_s_criteo_kaggle.sh's flags (sgd, lr 0.1, B=128) and
   `--test-freq -1`, so that the final eval writes one checkpoint and one
   EV export; a resume from `--load-model`, which must skip every step and
   save the restored state again bit for bit; the exported tables held to
   the checkpoint's bit for bit; then the exported tables served with the
   flags of bench/dlrm_s_criteo_kaggle_C1.sh (Python EvLFU over mmap),
   bench/dlrm_s_criteo_kaggle_C1_C2_C3.sh (the engine over the files) and
   the C1 script's with `--use-device-cache True`, beside the plain eval
   of the same checkpoint: the fp32 paths' metrics equal to it (atol 1e-6,
   AUC within one tied pair), C2 live in the three-tier run; it prints
   the preprocess rate, steps/s, and the seconds and GB/s of the
   checkpoint save, the restore and the EV export;
4. the kernels' launch counts by path (serve, serve_int8, serve_host,
   gram_ab, train, train_factored, cli) and one JSON line describing every
   kernel, each of which must have launched on some path;
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
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
PHASE_BUDGET_S = {"0 environment": 30, "1 build": 180,
                  "2 kernels vs plain": 150, "2b grouped widths": 90,
                  "3 main path": 200, "3c three tiers int8": 200,
                  "3d host tiers": 240, "3b train": 240,
                  "3e train factored": 240, "3f cli": 420,
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


def device_host_us(torch, fn, reps: int = 20, calls: int = 200):
    """(device us per call, host us per call): the device time of every
    kernel `fn` launches, summed over `reps` calls traced by torch.profiler
    (the CUDA activity alone, so no op is counted twice); time.perf_counter
    over `calls` unsynchronised calls.  The host time is what the call
    costs before the device sees its launches."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    # a trace now and then comes back empty after many traces in one
    # process (seen once on the H100); trace again, at most twice
    for attempt in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev_us = sum(e.device_time_total for e in prof.key_averages()
                     if e.device_type == cuda) / reps
        if dev_us > 0:
            break
        print(f"  the profiler saw no kernel (trace {attempt + 1} of 3)",
              flush=True)
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


def profile_steps(torch, run, n: int):
    """`run()` n times under torch.profiler: (wall ms, {kernel or copy name:
    (count, device ms)}).  Busy time counts kernels and copies only, not
    the spans' device-side annotations."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    on_card = {}
    for e in prof.events():
        if e.device_type == cuda and not e.name.startswith("train_step."):
            c, t = on_card.get(e.name, (0, 0.0))
            on_card[e.name] = (c + 1, t + e.device_time_total / 1e3)
    return wall_ms, on_card


# each kernel of the train path by its function's name (K5 is two)
TRAIN_KERNELS = {"K1 interaction_fwd": ("interaction_fwd_kernel",),
                 "K2 gather_rows_grouped": ("Grouped<",),
                 "K4 interaction_bwd": ("interaction_bwd_kernel",),
                 "K5 scatter_sub_sorted": ("chunk_sums_kernel",
                                           "cross_chunk_kernel")}


def by_kernel(on_card, n: int) -> str:
    """Device µs and device kernels a step (K5's launch is two kernels),
    by kernel of the train path, as the trace saw them."""
    return ", ".join(
        f"{label} " + "{:.2f} us ({:g} kernels)".format(
            sum(t for k, (_, t) in on_card.items()
                if any(f in k for f in funcs)) * 1e3 / n,
            sum(c for k, (c, _) in on_card.items()
                if any(f in k for f in funcs)) / n)
        for label, funcs in TRAIN_KERNELS.items())


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
    from evstore_tpu_torch.native import NativeShardedCache, NativeTieredCache
    from evstore_tpu_torch.config import (CacheConfig, TrainConfig,
                                          kaggle_dlrm_config)
    from evstore_tpu_torch.data.synthetic import (RandomDataConfig,
                                                  random_batches)
    from evstore_tpu_torch.drivers.infer import build_cache, run_inference
    from evstore_tpu_torch.models.dlrm import DLRM
    from evstore_tpu_torch.models.embedding import (flat_ids, gather_groups,
                                                    group_ids,
                                                    init_embedding_tables,
                                                    init_qr_tables,
                                                    row_sources, table_kinds)
    from evstore_tpu_torch.native import build as engine_build
    from evstore_tpu_torch.ops.cuda_gather import (
        gather_rows, gather_rows_dequant_int8, gather_rows_dequant_int8_ref,
        gather_rows_grouped, gather_rows_grouped_ref, gather_rows_ref)
    from evstore_tpu_torch.ops.cuda_interaction import (
        DotInteraction, DotInteractionGram, dot_interaction_bwd_kernel,
        dot_interaction_bwd_ref, dot_interaction_gram_kernel,
        dot_interaction_kernel, dot_interaction_ref, gram_geometry,
        interaction_geometry)
    from evstore_tpu_torch.ops.cuda_update import (
        CHUNK, scatter_sub_sorted, scatter_sub_sorted_grouped_ref,
        scatter_sub_sorted_ref)
    from evstore_tpu_torch.ops.interaction import num_pairs
    from evstore_tpu_torch.ops.quant import (dequantize, dequantize_int8,
                                             np_quantize_int8)
    from evstore_tpu_torch.train.optim import (PAD_ROW, dense_parameters,
                                               update_groups)
    from evstore_tpu_torch.train.train_loop import (evaluate, init_opt_state,
                                                    make_train_step, train,
                                                    unpack_batch)
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
                    if "Compiling entry" in line or "registers" in line \
                            or "spill" in line:
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

    # -------------------------------------- 2b grouped kernels, new widths
    BAG_B, BAG_L = 128, 10      # the recipe's batch; the reference's bags

    def bag_stream(fcfg, seed: int, n: int):
        """The factored phases' requests: grouped_zipf ids (alpha 1.05,
        group noise 0.1) in bags of up to BAG_L, sizes U[1, BAG_L] (the
        reference's random-data default), with their 0/1 bag weights."""
        return list(random_batches(RandomDataConfig(
            num_dense=fcfg.num_dense_features, table_sizes=fcfg.table_sizes,
            batch_size=BAG_B, num_batches=n, seed=seed,
            distribution="grouped_zipf", zipf_alpha=1.05, group_noise=0.1,
            num_indices_per_lookup=BAG_L)))

    def phase_2b():
        """K2 grouped bit for bit and K5 grouped against their plain
        versions at the widths phase 3e adds: 1 (pool_w), 18 (qr concat's
        q and r) and md_solver's widths below 36, f32 and bf16, over the
        Kaggle tables' row counts and the index [B·L, S] of one bagged
        batch."""
        with Phase("2b grouped widths"):
            base = kaggle_dlrm_config()
            bag = bag_stream(base, args.seed + 7, 1)[0]
            flat = flat_ids(torch.from_numpy(bag[1])).to(dev)
            for dt, (label, kw) in ((dt, v) for dt in ("float32",
                                                        "bfloat16") for v in (
                    ("pool_w", dict(weighted_pooling="learned")),
                    ("qr concat", dict(qr_flag=True, qr_operation="concat")),
                    ("md (temperature -0.3)", dict(md_flag=True,
                                                   md_temperature=-0.3)))):
                tdt = getattr(torch, dt)
                bits = torch.int32 if dt == "float32" else torch.int16
                fcfg = kaggle_dlrm_config(**kw)
                sources = row_sources(fcfg)
                for members in gather_groups(sources):
                    srcs = [sources[i] for i in members]
                    w = srcs[0].width
                    if w == fcfg.embedding_dim:      # phase 2's width
                        continue
                    tabs = [torch.empty(s.rows, w, device=dev).uniform_(
                        -float(np.sqrt(1.0 / s.rows)),
                        float(np.sqrt(1.0 / s.rows)), generator=gen).to(tdt)
                        for s in srcs]
                    ids = group_ids(sources, members, flat)
                    R, S = ids.shape
                    got = gather_rows_grouped(tabs, ids)
                    ref = gather_rows_grouped_ref(tabs, ids)
                    torch.cuda.synchronize()
                    if not torch.equal(got.view(bits), ref.view(bits)):
                        raise AssertionError(f"gather_rows_grouped differs "
                                             f"at {label} width {w} {dt}")
                    bases = torch.tensor(
                        np.concatenate([[0], np.cumsum(
                            [s.rows for s in srcs])]), device=dev)
                    rows = torch.sort((ids.long() + bases[:-1]).reshape(-1)
                                      )[0].to(torch.int32)
                    K = rows.numel()
                    uniq = int(torch.unique(rows).numel())
                    rb = w * tabs[0].element_size()
                    g_bms, g_by = bound_ms(uniq * rb + R * S * 4 + R * S * rb,
                                           0.0, "float32")
                    g_ms = time_ms(torch, lambda: gather_rows_grouped(
                        tabs, ids))
                    g_pms = time_ms(torch, lambda: gather_rows_grouped_ref(
                        tabs, ids))
                    vals = torch.randn(K, w, generator=gen, device=dev) * 1e-3
                    twice = [t.clone() for t in tabs]
                    ref_tabs = [t.clone() for t in tabs]
                    scatter_sub_sorted(tabs, rows, vals)
                    scatter_sub_sorted(twice, rows, vals)
                    scatter_sub_sorted_grouped_ref(ref_tabs, rows, vals)
                    torch.cuda.synchronize()
                    err = 0.0
                    for t, (a_, b_, c_) in enumerate(zip(tabs, ref_tabs,
                                                         twice)):
                        ok, e_ = within(a_, b_, 1e-6, dt == "bfloat16")
                        err = max(err, e_)
                        if not ok or not torch.equal(a_, c_):
                            raise AssertionError(
                                f"grouped scatter_sub_sorted differs or is "
                                f"not deterministic at {label} width {w}, "
                                f"table {t}: max|d| {e_}")
                    s_bms, s_by = bound_ms(K * 4 + K * w * 4 + 2 * uniq * rb,
                                           float(K * w + uniq * w),
                                           "float32")
                    s_ms = time_ms(torch, lambda: scatter_sub_sorted(
                        tabs, rows, vals))
                    s_pms = time_ms(torch, lambda: scatter_sub_sorted_grouped_ref(
                        ref_tabs, rows, vals))
                    print(f"{label} width {w} {dt}, {S} tables "
                          f"({sum(s.rows for s in srcs)} rows), idx [{R}, "
                          f"{S}] of one bagged batch: gather_rows_grouped "
                          f"bit-exact, kernel_ms {g_ms:.4f} plain_ms "
                          f"{g_pms:.4f} bound_us {g_bms * 1e3:.2f} ({g_by}); "
                          f"scatter_sub_sorted K={K}, {uniq} rows, max|d| "
                          f"{err:.3e}, two launches bitwise equal, kernel_ms "
                          f"{s_ms:.4f} plain_ms {s_pms:.4f} bound_us "
                          f"{s_bms * 1e3:.2f} ({s_by}) [{card}]", flush=True)
                    del tabs, twice, ref_tabs, got, ref
                torch.cuda.empty_cache()

    # ------------------------------------------------------- 3f the CLI
    CLI_LINES = 100_000     # lines of the synthetic train.txt
    CLI_VOCAB = 1_000_000   # categorical values a column, capped by the table

    class Tee:
        """stdout for the CLI's runs: every line is kept, and printed
        unless it is an MLPerf record."""

        def __init__(self, out):
            self.out, self.buf, self.text = out, "", []

        def write(self, s):
            self.buf += s
            while "\n" in self.buf:
                line, self.buf = self.buf.split("\n", 1)
                self.text.append(line)
                if not line.startswith(":::MLLOG"):
                    self.out.write(line + "\n")
            return len(s)

        def flush(self):
            self.out.flush()

    def bench_flags(script):
        """The flags a bench/ script passes to the CLI."""
        with open(os.path.join("bench", script)) as f:
            lines = f.read().splitlines()
        at = next(i for i, x in enumerate(lines) if "python -m" in x)
        flags = []
        for x in lines[at + 1:]:
            if "$dlrm_extra_option" in x:
                break
            flags += x.replace("\\", " ").split()
        return flags

    def metrics_of(text):
        """A printed metrics dict -> {name: float} (nan for nan)."""
        return {k: float(v) for k, v in re.findall(
            r"'(\w+)': (nan|[-\d.e]+)", text)}

    def phase_3f():
        """The CLI end to end at the full Kaggle width through
        `cli.main`: preprocess a synthetic train.txt and train with
        bench/dlrm_s_criteo_kaggle.sh's flags (one final eval writes one
        checkpoint and one EV export), resume from the checkpoint (every
        step skipped; the state it restores and saves again must be the
        saved one bit for bit), hold the exported tables to the
        checkpoint's bit for bit, then serve the exported tables with the
        C1 script's flags, the C1+C2+C3 script's and C1 on the device
        cache, beside the plain eval of the same checkpoint.  Each CLI run
        is counted on the `cli` path, its counts set to 0 just before."""
        import contextlib
        import hashlib

        from evstore_tpu_torch import cli
        from evstore_tpu_torch.data.criteo import (CriteoDataset,
                                                   make_synthetic_criteo_txt)
        from evstore_tpu_torch.utils.checkpoint import (
            checkpoint_path, latest_step, load_ev_tables_into_params,
            restore_checkpoint)
        launches = dict.fromkeys(wrappers, 0)

        def run(argv):
            """cli.main(argv) in this process: -> its stdout."""
            reset_counts()
            tee = Tee(sys.stdout)
            with contextlib.redirect_stdout(tee):
                rc = cli.main(argv)
            for k, v in read_counts().items():
                launches[k] += v
            torch.cuda.empty_cache()
            if rc != 0:
                raise AssertionError(f"cli.main returned {rc}")
            return "\n".join(tee.text)

        def grab(pattern, text, what):
            m = re.search(pattern, text)
            if m is None:
                raise AssertionError(f"no {what} in the CLI's output")
            return m.groups()

        def digests(path):
            """sha256 of every tensor of a checkpoint, by name, and its
            optimizer step."""
            state = torch.load(path, map_location="cpu", mmap=True,
                               weights_only=True)
            out = {k: hashlib.sha256(v.contiguous().view(torch.uint8)
                                     .numpy()).hexdigest()
                   for k, v in state["model"].items()}
            out["opt.step"] = state["opt"]["step"]
            return out

        with Phase("3f cli"):
            tmp = tempfile.TemporaryDirectory()
            d = tmp.name
            try:
                train_flags = bench_flags("dlrm_s_criteo_kaggle.sh")
                kcfg, _, _ = cli.configs_from_args(
                    cli.build_parser().parse_args(train_flags))
                sizes = kcfg.table_sizes
                txt = os.path.join(d, "train.txt")
                t0 = time.perf_counter()
                make_synthetic_criteo_txt(
                    txt, n=CLI_LINES, seed=args.seed + 11,
                    vocab=[min(n, CLI_VOCAB) for n in sizes])
                print(f"synthetic train.txt: {CLI_LINES} lines, categories "
                      f"in [0, min(table rows, {CLI_VOCAB})), in "
                      f"{time.perf_counter() - t0:.2f} s", flush=True)
                ck, ev = os.path.join(d, "ck"), os.path.join(d, "ev")
                out_dir = os.path.join(d, "out")
                train_argv = train_flags + [
                    "--raw-data-file", txt, "--output-dir", out_dir,
                    "--save-model", ck, "--ev-table-path", ev,
                    "--test-freq", "-1"]
                print("train: bench/dlrm_s_criteo_kaggle.sh's flags + "
                      "--raw-data-file --output-dir --save-model "
                      "--ev-table-path --test-freq -1", flush=True)
                out = run(train_argv)
                pre = grab(r"preprocessed \S+: (\d+) lines in ([\d.]+) s "
                           r"\((\d+) lines/s\)", out, "preprocess line")
                trained = grab(r"trained (\d+) steps in ([\d.]+) s "
                               r"\(([\d.]+) steps/s\)", out, "step rate")
                saved = grab(r"checkpoint step_(\d+): ([\d.]+) GB in "
                             r"([\d.]+) s \(([\d.]+) GB/s\)", out,
                             "checkpoint line")
                exported = grab(r"EV tables exported: ([\d.]+) GB in "
                                r"([\d.]+) s \(([\d.]+) GB/s\)", out,
                                "export line")
                step = latest_step(ck)
                pf = os.path.join(out_dir, "processed",
                                  "kaggle_processed.npz")
                ds = CriteoDataset.load(pf)
                n_train = ds.splits()[0][1] // 128
                if int(trained[0]) != n_train or step != n_train or \
                        int(saved[0]) != step:
                    raise AssertionError(f"trained {trained[0]} steps of "
                                         f"{n_train}, checkpoint at {step}")
                first = digests(checkpoint_path(ck, step))
                with open(os.path.join(ck, f"step_{step}.meta.json")) as f:
                    meta = json.load(f)

                # resume: --load-model beside the same --save-model
                out = run(train_argv + ["--load-model", ck])
                restored = grab(r"resumed from checkpoint step (\d+) "
                                r"\(([\d.]+) GB in ([\d.]+) s, ([\d.]+) "
                                r"GB/s\)", out, "resume line")
                if int(restored[0]) != step or \
                        "trained 0 steps" not in out:
                    raise AssertionError("the resumed run did not skip "
                                         "every step")
                again = digests(checkpoint_path(ck, step))
                with open(os.path.join(ck, f"step_{step}.meta.json")) as f:
                    meta2 = json.load(f)
                if again != first or meta2 != meta:
                    bad = [k for k in first if first[k] != again.get(k)]
                    raise AssertionError(f"the restored state saved again "
                                         f"differs: {bad[:5]}, "
                                         f"{meta} / {meta2}")
                print(f"resume: restored step {step} and saved it again, "
                      f"{len(first) - 1} tensors bit for bit; the final "
                      f"eval's metrics the same ({meta['extra']})",
                      flush=True)

                # the exported tables against the checkpoint's
                empty = [torch.empty((n, kcfg.embedding_dim), device=dev)
                         for n in sizes]
                m_ck = DLRM(kcfg, device=dev, tables=empty)
                m_ev = DLRM(kcfg, device=dev, tables=empty)
                del empty
                restore_checkpoint(ck, step, m_ck,
                                   init_opt_state(m_ck, TrainConfig()))
                load_ev_tables_into_params(m_ev, ev)
                for t in range(len(sizes)):
                    if not torch.equal(m_ck.tables[t], m_ev.tables[t]):
                        raise AssertionError(f"exported table {t} differs "
                                             f"from the checkpoint's")
                print(f"EV export: the {len(sizes)} .bin tables equal the "
                      f"checkpoint's bit for bit (load_ev_tables_into_params "
                      f"against restore_checkpoint)", flush=True)
                del m_ck, m_ev
                torch.cuda.empty_cache()

                # serving the exported tables, beside the plain eval
                pct = "1.0"
                labels = np.concatenate([y for _, _, y in ds.batches(
                    "test", 128, fraction=float(pct), drop_last=True)])
                n_batches = len(labels) // 128
                if n_batches < 16:
                    raise AssertionError(f"{n_batches} test batches")
                n_pos = int(labels.sum())
                tie = 1.0 / max(n_pos * (len(labels) - n_pos), 1)
                common = ["--processed-data-file", pf, "--load-model", ck,
                          "--percent-data-for-inference", pct]
                out = run(train_flags + ["--inference-only"] + common)
                ref = metrics_of(grab(r"inference done: (\{.*\})", out,
                                      "plain metrics")[0])
                print(f"plain eval (--use-evstore False), {n_batches} test "
                      f"batches of 128 ({n_pos} clicks): {ref}", flush=True)
                c1 = bench_flags("dlrm_s_criteo_kaggle_C1.sh")
                for label, flags, fp32 in (
                        ("C1 (bench/dlrm_s_criteo_kaggle_C1.sh)", c1, True),
                        ("C1+C2+C3 (bench/dlrm_s_criteo_kaggle_C1_C2_C3.sh)",
                         bench_flags("dlrm_s_criteo_kaggle_C1_C2_C3.sh"),
                         False),
                        ("C1 on the device cache (the C1 script's flags + "
                         "--use-device-cache True)",
                         c1 + ["--use-device-cache", "True"], True)):
                    cdf = os.path.join(d, "cdf.csv")
                    out = run(flags + common + [
                        "--ev-table-path", ev, "--write-cdf-file", cdf])
                    m = metrics_of(grab(r"inference done: metrics=(\{.*?\}) "
                                        r"perfect_hits", out, "metrics")[0])
                    stats = json.loads(grab(r"cache stats: (\{.*\})", out,
                                            "cache stats")[0])
                    rate = grab(r"inference: (\d+) requests in [\d.]+s "
                                r"\((\d+) req/s\)", out, "request rate")
                    if m.keys() != ref.keys() or not all(
                            np.isfinite(v) for v in m.values()) or \
                            not os.path.exists(cdf):
                        raise AssertionError(f"{label}: {m}")
                    if fp32:
                        for k, v in ref.items():
                            tol = tie + 1e-12 if k == "auc" else 1e-6
                            if abs(m[k] - v) > tol:
                                raise AssertionError(
                                    f"{label}: {k} {m[k]} against the plain "
                                    f"eval's {v}")
                    else:
                        c2 = stats.get("c2", {})
                        if c2.get("size", 0) <= 0 or \
                                c2.get("hit_rate", 0.0) <= 0.0:
                            raise AssertionError(f"{label}: C2 is not live: "
                                                 f"{stats}")
                    print(f"3f serve {label} [{card}]: {rate[0]} requests "
                          f"scored after a warm-up pass over the same, "
                          f"{rate[1]} requests/s; metrics "
                          f"{'equal the plain eval' if fp32 else 'int8/4-bit'}"
                          f": auc {m['auc']:.6f}, accuracy "
                          f"{m['accuracy']:.6f}; stats {json.dumps(stats)}",
                          flush=True)
                print(f"3f [{card}]: preprocess {pre[0]} lines in {pre[1]} "
                      f"s = {pre[2]} lines/s; train {trained[0]} steps in "
                      f"{trained[1]} s = {trained[2]} steps/s (B=128, sgd, "
                      f"lr 0.1, bf16 compute); checkpoint save {saved[1]} GB "
                      f"in {saved[2]} s = {saved[3]} GB/s; restore "
                      f"{restored[1]} GB in {restored[2]} s = {restored[3]} "
                      f"GB/s; EV export {exported[0]} GB in {exported[1]} s "
                      f"= {exported[2]} GB/s", flush=True)
            finally:
                tmp.cleanup()
            path = {k: launches[k] for k in (
                "interaction_fwd", "interaction_bwd", "gather_rows",
                "gather_rows_grouped", "scatter_sub_sorted")}
            if min(path[k] for k in ("interaction_fwd", "interaction_bwd",
                                     "gather_rows_grouped",
                                     "scatter_sub_sorted")) < 1:
                raise AssertionError(f"a kernel of the CLI's path never ran: "
                                     f"{launches}")
            print(f"cli path launches: {json.dumps(path)}", flush=True)
            return path

    # ------------------------------------------ 3e train factored tables
    def phase_3e(tables):
        """Training at the Kaggle model's full width beyond one-hot plain
        tables: (a) bags with learned pooling weights (sgd, adagrad,
        rwsadagrad), (b) qr tables (sgd), (c) md tables with projections
        (rwsadagrad).  Returns the launch counts of the path."""
        with Phase("3e train factored"):
            reset_counts()
            prng = np.random.default_rng(args.seed + 8)

            def entries_for(fcfg):
                """Per table: phase 3's host table where the shapes allow
                (a plain table; an md table's first columns), q and r
                drawn at their own scale (`init_qr_tables`) and a
                projection, both from --seed; copied to the card once."""
                out = []
                for t, (kind, dim) in enumerate(table_kinds(fcfg)):
                    host = tables[t]
                    if kind == "qr":
                        e = {"kind_qr": init_qr_tables(
                            host.shape[0], fcfg.embedding_dim,
                            fcfg.qr_collisions, fcfg.qr_operation, prng)}
                    elif kind == "md":
                        e = {"kind_md": {"table": host[:, :dim]}}
                        if dim != fcfg.embedding_dim:
                            b = float(np.sqrt(2.0 / (dim + 36)))
                            e["kind_md"]["proj"] = prng.uniform(
                                -b, b, (dim, 36)).astype(np.float32)
                    else:
                        e = {"kind_plain": host}
                    out.append({k: ({kk: torch.from_numpy(vv).to(dev)
                                     for kk, vv in v.items()}
                                    if isinstance(v, dict) else
                                    torch.from_numpy(v).to(dev))
                                for k, v in e.items()})
                return out

            def call(step, m, st, b):
                d, i, y, w = unpack_batch(b)
                return step(m, st, d, i, y, w)

            def no_wait(step, m, st, bs):
                """Steps on device-resident inputs with every
                synchronising CUDA call an error
                (`torch.cuda.set_sync_debug_mode`) and torch.unique
                counted: returns the number of torch.unique calls."""
                dev_bs = [tuple(torch.from_numpy(x).to(dev) for x in b)
                          for b in bs]
                torch.cuda.synchronize()
                real, calls = torch.unique, [0]

                def counted(*a, **k):
                    calls[0] += 1
                    return real(*a, **k)

                torch.unique = counted
                torch.cuda.set_sync_debug_mode("error")
                try:
                    for b in dev_bs:
                        call(step, m, st, b)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                    torch.unique = real
                torch.cuda.synchronize()
                return calls[0]

            rates = {}
            want = {"gather_rows_grouped": 0, "scatter_sub_sorted": 0}
            cases = (
                ("a", "bags, learned pooling", dict(
                    weighted_pooling="learned"),
                 ("sgd", "adagrad", "rwsadagrad")),
                ("b", "bags, qr (threshold 200, 4 collisions, mult)",
                 dict(qr_flag=True), ("sgd",)),
                ("c", "bags, md (threshold 200, temperature -0.3)",
                 dict(md_flag=True, md_temperature=-0.3), ("rwsadagrad",)))
            print("md_temperature -0.3 in (c): the reference's md_solver "
                  "is given alpha = -md_temperature (the JAX package's "
                  "init_sparse_arch, copied by the port), so the CLI's 0.3 "
                  "gives every Kaggle md table width 36 and no projection; "
                  "-0.3 gives widths 1-36 and 17 projections")
            for key, label, kw, opts in cases:
                fcfg = kaggle_dlrm_config(**kw)
                off_cfg = dataclasses.replace(
                    fcfg, use_interaction_kernel=False,
                    use_gather_kernel=False)
                t0 = time.perf_counter()
                dev_entries = entries_for(fcfg)
                model = DLRM(fcfg, device=dev, seed=args.seed,
                             tables=dev_entries)
                plain = DLRM(off_cfg, device=dev, seed=args.seed,
                             tables=dev_entries)
                del dev_entries
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                sources = model.row_sources()
                kinds = [k for k, _ in table_kinds(fcfg)]
                sparse_gb = sum(p.numel() * 4 for n, p in
                                model.named_parameters()
                                if not n.startswith(("bot.", "top."))) / 1e9
                n_gather = len(gather_groups(sources))
                print(f"3e({key}) {label}: {kinds.count('plain')} plain, "
                      f"{kinds.count('qr')} qr, {kinds.count('md')} md "
                      f"tables, {sparse_gb:.2f} GB of sparse parameters a "
                      f"copy, {n_gather} width group(s) to gather; two "
                      f"copies on the card in {time.perf_counter() - t0:.2f}"
                      f" s, {torch.cuda.memory_allocated() / 1e9:.2f} GB "
                      f"allocated", flush=True)
                stream = iter(bag_stream(fcfg, args.seed + 9,
                                         30 * len(opts) + 2))

                def take(n):
                    return [next(stream) for _ in range(n)]

                for opt in opts:
                    tcfg = TrainConfig(learning_rate=0.1, optimizer=opt)
                    off_t = dataclasses.replace(tcfg,
                                                use_update_kernel=False)
                    step_k = make_train_step(fcfg, tcfg)
                    step_p = make_train_step(off_cfg, off_t)
                    st_k = init_opt_state(model, tcfg)
                    st_p = init_opt_state(plain, off_t)
                    updates = [u for u in update_groups(sources, opt)
                               if fcfg.weighted_pooling == "learned"
                               or sources[u.members[0]].part != "pool_w"]
                    n_upd = len(updates)
                    updated = [sources[i].name for u in updates
                               for i in u.members]
                    steps = 0

                    def on_vs_off(b, worst, hold):
                        """One step on each copy from the kernel copy's
                        state; with `hold`, raises past phase 3b's rule
                        (the loss, the accumulators, and elementwise the
                        parameters that no row update touches), or where
                        a row-updated parameter's step change (after -
                        before) differs from the plain copy's by more
                        than 1e-2 of the latter's norm.  Elementwise, a
                        row first touched under adagrad whose gradient G
                        cancels moves by up to about lr·ε/|G| between
                        two correct sums (1.1e-4 on the card).  A dropped,
                        doubled or misrouted update differs by 1 or more;
                        rounding differs by more the more a row's sum of
                        up to B·L entries cancels (an r row of 4 collects
                        a quarter of a table's 1280), and the plain copy's
                        `index_add_` sums in an order that changes from
                        run to run (1.3e-5 to 4.0e-4 across calls on the
                        card at --seed 0)."""
                        with torch.no_grad():
                            plain.load_state_dict(model.state_dict())
                            for part in ("dense", "sparse"):
                                for k, v in getattr(st_k, part).items():
                                    getattr(st_p, part)[k].copy_(v)
                            before = {s.name: s.param.clone()
                                      for s in sources if s.name in updated}
                        lk = float(call(step_k, model, st_k, b))
                        lp = float(call(step_p, plain, st_p, b))
                        bad = []
                        plain_of = {s.name: s.param
                                    for s in plain.row_sources()}
                        for s in sources:
                            if s.name not in updated:
                                continue
                            k, p0 = s.name, before.pop(s.name)
                            dk = s.param - p0
                            dp = plain_of[k] - p0
                            size = float(dp.norm())
                            rel = (float((dk - dp).norm()) / size if size
                                   else np.inf if bool(dk.any()) else 0.0)
                            worst["step"] = min(worst["step"],
                                                float(dp.abs().max()))
                            if rel >= worst["step_rel"]:
                                worst["step_rel"], worst["step_at"] = rel, k
                            if not rel <= 1e-2:
                                bad.append(f"{k}: step change |d_on - "
                                           f"d_off| / |d_off| {rel} "
                                           f"(|d_off| {size})")
                            del dk, dp
                        worst["loss"] = max(worst["loss"],
                                            abs(lk - lp) / abs(lp))
                        if not abs(lk - lp) <= 1e-5 * abs(lp):
                            bad.append(f"loss {lk} with the kernels, {lp} "
                                       f"without")
                        ref_sd = plain.state_dict()
                        for k, a in model.state_dict().items():
                            v = ref_sd[k]
                            rel = float(((a - v).abs() / (1 + v.abs()))
                                        .max())
                            part = "rows" if k in updated else "param"
                            if rel > worst[part]:
                                worst[part], worst[part + "_at"] = rel, k
                            if part == "param" and not rel <= 1e-4:
                                bad.append(f"{k}: max|d|/(1+|ref|) {rel}")
                        for part in ("dense", "sparse"):
                            for k, v in getattr(st_p, part).items():
                                ok, rel = within_own(getattr(st_k, part)[k],
                                                     v, 1e-4)
                                worst["acc"] = max(worst["acc"], rel)
                                if not ok:
                                    bad.append(f"accumulator {k}: {rel}")
                        if hold and bad:
                            raise AssertionError(
                                f"3e({key}) {opt}, kernels on vs off: "
                                + "; ".join(bad))

                    def worst_line(w):
                        return (f"max rel loss diff {w['loss']:.3e} (limit "
                                f"1e-5); MLPs and md projections max|d|/"
                                f"(1+|ref|) {w['param']:.3e} "
                                f"({w['param_at']}; limit 1e-4); row-updated "
                                f"parameters' step change, |d_on - d_off| / "
                                f"|d_off| (2-norms a parameter) "
                                f"{w['step_rel']:.3e} ({w['step_at']}; limit "
                                f"1e-2), the smallest max|d_off| of a "
                                f"parameter {w['step']:.3e}, their "
                                f"max|d|/(1+|ref|) {w['rows']:.3e} "
                                f"({w['rows_at']}; not held: a row first "
                                f"touched whose adagrad gradient cancels "
                                f"moves by up to about lr * eps / |G| between "
                                f"correct sums); accumulators max|d|/(|ref| + "
                                f"mean nonzero |ref|) {w['acc']:.3e} (limit "
                                f"1e-4)")

                    def new_worst():
                        return dict(loss=0.0, param=0.0, param_at="-",
                                    rows=0.0, rows_at="-", acc=0.0,
                                    step=np.inf, step_rel=0.0, step_at="-")

                    fresh = new_worst()
                    on_vs_off(take(1)[0], fresh, hold=False)
                    steps += 1
                    for b in take(3):                       # warm-up
                        call(step_k, model, st_k, b)
                    steps += 3
                    worst = new_worst()
                    for b in take(3):
                        on_vs_off(b, worst, hold=True)
                    steps += 3
                    del st_p
                    torch.cuda.empty_cache()
                    print(f"3e({key}) {opt}: kernels on vs off, one step "
                          f"from the fresh state, measured and not held "
                          f"(elementwise adagrad's update is about lr * "
                          f"sign(G) where the state is still 0, so "
                          f"gradients that cancel to rounding noise move "
                          f"it): {worst_line(fresh)}; then, after 3 "
                          f"warm-up steps, 3 steps each from one state, "
                          f"held: {worst_line(worst)}", flush=True)
                    windows = []
                    for _ in range(2):
                        bs = take(10)
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        for b in bs:
                            call(step_k, model, st_k, b)
                        torch.cuda.synchronize()
                        windows.append(10 / (time.perf_counter() - t0))
                    steps += 20
                    rate = float(np.mean(windows))
                    rates[f"{key} {opt}"] = rate
                    pb = take(1)[0]
                    wall_ms, on_card = profile_steps(
                        torch, lambda: call(step_k, model, st_k, pb), 1)
                    steps += 1
                    busy = sum(t for _, t in on_card.values())
                    n_ops = sum(c for c, _ in on_card.values())
                    print(f"3e({key}) {opt} B={BAG_B} bags of up to "
                          f"{BAG_L} lr 0.1 [{card}]: {rate:.2f} steps/s "
                          f"(mean of two 10-step windows: "
                          f"{', '.join(f'{r:.2f}' for r in windows)}; 3 "
                          f"warm-up steps), {rate * BAG_B:.1f} samples/s; "
                          f"one profiled step: {n_ops} kernels and copies, "
                          f"device busy {busy:.3f} ms, "
                          + (f"{100 * busy / wall_ms:.1f}% of its "
                             f"{wall_ms:.2f} ms under the profiler, "
                             f"{100 * busy * rate / 1e3:.1f}% of an "
                             f"unprofiled step ({1e3 / rate:.2f} ms)"
                             if busy > 0 else "busy share not measured "
                             "(no device time in the trace)")
                          + f"; by kernel: {by_kernel(on_card, 1)}",
                          flush=True)
                    uniq_calls = no_wait(step_k, model, st_k, take(2))
                    steps += 2
                    if uniq_calls:
                        raise AssertionError(f"3e({key}) {opt}: the step "
                                             f"called torch.unique "
                                             f"{uniq_calls} times")
                    print(f"3e({key}) {opt}: no device wait: 2 steps on "
                          f"device-resident inputs under torch.cuda."
                          f"set_sync_debug_mode('error') (any synchronising "
                          f"call raises) with torch.unique counted: 0 "
                          f"calls", flush=True)
                    want["gather_rows_grouped"] += steps * n_gather
                    want["scatter_sub_sorted"] += steps * n_upd
                    del st_k
                metrics = evaluate(model, fcfg, take(2))
                want["gather_rows_grouped"] += 2 * n_gather
                if not all(np.isfinite(v) for v in metrics.values()):
                    raise AssertionError(f"3e({key}): evaluate gave "
                                         f"{metrics}")
                print(f"3e({key}) evaluate over 2 bagged batches: auc "
                      f"{metrics['auc']:.4f}, accuracy "
                      f"{metrics['accuracy']:.4f} (random weights and "
                      f"labels)", flush=True)
                del model, plain
                torch.cuda.empty_cache()
            launches = {k: v for k, v in read_counts().items()
                        if k in ("interaction_fwd", "interaction_bwd",
                                 "gather_rows_grouped",
                                 "scatter_sub_sorted")}
            got = {k: launches[k] for k in want}
            if min(launches.values()) < 1 or got != want or \
                    read_counts()["gather_rows"] != 0:
                raise AssertionError(f"train_factored launches "
                                     f"{read_counts()}, expected {want} "
                                     f"(one grouped gather per width group"
                                     f" and one grouped row update per "
                                     f"update group a step), K1 and K4 at "
                                     f"least once and no flat gather")
            print(f"train_factored launches: {json.dumps(launches)} (one "
                  f"grouped gather per width group and one grouped row "
                  f"update per update group a step, as expected)")
            return launches

    with Phase("2 kernels vs plain"):
        # K1: f32 |d| <= 1e-5 (1 + |ref|) (summation order); bf16: one
        # bf16 ulp of ref plus that f32 allowance.  Bit for bit with K6 on
        # the same inputs (both sum each pair as one fmaf chain in d
        # order).  The cases include the edges of the design: one sample;
        # batches around the train batch and the 132 SMs (3, 127, 129); a
        # serve batch whose last group is ragged (2049); D=4, 7 (scalar
        # path) and 128; self_interaction; and inputs that start 4 bytes
        # past a 16-byte boundary (the spans' phase, the scalar path)
        def offset_view(t):
            """t's values in a tensor that starts one element past t's
            storage start (contiguous, 16-byte misaligned)."""
            buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
            buf[1:] = t.reshape(-1)
            return buf[1:].view(t.shape)

        k1_cases = [(B, T, D, dt, False, False)
                    for (B, T, D) in [(1, 26, 36), (3, 26, 36),
                                      (127, 26, 36), (128, 26, 36),
                                      (129, 26, 36), (1000, 26, 36),
                                      (2048, 26, 36), (2049, 26, 36),
                                      (65536, 26, 36),
                                      (4096, 26, 64), (4096, 26, 128),
                                      (256, 3, 4), (129, 26, 4),
                                      (129, 26, 7)]
                    for dt in ("float32", "bfloat16")]
        k1_cases += [(B, 26, 36, dt, True, False) for B in (129, 2048)
                     for dt in ("float32", "bfloat16")]
        k1_cases += [(129, 26, 36, dt, si, True)
                     for dt in ("float32", "bfloat16")
                     for si in (False, True)]
        # a sample's output row (179,704 values) too wide to stage: the
        # pairs go straight to global memory; K6 does not take the shape
        k1_cases += [(130, 599, 4, dt, False, False)
                     for dt in ("float32", "bfloat16")]
        for B, T, D, dt, si, off in k1_cases:
            tdt = getattr(torch, dt)
            x = torch.randn(B, D, generator=gen, device=dev).to(tdt)
            ly = torch.randn(B, T, D, generator=gen, device=dev).to(tdt)
            if off:
                x, ly = offset_view(x), offset_view(ly)
            got = dot_interaction_kernel(x, ly, si)
            ref = dot_interaction_ref(x, ly, si)
            k6 = (dot_interaction_gram_kernel(x, ly, si)
                  if gram_geometry(B, T + 1, D, x.element_size(), si)
                  else got)
            torch.cuda.synchronize()
            ok, err = within(got, ref, 1e-5, dt == "bfloat16")
            label = (f"B={B} T={T} D={D} {dt} self={si}"
                     + (" offset by one element" if off else ""))
            if got.shape != ref.shape or not ok:
                raise AssertionError(f"interaction_fwd disagrees at {label}:"
                                     f" max|d| {err}")
            ok6, err6 = within(k6, ref, 1e-5, dt == "bfloat16")
            if not torch.equal(got, k6) or not ok6:
                raise AssertionError(f"interaction_fwd differs from K6 at "
                                     f"{label} (K6 max|d| {err6} vs plain)")
            P = num_pairs(T + 1, si)
            es = x.element_size()
            bms, by = bound_ms((B * (T + 1) * D + B * (D + P)) * es,
                               2.0 * B * P * D, dt)
            call = lambda: dot_interaction_kernel(x, ly, si)  # noqa: E731
            k_ms = time_ms(torch, call)
            p_ms = time_ms(torch, lambda: dot_interaction_ref(x, ly, si))
            split = ""
            if dt == "float32" and not si and not off and T == 26 \
                    and D == 36 and B in (128, 2048, 65536):
                dev_us, host_us = device_host_us(torch, call)
                split = (f" device_us {dev_us:.2f} host_us {host_us:.2f} "
                         f"({100 * bms * 1e3 / dev_us:.0f}% of the bound on "
                         f"the device)")
            staged = interaction_geometry(B, T + 1, D, es, si).stage_out
            print(f"interaction_fwd {label}: max|d| {err:.3e}, "
                  + ("equal to K6" if k6 is not got else
                     "K6 does not take it")
                  + ("" if staged else ", pairs stored unstaged") + "; "
                  f"kernel_ms {k_ms:.4f}{split} plain_ms {p_ms:.4f} bound_us "
                  f"{bms * 1e3:.2f} ({by}) library_ms none (no single "
                  f"PyTorch call computes it) [{card}]", flush=True)
            if (B, T, D, dt, si, off) == (2048, 26, 36, "float32", False,
                                          False):
                report["interaction_fwd"] = dict(
                    max_abs_err=err, ms=k_ms, device_ms=dev_us / 1e3,
                    plain_ms=p_ms, bound_ms=bms, bound_by=by,
                    library_ms=None)
            del x, ly, got, ref, k6

        # K4: as K1, f32 |d| <= 1e-5 (1 + |ref|); bf16 adds one bf16 ulp;
        # every case launched twice on the same inputs, bitwise equal
        k4_cases = [(B, 26, 36, "float32", False, False)
                    for B in (1, 3, 127, 128, 129, 2048, 2049, 65536)]
        k4_cases += [(65536, 26, 36, "bfloat16", False, False),
                     (129, 26, 36, "bfloat16", False, False),
                     (2048, 26, 36, "float32", True, False),
                     (129, 26, 36, "bfloat16", True, False),
                     (129, 26, 4, "float32", False, False),
                     (129, 26, 7, "float32", False, False),
                     (4096, 26, 128, "float32", False, False),
                     (4096, 26, 128, "bfloat16", False, False),
                     (256, 3, 4, "float32", True, False),
                     (129, 26, 36, "float32", False, True),
                     (129, 26, 36, "bfloat16", True, True)]
        for B, T, D, dt, si, off in k4_cases:
            tdt = getattr(torch, dt)
            P = num_pairs(T + 1, si)
            x = torch.randn(B, D, generator=gen, device=dev).to(tdt)
            ly = torch.randn(B, T, D, generator=gen, device=dev).to(tdt)
            g = torch.randn(B, D + P, generator=gen, device=dev).to(tdt)
            if off:
                x, ly, g = offset_view(x), offset_view(ly), offset_view(g)
            got = dot_interaction_bwd_kernel(x, ly, g, si)
            again = dot_interaction_bwd_kernel(x, ly, g, si)
            ref = dot_interaction_bwd_ref(x, ly, g, si)
            torch.cuda.synchronize()
            label = (f"B={B} T={T} D={D} {dt} self={si}"
                     + (" offset by one element" if off else ""))
            checks = [within(a, b, 1e-5, dt == "bfloat16")
                      for a, b in zip(got, ref)]
            err = max(e for _, e in checks)
            if not all(ok for ok, _ in checks) or any(
                    a.shape != b.shape or a.dtype != b.dtype
                    for a, b in zip(got, ref)):
                raise AssertionError(f"interaction_bwd disagrees at {label}:"
                                     f" max|d| {err}")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"interaction_bwd is not deterministic "
                                     f"at {label}")
            es = x.element_size()
            F = T + 1
            bms, by = bound_ms((2 * B * F * D + B * (D + P)) * es,
                               2.0 * B * F * F * D + B * D, dt)
            call = lambda: dot_interaction_bwd_kernel(  # noqa: E731
                x, ly, g, si)
            k_ms = time_ms(torch, call)
            p_ms = time_ms(torch,
                           lambda: dot_interaction_bwd_ref(x, ly, g, si))
            split = ""
            if dt == "float32" and not si and not off and T == 26 \
                    and D == 36 and B in (128, 2048, 65536):
                dev_us, host_us = device_host_us(torch, call)
                split = (f" device_us {dev_us:.2f} host_us {host_us:.2f} "
                         f"({100 * bms * 1e3 / dev_us:.0f}% of the bound on "
                         f"the device)")
            print(f"interaction_bwd {label}: max|d| {err:.3e}, two launches "
                  f"bitwise equal; kernel_ms {k_ms:.4f}{split} plain_ms "
                  f"{p_ms:.4f} bound_us {bms * 1e3:.2f} ({by}) library_ms "
                  f"none (no single PyTorch call computes it) [{card}]",
                  flush=True)
            if (B, T, D, dt, si, off) == (128, 26, 36, "float32", False,
                                          False):
                report["interaction_bwd"] = dict(
                    max_abs_err=err, ms=k_ms, device_ms=dev_us / 1e3,
                    plain_ms=p_ms, bound_ms=bms, bound_by=by,
                    library_ms=None)
            del x, ly, g, got, again, ref
        T, D = 26, 36

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
            if got.shape != ref.shape or got.dtype != ref.dtype or not ok \
                    or not torch.equal(got, k1):
                raise AssertionError(
                    f"interaction_gram disagrees at B={B} T={T} D={D} {dt} "
                    f"self={si}: max|d| {err} vs plain, equal to K1: "
                    f"{torch.equal(got, k1)}")
            P = num_pairs(T + 1, si)
            es = x.element_size()
            bms, by = bound_ms((B * (T + 1) * D + B * (D + P)) * es,
                               2.0 * B * P * D, dt)
            call = lambda: dot_interaction_gram_kernel(  # noqa: E731
                x, ly, si)
            k_ms = time_ms(torch, call)
            k1_ms = time_ms(torch, lambda: dot_interaction_kernel(x, ly, si))
            p_ms = time_ms(torch, lambda: dot_interaction_ref(x, ly, si))
            split = ""
            if not si:
                dev_us, host_us = device_host_us(torch, call)
                split = (f" device_us {dev_us:.2f} host_us {host_us:.2f} "
                         f"({100 * bms * 1e3 / dev_us:.0f}% of the bound on "
                         f"the device)")
            print(f"interaction_gram B={B} T={T} D={D} {dt} self={si}: "
                  f"max|d| {err:.3e} vs plain, bit for bit equal to K1; "
                  f"kernel_ms {k_ms:.4f}{split} K1_ms {k1_ms:.4f} plain_ms "
                  f"{p_ms:.4f} "
                  f"bound_us {bms * 1e3:.2f} ({by}) library_ms none (no "
                  f"single PyTorch call computes it) [{card}]", flush=True)
            if (B, dt, si) == (2048, "float32", False):
                report["interaction_gram"] = dict(
                    max_abs_err=err, ms=k_ms, device_ms=dev_us / 1e3,
                    plain_ms=p_ms, bound_ms=bms, bound_by=by,
                    library_ms=None)
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

        # K3: bit for bit (IEEE division in both), every case launched
        # twice (bitwise equal); the int8 C1 cache of the three-tier
        # configuration holds 36,204 rows
        def k3_check(cache, idx, buf, label):
            got = gather_rows_dequant_int8(cache, idx, buf)
            again = gather_rows_dequant_int8(cache, idx, buf)
            ref = gather_rows_dequant_int8_ref(cache, idx, buf)
            torch.cuda.synchronize()
            if got.shape != ref.shape or not torch.equal(
                    got.view(torch.int32), ref.view(torch.int32)):
                raise AssertionError(f"gather_rows_dequant_int8 differs at "
                                     f"{label}")
            if not torch.equal(got.view(torch.int32),
                               again.view(torch.int32)):
                raise AssertionError(f"gather_rows_dequant_int8 is not "
                                     f"deterministic at {label}")

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
            k3_check(cache, idx, buf, label)
            uniq = int(torch.unique(idx).numel())
            bms, by = bound_ms(uniq * D + R * 4 + R * D * 4, 3.0 * R * D,
                               "float32")
            call = lambda: gather_rows_dequant_int8(  # noqa: E731
                cache, idx, buf)
            k_ms = time_ms(torch, call)
            dev_us, host_us = device_host_us(torch, call)
            p_ms = time_ms(torch, lambda: gather_rows_dequant_int8_ref(
                cache, idx, buf))
            print(f"gather_rows_dequant_int8 {label}: bit-exact, two launches "
                  f"bitwise equal; kernel_ms {k_ms:.4f} device_us "
                  f"{dev_us:.2f} host_us {host_us:.2f} plain_ms {p_ms:.4f} "
                  f"bound_us {bms * 1e3:.2f} ({by}, "
                  f"{100 * bms * 1e3 / dev_us:.0f}% of it on the device) "
                  f"library_ms none (no single PyTorch call computes it) "
                  f"[{card}]", flush=True)
            return dict(max_abs_err=0.0, ms=k_ms, device_ms=dev_us / 1e3,
                        plain_ms=p_ms, bound_ms=bms, bound_by=by,
                        library_ms=None)

        report["gather_rows_dequant_int8"] = k3_case(
            36204, 4096, 2048 * 26, 36,
            "cache 36204x36 u8 + buffer 4096, R=2048*26")
        k3_case(36204, 4096, 65536 * 26, 36,
                "cache 36204x36 u8 + buffer 4096, R=65536*26")
        k3_case(36204, 4096, 2048 * 26, 7,
                "cache 36204x7 u8 + buffer 4096, R=2048*26 (byte path)")

        # the cases that break a unit design, checked and not timed: R=1,
        # R that no thread's 4 x 256 units divide, the two sources' edges
        # (C-1, C, C+M-1, C+M), indices out of range, no secondary, sources
        # one element (a byte: the byte path) or a word (the word path, not
        # 16-byte aligned) off a 16-byte boundary.  The wrapper allocates
        # the output itself, always 16-byte aligned
        def codes(n, D):
            return torch.randint(0, 256, (n, D), generator=gen, device=dev,
                                 dtype=torch.uint8)

        def offset_codes(n, D, by):
            buf8 = codes(n * D + by, 1).reshape(-1)
            return buf8[by:].view(n, D)

        C3, M3 = 1000, 96
        edges = torch.tensor([C3 - 1, C3, C3 + M3 - 1, C3 + M3, -1, 0,
                              2 ** 31 - 1], device=dev, dtype=torch.int32)
        n3 = 0
        for D3 in (4, 7, 8, 36, 64):
            cache, buf = codes(C3, D3), codes(M3, D3)
            for R3 in (1, 3, 1025, 2048 * 26 + 3):
                idx = torch.randint(-4, C3 + M3 + 4, (R3,), generator=gen,
                                    device=dev, dtype=torch.int32)
                idx[:min(R3, 7)] = edges[:min(R3, 7)]
                k3_check(cache, idx, buf, f"D={D3} R={R3}")
                k3_check(cache, idx.clamp(-1, C3), None,
                         f"D={D3} R={R3}, no secondary")
                n3 += 2
            bad = torch.randint(C3 + M3, 2 ** 31 - 1, (4097,),
                                generator=gen, device=dev, dtype=torch.int32)
            bad[::2] = -bad[::2]
            k3_check(cache, bad, buf, f"D={D3} every index out of range")
            n3 += 1
            for by in (1, 4):
                idx = torch.randint(0, C3 + M3, (1025,), generator=gen,
                                    device=dev, dtype=torch.int32)
                k3_check(offset_codes(C3, D3, by), idx,
                         offset_codes(M3, D3, by),
                         f"D={D3} sources {by} byte(s) off a 16-byte "
                         f"boundary")
                n3 += 1
        print(f"gather_rows_dequant_int8: {n3} edge cases (R = 1, 3, 1025, "
              f"53251; D = 4, 7, 8, 36, 64; indices C-1, C, C+M-1, C+M, -1 "
              f"and all out of range; no secondary; sources 1 and 4 bytes "
              f"off a 16-byte boundary) bit for bit against the plain "
              f"version, two launches bitwise equal", flush=True)
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

    phase_2b()

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
        kcfga = CacheConfig(policy="evlfu", n_caching_layers=1,
                             total_size=64000, main_precision=32)
        tc = build_cache(kcfga, cfg, mm)
        warm_a, scored_a, extra_a = warm_up(
            tc, lambda s: s["c1"]["size"] >= 64000, n_scored=16)
        res_a = serve_host(model, cfg, kcfga, scored_a, mm, cache=tc)
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
        kcfgb = CacheConfig(policy="evlfu", n_caching_layers=3,
                             total_size=75425, main_precision=8,
                             secondary_precision=4,
                             size_proportion=(48, 48, 4))
        resolver = AltKeyResolver(bin_dir=bins, table_sizes=sizes)
        if not all(np.array_equal(a, b) for a, b in
                   zip(resolver.tables, alts)):
            raise AssertionError("alt keys read back differ")
        eng = NativeTieredCache(kcfgb, cfg.num_tables, cfg.embedding_dim)
        eng.open_table_files(bins, sizes)
        eng.load_altkeys(resolver.tables)
        caps = kcfgb.tier_capacities()
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
        res_b = serve_host(model, cfg, kcfgb, scored_b, mm,
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
        res_d = serve_host(model, cfg, kcfgb, singles, mm,
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
        # two-stage Gram op and the top MLP must give (b)'s scores (K1) bit
        # for bit at f32, and K6's interaction must equal K1's on the same
        # inputs bit for bit
        reset_counts()
        worst_e = 0.0
        with torch.inference_mode():
            for i, ((dense, _, _), rows) in enumerate(zip(scored_b,
                                                          rec.rows)):
                dense_t = torch.from_numpy(dense).to(dev)
                rows_t = torch.from_numpy(rows).to(dev)
                x = model.bottom_mlp(dense_t).contiguous()
                z6 = DotInteractionGram.apply(x, rows_t,
                                              cfg.interaction_itself)
                z1 = dot_interaction_kernel(x, rows_t,
                                            cfg.interaction_itself)
                got = torch.sigmoid(model.top_mlp(z6)).cpu()
                ref = torch.from_numpy(res_b.scores[i * 2048:(i + 1) * 2048])
                err = float((got - ref).abs().max())
                worst_e = max(worst_e, err)
                if not torch.equal(z6, z1) or not torch.equal(got, ref):
                    raise AssertionError(
                        f"(e): K6's interaction equals K1's: "
                        f"{torch.equal(z6, z1)}; its scores differ from "
                        f"K1's by max|d| {err}")
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
              f"[{card}]: interaction and scores bit for bit equal to K1's "
              f"(max|d| {worst_e:.3e}); the forward of one batch of 2048 "
              f"with K1 "
              f"{ab[0]:.4f} / {ab[3]:.4f} ms, with K6 {ab[1]:.4f} / "
              f"{ab[2]:.4f} ms (CUDA events, median of 20, in the order K1, "
              f"K6, K6, K1); launches {json.dumps(gram_launches)}",
              flush=True)
        del rec, dense_t, rows_t

        # (c) the LFU and LRU baselines at 64,000 entries: Python
        # (SimpleCacheFrontend over the mmap store, 4 scored batches) and
        # the engine (its file mode, 64 scored batches)
        for policy in ("lfu", "lru"):
            kcfgc = CacheConfig(policy=policy, n_caching_layers=1,
                                 total_size=64000, main_precision=32)
            py = build_cache(kcfgc, cfg, mm)
            warm_c, scored_c, _ = warm_up(
                py, lambda s: s["cache"]["size"] >= 64000, n_scored=4)
            res_c = serve_host(model, cfg, kcfgc, scored_c, mm, cache=py)
            served(res_c, 4)
            err_c = check_plain(res_c, scored_c, f"(c) Python {policy}")
            host_line(f"3d(c) Python {policy.upper()} 64,000 fp32 over the "
                      f"mmap store, {len(warm_c)} warm-up batches", res_c, 4)
            del py
            nat = NativeTieredCache(kcfgc, cfg.num_tables,
                                    cfg.embedding_dim)
            nat.open_table_files(bins, sizes)
            warm_n, scored_n, _ = warm_up(
                nat, lambda s: s["c1"]["size"] >= 64000)
            res_n = serve_host(model, cfg, kcfgc, scored_n, mm,
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
        nat = build_cache(kcfga, cfg, storage, use_native=True)
        warm_g, scored_g, _ = warm_up(
            nat, lambda s: s["c1"]["size"] >= 64000)
        res_g = serve_host(model, cfg, kcfga, scored_g, storage,
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
        serial = res_g.cache_stats
        del nat

        # (g) beside it: the table-partitioned engine (NativeShardedCache)
        # over the same tables, borrowed, at 1, 2, 4 and 8 workers, fed
        # (g)'s warm-up and scored batches: its scores equal (g)'s bit for
        # bit, one more batch's rows equal the store's, at 1 worker its
        # stats equal the serial engine's, at more C1's hit rate is within
        # 0.05 of it (tests/test_sharded_engine.py)
        rate_g = res_g.requests / res_g.elapsed_s
        for workers in (1, 2, 4, 8):
            sh = NativeShardedCache(kcfga, cfg.num_tables,
                                    cfg.embedding_dim, workers)
            sh.borrow_tables(tables)
            for _, idx, _ in warm_g:
                sh.request_batch(idx)
            res_s = serve_host(model, cfg, kcfga, scored_g, None, cache=sh)
            idx_x = scored_g[-1][1][::-1].copy()
            if not np.array_equal(sh.request_batch(idx_x).view(np.int32),
                                  store_rows(idx_x).view(np.int32)):
                raise AssertionError(f"(g) sharded W={workers}: rows differ "
                                     f"from the store's")
            st = res_s.cache_stats      # before the extra batch
            sh.close()
            if not np.array_equal(res_s.scores.view(np.int32),
                                  res_g.scores.view(np.int32)):
                raise AssertionError(f"(g) sharded W={workers}: scores "
                                     f"differ from the serial engine's")
            d_hr = st["c1"]["hit_rate"] - serial["c1"]["hit_rate"]
            if workers == 1 and (st["perfect_hits"] !=
                                 serial["perfect_hits"] or d_hr != 0.0):
                raise AssertionError(f"(g) sharded W=1 {st} against the "
                                     f"serial engine's {serial}")
            if abs(d_hr) >= 0.05:
                raise AssertionError(f"(g) sharded W={workers}: C1 hit rate "
                                     f"{st['c1']['hit_rate']} against the "
                                     f"serial engine's "
                                     f"{serial['c1']['hit_rate']}")
            host_line(f"3d(g) NativeShardedCache W={workers}, EvLFU 64,000 "
                      f"fp32, tables borrowed in RAM, (g)'s batches", res_s,
                      N_SCORED)
            print(f"check (g) sharded W={workers}: scores equal the serial "
                  f"engine's bit for bit, rows the store's; C1 hit rate "
                  f"{st['c1']['hit_rate']:.6f} (serial "
                  f"{serial['c1']['hit_rate']:.6f}, d {d_hr:+.6f}), perfect "
                  f"hits {st['perfect_hits']} (serial "
                  f"{serial['perfect_hits']}); "
                  f"{res_s.requests / res_s.elapsed_s:.1f} requests/s "
                  f"against the serial engine's {rate_g:.1f}", flush=True)
            del res_s

        # (f) the TCP service in batched mode over a fresh fp32 C1 of the
        # engine, on 127.0.0.1: the rows equal the store's bit for bit
        eng_f = NativeTieredCache(kcfga, cfg.num_tables, cfg.embedding_dim)
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
            batch_size=B, num_batches=5 + 5 + 5 + 2 * (3 + 3 * 20) + 5 + 2,
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
                      f"{k} {t:.3f} ms x{n}" for k, (n, t) in top))
            # each kernel of the port by its function's name (K5 is two)
            per_kernel = {"K1 interaction_fwd": ("interaction_fwd_kernel",),
                          "K2 gather_rows_grouped": ("Grouped<",),
                          "K4 interaction_bwd": ("interaction_bwd_kernel",),
                          "K5 scatter_sub_sorted": ("chunk_sums_kernel",
                                                    "cross_chunk_kernel")}
            print("device us per rwsadagrad step, by kernel: " + ", ".join(
                f"{label} " + "{:.2f}".format(sum(
                    t for k, (_, t) in on_card.items()
                    if any(f in k for f in funcs)) * 1e3 / 5)
                + " ({} launches)".format(sum(
                    n for k, (n, _) in on_card.items()
                    if any(f in k for f in funcs)))
                for label, funcs in per_kernel.items())
                + f" [{card}]", flush=True)
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
        print(f"sgd: {rates['sgd']:.2f} steps/s in this run; 42.68 on an "
              f"NVIDIA H100 80GB HBM3 at 700.00 W when sgd updated its "
              f"tables one by one (a torch.unique each); "
              f"rwsadagrad / sgd steps/s in this run: "
              f"{rates['rwsadagrad'] / rates['sgd']:.3f} (both row updates "
              f"are one grouped call now)")
        # what an sgd step launches: 5 steps under the profiler
        step_s, st_s = make_train_step(cfg, sgd), init_opt_state(model, sgd)
        sgd_batches = iter(take(5))
        s_wall, s_card = profile_steps(
            torch, lambda: step_s(model, st_s, *next(sgd_batches)), 5)
        s_busy = sum(t for _, t in s_card.values())
        print(f"profile of 5 sgd steps [{card}]: "
              f"{sum(c for c, _ in s_card.values()) / 5:.1f} kernels and "
              f"copies a step, device busy {s_busy / 5:.3f} ms a step "
              f"({100 * s_busy / s_wall:.1f}% of the profiled wall time); "
              f"by kernel, a step: {by_kernel(s_card, 5)}", flush=True)
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
        # train step with the kernels on: rwsadagrad 5 + 5 checked, 5
        # profiled, 3 + 3 x 20 through train(); sgd 3 + 3 x 20 through
        # train(), 5 profiled; 2 eval
        rws_steps = 5 + 5 + 5 + (3 + 3 * 20)
        sgd_steps = 3 + 3 * 20 + 5
        want = {"gather_rows_grouped": rws_steps + sgd_steps + 2,
                "scatter_sub_sorted": rws_steps + sgd_steps}
        got = {k: train_launches[k] for k in want}
        if got != want or read_counts()["gather_rows"] != 0:
            raise AssertionError(f"train path launches {read_counts()}, "
                                 f"expected {want} and no flat gather")
        print(f"train path launches: {json.dumps(got)} (one grouped gather "
              f"per train or eval step, one grouped row update per train "
              f"step, sgd's included)")
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"evaluate gave {metrics}")
        print(f"evaluate over 2 batches: auc {metrics['auc']:.4f}, accuracy "
              f"{metrics['accuracy']:.4f} (random weights and labels)")

    del model, st_k, step_k, st_s, step_s
    torch.cuda.empty_cache()
    factored_launches = phase_3e(tables)
    del tables
    cli_launches = phase_3f()

    # ---------------------------------------------------- 4 kernels line
    with Phase("4 kernels line"):
        print(f"kernels: serve {json.dumps(serve_launches)}; serve_int8 "
              f"{json.dumps(int8_launches)}; serve_host "
              f"{json.dumps(host_launches)}; gram_ab "
              f"{json.dumps(gram_launches)}; train "
              f"{json.dumps(train_launches)}; train_factored "
              f"{json.dumps(factored_launches)}; cli "
              f"{json.dumps(cli_launches)}")
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
                 "train": train_launches,
                 "train_factored": factored_launches, "cli": cli_launches}
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
