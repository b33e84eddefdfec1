"""Command-line interface with the JAX package's flags.

Port of `evstore_tpu/cli.py`.  The reference drives everything through
some 90 argparse flags on dlrm_s_pytorch.py (:924-1047) and the EVStore
flags of its C1/C2/C3 drivers (dlrm_s_pytorch_C1.py:1248-1268).  This CLI
takes every flag of the JAX package's parser under its name and default,
and one more, `--device` (default `cuda`; `cpu` for the tests: without a
card, `cuda` raises).  One command covers the reference's five drivers:
training, and with `--inference-only`, `--use-evstore` and
`--n-caching-layers {1,2,3}` the C1, C1+C2 and C1+C2+C3 servers.

    python -m evstore_tpu_torch.cli --arch-mlp-bot 13-512-256-64-36 ...

Where the port departs from the JAX CLI:
- `--use-pallas-gather` and `--use-pallas-interaction` switch the port's
  CUDA kernels (`use_gather_kernel`, `use_interaction_kernel`).  Unset,
  the kernels run; only an explicit `False` turns one off.
- Serving the exported tables from files (`--ev-table-path` with a
  file-backed `--emb-stor`) through the engine (`--cache-algo native`,
  `--cache-engine native` or `--use-device-cache True`) opens the engine
  on the .bin files (`open_table_files`); the JAX CLI raises there.
- A checkpoint is the port's own (`utils/checkpoint.py`); a JAX
  checkpoint (orbax) cannot be read.  The EV tables are shared.
- Not ported: training with `--use-evstore` (ROADMAP queue 1 item 7) and
  the mesh flags above 1 (item 8); both raise NotImplementedError.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

from evstore_tpu_torch.config import (CacheConfig, TrainConfig,
                                      make_dlrm_config)

CACHED_TRAINING_ITEM = "ROADMAP queue 1 item 7 (the trainable cache)"
MESH_ITEM = "ROADMAP queue 1 item 8 (multi-GPU)"


def _dash_ints(s: str) -> List[int]:
    return [int(x) for x in s.split("-")]


def _str_bool(s) -> bool:
    # the reference parses string booleans by hand
    # (dlrm_s_pytorch_C1.py:1276-1294)
    if isinstance(s, bool):
        return s
    return str(s).lower() in ("true", "1", "yes")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="DLRM with EVStore tiered embedding, PyTorch/CUDA")
    # model arch (dlrm_s_pytorch.py:926-936)
    p.add_argument("--arch-sparse-feature-size", type=int, default=2)
    p.add_argument("--arch-embedding-size", type=str, default="4-3-2")
    p.add_argument("--arch-mlp-bot", type=str, default="4-3-2")
    p.add_argument("--arch-mlp-top", type=str, default="4-2-1")
    p.add_argument("--arch-interaction-op", type=str, default="dot")
    p.add_argument("--arch-interaction-itself", action="store_true")
    p.add_argument("--weighted-pooling", type=str, default=None)
    # embedding tricks (:937-944)
    p.add_argument("--md-flag", action="store_true")
    p.add_argument("--md-threshold", type=int, default=200)
    p.add_argument("--md-temperature", type=float, default=0.3)
    p.add_argument("--md-round-dims", action="store_true")
    p.add_argument("--qr-flag", action="store_true")
    p.add_argument("--qr-threshold", type=int, default=200)
    p.add_argument("--qr-operation", type=str, default="mult")
    p.add_argument("--qr-collisions", type=int, default=4)
    # activations and loss (:946-951)
    p.add_argument("--loss-function", type=str, default="bce")
    p.add_argument("--loss-weights", type=str, default="1.0-1.0")
    p.add_argument("--loss-threshold", type=float, default=0.0)
    p.add_argument("--round-targets", type=_str_bool, default=False)
    # data (:952-968)
    p.add_argument("--data-size", type=int, default=1)
    p.add_argument("--num-batches", type=int, default=0)
    p.add_argument("--data-generation", type=str, default="random",
                   choices=["random", "synthetic", "dataset"])
    p.add_argument("--rand-data-dist", type=str, default="uniform")
    p.add_argument("--rand-data-min", type=float, default=0)
    p.add_argument("--rand-data-max", type=float, default=1)
    p.add_argument("--rand-data-mu", type=float, default=-1)
    p.add_argument("--rand-data-sigma", type=float, default=1)
    p.add_argument("--data-set", type=str, default="kaggle")
    p.add_argument("--raw-data-file", type=str, default="")
    p.add_argument("--processed-data-file", type=str, default="")
    p.add_argument("--max-ind-range", type=int, default=-1)
    p.add_argument("--data-sub-sample-rate", type=float, default=0.0)
    p.add_argument("--num-indices-per-lookup", type=int, default=1,
                   help="max multi-hot bag size L (> 1: pooled bags, "
                        "dlrm_data_pytorch.py:1062-1120)")
    p.add_argument("--num-indices-per-lookup-fixed", type=_str_bool,
                   default=False)
    p.add_argument("--memory-map", action="store_true")
    p.add_argument("--dataset-multiprocessing", type=int, default=0,
                   help="process-pool workers of the --memory-map "
                        "streaming preprocess (≙ data_utils.py:876; 0 or 1: "
                        "sequential)")
    p.add_argument("--mlperf-bin-loader", action="store_true")
    p.add_argument("--percent-data-for-inference", type=float, default=1.0)
    # training (:977-1002)
    p.add_argument("--mini-batch-size", type=int, default=128)
    p.add_argument("--nepochs", type=int, default=1)
    p.add_argument("--learning-rate", type=float, default=0.01)
    p.add_argument("--optimizer", type=str, default="sgd",
                   choices=["sgd", "adagrad", "rwsadagrad"])
    p.add_argument("--print-precision", type=int, default=5)
    p.add_argument("--numpy-rand-seed", type=int, default=123)
    p.add_argument("--print-freq", type=int, default=1024)
    p.add_argument("--test-freq", type=int, default=-1)
    p.add_argument("--test-mini-batch-size", type=int, default=-1)
    p.add_argument("--nbatches-test", type=int, default=0)
    p.add_argument("--lr-num-warmup-steps", type=int, default=0)
    p.add_argument("--lr-decay-start-step", type=int, default=0)
    p.add_argument("--lr-num-decay-steps", type=int, default=0)
    # checkpoints and modes (:1004-1032)
    p.add_argument("--save-model", type=str, default="")
    p.add_argument("--load-model", type=str, default="")
    p.add_argument("--inference-only", action="store_true")
    p.add_argument("--mlperf-logging", action="store_true")
    p.add_argument("--mlperf-acc-threshold", type=float, default=0.0)
    p.add_argument("--mlperf-auc-threshold", type=float, default=0.0)
    p.add_argument("--quantize-embedding-with-bit", type=int, default=32)
    p.add_argument("--quantize-mlp-with-bit", type=int, default=32)
    p.add_argument("--enable-profiling", action="store_true")
    p.add_argument("--tensor-board-filename", type=str, default="run_0")
    # parallelism: one card; the mesh flags above 1 are not ported
    p.add_argument("--mesh-data", type=int, default=0,
                   help="data-parallel mesh axis (0 = all devices)")
    p.add_argument("--mesh-model", type=int, default=1,
                   help="model-parallel (table-sharding) mesh axis")
    p.add_argument("--dedup-exchange", type=_str_bool, default=False,
                   help="ship unique rows through the sharded exchange")
    p.add_argument("--alltoall-impl", type=str,
                   default=os.environ.get("DLRM_ALLTOALL_IMPL", "psum"),
                   choices=["psum", "butterfly", "alltoall"],
                   help="embedding exchange (≙ DLRM_ALLTOALL_IMPL, "
                        "extend_distributed.py:34)")
    p.add_argument("--compute-dtype", type=str, default="bfloat16")
    p.add_argument("--use-pallas-gather", type=_str_bool, default=None,
                   help="the row-gather CUDA kernel (use_gather_kernel); "
                        "unset: on")
    p.add_argument("--use-pallas-interaction", type=_str_bool, default=None,
                   help="the dot-interaction CUDA kernels "
                        "(use_interaction_kernel); unset: on")
    # EVStore flags (dlrm_s_pytorch_C1.py:1248-1268)
    p.add_argument("--use-evstore", type=_str_bool, default=False)
    p.add_argument("--train-window", type=int, default=0,
                   help="cached training: batches per device call")
    p.add_argument("--use-emb-cache", type=_str_bool, default=True)
    p.add_argument("--cache-algo", type=str, default="evlfu",
                   choices=["evlfu", "lfu", "lru", "native"])
    p.add_argument("--cache-engine", type=str, default="python",
                   choices=["python", "native"],
                   help="run --cache-algo's policy in Python or in the "
                        "C++ engine; --cache-algo native implies native")
    p.add_argument("--emb-cache-size", type=int, default=64000)
    p.add_argument("--n-caching-layers", type=int, default=1)
    p.add_argument("--size-proportion", type=str, default="48-48-4")
    p.add_argument("--main-precision", type=int, default=32)
    p.add_argument("--secondary-precision", type=int, default=8)
    p.add_argument("--high-agghit-threshold", type=int, default=23)
    p.add_argument("--emb-stor", type=str, default="dummy",
                   choices=["dummy", "file", "mmap", "sqlite", "logkv",
                            "native"])
    p.add_argument("--emb-stor-layout", type=str, default="global",
                   choices=["global", "per_table"],
                   help="the sqlite/logkv layout: one global table or one "
                        "per EV table")
    p.add_argument("--ev-table-path", type=str, default="")
    p.add_argument("--alt-key-path", type=str, default="")
    p.add_argument("--ev-precs", type=int, default=32)
    p.add_argument("--ev-lookup-only", type=_str_bool, default=False)
    p.add_argument("--approx-emb-threshold", type=int, default=-1)
    p.add_argument("--enable-warmup", type=_str_bool, default=False)
    p.add_argument("--trace-inference-workload", type=_str_bool,
                   default=False)
    p.add_argument("--write-cdf-file", type=str, default="")
    p.add_argument("--use-device-cache", type=_str_bool, default=False,
                   help="C1 rows resident on the card (the device cache)")
    p.add_argument("--extra-mem-load", type=int, default=0,
                   help="MB of the card's memory held as ballast "
                        "(dlrm_s_pytorch_lock_gpu_C1.py:1819)")
    p.add_argument("--output-dir", type=str, default="./output")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the card) or cpu")
    return p


def configs_from_args(args) -> tuple:
    emb_sizes = _dash_ints(args.arch_embedding_size)
    bot = _dash_ints(args.arch_mlp_bot)
    top_hidden = _dash_ints(args.arch_mlp_top)[:-1]
    if args.max_ind_range > 0:
        emb_sizes = [min(s, args.max_ind_range) for s in emb_sizes]
    cfg = make_dlrm_config(
        args.arch_sparse_feature_size, emb_sizes, bot[1:-1], top_hidden,
        num_dense=bot[0],
        interaction_op=args.arch_interaction_op,
        interaction_itself=args.arch_interaction_itself,
        qr_flag=args.qr_flag, qr_operation=args.qr_operation,
        qr_collisions=args.qr_collisions, qr_threshold=args.qr_threshold,
        md_flag=args.md_flag, md_threshold=args.md_threshold,
        md_temperature=args.md_temperature, md_round_dims=args.md_round_dims,
        compute_dtype=args.compute_dtype,
        use_gather_kernel=args.use_pallas_gather is not False,
        use_interaction_kernel=args.use_pallas_interaction is not False,
        loss_threshold=args.loss_threshold,
        weighted_pooling=args.weighted_pooling)
    lw = [float(x) for x in args.loss_weights.split("-")]
    tcfg = TrainConfig(
        batch_size=args.mini_batch_size,
        test_batch_size=(args.test_mini_batch_size
                         if args.test_mini_batch_size > 0
                         else args.mini_batch_size),
        learning_rate=args.learning_rate, optimizer=args.optimizer,
        loss_function=args.loss_function, loss_weights=(lw[0], lw[1]),
        nepochs=args.nepochs, numpy_rand_seed=args.numpy_rand_seed,
        lr_num_warmup_steps=args.lr_num_warmup_steps,
        lr_decay_start_step=args.lr_decay_start_step,
        lr_num_decay_steps=args.lr_num_decay_steps,
        test_freq=args.test_freq, print_freq=args.print_freq,
        mlperf_acc_threshold=args.mlperf_acc_threshold,
        mlperf_auc_threshold=args.mlperf_auc_threshold,
        save_model=args.save_model, load_model=args.load_model)
    ccfg = CacheConfig(
        policy=("evlfu" if args.cache_algo == "native" else args.cache_algo),
        n_caching_layers=args.n_caching_layers,
        total_size=args.emb_cache_size,
        size_proportion=tuple(_dash_ints(args.size_proportion)),
        main_precision=args.main_precision,
        secondary_precision=args.secondary_precision,
        high_agghit_threshold=args.high_agghit_threshold,
        approx_emb_threshold=args.approx_emb_threshold,
        storage_backend=args.emb_stor,
        storage_path=args.ev_table_path)
    return cfg, tcfg, ccfg


def _preprocess(args) -> str:
    """The raw TSV preprocessed on demand into <output-dir>/processed
    (≙ CriteoDataset's lazy getCriteoAdData, dlrm_data_pytorch.py:53-120);
    `--memory-map` takes the bounded-memory streaming path."""
    from evstore_tpu_torch.data.criteo import (preprocess_criteo,
                                               preprocess_criteo_streaming)
    out_dir = os.path.join(args.output_dir, "processed")
    kw = dict(days=7, sub_sample_rate=args.data_sub_sample_rate,
              seed=args.numpy_rand_seed, dataset_name=args.data_set)
    t0 = time.perf_counter()
    if args.memory_map:
        pf = preprocess_criteo_streaming(
            args.raw_data_file, out_dir,
            num_workers=args.dataset_multiprocessing, **kw)
    else:
        pf = preprocess_criteo(args.raw_data_file, out_dir, **kw)
    dt = time.perf_counter() - t0
    with open(args.raw_data_file, "rb") as f:
        lines = sum(buf.count(b"\n") for buf in iter(
            lambda: f.read(1 << 24), b""))
    print(f"preprocessed {args.raw_data_file}: {lines} lines in {dt:.3f} s "
          f"({lines / max(dt, 1e-9):.0f} lines/s)")
    return pf


def _make_data(args, cfg):
    from evstore_tpu_torch.data.synthetic import (RandomDataConfig,
                                                  random_batches)
    if args.data_generation == "dataset":
        from evstore_tpu_torch.data.criteo import (CriteoBinDataset,
                                                   CriteoDataset)
        if args.mlperf_bin_loader:
            # packed int32 records (≙ data_loader_terabyte.py
            # CriteoBinDataset under --mlperf-bin-loader,
            # dlrm_s_pytorch.py:1164-1192)
            ds = CriteoBinDataset(args.processed_data_file,
                                  batch_size=args.mini_batch_size,
                                  max_ind_range=max(args.max_ind_range, 0))
            n_test = args.nbatches_test or max(
                1, int(len(ds) * args.percent_data_for_inference))

            def test_iter():
                for k, b in enumerate(ds):
                    if k >= n_test:
                        break
                    yield b

            return (lambda: iter(ds), test_iter)
        pf = args.processed_data_file
        if args.raw_data_file and not (pf and os.path.exists(pf)):
            pf = _preprocess(args)
        if pf.endswith("_stream_meta.npz"):
            ds = CriteoDataset.from_stream(pf, max(args.max_ind_range, 0))
        else:
            ds = CriteoDataset.load(pf, max(args.max_ind_range, 0))
        return (lambda: ds.batches("train", args.mini_batch_size,
                                   drop_last=True),
                lambda: ds.batches("test", args.mini_batch_size,
                                   fraction=args.percent_data_for_inference,
                                   drop_last=True))
    if args.data_generation == "synthetic":
        dist = "zipf"
    elif args.rand_data_dist == "gaussian":
        # generate_dist_input_batch (dlrm_data_pytorch.py:1011-1068)
        dist = "gaussian"
    else:
        dist = "uniform"
    import dataclasses
    dcfg = RandomDataConfig(
        num_dense=cfg.num_dense_features, table_sizes=cfg.table_sizes,
        batch_size=args.mini_batch_size, num_batches=args.num_batches or 100,
        seed=args.numpy_rand_seed, distribution=dist,
        rand_data_mu=args.rand_data_mu, rand_data_sigma=args.rand_data_sigma,
        rand_data_min=args.rand_data_min, rand_data_max=args.rand_data_max,
        num_indices_per_lookup=args.num_indices_per_lookup,
        num_indices_per_lookup_fixed=args.num_indices_per_lookup_fixed)
    test_d = dataclasses.replace(dcfg,
                                 num_batches=max(args.nbatches_test, 10),
                                 seed=args.numpy_rand_seed + 1)
    return (lambda: random_batches(dcfg), lambda: random_batches(test_d))


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.enable_profiling:
        # a trace around the whole run (≙ torch.autograd.profiler around
        # the main loop, dlrm_s_pytorch.py:1567-1569, 1880-1890)
        from evstore_tpu_torch.utils.profiling import profile_trace
        with profile_trace(os.path.join(args.output_dir, "profile")):
            return _run(args)
    return _run(args)


def _run(args) -> int:
    import torch
    from evstore_tpu_torch.utils.device import resolve_device
    dev = resolve_device(args.device)
    cfg, tcfg, ccfg = configs_from_args(args)
    if args.mesh_data > 1 or args.mesh_model > 1:
        raise NotImplementedError(f"--mesh-data / --mesh-model above 1 "
                                  f"are not ported yet: {MESH_ITEM}")
    if args.mlperf_logging:
        from evstore_tpu_torch.utils.logging import MLPerfLogger
        MLPerfLogger().submission_metadata(
            platform=(torch.cuda.get_device_name(dev).replace(" ", "-")
                      if dev.type == "cuda" else "cpu"))
    make_train, make_test = _make_data(args, cfg)

    if not args.inference_only:
        if args.use_evstore:
            raise NotImplementedError(
                f"training with --use-evstore (the HBM-bounded cached "
                f"trainer) is not ported yet: {CACHED_TRAINING_ITEM}")
        from evstore_tpu_torch.drivers.train import run_training
        res = run_training(
            cfg, tcfg, make_train, make_test,
            ckpt_dir=args.save_model or None,
            ev_export_dir=(args.ev_table_path or None),
            resume=bool(args.load_model), seed=args.numpy_rand_seed,
            dedup_exchange=args.dedup_exchange,
            alltoall_impl=args.alltoall_impl,
            multihot=args.num_indices_per_lookup > 1, device=dev)
        print(f"training done: steps={res.steps} best={res.best_metric:.4f}")
        return 0
    return _serve(args, cfg, tcfg, ccfg, make_test, dev)


def _serve(args, cfg, tcfg, ccfg, make_test, dev) -> int:
    """The inference path (the reference's C1 / C1C2 / C1C2C3 drivers)."""
    from evstore_tpu_torch.cache.storage import StorageManager
    from evstore_tpu_torch.models.dlrm import DLRM
    from evstore_tpu_torch.train.train_loop import (evaluate,
                                                    init_opt_state)
    from evstore_tpu_torch.utils.checkpoint import (latest_step,
                                                    quantize_embeddings,
                                                    quantize_mlps,
                                                    restore_checkpoint)
    if args.extra_mem_load > 0:
        from evstore_tpu_torch.utils.memory import HBMBallast
        _ballast = HBMBallast(args.extra_mem_load, device=dev)  # noqa: F841
    model = DLRM(cfg, device=dev, seed=args.numpy_rand_seed)
    if args.load_model:
        s = latest_step(args.load_model)
        if s is not None:
            restore_checkpoint(args.load_model, s, model,
                               init_opt_state(model, tcfg))
    if args.quantize_embedding_with_bit < 32:
        quantize_embeddings(model, args.quantize_embedding_with_bit)
    if args.quantize_mlp_with_bit < 32:
        quantize_mlps(model, args.quantize_mlp_with_bit)

    if not args.use_evstore:
        m = evaluate(model, cfg, make_test())
        print(f"inference done: {m}")
        return 0

    from evstore_tpu_torch.drivers.infer import run_inference
    use_native = (args.cache_algo == "native"
                  or args.cache_engine == "native")
    cache = sm = None
    if args.ev_table_path and (args.emb_stor != "dummy"
                               and (use_native or args.use_device_cache)):
        # the engine reads the exported .bin files itself
        if args.use_device_cache:
            from evstore_tpu_torch.cache.device_cache import \
                NativeDeviceC1Cache
            if use_native:
                raise ValueError("use_native and use_device_cache are "
                                 "exclusive: the device cache runs its own "
                                 "engine")
            cache = NativeDeviceC1Cache(ccfg, cfg.num_tables,
                                        cfg.embedding_dim, device=dev)
        else:
            from evstore_tpu_torch.native import NativeTieredCache
            cache = NativeTieredCache(ccfg, cfg.num_tables,
                                      cfg.embedding_dim)
        cache.open_table_files(args.ev_table_path, list(cfg.table_sizes),
                               args.ev_precs)
    elif args.ev_table_path:
        sm = StorageManager(args.emb_stor, precision=args.ev_precs,
                            dim=cfg.embedding_dim,
                            layout=args.emb_stor_layout)
        sm.load(bin_dir=args.ev_table_path,
                table_sizes=list(cfg.table_sizes))
    else:
        sm = StorageManager("dummy", dim=cfg.embedding_dim).load(
            tables=[t.detach().float().cpu().numpy() for t in model.tables])
    try:
        res = run_inference(
            model, cfg, ccfg, make_test(), sm,
            warmup_batches=make_test() if args.enable_warmup else None,
            ev_lookup_only=args.ev_lookup_only,
            trace_dir=(args.output_dir + "/trace"
                       if args.trace_inference_workload else None),
            cdf_path=args.write_cdf_file or None,
            use_native=use_native, use_device_cache=args.use_device_cache,
            cache=cache, device=dev)
    finally:
        if cache is not None:
            cache.close()
        if sm is not None:
            sm.close()
    print(f"inference done: metrics={res.metrics} "
          f"perfect_hits={res.cache_stats.get('perfect_hits')} "
          f"p99={res.latency.get('p99_s')}")
    print(f"cache stats: {json.dumps(res.cache_stats)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
