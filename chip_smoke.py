#!/usr/bin/env python3
"""On-card check of evstore_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py [--seed N] [--only 3j | --only 3k | --only 3l |
                           --only 3m | --only altkeys [--query-rows a:b]]

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
   the kernel's device time (profiler) and the wrapper's host time, or
   "not measured" where a trace reads less than the bound; and at the
   widths of phase 3j: K1 and K4 at (2048, 26, 64) and (2048, 26, 128),
   f32 and bf16; K2 two-source over 4,000,000 cells of 128 and a buffer
   of 16,384 rows at R = 2048·26, f32 and bf16; K3 over such uint8 cells;
   K5 grouped at K = 2048·26 Zipf entries over the 26 Terabyte tables
   (D = 64) and over the cells and the buffer (D = 128, the column tiles
   of 40, 40, 40 and 8); those cases are timed rotating over input sets
   (idx draws, shifted ids or copies) that pass the 50 MB L2 four times
   together, so that no call reads what the one before left in L2; K7,
   the alt-key kNN, at the tool's call on the card (131,072 queries)
   against the first 1,048,576 rows of the Kaggle tables at their init
   scales (k = 10), with its device and host µs and both bounds (the
   function's 72 flop a pair at the TF32 and at the f32 FMA peak),
   the plain version in blocks of 2,048 queries, and at the cases that
   break its design (N = 1,013 and N = 37 < k + m; Q = 1, 3, 2,049; D =
   7, 36, 64, 128; k = 1, 10, 11, 32; duplicate and zero rows; query ids
   of -1; the init's extreme scales side by side; near-ties that fail
   the certificate, every one swept), each launched twice bit for bit
   and held to the plain version by the rule: neighbour sets equal where
   the k-th and k+1-th float64 distances differ by more than 1e-5
   relative, the nearest where the 1st and 2nd do (`knn_rule`);
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
   48-48-4, 75,425 entries), served twice: with one uniform row of each
   row's table as its alt key, from --seed; then with the alt keys of
   the kNN (K7, k = 10) of every row the serving stream's first 60 + 64 +
   1 batches reach (about 0.68M) over all 33,762,577 rows, each row's key
   the most accessed of its 10 by the stream's counts (gen_altkeys'
   rule), 2,048 sampled rows held to the plain version over all rows by
   the rule (the other rows keep their uniform keys).  Each run is
   warmed up until all three tiers are full (at most 60 batches) and
   then scored over 64 batches through `run_inference` with
   `pipeline_depth` 2: the int8 gather's launch count must be above 0, C2
   and C3 must be live, and one more batch's int8 rows must equal the
   plain version's on the same cache state and miss buffer, on the int8
   grid; C3's stats side by side;
3d. the host tiers, over the same tables written to 26 .bin files in a
   temporary directory: (a) the published C1 as the reference's driver
   runs it, the Python `TieredCache` (EvLFU, 64,000 fp32) over an
   `MmapStore`, 16 scored batches, held to the plain forward on the
   store's rows; (b) the published C1+C2+C3 through the engine's host path
   (`use_native`), reading the files and 3c's kNN alt keys from their
   .bin files, 64 batches; (c) the LFU and LRU baselines at 64,000,
   Python (4 batches)
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
   must be above 0, with one grouped gather per train or eval step and
   one K5 call per step (under rwsadagrad its fused row-wise rule, under
   sgd its subtract rule); kernels and copies per step and
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
   bagged batches; exactly one K2 launch per width group and one K5 call
   per update group a step (the subtract rule once under sgd and twice
   under adagrad, the fused row-wise rule once under rwsadagrad), K1 and
   K4 at least once;
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
3g. training through the device-memory-bounded cache
   (`cache/trainable.py::TrainableDeviceCache`, C1 of 64,000 entries, the
   26 tables' 4.86 GB of masters in host memory, B=128, rwsadagrad, lr
   0.1): (1) `cli.main` with bench/dlrm_s_criteo_kaggle.sh's flags plus
   `--use-evstore True --optimizer rwsadagrad --emb-cache-size 64000` on
   3f's preprocessed data (two evals and a save); then in float32
   compute, (7) steps/s, samples/s and the host split (assign, fetch,
   land, step) of the per-batch and pipelined drivers at fp32 and (4) the
   pipelined driver with bf16 and int8 cells over 200 batches (the loss
   must fall, `hbm_bytes` is checked, and one int8 step must keep every
   untouched cell's bytes with each touched code within one of the
   deterministic encode), a profiled window of 16 pipelined steps at fp32
   (device busy share, kernels by name); (6) the device memory runs 1, 4
   and 7 add, at most 256 MiB; (5) the masters mapped from 3f's exported
   .bin files, 100 steps, then `flush_files`, the files equal to
   `host_tables`; (2) 20 batches with
   every key cached against `make_train_step` on the full tables, both
   from the full-table step's state after 20 steps (losses within
   1e-4·(1+|ref|), the changed rows by the step-change rule), and from
   zero row sums a witness: how far the cache, the full-table step with
   every kernel off and the full-table step on the batches in reverse
   sample order part from the full-table step; (3) the
   kernels on against off with fp32, bf16 and int8 cells, 3 held steps
   after 3 warm-up steps each (loss 1e-5, MLPs 1e-4·(1+|ref|), the cells'
   and written-back rows' step change 1e-2, the sums 1e-4 of their own
   size, int8 codes within one of each other's), and K3 at the path's
   shape against its plain version.  Runs 1, 4, 5 and 7 are
   the `train_cached` path: K1, K2, K3, K4 and K5 must each launch there;
3h. the multi-GPU modules (`parallel/`) at world 1 over NCCL in this
   process (NCCL takes one card a rank: more ranks are held on the CPU by
   the tests), with the NCCL version and world size printed: at the full
   Kaggle width, B=128, lr 0.1, (1) `make_sharded_eval_step` against
   `evaluate`; (2) the psum route (`make_sharded_train_step`) under
   rwsadagrad and sgd, 20 steps against `make_train_step` from the same
   state, compounding with the dense exchange and each from the
   reference's state with `dedup_exchange`, bit for bit or by phase 3b's
   rule (printed), and its steps/s beside 3b's; (3)
   `run_training(mesh=make_mesh(1, 1))` against `run_training` on one
   device from the same weights and batches (losses, tables, sums and
   MLPs; the mesh's result comes back on rank 0's host); (4) the butterfly
   route with the planner's order, 5 steps against the psum route's, then
   5 more with K2 and K5 and the same 5 from the same state with the
   plain gather and update (K2 and K5 off; after the warm-up the sums are
   not zero) against the kernels' (the rows the batches touch by phase
   3b's rule, every other row of the 26 slots unchanged in both),
   its steps/s and peak device memory (the stack pads every table to the
   largest); (5)
   `ShardedDeviceC1Cache` at fp32 (64,000 entries) and int8 (the
   C1+C2+C3 script's), 40 batches of phase 3's stream, rows and stats
   equal to `NativeDeviceC1Cache`'s (fp32 rows to the store's), then
   `run_inference(mesh=)` at depth 2, its scores equal to phase 3's and
   its requests/s beside them.  K1, K2 (grouped), K4 and K5 must launch
   on `train_sharded` (2, 3) and `train_butterfly` (4), K1, K2 and K3 on
   `serve_sharded` (5);
3i. the sharded trainable cache and the offline tools, at world 1 over
   NCCL in this process, the Kaggle width (masters of 4.86 GB in host
   memory from --seed, C1 of 64,000 cells, B=128, rwsadagrad, lr 0.1,
   f32 compute): (a) `ShardedTrainableDeviceCache` beside
   `TrainableDeviceCache`, 16 + 100 per-batch steps at fp32 and at int8,
   then over 3f's exported .bin files (`from_files`), each bit for bit
   (losses, flushed tables and row sums, MLPs and their sums, cells),
   `save`'s files byte-equal, with steps/s beside 3g's per-batch rate and
   the device memory it adds; (b) `run_cached_training(mesh=)` beside the
   one-device driver from the same weights with an eval every 50 steps,
   bit for bit, steps/s of both; (c) `gen_altkeys` on the card (K7) over
   the first 1,000,000 rows (k = 10), rows/s beside the 21.1 s the
   plain addmm and topk path took (PERF.md §5), its
   neighbour sets held to the CPU run's on 20,000 of them by the rule;
   (d) the model with its tables cut to 100,000 rows by
   `truncate_tables`, exported at batch 2048 (`torch.export`, the K1
   custom op), saved, loaded and scoring one grouped_zipf batch within
   1e-5·(1+|ref|) of `DLRM.predict`, with the times of each; (e) the
   CLIs of `reduce_precision` (32 -> 8 bits) and `visualize` over 3f's
   tables and `plot_cdf` over 3f's latency CSV, each saying which path
   (plots or the matplotlib-free fallbacks) it took.  K1, K2
   (two-source), K3, K4 and K5 must launch on `train_cached_sharded`
   ((a), (b)), K1 on `export` ((d)), K7 on `tools` ((c));
3j. the MLPerf recipe's shape (bench/run_and_time.sh: dim 128, the 26
   Terabyte tables capped at 40M rows, 104.5 GB at float32, top MLP
   1024-1024-512-256-1, B=2048, lr 1.0 with 2,750 warm-up steps) through
   the trainable cache from sparse masters (memory files, `MemoryFiles`):
   (0) the card, free RAM and disk, the first touch of a page, and the
   pages the runs can touch, held to a quarter of the smaller room; (a)
   `cli.main` with the recipe's model, loss and schedule flags plus
   `--data-generation random --use-evstore True --emb-cache-size
   4000000 --ev-table-path <masters>`, 32 batches; (b) `from_files` per
   batch and pipelined from fresh masters, bit for bit (losses, stats,
   the resident cells and sums, the MLPs and their sums, the rows and
   sums read back from the files), 6 + 32 grouped_zipf batches, at fp32
   and int8 with 4,000,000 cells and fp32 with 64,000,000 (16,000,000
   where those do not fit), each with steps/s, the host split, the
   window's hit rate, the device memory added, host RSS, the pages the
   files took and a profiled window of 3 steps; in (a) and (b) every loss
   finite and under 2 ln 2 (how many pass 0.75 is printed); (c) the
   shape cut to 1M rows a table (3.64 GB, drawn on the card and written
   with `write_ev_tables_binary`): the cache over those files, from
   `make_train_step`'s state after 20 warm-up steps, held to it for 10
   steps, each from one state (`cache_against_full`: the loss 1e-4, the
   rows' step change 1e-2, the MLPs and both sums 1e-4), then the kernels
   on against off by 3g(3)'s rules at fp32 and int8; (d) the Terabyte
   shape (dim 64, 13.87 GB of tables on the card, two copies) held by
   3b's rules under sgd and rwsadagrad at lr 0.1, with steps/s over 50
   steps of `train` after 5.  K1, K2,
   K4 and K5 must launch in every part (`train_mlperf`), K3 in the int8
   cell; the phase's directory is removed at its end;
3k. the MLPerf shape served through EVStore's tiers, with its 104.5 GB of
   tables in memory files on the host and only the cache on the card, by
   a model that holds no tables (`DLRM(tables=False)`): (0) the room, the
   distinct rows one grouped_zipf stream (alpha 1.05, group noise 0.1,
   B = 2048, 60 + 64 + 1 batches) reaches in each table, a seeded float32
   row written into each of them (one pwrite a run of rows, table by
   table in row order) and nothing else, the seconds of the write and the
   pages the files took, held within a quarter of the smaller of free RAM
   and disk; (a) the device C1 of bench/dlrm_s_criteo_kaggle_C1.sh
   (EvLFU, 64,000 fp32 entries) through `NativeDeviceC1Cache.
   open_table_files` and `run_inference`, warmed up until full and scored
   over 64 batches at `pipeline_depth` 0 and 2 (equal scores and stats),
   every row in C1's slots bit for bit the files', the scores within
   1e-5·(1+|ref|) of `DLRM.predict` with every kernel off on rows read
   through a np.memmap of the files; (b) the published three-tier
   configuration (bench/dlrm_s_criteo_kaggle_C1_C2_C3.sh: int8 C1, 4-bit
   C2, alt-key C3 at 48-48-4, 75,425 entries), each row's alt key a
   uniform row of its own table among those the stream reaches (204M
   uint32 keys in the engine), warmed up until every tier is full (at
   most 60 batches) and scored over 64 at depth 2, C2 and C3 live, one
   more batch's int8 rows bit for bit the plain version's and on the
   grid; with requests/s, p50/p99, the host split, C1's hit rate over
   the scored window, the C2/C3 stats and the card's peak allocated
   memory after (a) and (b), held under 2 GiB; K1, K2 and K3 must launch
   (`serve_mlperf`); every cache, engine and memory file is closed at the
   phase's end;
3l. the MLPerf shape from training to serving: (0) the room, fresh
   memory-file masters (every row zero) and the pages the runs can
   touch, held within a quarter of the smaller of free RAM and disk; (a)
   `cli.main` with run_and_time.sh's model, loss and schedule flags plus
   `--data-generation synthetic --use-evstore True --optimizer rwsadagrad
   --emb-cache-size 64000 --ev-table-path <masters> --save-model <ck>
   --test-freq -1`, 32 batches of 2048 (zipf 1.05): it must end `training
   done` with every loss finite and under 2 ln 2 and leave
   `dense_params.npz` in <ck>, whose MLPs differ from the seed's; with
   steps/s, the host split (assign, fetch, land, step), the C1 hit rate,
   the rows landed during the run and flushed at its end, the rows of the
   files that training wrote and the pages the files took; (b) a
   `DLRM(tables=False)` with the MLPs `restore_npz_mlps` reads from <ck>,
   served through the C1 script's device C1 (EvLFU, 64,000 fp32) over
   the trained files on the CLI's own test batches (seed + 1, 10-16 of
   2048, cut by the room) after a warm-up pass over them, at
   `pipeline_depth` 0 and 2 (equal scores and stats), every row in C1's
   slots bit for bit the files', the scores within 1e-5·(1+|ref|) of
   `DLRM.predict` with every kernel off on the files' rows through
   np.memmap, at least half the lookups reading a row training wrote,
   and the seed's MLPs on the same rows outside that bound (the
   witness); (c) the published three tiers over the same files, alt keys
   uniform among the rows training wrote, warmed up on the CLI's stream
   until every tier is full (at most 120 batches), scored at depth 2, C2
   and C3 live, one more batch's int8 rows bit for bit the plain
   version's; (d) `cli.main` with run_and_time.sh's model flags, the C1
   script's serving flags and `--use-device-cache True --ev-table-path
   <masters> --load-model <ck> --data-generation synthetic
   --compute-dtype float32`: it must end `inference done` with a model
   that holds no table and metrics equal to the plain eval of (b)'s
   batches (atol 1e-6, AUC within one tied pair); requests/s, p50/p99,
   the host split and C1's hit rate for (b)-(d), the card's peak
   allocated memory after (b), (c) and (d) held under 2 GiB beside (a)'s;
   K1, K2, K4 and K5 must launch in (a), K1 and K2 in (b) and (d), K1 and
   K3 in (c) (`handoff_mlperf`); every cache, engine and memory file is
   closed at the phase's end;
3m. MLPerf's DLRM-DCNv2 (`config.py::mlperf_dcnv2_config`): K8 against
   its plain version at the cell's shape and at the shapes that break its
   design, timed; the bags' pooling; the cross network with K8 against the
   plain one; K5's fused row-wise rule at the cases that break its design
   (widths 1 to 444, f32 and bf16, long and edge runs), twice bitwise and
   against its plain version and the composite path; K2 over the cell's
   214-column descriptor and K5's grouped row-wise update with `columns=`
   against their plain versions on the same ids [16,384, 214] and rows,
   K5 twice bitwise, timed beside the composite path and K5's bound; six
   `make_train_step` steps of the cell's model on host batches, with the
   launches of K2, K5 and K8 a step counted from zero (`train_dcnv2`);
4. the kernels' launch counts by path (serve, serve_int8, altkeys,
   serve_host, gram_ab, train, train_factored, cli, train_cached,
   train_sharded, train_butterfly, serve_sharded, train_cached_sharded,
   export, tools, train_mlperf, serve_mlperf, handoff_mlperf,
   train_dcnv2) and one
   JSON line describing every kernel (K1-K6, K5's fused row-wise rule
   apart, and K7, which replaces no TPU kernel), each of which must have
   launched on some path;
5. as the last line: {"ok": true, "device": {...}}.

Each serving phase closes its caches, and so their engines (each holds a
copy of the 4.86 GB of tables, or reads the files), its stores and its
temporary files before the next one starts; 3f leaves its preprocessed
data, exported tables and latency CSV to 3g and 3i, after which they are
removed.

`--only 3j` runs phases 0-2 and 3j alone, a quicker check of the MLPerf
shape, and prints neither the kernels line nor the result line; `--only
3k` and `--only 3l` do the same for 3k and 3l.  `--only 3m` runs phases
0-1 and 3m alone: K8, the cross layer's elementwise kernel of MLPerf's
DLRM-DCNv2, against its plain version and timed, the bags' pooling, the
cross network with K8 against the plain one, K5's row-wise rule at its
edge cases, K2 and K5 at the cell's shape against their plain versions,
and six `make_train_step` steps of
the cell's model with their launches (the cell itself is `python3 -m
evbench --workload mlperf-dcnv2.train.rwsadagrad-b16384`).
`--only altkeys [--query-rows A:B]` runs phases 0-2 and then the C3
tier's full kNN: query rows A:B (all by default) of the seeded Kaggle
tables against all their 33,762,577 rows through K7 (the whole range
through `gen_altkeys.generate_altkeys`), with its seconds, rows/s,
TFLOP/s, peak device memory and certified share, every alt key checked
to name a row and 2,048 sampled rows held to the plain version by the
rule; it has its own budget (3,000 s) and no kernels or result line.

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
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "tfloat32": 495e12}
PHASE_BUDGET_S = {"0 environment": 30, "1 build": 180,
                  "2 kernels vs plain": 210, "2b grouped widths": 90,
                  "3 main path": 200, "3c three tiers int8": 300,
                  "3d host tiers": 240, "3b train": 240,
                  "3e train factored": 240, "3f cli": 420,
                  "3g cached training": 300, "3h mesh": 300,
                  "3i sharded cache and tools": 420,
                  "3j mlperf shape": 420, "3k mlperf serving": 240,
                  "3l mlperf train to serve": 240,
                  "3m dlrm-dcnv2": 420, "4 kernels line": 30,
                  "altkeys full kNN": 3000}


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


def step_change(after_a, after_b, before_b):
    """|d_a - d_b| / |d_b|, d = after - before (2-norms), the changes of b
    taken as the plain reference."""
    import numpy as np
    size = float(np.linalg.norm(np.asarray(after_b, np.float64) - before_b))
    diff = float(np.linalg.norm(np.asarray(after_a, np.float64) - after_b))
    return diff / size if size else (0.0 if diff == 0 else np.inf)


CACHE_TO_FULL_LIMITS = {"loss": 1e-4, "rows": 1e-2, "row sums": 1e-4,
                        "MLPs": 1e-4, "MLP sums": 1e-4}


def cache_against_full(torch, tc, model, dst, full, st_f, step_f, batches,
                       step0, run=lambda fn: fn()):
    """The trainable cache `tc` (with `model` and its dense sums `dst`)
    held to the full-table step `step_f` on `full` and its state `st_f`,
    one step at a time from one state: before each batch the cache writes
    its cells back (`flush_to_host`) and the full tables take the batch's
    rows and row sums from the masters, and the MLPs and their sums from
    `model` and `dst`; both then take the batch at step step0 + k (the
    cache's step through run(fn)).  Held after each step
    (CACHE_TO_FULL_LIMITS): the loss |a - b| / (1 + |b|) 1e-4; the batch's
    rows, read back from the masters, by their step change
    |d_cached - d_full| / |d_full| per table 1e-2; the row sums, the MLPs'
    sums (within_own) and the MLPs (|a - b| / (1 + |b|)) 1e-4.  Raises on
    the first step past a limit; -> the worst of each over the steps."""
    import numpy as np
    worst = dict.fromkeys(CACHE_TO_FULL_LIMITS, 0.0)
    dev = full.tables[0].device
    params_f = dict(full.named_parameters())
    T = len(tc.host_tables)
    for k, (dense, idx, y) in enumerate(batches):
        idx = np.asarray(idx)
        rows = [np.unique(idx[:, t]) for t in range(T)]
        rows_d = [torch.from_numpy(r).to(dev) for r in rows]
        tc.flush_to_host()
        before = [np.array(tc.host_tables[t][r]) for t, r in enumerate(rows)]
        with torch.no_grad():
            for t, r in enumerate(rows):
                full.tables[t][rows_d[t]] = torch.from_numpy(
                    before[t]).to(dev)
                st_f.sparse[f"tables.{t}"][rows_d[t]] = torch.from_numpy(
                    np.array(tc.host_mom[t][r])).to(dev)
            for n, p in model.named_parameters():
                params_f[n].copy_(p)
                st_f.dense[n].copy_(dst[n])
        st_f.step = step0 + k
        lc = float(run(lambda: tc.train_batch(model, dst, step0 + k, dense,
                                              idx, y)[2]))
        lf = float(step_f(full, st_f, dense, idx, y))
        tc.flush_to_host()
        got = {"loss": abs(lc - lf) / (1 + abs(lf)), "rows": 0.0,
               "row sums": 0.0, "MLPs": 0.0, "MLP sums": 0.0}
        for t, r in enumerate(rows):
            ref = full.tables[t][rows_d[t]].detach().cpu().numpy()
            got["rows"] = max(got["rows"], step_change(
                tc.host_tables[t][r], ref, before[t]))
            got["row sums"] = max(got["row sums"], within_own(
                torch.from_numpy(np.array(tc.host_mom[t][r])),
                st_f.sparse[f"tables.{t}"][rows_d[t]].cpu(), 1e-4)[1])
        for n, p in model.named_parameters():
            v = params_f[n].detach()
            got["MLPs"] = max(got["MLPs"], float(
                ((p.detach() - v).abs() / (1 + v.abs())).max()))
            got["MLP sums"] = max(got["MLP sums"], within_own(
                dst[n], st_f.dense[n], 1e-4)[1])
        for key, v in got.items():
            worst[key] = max(worst[key], v)
        if not all(got[key] <= lim
                   for key, lim in CACHE_TO_FULL_LIMITS.items()):
            raise AssertionError(f"the cache against the full-table step, "
                                 f"step {step0 + k}: {got} (limits "
                                 f"{CACHE_TO_FULL_LIMITS})")
    return worst


L2_BYTES = 50 * 2**20              # H100 SXM data sheet


def n_sets(nbytes: float, times: int = 4) -> int:
    """How many input sets of `nbytes` each pass the L2 `times` over."""
    return max(1, -(-times * L2_BYTES // max(1, int(nbytes))))


def rotating(calls):
    """One callable that runs calls[0], calls[1], ... in turn: timed over
    input sets that together pass the L2 several times, each call reads
    its inputs from memory, not from what the call before left in L2."""
    k = [0]

    def call():
        k[0] += 1
        return calls[(k[0] - 1) % len(calls)]()
    return call


def on_device(dev_us: float, host_us: float, bms: float):
    """The traced device time beside the bound, as text, and in ms; a
    trace that reads less than the bound (it missed a kernel, or the L2
    held the inputs) is not a reading: 'not measured' and None."""
    if dev_us * 1e-3 < bms:
        return (f" device_us not measured (a trace of {dev_us:.2f} us, "
                f"under the bound) host_us {host_us:.2f}", None)
    return (f" device_us {dev_us:.2f} host_us {host_us:.2f} "
            f"({100 * bms * 1e3 / dev_us:.0f}% of the bound on the device)",
            dev_us / 1e3)


def bound_ms(nbytes: float, ops: float, dtype: str):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def knn_rule(torch, keys, qids, got, ref, k: int, label: str):
    """The correctness rule of the kNN (PERF.md §2): `got` [Q, k] (K7's
    neighbours of the rows keys[qids], or of queries) must hold the plain
    version's set on every row whose k-th and k+1-th float64 distances
    differ by more than 1e-5 relative, and its nearest on every row whose
    1st and 2nd do (ref [Q, k + 1], the plain version's).  `qids` may be a
    [Q, D] tensor of the query rows themselves.  Raises on a miss; ->
    (rows whose sets were held, rows whose nearest was)."""
    q64 = (keys[qids] if qids.dim() == 1 else qids).double()

    def dist(j):
        return ((q64 - keys[ref[:, j]].double()) ** 2).sum(1)

    dk, dk1, d1, d2 = dist(k - 1), dist(k), dist(0), dist(1)
    sep, sep1 = dk1 - dk > 1e-5 * dk, d2 - d1 > 1e-5 * d1
    sets = (torch.sort(got, 1).values != torch.sort(ref[:, :k], 1).values
            ).any(1)
    off = int((sep & sets).sum())
    off1 = int((sep1 & (got[:, 0] != ref[:, 0])).sum())
    if off or off1:
        raise AssertionError(f"knn_topk {label}: {off} of {int(sep.sum())} "
                             f"separated rows' neighbour sets and {off1} of "
                             f"{int(sep1.sum())} nearest keys differ from "
                             f"the plain version's")
    return int(sep.sum()), int(sep1.sum())


def knn_plain(torch, knn_topk_ref, keys, qids, k: int, block: int,
              queries=None):
    """The plain version's k nearest over all keys, `block` query rows at
    a time (its [block, N] distances fit the card)."""
    outs = []
    for s in range(0, len(qids), block):
        ids = qids[s:s + block]
        q = keys[ids] if queries is None else queries[s:s + block]
        outs.append(knn_topk_ref(q.contiguous(), ids, keys, k))
    return torch.cat(outs)


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


def meminfo_kb(field: str) -> int:
    """A field of /proc/meminfo, in kB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith(field + ":"):
                return int(line.split()[1])
    raise KeyError(field)


def rss_gb() -> float:
    """This process's resident set (VmRSS), in GB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024 / 1e9
    raise KeyError("VmRSS")


class MemoryFiles:
    """Sparse float32 masters: in directory `d`, each `ev-table-<t>.bin`
    and `mom-<t>.bin` of `sizes` x `dim` is a link to a memory file
    (`os.memfd_create`) cut to its size with ftruncate, so its holes read
    as zero and only the pages a run touches take memory.  Memory files,
    not files on the checkout's disk: a gVisor 9p filesystem
    reports every file as fully allocated and caches a mapped file 2 MB at
    a time, so random rows over 104.5 GB of tables would cache them whole.
    /proc/meminfo's Shmem counts the pages the files hold (`touched_mb`);
    it is checked to stay flat when the first file is made."""

    def __init__(self, d: str, sizes, dim: int):
        os.makedirs(d)
        self.dir, self.fds = d, []
        self.shmem0 = meminfo_kb("Shmem")
        self.virtual = 0
        for t, n in enumerate(sizes):
            for name, nbytes in ((f"ev-table-{t + 1}.bin", n * dim * 4),
                                 (f"mom-{t + 1}.bin", n * 4)):
                fd = os.memfd_create(name)
                self.fds.append(fd)
                os.ftruncate(fd, nbytes)
                os.symlink(f"/proc/{os.getpid()}/fd/{fd}",
                           os.path.join(d, name))
                self.virtual += nbytes
                if len(self.fds) == 1 and self.touched_mb() > 1.0:
                    raise AssertionError(
                        f"{name} is not sparse: {nbytes} bytes made "
                        f"{self.touched_mb():.1f} MB of shared memory")

    def touched_mb(self) -> float:
        """The MB of pages the files hold (Shmem's growth)."""
        return (meminfo_kb("Shmem") - self.shmem0) / 1024

    def blocks_mb(self) -> float:
        """The files' st_blocks, in MB (a gVisor 9p filesystem reports
        the size)."""
        return sum(os.fstat(fd).st_blocks * 512 for fd in self.fds) / 2**20

    def close(self) -> None:
        for fd in self.fds:
            os.close(fd)
        self.fds = []
        shutil.rmtree(self.dir)


# each kernel of the train path by its function's name (K5 is two: its
# chunks and its cross-chunk pass, under either rule)
TRAIN_KERNELS = {"K1 interaction_fwd": ("interaction_fwd_kernel",),
                 "K2 gather_rows_grouped": ("Grouped<",),
                 "K4 interaction_bwd": ("interaction_bwd_kernel",),
                 "K5 row update": ("chunk_sums_kernel",
                                   "cross_chunk_kernel")}


# the cached train path's: K2's two-source gather, K3 for int8 cells
CACHED_KERNELS = {"K1 interaction_fwd": ("interaction_fwd_kernel",),
                  "K2 gather_rows": ("gather_kernel",),
                  "K3 gather_rows_dequant_int8": ("gather_dequant_kernel",),
                  "K4 interaction_bwd": ("interaction_bwd_kernel",),
                  "K5 row update": ("chunk_sums_kernel",
                                    "cross_chunk_kernel")}


def by_kernel(on_card, n: int, kernels=TRAIN_KERNELS) -> str:
    """Device µs and device kernels a step (K5's launch is two kernels),
    by kernel of the train path, as the trace saw them."""
    return ", ".join(
        f"{label} " + "{:.2f} us ({:g} kernels)".format(
            sum(t for k, (_, t) in on_card.items()
                if any(f in k for f in funcs)) * 1e3 / n,
            sum(c for k, (c, _) in on_card.items()
                if any(f in k for f in funcs)) / n)
        for label, funcs in kernels.items())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=["3j", "3k", "3l", "3m", "altkeys"],
                    default=None,
                    help="run phases 0-2 and this phase alone (a quick "
                         "check; no kernels line and no result line); "
                         "altkeys: the full kNN over the Kaggle tables")
    ap.add_argument("--query-rows", default=None, metavar="A:B",
                    help="with --only altkeys: the query rows A:B of the "
                         "33,762,577 (all by default)")
    args = ap.parse_args()

    import copy
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
                                          kaggle_dlrm_config,
                                          mlperf_dlrm_config,
                                          terabyte_dlrm_config)
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
    from evstore_tpu_torch.ops.cuda_knn import knn_topk, knn_topk_ref
    from evstore_tpu_torch.tools import gen_altkeys
    from evstore_tpu_torch.ops.cuda_interaction import (
        DotInteraction, DotInteractionGram, dot_interaction_bwd_kernel,
        dot_interaction_bwd_ref, dot_interaction_gram_kernel,
        dot_interaction_kernel, dot_interaction_ref, gram_geometry,
        interaction_geometry)
    from evstore_tpu_torch.ops.cuda_update import (
        CHUNK, rwsadagrad_sorted, scatter_sub_sorted,
        scatter_sub_sorted_grouped_ref, scatter_sub_sorted_ref)
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

    def rowwise_cases():
        """K5's fused row-wise rule (`rwsadagrad_sorted`) at the cases that
        break its design, over a group of three tables (73,000 rows): each
        run on two copies (rows and state bitwise equal) and held to its
        plain version (float64 run sums) and to the composite path it
        replaced (tables within 1e-5 (1 + |ref|), a bf16 table one bf16
        ulp more; the state within 1e-5 of its own size).  Widths 1, 18,
        36, 64, 128, 130 and 444 (the widest whose chunk fits), 16-byte
        and 4-byte staging (grads one float off a 16-byte boundary), f32
        and bf16, on Zipf ids with PAD_ROW, negative ids and ids past the
        group; then runs from chunk boundaries, one run of 2,100 entries
        (its cross-chunk sum over 17 chunks passes the look-ahead of 16),
        one of all 65,536, K = 1, K = E*m +- 1, all PAD_ROW and inert ids
        alone, at three widths."""
        from evstore_tpu_torch.ops import cuda_update as cu
        from evstore_tpu_torch.ops.table_desc import table_group
        sizes_ = (20000, 50000, 3000)
        total, E, lr = sum(sizes_), CHUNK, 0.05
        g25 = torch.Generator(device=dev).manual_seed(args.seed + 25)
        rng = np.random.default_rng(args.seed + 25)
        zipf_ = (rng.zipf(1.05, 65536) - 1) % total
        odd = rng.random(65536)
        zipf_[odd < 0.03] = PAD_ROW
        zipf_[(odd >= 0.03) & (odd < 0.04)] = -1
        zipf_[(odd >= 0.04) & (odd < 0.05)] = total
        adversarial = {
            "one run of 2100 among 500": np.concatenate(
                [np.full(2100, 777), rng.integers(0, total, 500)]),
            "one run of all 65536": np.full(65536, 12345),
            f"runs of {E} from every chunk boundary":
                np.repeat(rng.choice(total, 64, replace=False), E),
            f"runs of {E // 2}, {E} and {3 * E} from chunk boundaries":
                np.concatenate([np.repeat(np.arange(8), E // 2),
                                np.repeat(np.arange(8, 12), E),
                                np.repeat(np.arange(12, 15), 3 * E)]),
            "K=1": np.asarray([7]),
            f"K={5 * E + 1}": rng.integers(0, 40, 5 * E + 1),
            f"K={5 * E - 1}": rng.integers(0, 40, 5 * E - 1),
            "all PAD_ROW": np.full(1000, PAD_ROW),
            "negative ids and ids past the group alone": np.concatenate(
                [np.full(300, -1), np.full(10, -5), np.full(200, total),
                 np.full(10, total + 1000)]),
        }

        def case(D, dt, ids, label, misalign=False):
            tdt = getattr(torch, dt)
            tabs0 = [(torch.rand(n, D, generator=g25, device=dev) * 0.2
                      - 0.1).to(tdt) for n in sizes_]
            st0 = torch.rand(total, generator=g25, device=dev) * 0.01
            gid = torch.from_numpy(rng.permutation(ids).astype(np.int32)
                                   ).to(dev)
            rows_s, order = torch.sort(gid, stable=True)
            K = gid.numel()
            buf = torch.randn(K * D + 1, generator=g25, device=dev) * 1e-2
            grads = (buf[1:] if misalign else buf[:-1]).view(K, D)
            runs = []
            for fn in (rwsadagrad_sorted, rwsadagrad_sorted,
                       cu.rwsadagrad_sorted_ref, "composite"):
                t_, s_ = [t.clone() for t in tabs0], st0.clone()
                if fn == "composite":   # inert ids as the sort makes them
                    rows_c, order_c = torch.sort(torch.where(
                        (gid >= 0) & (gid < total), gid, PAD_ROW),
                        stable=True)
                    cu._rwsadagrad_composite(
                        table_group("composite", t_, True), s_, t_, rows_c,
                        grads[order_c], lr, cu.EPS)
                else:
                    fn(s_, t_, rows_s, order, grads, lr)
                runs.append((t_, s_))
            torch.cuda.synchronize()
            (kt, ks), (kt2, ks2) = runs[:2]
            ok = all(torch.equal(a, b)
                     for a, b in zip(kt + [ks], kt2 + [ks2]))
            errs = []
            for rt, rs in runs[2:]:
                e_t = 0.0
                for a, b in zip(kt, rt):
                    ok_, e_ = within(a, b, 1e-5, dt == "bfloat16")
                    ok, e_t = ok and ok_, max(e_t, e_)
                ok_, e_s = within_own(ks, rs, 1e-5)
                ok = ok and ok_
                errs += [e_t, e_s]
            print(f"  K5 row-wise D={D} {dt}{' (grads off 16 B)' * misalign}"
                  f" {label}: against the plain version max|d| "
                  f"{errs[0]:.3g}, state {errs[1]:.3g}; against the "
                  f"composite path {errs[2]:.3g}, {errs[3]:.3g}; two runs "
                  f"bitwise equal", flush=True)
            if not ok:
                raise AssertionError(f"K5's row-wise rule at D={D} {dt} "
                                     f"{label}: {errs}")

        label = "zipf(1.05) K=65536, 5% inert"
        for D, dt, mis in ((128, "float32", False), (128, "bfloat16", False),
                           (128, "float32", True), (36, "float32", False),
                           (36, "bfloat16", False), (64, "float32", False),
                           (1, "float32", False), (18, "bfloat16", False),
                           (130, "float32", False), (444, "float32", False)):
            case(D, dt, zipf_, label, mis)
        for D, dt in ((128, "float32"), (36, "bfloat16"), (130, "float32")):
            for label, ids in adversarial.items():
                case(D, dt, ids, label)
        torch.cuda.empty_cache()

    # ---------------------------------------------- 3m DLRM-DCNv2 and K8
    def phase_3m():
        """K8 (`ops/cuda_cross.py`) against its plain version at the
        DLRM-DCNv2 cell's shape (B = 16,384, N = 27 x 128) and at the
        cases that break its design (B = 1, 3, 257; N = 3,455, which takes
        the scalar path; inputs one float off a 16-byte boundary), each
        launched twice and bit for bit; timed beside its bound and the
        plain version; the bags' pooling (`torch.segment_reduce`) against
        `index_add`; the cross network's Function with K8 against the
        plain one, forward and backward; K5's fused row-wise rule at the
        cases that break its design (`rowwise_cases`).  Then the benchmark
        cell's model
        (one chip's share of the recipe's tables, 54,184,588 rows drawn on
        the card) and ids [16,384, 214], each column skewed over its
        table: K2 over the 214-entry descriptor bit for bit the plain
        gather's; K5's grouped row-wise update with `columns=` against the
        plain dedup path table by table from the same rows and state
        (rows' change and state within 1e-4 of their own size, one call
        of the fused rule, no subtract launch), run twice (bitwise equal)
        and against the composite path it replaced; both timed beside the
        plain versions, K5 also beside the composite path and its bound.
        Last, the counts zeroed and six `make_train_step` steps of
        `mlperf_dcnv2_config` on host batches of the cell's shape: one K2
        launch, one fused K5 call and three K8 forwards and backwards a
        step, no K1 or K4, B x 214 gathered rows a step.  Returns those steps'
        launches (`train_dcnv2`) and the fused rule's kernels-line
        entry."""
        from evstore_tpu_torch.models.embedding import pool_columns
        from evstore_tpu_torch.ops.cuda_cross import (
            LowRankCross, cross_layer_bwd, cross_layer_bwd_ref,
            cross_layer_fwd, cross_layer_fwd_ref)
        from evstore_tpu_torch.ops import cuda_update as cu
        from evstore_tpu_torch.ops.cuda_update import rwsadagrad_row_update
        from evstore_tpu_torch.config import (MLPERF_MULTI_HOT_SIZES,
                                              mlperf_dcnv2_config)
        from evstore_tpu_torch.train.optim import row_state_views, row_update
        with Phase("3m dlrm-dcnv2"):
            cross_layer_fwd.launches = cross_layer_bwd.launches = 0
            g3 = torch.Generator(device=dev).manual_seed(args.seed + 3)

            def arrays(B, N, off=0):
                x = torch.randn(5 * B * N + N + off, generator=g3,
                                device=dev)[off:]
                return [x[k * B * N:(k + 1) * B * N].view(B, N)
                        for k in range(5)] + [x[5 * B * N:5 * B * N + N]]

            def case(B, N, off=0):
                x0, u, xl, g, acc, b = arrays(B, N, off)
                y = cross_layer_fwd(x0, u, b, xl)
                y2 = cross_layer_fwd(x0, u, b, xl)
                ref = cross_layer_fwd_ref(x0.double(), u.double(),
                                          b.double(), xl.double())
                ok_f, d_f = within(y.double(), ref, 1e-6)
                res = []
                for accumulate, residual in ((False, False), (True, True)):
                    a1 = acc.clone() if accumulate else None
                    a2 = acc.clone() if accumulate else None
                    gu, gb, gx = cross_layer_bwd(g, x0, u, b, a1, residual)
                    gu2, gb2, gx2 = cross_layer_bwd(g, x0, u, b, a2,
                                                    residual)
                    rgu, rgb, rgx = cross_layer_bwd_ref(
                        g.double(), x0.double(), u.double(), b.double(),
                        acc.double() if accumulate else None, residual)
                    same = torch.equal(gu, gu2) and torch.equal(gb, gb2) \
                        and torch.equal(gx, gx2)
                    ok_u, _ = within(gu.double(), rgu, 1e-6)
                    ok_x, d_x = within(gx.double(), rgx, 1e-6)
                    # a column sum of B float32 values: its error scales
                    # with the sum of their magnitudes
                    d_b = float(((gb.double() - rgb).abs()
                                 / (g * x0).abs().sum(0).double()
                                 .clamp_min(1e-30)).max())
                    res.append((same, ok_u and ok_x and d_b <= 1e-6,
                                d_x, d_b))
                same_f = torch.equal(y, y2)
                good = ok_f and same_f and all(s and o for s, o, _, _ in res)
                print(f"  K8 B={B} N={N} off={off}: forward max|d| {d_f:.3g}"
                      f", twice equal {same_f}; backward (write, "
                      f"accumulate+residual): " + "; ".join(
                          f"twice equal {s}, gx max|d| {dx:.3g}, gb rel "
                          f"{db:.3g}" for s, _, dx, db in res), flush=True)
                if not good:
                    raise AssertionError(f"K8 at B={B} N={N} off={off}")

            for B, N, off in ((16384, 3456, 0), (1, 3456, 0), (3, 3456, 0),
                              (257, 3456, 0), (257, 3455, 0), (64, 3456, 1),
                              (300000, 8, 0)):
                case(B, N, off)

            B, N = 16384, 3456
            x0, u, xl, g, acc, b = arrays(B, N)
            fwd_ms = time_ms(torch, lambda: cross_layer_fwd(x0, u, b, xl))
            bwd_ms = time_ms(torch, lambda: cross_layer_bwd(g, x0, u, b,
                                                            acc, False))
            fwd_dev, fwd_host = device_host_us(
                torch, lambda: cross_layer_fwd(x0, u, b, xl))
            bwd_dev, bwd_host = device_host_us(
                torch, lambda: cross_layer_bwd(g, x0, u, b, acc, False))
            fwd_plain = time_ms(torch, lambda: cross_layer_fwd_ref(
                x0, u, b, xl))
            bwd_plain = time_ms(torch, lambda: cross_layer_bwd_ref(
                g, x0, u, b, acc, False))
            fb, _ = bound_ms(4 * (4 * B * N + N), 3 * B * N, "float32")
            bb, _ = bound_ms(4 * (6 * B * N + 2 * N), 5 * B * N, "float32")
            print(f"  K8 at [{B}, {N}] f32: forward {fwd_ms:.4f} ms, "
                  f"device {fwd_dev:.2f} us ({100 * fb * 1e3 / fwd_dev:.0f}%"
                  f" of the bound {fb:.4f} ms), host {fwd_host:.2f} us, "
                  f"plain {fwd_plain:.4f} ms; backward (accumulating) "
                  f"{bwd_ms:.4f} ms, device {bwd_dev:.2f} us "
                  f"({100 * bb * 1e3 / bwd_dev:.0f}% of the bound "
                  f"{bb:.4f} ms), host {bwd_host:.2f} us, plain "
                  f"{bwd_plain:.4f} ms", flush=True)
            del x0, u, xl, g, acc, b

            # the bags' pooling at the cell's shape
            L = MLPERF_MULTI_HOT_SIZES
            rows = torch.randn(B, sum(L), 128, generator=g3, device=dev)
            cols = torch.tensor([t for t, n in enumerate(L)
                                 for _ in range(n)], device=dev)
            got = pool_columns(rows, L)
            ref = torch.zeros(B, len(L), 128, device=dev,
                              dtype=torch.float64).index_add_(
                1, cols, rows.double())
            ok_p, d_p = within(got.double(), ref, 1e-5)
            same_p = torch.equal(got, pool_columns(rows, L))
            pool_ms = time_ms(torch, lambda: pool_columns(rows, L))
            print(f"  pooling [{B}, {sum(L)}, 128] -> [{B}, {len(L)}, 128]:"
                  f" max|d| {d_p:.3g} against float64, twice equal "
                  f"{same_p}, {pool_ms:.4f} ms (bytes bound "
                  f"{4 * B * (sum(L) + len(L)) * 128 / HBM_BYTES_PER_S * 1e3:.4f}"
                  f" ms)", flush=True)
            if not (ok_p and same_p):
                raise AssertionError("the bags' pooling")
            del rows, got, ref

            # the whole network, K8 against the plain version
            r = 512
            x0 = torch.randn(B, N, generator=g3, device=dev) * 0.3
            ps = []
            for _ in range(3):
                s = (2.0 / (N + r)) ** 0.5
                ps += [torch.randn(r, N, generator=g3, device=dev) * s,
                       torch.randn(N, r, generator=g3, device=dev) * s,
                       torch.randn(N, generator=g3, device=dev) * 0.02]
            gy = torch.randn(B, N, generator=g3, device=dev)
            outs = []
            for use_kernel in (True, False):
                xs = x0.clone().requires_grad_(True)
                pp = [p.clone().requires_grad_(True) for p in ps]
                y = LowRankCross.apply(xs, torch.float32, use_kernel, *pp)
                y.backward(gy)
                outs.append([y.detach(), xs.grad] + [p.grad for p in pp])
            gaps = [float((a - b).norm() / b.norm().clamp_min(1e-30))
                    for a, b in zip(*outs)]
            print(f"  cross network [{B}, {N}] x 3 layers, rank {r}: K8 "
                  f"against the plain version, relative norm gaps: output "
                  f"{gaps[0]:.3g}, x0's gradient {gaps[1]:.3g}, V/W/b's "
                  f"worst {max(gaps[2:]):.3g}", flush=True)
            if max(gaps) > 1e-5:
                raise AssertionError("the cross network with K8")
            print(f"  launches of these checks: cross_layer_fwd "
                  f"{cross_layer_fwd.launches}, cross_layer_bwd "
                  f"{cross_layer_bwd.launches}", flush=True)
            del x0, ps, gy, outs
            torch.cuda.empty_cache()

            rowwise_cases()

            # the cell's model: one chip's share of the recipe's tables
            # (the five 40M-row tables quartered), drawn on the card
            sizes = [n // 4 if n == 40_000_000 else n
                     for n in mlperf_dlrm_config().table_sizes]
            cfg_c = mlperf_dcnv2_config(table_sizes=sizes)
            cols, C, D = cfg_c.bag_columns(), len(cfg_c.bag_columns()), 128

            class Drawn:
                def __len__(self):
                    return len(sizes)

                def __iter__(self):
                    for n in sizes:
                        yield torch.rand(n, D, generator=g3, device=dev) \
                            .mul_(2).sub_(1).mul_((1.0 / n) ** 0.5)

            t0 = time.perf_counter()
            model = DLRM(cfg_c, device=dev, seed=args.seed, tables=Drawn())
            tabs = list(model.tables)
            lim = torch.tensor([sizes[t] for t in cols], device=dev)
            offs = torch.tensor([0] + sizes[:-1], device=dev).cumsum(0)[
                torch.tensor(cols, device=dev)]

            def draw_ids():
                """ids [B, 214]: each column skewed over its table's rows
                (u^4), so hot rows repeat within and across bags."""
                u = torch.rand(B, C, generator=g3, device=dev,
                               dtype=torch.float64)
                return torch.minimum((u ** 4 * lim).long(), lim - 1).to(
                    torch.int32).contiguous()

            idx = draw_ids()
            U = torch.unique(idx.long() + offs).numel()
            print(f"  model: {sum(sizes):,} rows x {D} "
                  f"({4 * D * sum(sizes) / 1e9:.2f} GB) drawn in "
                  f"{time.perf_counter() - t0:.2f} s; ids [{B}, {C}], "
                  f"{U:,} distinct (table, row) keys", flush=True)

            # K2 over the 214-entry descriptor (a table once a column)
            desc = [tabs[t] for t in cols]
            gather_rows_grouped.launches = 0
            got = gather_rows_grouped(desc, idx)
            same2 = torch.equal(got, gather_rows_grouped(desc, idx))
            ok2 = torch.equal(got, gather_rows_grouped_ref(desc, idx))
            del got
            k2_ms = time_ms(torch, lambda: gather_rows_grouped(desc, idx))
            k2_plain = time_ms(torch, lambda: gather_rows_grouped_ref(
                desc, idx), reps=5, warmup=1)
            k2b, _ = bound_ms(4 * B * C + 4 * D * (B * C + U), 0, "float32")
            print(f"  K2 grouped [{B}, {C}] x {D} over the 214-column "
                  f"descriptor: equal to the plain version {ok2}, twice "
                  f"equal {same2}; {k2_ms:.4f} ms ({100 * k2b / k2_ms:.0f}%"
                  f" of the bound {k2b:.4f} ms), plain {k2_plain:.4f} ms",
                  flush=True)
            if not (ok2 and same2):
                raise AssertionError("K2 over the bags' descriptor")

            # K5: the grouped row-wise update with `columns=` (its fused
            # rule) against the plain dedup path table by table, from the
            # same rows and state; twice, bitwise; timed beside the
            # composite path it replaced and K5's bound
            lr = 0.005
            grads = torch.randn(B, C, D, generator=g3, device=dev)
            sel = [[c for c, t in enumerate(cols) if t == j]
                   for j in range(len(sizes))]
            touched = [torch.unique(idx[:, s].reshape(-1).long())
                       for s in sel]
            rows0 = [tab[u].clone() for tab, u in zip(tabs, touched)]
            flat = torch.zeros(sum(sizes), device=dev)
            views = list(row_state_views(flat, sizes).values())

            def plain_update():
                for j, s in enumerate(sel):
                    row_update("rwsadagrad", views[j], tabs[j],
                               idx[:, s].reshape(-1),
                               grads[:, s].reshape(-1, D), lr,
                               use_kernel=False)

            def kernel_update():
                rwsadagrad_row_update(flat, tabs, idx, grads, lr,
                                      columns=cols)

            def composite_update():
                """The path the fused rule replaced: the sort, the
                subtract rule's run sums, tensor passes, its update."""
                g_, rs, order, flat_g = cu._sorted_ids(
                    "composite", flat, tabs, idx, grads,
                    lambda n, D_: (n,), cols)
                cu._rwsadagrad_composite(g_, flat, tabs, rs,
                                         flat_g.float()[order], lr, cu.EPS)

            def run_from_start(update):
                with torch.no_grad():
                    for tab, u, r0 in zip(tabs, touched, rows0):
                        tab[u] = r0
                    flat.zero_()
                    update()
                    return ([tab[u] - r0 for tab, u, r0 in
                             zip(tabs, touched, rows0)],
                            [v[u] for v, u in zip(views, touched)])

            dp, sp = run_from_start(plain_update)
            scatter_sub_sorted.launches = rwsadagrad_sorted.launches = 0
            dk, sk = run_from_start(kernel_update)
            k5_calls = (scatter_sub_sorted.launches,
                        rwsadagrad_sorted.launches)
            dk2, sk2 = run_from_start(kernel_update)
            twice = all(torch.equal(a, b) for a, b in zip(dk + sk,
                                                          dk2 + sk2))
            del dk2, sk2
            ok_d, d_d = within_own(torch.cat(dk), torch.cat(dp), 1e-4)
            ok_s, d_s = within_own(torch.cat(sk), torch.cat(sp), 1e-4)
            dc, sc = run_from_start(composite_update)
            _, c_d = within_own(torch.cat(dk), torch.cat(dc), 1e-4)
            _, c_s = within_own(torch.cat(sk), torch.cat(sc), 1e-4)
            del dp, sp, dk, sk, dc, sc
            n_rows = sum(u.numel() for u in touched)
            k5_ms = time_ms(torch, kernel_update, reps=10, warmup=2)
            comp_ms = time_ms(torch, composite_update, reps=10, warmup=2)
            k5_plain = time_ms(torch, plain_update, reps=3, warmup=1)
            # the fused call alone, from the sorted ids, beside the bound
            # of the benchmark's K5 reader (evbench/roofline/k5.py: ids,
            # values and each row read once, each row written once) and
            # of all it moves (the order and each row's state too)
            g_, rs, order, flat_g = cu._sorted_ids(
                "fused", flat, tabs, idx, grads, lambda n, D_: (n,), cols)
            K_ = rs.numel()
            call = lambda: rwsadagrad_sorted(  # noqa: E731
                flat, tabs, rs, order, flat_g, lr)
            f_ms = time_ms(torch, call, reps=10, warmup=2)
            f_dev, f_host = device_host_us(torch, call, reps=5, calls=20)
            kb, _ = bound_ms(4 * K_ + 4 * D * K_ + 8 * D * n_rows, 0,
                             "float32")
            fb, fby = bound_ms(12 * K_ + 4 * D * K_ + 8 * D * n_rows
                               + 8 * n_rows, float(3 * D * n_rows),
                               "float32")
            del g_, rs, order, flat_g
            print(f"  K5 rwsadagrad, K = {B * C:,} entries over 26 tables "
                  f"(columns=), {n_rows:,} rows: against the plain dedup "
                  f"path, the rows' change max|d|/(|ref| + mean |ref|) "
                  f"{d_d:.3e}, the row state {d_s:.3e} (limit 1e-4); "
                  f"against the composite path {c_d:.3e}, {c_s:.3e}; two "
                  f"runs bitwise equal {twice}; launches a call (subtract "
                  f"rule, fused rule) {k5_calls}; {k5_ms:.4f} ms a call "
                  f"with the sort (composite path {comp_ms:.4f} ms, plain "
                  f"{k5_plain:.4f} ms); the fused call alone {f_ms:.4f} ms,"
                  f" device {f_dev:.2f} us, host {f_host:.2f} us: "
                  f"{100 * kb * 1e3 / f_dev:.0f}% of K5's bound "
                  f"{kb:.4f} ms, {100 * fb * 1e3 / f_dev:.0f}% of the bound"
                  f" of all it moves {fb:.4f} ms ({fby}) [{card}]",
                  flush=True)
            k5_entry = dict(
                max_abs_err=max(d_d, d_s), ms=f_ms, device_ms=f_dev / 1e3,
                plain_ms=k5_plain, bound_ms=fb, bound_by=fby,
                library_ms=None)
            if not (ok_d and ok_s and twice and k5_calls == (0, 1)):
                raise AssertionError("K5's grouped update over the bags")
            del grads, rows0, flat, views, touched, desc, idx

            # the main path: make_train_step at the cell's batch and bags,
            # host batches as the cell feeds them, counts zeroed just before
            tcfg = TrainConfig(batch_size=B, learning_rate=lr,
                               optimizer="rwsadagrad")
            st = init_opt_state(model, tcfg)
            step = make_train_step(cfg_c, tcfg)
            batches = [(torch.rand(B, 13, generator=g3, device=dev)
                        .cpu().numpy(), draw_ids().cpu().numpy(),
                        torch.randint(0, 2, (B,), generator=g3, device=dev)
                        .float().cpu().numpy()) for _ in range(3)]
            float(step(model, st, *batches[0]))
            counted = {"gather_rows_grouped": gather_rows_grouped,
                       "scatter_sub_sorted": scatter_sub_sorted,
                       "rwsadagrad_sorted": rwsadagrad_sorted,
                       "cross_layer_fwd": cross_layer_fwd,
                       "cross_layer_bwd": cross_layer_bwd,
                       "interaction_fwd": dot_interaction_kernel,
                       "interaction_bwd": dot_interaction_bwd_kernel}
            for w in counted.values():
                w.launches = 0
            gather_rows_grouped.rows = 0
            n_steps = 6
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = [step(model, st, *batches[k % 3])
                      for k in range(n_steps)]
            torch.cuda.synchronize()
            step_ms = 1e3 * (time.perf_counter() - t0) / n_steps
            losses = [float(x) for x in losses]
            launches = {k: w.launches for k, w in counted.items()}
            rows = gather_rows_grouped.rows
            want = {"gather_rows_grouped": n_steps,
                    "scatter_sub_sorted": 0, "rwsadagrad_sorted": n_steps,
                    "cross_layer_fwd": 3 * n_steps,
                    "cross_layer_bwd": 3 * n_steps,
                    "interaction_fwd": 0, "interaction_bwd": 0}
            print(f"  make_train_step, mlperf_dcnv2_config, B={B}, 214 ids "
                  f"a sample, rwsadagrad lr {lr}: {n_steps} steps "
                  f"{step_ms:.2f} ms a step ({B / step_ms * 1e3:,.0f} "
                  f"samples/s, host batches), losses "
                  f"{[round(x, 5) for x in losses]}; launches "
                  f"{json.dumps(launches)}; gathered rows {rows:,} "
                  f"({rows // n_steps:,} a step = {B} x {C}); peak "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
                  flush=True)
            if launches != want or rows != n_steps * B * C or \
                    not all(np.isfinite(losses)):
                raise AssertionError(f"the DLRM-DCNv2 train step: launches "
                                     f"{launches}, want {want}; rows {rows}")
            del model, st, step, batches, tabs
            torch.cuda.empty_cache()
            return launches, k5_entry

    if args.only == "3m":
        phase_3m()
        print(f"total: {time.perf_counter() - t_all:.2f} s (phases 0-1 "
              f"and 3m)")
        return 0

    # ----------------------------------------------- 2 kernels vs plain
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    report = {}
    wrappers = {"interaction_fwd": dot_interaction_kernel,
                "interaction_bwd": dot_interaction_bwd_kernel,
                "interaction_gram": dot_interaction_gram_kernel,
                "gather_rows": gather_rows,
                "gather_rows_grouped": gather_rows_grouped,
                "gather_rows_dequant_int8": gather_rows_dequant_int8,
                "scatter_sub_sorted": scatter_sub_sorted,
                "rwsadagrad_sorted": rwsadagrad_sorted,
                "knn_topk": knn_topk}

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    def read_counts():
        return {name: w.launches for name, w in wrappers.items()}

    def never_launched(got, names):
        """The kernels of `names` that did not launch in `got`; K5
        (`scatter_sub_sorted`) launched if either of its rules did, the
        subtract rule or the fused row-wise rule (`rwsadagrad_sorted`)."""
        k5 = got["scatter_sub_sorted"] + got["rwsadagrad_sorted"]
        return [k for k in names
                if (k5 if k == "scatter_sub_sorted" else got[k]) < 1]

    def held_on_off(tcfg_, model, plain, take, label=""):
        """Phase 3b's check: five steps with every kernel on, each held to a
        step with every kernel off taken from the same state (on `plain`, a
        copy of `model` built from the config with the kernels off); then
        five more from one state, compounding, held to the same rule after
        every step (loss 1e-5 relative; MLPs and tables 1e-4·(1+|ref|);
        accumulators 1e-4 of their own size).  The per-step loss sees only
        the forward (K1, K2); the compounded losses see K4 and K5 through
        the state they leave behind.  take(n) gives n batches.  -> (the
        step with the kernels, its state)."""
        off_t = dataclasses.replace(tcfg_, use_update_kernel=False)
        step_k, step_p = (make_train_step(model.cfg, tcfg_),
                          make_train_step(plain.cfg, off_t))
        st_k, st_p = init_opt_state(model, tcfg_), init_opt_state(plain,
                                                                  off_t)

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
                      for t in range(model.cfg.num_tables)]
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
            print(f"{label}kernels on vs off, 5 {tcfg_.optimizer} steps "
                  f"{mode}: max rel loss diff {worst['loss']:.3e} (limit "
                  f"1e-5); max|d|/"
                  f"(1+|ref|) MLPs {worst['mlp']:.3e}, tables "
                  f"{worst['table']:.3e} (limit 1e-4); accumulators max|d|/"
                  f"(|ref| + mean nonzero |ref|) {worst['acc']:.3e} (limit "
                  f"1e-4)", flush=True)
        return step_k, st_k

    def cached_on_off(trainer, work, moms, sd0, dst0, held_b, precisions,
                      tag, step0=1):
        """Phase 3g(3)'s check of the trainable cache with every kernel on
        against every kernel off, at each of `precisions` (32, 16, 8 bits):
        trainer(bits, on) -> (cache, model, dense state) over the shared
        masters `work` (list of [N_t, D] float32); both start from the
        rows `work` holds for the six batches `held_b`, the row sums
        `moms`, the MLPs `sd0` and their sums `dst0`; 3 warm-up steps, then
        3 held ones, each from one state (the plain trainer takes the kernel
        trainer's cells, MLPs and sums before each step, and the masters'
        rows are swapped so that it starts from the same ones): the loss
        1e-5 relative, the MLPs 1e-4·(1+|ref|), the cells' and the
        written-back rows' step change 1e-2 of the plain change's norm, the
        row and dense sums 1e-4 of their own size.  At 8 bits both trainers
        seed the stochastic encode with the step index on one device, so
        they draw the same u: every code must lie within one of the other
        side's; and K3 at the batch's shape over the int8 cells is held to
        its plain version bit for bit.  Steps are numbered from step0."""
        from evstore_tpu_torch.cache import trainable as trn
        rows3 = [np.unique(np.concatenate([np.asarray(b[1])[:, t]
                                           for b in held_b]))
                 for t in range(len(work))]
        start3 = [work[t][rows3[t]].copy() for t in range(len(work))]
        limits = {"loss": 1e-5, "mlp": 1e-4, "cells": 1e-2,
                  "rows": 1e-2, "sums": 1e-4}

        def as_f32(v):
            return trn._q8_decode(v) if v.dtype == torch.uint8 \
                else v.float()

        for precision in precisions:
            for t in range(len(work)):
                work[t][rows3[t]] = start3[t]
            tk, mk, sk = trainer(precision, True)
            tp, mp, sp = trainer(precision, False)
            with torch.no_grad():
                mk.load_state_dict(sd0)
                for n_ in sk:
                    sk[n_].copy_(dst0[n_])
            for t in range(len(work)):
                tk.host_mom[t][:] = moms[t]
            held = dict.fromkeys(limits, 0.0)
            codes = [0, 0]      # the largest code distance, codes apart
            for k, b in enumerate(held_b):
                idx = np.asarray(b[1])
                with torch.no_grad():
                    tp.cache_values.copy_(tk.cache_values)
                    tp.cache_mom.copy_(tk.cache_mom)
                    mp.load_state_dict(mk.state_dict())
                    for n_ in sk:
                        sp[n_].copy_(sk[n_])
                    cells0 = tk.cache_values.clone()
                # the masters are shared and the row sums apart: the
                # plain trainer starts from the rows and sums the
                # kernel trainer started from, which then gets its own
                # back
                pre = [(work[t][idx[:, t]].copy(),
                        tk.host_mom[t][idx[:, t]].copy())
                       for t in range(len(work))]
                lk = float(tk.train_batch(mk, sk, step0 + k, *b)[2])
                post_k = [(work[t][idx[:, t]].copy(),
                           tk.host_mom[t][idx[:, t]].copy())
                          for t in range(len(work))]
                for t, (rows, sums) in enumerate(pre):
                    work[t][idx[:, t]] = rows
                    tp.host_mom[t][idx[:, t]] = sums
                scat = {}
                assign = tp.assigner.assign_batch_train_raw

                def spy(ids):
                    out = assign(ids)
                    scat["slots"], scat["m"] = out[1], out[2]
                    return out

                tp.assigner.assign_batch_train_raw = spy
                lp = float(tp.train_batch(mp, sp, step0 + k, *b)[2])
                tp.assigner.assign_batch_train_raw = assign
                post_p = [(work[t][idx[:, t]].copy(),
                           tp.host_mom[t][idx[:, t]].copy())
                          for t in range(len(work))]
                for t, (rows, _) in enumerate(post_k):
                    work[t][idx[:, t]] = rows
                if k < 3:
                    continue
                # the cells' change, each inserted cell from the row it
                # took, as its cell's type holds it (the plain
                # trainer's buffer keeps the row)
                start = as_f32(cells0)
                slots = torch.from_numpy(scat["slots"]).long().to(dev)
                start[slots] = as_f32(tp._encode_det(tp._buf[
                    torch.from_numpy(scat["m"]).long().to(dev)]))
                held["cells"] = max(held["cells"], step_change(
                    as_f32(tk.cache_values).cpu().numpy(),
                    as_f32(tp.cache_values).cpu().numpy(),
                    start.cpu().numpy()))
                if precision == 8:
                    gap = (tk.cache_values.int()
                           - tp.cache_values.int()).abs()
                    codes[0] = max(codes[0], int(gap.max()))
                    codes[1] += int((gap > 0).sum())
                    if codes[0] > 1:
                        raise AssertionError(f"{tag} int8, step {k + 1}"
                                             f": codes {codes[0]} apart")
                held["rows"] = max(held["rows"], step_change(
                    np.concatenate([r for r, _ in post_k]),
                    np.concatenate([r for r, _ in post_p]),
                    np.concatenate([r for r, _ in pre])))
                held["loss"] = max(held["loss"], abs(lk - lp) / abs(lp))
                ref_sd = mp.state_dict()
                for n_, a in mk.state_dict().items():
                    v = ref_sd[n_]
                    held["mlp"] = max(held["mlp"], float(
                        ((a - v).abs() / (1 + v.abs())).max()))
                for a, v in [(tk.cache_mom, tp.cache_mom)] + [
                        (sk[n_], sp[n_]) for n_ in sk] + [
                        (torch.from_numpy(mk_), torch.from_numpy(mp_))
                        for (_, mk_), (_, mp_) in zip(post_k, post_p)]:
                    held["sums"] = max(held["sums"], within_own(
                        a, v, 1e-4)[1])
                if not all(held[k_] <= lim
                           for k_, lim in limits.items()):
                    raise AssertionError(f"{tag} kernels on against "
                                         f"off at {precision} bits, "
                                         f"step {k + 1}: {held}")
            k3 = ""
            if precision == 8:
                # K3 at this path's shape: one source, the uint8 cells,
                # the batch's idx [B, T]
                shape = np.asarray(held_b[0][1]).shape
                gi = torch.randint(0, tk.capacity, shape,
                                   dtype=torch.int32, device=dev)
                got = gather_rows_dequant_int8(tk.cache_values, gi)
                want_ = gather_rows_dequant_int8_ref(tk.cache_values,
                                                     gi)
                if not torch.equal(got, want_):
                    raise AssertionError(f"{tag} K3 at {list(shape)} "
                                         f"over the int8 cells differs "
                                         f"from its plain version")
                k3 = (f"; int8 codes at most {codes[0]} apart, "
                      f"{codes[1]} codes apart in all; K3 at idx "
                      f"{list(shape)} over the {tk.capacity} x {tk.dim}"
                      f" uint8 cells equals its "
                      f"plain version bit for bit")
            print(f"{tag} kernels on against off at {precision} bits, "
                  f"3 held steps after 3 warm-up ones (per-batch, from "
                  f"(2)'s state): max rel loss diff "
                  f"{held['loss']:.3e} (limit 1e-5); MLPs "
                  f"max|d|/(1+|ref|) {held['mlp']:.3e} (limit 1e-4); "
                  f"step change |d_on - d_off| / |d_off| of the cells "
                  f"{held['cells']:.3e} and of the rows written back "
                  f"{held['rows']:.3e} (limit 1e-2); row and dense sums "
                  f"max|d|/(|ref| + mean nonzero |ref|) "
                  f"{held['sums']:.3e} (limit 1e-4){k3}", flush=True)
            tk.close()
            tp.close()
            del tk, tp, mk, mp, sk, sp

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

    def phase_3f(d):
        """The CLI end to end at the full Kaggle width through
        `cli.main`: preprocess a synthetic train.txt and train with
        bench/dlrm_s_criteo_kaggle.sh's flags (one final eval writes one
        checkpoint and one EV export), resume from the checkpoint (every
        step skipped; the state it restores and saves again must be the
        saved one bit for bit), hold the exported tables to the
        checkpoint's bit for bit, then serve the exported tables with the
        C1 script's flags, the C1+C2+C3 script's and C1 on the device
        cache, beside the plain eval of the same checkpoint.  Each CLI run
        is counted on the `cli` path, its counts set to 0 just before.  It
        works in `d`, and leaves the preprocessed data and the exported
        tables there for phase 3g."""
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
            shutil.rmtree(ck)       # 3g needs the data and the export
            path = {k: launches[k] for k in (
                "interaction_fwd", "interaction_bwd", "gather_rows",
                "gather_rows_grouped", "scatter_sub_sorted",
                "rwsadagrad_sorted")}
            if never_launched(path, ("interaction_fwd", "interaction_bwd",
                                     "gather_rows_grouped",
                                     "scatter_sub_sorted")):
                raise AssertionError(f"a kernel of the CLI's path never ran: "
                                     f"{launches}")
            print(f"cli path launches: {json.dumps(path)}", flush=True)
            return path

    # ------------------------------------------- 3g cached training
    CACHED_C1 = 64_000      # bench/dlrm_s_criteo_kaggle_C1.sh's cache size
    CACHED_HBM = 256 << 20  # the device memory the phase may add, at most
    cached_rates = {}       # 3g's steps/s by (driver, bits), beside 3i's
    CACHED_B = 128          # the recipe's batch
    CACHED_N = 200          # batches of the bf16 and int8 runs
    CACHED_FILES = 100      # batches over the mapped files

    def phase_3g(d):
        """Training through `TrainableDeviceCache` at the full Kaggle width,
        the tables in host memory and C1 of 64,000 entries on the card:
        (1) `cli.main` with bench/dlrm_s_criteo_kaggle.sh's flags plus
        `--use-evstore True --optimizer rwsadagrad --emb-cache-size 64000`
        on 3f's preprocessed data; (4) bf16 and int8 cells, 200 batches
        each (the loss falls, `hbm_bytes`, int8's untouched cells keep
        their bytes); (5) the masters mapped from 3f's exported .bin files,
        100 batches, then `flush_files`; (7) steps/s of the two drivers at
        fp32, the host split and a profiled window; all of them counted on the
        `train_cached` path, and the device memory they add held to 256
        MiB (runs 1 and 4); then (2) the cache against the full-table step
        where nothing is evicted, with a witness from zero row sums, and
        (3) the kernels on against off at 32, 16 and 8 bits."""
        import contextlib

        from evstore_tpu_torch import cli
        from evstore_tpu_torch.cache import trainable as trn
        from evstore_tpu_torch.data.criteo import CriteoDataset
        from evstore_tpu_torch.data.synthetic import learnable_batches
        from evstore_tpu_torch.models.dlrm import init_host_tables
        launches = dict.fromkeys(wrappers, 0)

        def counted(fn):
            """fn() with every count set to 0 just before; its launches go
            to the path's."""
            reset_counts()
            out = fn()
            for k, v in read_counts().items():
                launches[k] += v
            return out

        def run_cli(argv):
            tee = Tee(sys.stdout)
            with contextlib.redirect_stdout(tee):
                rc = cli.main(argv)
            if rc != 0:
                raise AssertionError(f"cli.main returned {rc}")
            return "\n".join(tee.text)

        def grown():
            return torch.cuda.max_memory_allocated() - mem0

        with Phase("3g cached training"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            mem0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            train_flags = bench_flags("dlrm_s_criteo_kaggle.sh")
            parsed = cli.build_parser().parse_args(train_flags)
            kcfg, _, _ = cli.configs_from_args(parsed)
            sizes = kcfg.table_sizes
            D = kcfg.embedding_dim
            gb = sum(sizes) * D * 4 / 1e9
            pf = os.path.join(d, "out", "processed", "kaggle_processed.npz")
            n_train = CriteoDataset.load(pf).splits()[0][1] // CACHED_B

            # (1) the CLI
            save = os.path.join(d, "cached")
            argv = train_flags + [
                "--processed-data-file", pf, "--use-evstore", "True",
                "--optimizer", "rwsadagrad", "--emb-cache-size",
                str(CACHED_C1), "--test-freq", str(n_train),
                "--print-freq", "10", "--save-model", save]
            t0 = time.perf_counter()
            out = counted(lambda: run_cli(argv))
            secs = time.perf_counter() - t0
            trained = re.search(r"trained (\d+) steps in ([\d.]+) s "
                                r"\(([\d.]+) steps/s\)", out)
            done = re.search(r"cached training done: steps=(\d+) "
                             r"cache=(\{.*\}) best=([-\d.na]+)", out)
            if trained is None or done is None or \
                    int(trained.group(1)) != n_train:
                raise AssertionError(f"the cached CLI run did not train "
                                     f"{n_train} steps")
            evals = re.findall(r"eval @ (\d+): auc ([-\d.na]+)", out)
            if len(evals) != 2 or not os.path.exists(
                    os.path.join(save, "dense_params.npz")):
                raise AssertionError(f"the cached CLI run: evals {evals}")
            print(f"3g(1) cli [{card}]: {n_train} steps at "
                  f"{trained.group(3)} steps/s "
                  f"({float(trained.group(3)) * CACHED_B:.0f} samples/s;"
                  f" the run took {secs:.2f} s with 2 evals and one save"
                  f" of {gb:.3f} GB); best auc {done.group(3)}; cache "
                  f"{done.group(2)}; device memory added so far "
                  f"{grown() / 2**20:.1f} MiB", flush=True)
            shutil.rmtree(save)

            # runs 2-7 compute in float32, as phase 3b does (the CLI's
            # default is bfloat16); their masters are the seed's tables and
            # a copy to train, whose touched rows are reset after each run
            kcfg = dataclasses.replace(kcfg, compute_dtype="float32")
            t0 = time.perf_counter()
            base = init_host_tables(kcfg, args.seed + 31)
            work = [t.copy() for t in base]
            stream = list(learnable_batches(RandomDataConfig(
                num_dense=kcfg.num_dense_features, table_sizes=sizes,
                batch_size=CACHED_B, num_batches=2 * CACHED_N,
                seed=args.seed + 33, distribution="grouped_zipf",
                zipf_alpha=1.05, group_noise=0.1)))
            print(f"3g masters: {gb:.3f} GB of tables and "
                  f"{sum(sizes) * 4 / 1e9:.3f} GB of row sums in host "
                  f"memory a trainer, drawn and copied with "
                  f"{len(stream)} learnable grouped_zipf batches in "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)

            def reset(batches):
                for t in range(len(sizes)):
                    rows = np.unique(np.concatenate(
                        [np.asarray(b[1])[:, t] for b in batches]))
                    work[t][rows] = base[t][rows]

            def trainer(precision=32, capacity=CACHED_C1, cfg=kcfg,
                        opt=TrainConfig(learning_rate=0.1,
                                        optimizer="rwsadagrad")):
                tc = trn.TrainableDeviceCache(
                    cfg, opt, CacheConfig(total_size=capacity,
                                          main_precision=precision), work,
                    copy_tables=False, device=dev)
                model = DLRM(cfg, device=dev, seed=args.seed, tables=False)
                return tc, model, trn.init_dense_state(model)

            def drive(tc, model, dst, batches, how):
                if how == "batch":
                    return [tc.train_batch(model, dst, k + 1, *b)[2]
                            for k, b in enumerate(batches)]
                return [x[2] for x in tc.train_batches(model, dst, batches)]

            # (7) the two drivers at fp32, then (4) bf16 and int8
            rates = {}
            for how, precision, n in (("batch", 32, 100),
                                      ("pipelined", 32, 100),
                                      ("pipelined", 16, CACHED_N),
                                      ("pipelined", 8, CACHED_N)):
                tc, model, dst = trainer(precision)
                warm, timed = stream[:16], stream[16:n]
                counted(lambda: drive(tc, model, dst, warm, how))
                for k in tc.host_s:
                    tc.host_s[k] = 0.0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses = counted(lambda: drive(tc, model, dst, timed, how))
                losses = [float(x) for x in losses]
                secs = time.perf_counter() - t0
                st = tc.stats()
                item = {32: 4, 16: 2, 8: 1}[precision]
                if st["hbm_bytes"] != CACHED_C1 * (D * item + 4):
                    raise AssertionError(f"hbm_bytes {st['hbm_bytes']}")
                if not all(np.isfinite(losses)):
                    raise AssertionError(f"{how} {precision}: a loss is "
                                         f"not finite")
                split = ", ".join(f"{k} {v / len(timed) * 1e3:.3f}"
                                  for k, v in tc.host_s.items())
                rates[(how, precision)] = len(timed) / secs
                cached_rates[(how, precision)] = rates[(how, precision)]
                print(f"3g(7) {how} at {precision} bits [{card}]: "
                      f"{len(timed)} steps after 16 in {secs:.3f} s = "
                      f"{len(timed) / secs:.2f} steps/s "
                      f"({len(timed) * CACHED_B / secs:.0f} samples/s); "
                      f"host ms a step: {split}; C1 hit rate "
                      f"{st['hit_rate']:.4f}, {st['hbm_bytes']} bytes of "
                      f"cache; device memory added so far "
                      f"{grown() / 2**20:.1f} MiB", flush=True)
                if precision != 32:
                    first = np.mean(losses[:20])
                    last = np.mean(losses[-20:])
                    if not last < first:
                        raise AssertionError(f"{precision} bits: the loss "
                                             f"did not fall: {first} -> "
                                             f"{last}")
                    print(f"3g(4) {precision}-bit cells: mean loss of the "
                          f"first 20 steps {first:.5f}, of the last 20 "
                          f"{last:.5f}", flush=True)
                if precision == 8:
                    # one more step with the stochastic encode watched
                    before = tc.cache_values.clone()
                    seen = {}
                    encode = trn._q8_encode_sr
                    assign = tc.assigner.assign_batch_train_raw

                    def spy_encode(x, gen):
                        seen["x"], seen["codes"] = x, encode(x, gen)
                        return seen["codes"]

                    def spy_assign(idx):
                        out = assign(idx)
                        seen["scat"] = out[1].copy()
                        seen["target"] = np.where(out[6] == 2**31 - 1,
                                                  out[0], out[6])
                        return out

                    trn._q8_encode_sr = spy_encode
                    tc.assigner.assign_batch_train_raw = spy_assign
                    try:
                        counted(lambda: tc.train_batch(
                            model, dst, n + 1, *stream[n]))
                    finally:
                        trn._q8_encode_sr = encode
                        tc.assigner.assign_batch_train_raw = assign
                    # touched: the cells the batch's positions update
                    inserted = torch.zeros(CACHED_C1, dtype=torch.bool,
                                           device=dev)
                    inserted[torch.from_numpy(seen["scat"]).long()
                             .to(dev)] = True
                    target = seen["target"][seen["target"] < CACHED_C1]
                    moved = torch.zeros_like(inserted)
                    moved[torch.from_numpy(target).long().to(dev)] = True
                    keep = ~moved & ~inserted
                    det = trn._q8_encode_det(seen["x"]).int()
                    off = int((seen["codes"].int() - det).abs().max())
                    if not torch.equal(tc.cache_values[keep],
                                       before[keep]) or not torch.equal(
                            tc.cache_values[moved],
                            seen["codes"][moved]) or off > 1:
                        raise AssertionError("int8 cells: untouched bytes "
                                             "moved or a code strayed")
                    print(f"3g(4) int8: {int(keep.sum())} untouched cells "
                          f"kept their bytes, {int(moved.sum())} touched "
                          f"ones took their stochastic codes, each within "
                          f"{off} code of the deterministic encode; "
                          f"{int(inserted.sum())} inserted", flush=True)
                    del before, seen, det
                if (how, precision) == ("pipelined", 32):
                    # a profiled window: device-busy share
                    it = iter(stream[n:n + 16])
                    wall, on_card = profile_steps(
                        torch, lambda: counted(lambda: drive(
                            tc, model, dst, list(it), how)), 1)
                    busy = sum(t for _, t in on_card.values())
                    print(f"3g(7) a profiled window of 16 steps: "
                          f"{wall:.2f} ms wall, device busy {busy:.3f} ms "
                          f"({busy / wall:.1%}), "
                          f"{sum(c for c, _ in on_card.values())} kernels "
                          f"and copies; "
                          f"{by_kernel(on_card, 16, CACHED_KERNELS)}",
                          flush=True)
                tc.close()
                del tc, model, dst
                reset(stream[:n + 17])
            grew = grown()
            if grew > CACHED_HBM:
                raise AssertionError(f"cached training added {grew} bytes of"
                                     f" device memory (limit {CACHED_HBM})")
            print(f"3g(6) device memory: at most {grew / 2**20:.1f} MiB "
                  f"above the phase's start through runs 1, 4 and 7 "
                  f"(limit {CACHED_HBM / 2**20:.0f} MiB) against {gb:.3f} "
                  f"GB of master tables in host memory", flush=True)

            # (5) the masters mapped from 3f's exported files
            ev = os.path.join(d, "ev")
            tc = trn.TrainableDeviceCache.from_files(
                kcfg, TrainConfig(learning_rate=0.1, optimizer="rwsadagrad"),
                CacheConfig(total_size=CACHED_C1), ev, sizes, device=dev)
            model = DLRM(kcfg, device=dev, seed=args.seed, tables=False)
            dst = trn.init_dense_state(model)
            t0 = time.perf_counter()
            counted(lambda: drive(tc, model, dst, stream[:CACHED_FILES],
                                  "pipelined"))
            tc.flush_files()
            secs = time.perf_counter() - t0
            same = True
            for t, n in enumerate(sizes):
                on_disk = np.memmap(os.path.join(ev, f"ev-table-{t + 1}.bin"),
                                    np.float32, mode="r", shape=(n, D))
                moms = np.memmap(os.path.join(ev, f"mom-{t + 1}.bin"),
                                 np.float32, mode="r", shape=(n,))
                same &= bool(np.array_equal(on_disk, tc.host_tables[t])
                             and np.array_equal(moms, tc.host_mom[t]))
                del on_disk, moms
            touched = sum(int((m != 0).sum()) for m in tc.host_mom)
            tc.close()
            del tc, model, dst
            if not same or touched == 0:
                raise AssertionError("the mapped files differ from "
                                     "host_tables after flush_files")
            print(f"3g(5) from_files over 3f's {len(sizes)} exported .bin "
                  f"files: {CACHED_FILES} pipelined steps and flush_files in"
                  f" {secs:.2f} s; the files equal host_tables and host_mom "
                  f"bit for bit, {touched} rows trained", flush=True)

            # (2) no eviction: the cache against the full-table step.  From
            # the seed's weights and zero sums the first steps move every
            # weight by about lr (the loss reaches 1e4-1e5 at step 2), and
            # a row whose gradient cancels to rounding takes a first update
            # lr·G/|G| whose size and sign that rounding sets: the witness
            # runs the cache, the full-table step with every kernel off
            # (`index_add_`'s order changes from run to run) and the
            # full-table step fed each batch in reverse sample order (its
            # sums taken in another fixed order) from there and prints how
            # far each parts from the full-table step.  The held comparison
            # starts the cache from the full-table step's state after those
            # steps
            n2 = warm = 20
            tcfg = TrainConfig(learning_rate=0.1, optimizer="rwsadagrad")
            off_cfg = dataclasses.replace(kcfg, use_gather_kernel=False,
                                          use_interaction_kernel=False)
            off_t = TrainConfig(learning_rate=0.1, optimizer="rwsadagrad",
                                use_update_kernel=False)
            full = DLRM(kcfg, device=dev, seed=args.seed, tables=base)
            st_f = init_opt_state(full, tcfg)
            step_f = make_train_step(kcfg, tcfg)

            def ids_of(batches, t):
                return np.unique(np.concatenate(
                    [np.asarray(b[1])[:, t] for b in batches]))

            def gaps(a, ref):
                d = [abs(x - r) / (1 + abs(r)) for x, r in zip(a, ref)]
                big = [k + 1 for k, x in enumerate(d) if x > 1e-4]
                return (f"max {max(d):.3e}, first above 1e-4 at step "
                        f"{big[0] if big else None}")

            tc, model, dst = trainer(capacity=n2 * CACHED_B * len(sizes))
            from_zero = [float(x) for x in drive(tc, model, dst,
                                                 stream[:warm], "batch")]
            tc.close()
            del tc, model, dst
            ref0 = [float(step_f(full, st_f, *b)) for b in stream[:warm]]
            plain = DLRM(off_cfg, device=dev, seed=args.seed, tables=base)
            st_o = init_opt_state(plain, off_t)
            step_o = make_train_step(off_cfg, off_t)
            off0 = [float(step_o(plain, st_o, *b)) for b in stream[:warm]]
            del plain, st_o, step_o
            torch.cuda.empty_cache()
            rev = DLRM(kcfg, device=dev, seed=args.seed, tables=base)
            st_r = init_opt_state(rev, tcfg)
            rev0 = [float(step_f(rev, st_r, *(np.asarray(x)[::-1].copy()
                                              for x in b)))
                    for b in stream[:warm]]
            del rev, st_r
            torch.cuda.empty_cache()
            print(f"3g(2) witness, {warm} steps from the seed's weights and "
                  f"zero sums, losses |a - b| / (1 + |b|) against the "
                  f"full-table step's: the cache {gaps(from_zero, ref0)}; "
                  f"the full-table step with every kernel off "
                  f"{gaps(off0, ref0)}; the full-table step on the batches "
                  f"in reverse sample order {gaps(rev0, ref0)}", flush=True)

            tc, model, dst = trainer(capacity=n2 * CACHED_B * len(sizes))
            for t in range(len(sizes)):
                rows = ids_of(stream[:warm], t)
                rows_d = torch.from_numpy(rows).to(dev)
                work[t][rows] = full.tables[t][rows_d].cpu()
                tc.host_mom[t][rows] = st_f.sparse[f"tables.{t}"][rows_d].cpu()
            with torch.no_grad():
                params_f = dict(full.named_parameters())
                for n_, p_ in model.named_parameters():
                    p_.copy_(params_f[n_])
                    dst[n_].copy_(st_f.dense[n_])
            batches = stream[warm:warm + n2]
            before = [work[t][ids_of(batches, t)] for t in range(len(sizes))]
            losses = [float(x) for x in drive(tc, model, dst, batches,
                                              "batch")]
            tc.flush_to_host()
            ref = [float(step_f(full, st_f, *b)) for b in batches]
            dl = max(abs(a - b) / (1 + abs(b)) for a, b in zip(losses, ref))
            worst = 0.0
            for t in range(len(sizes)):
                rows = ids_of(batches, t)
                got = full.tables[t][torch.from_numpy(rows).to(dev)]
                worst = max(worst, step_change(work[t][rows],
                                               got.cpu().numpy(), before[t]))
            keys = sum(len(ids_of(batches, t)) for t in range(len(sizes)))
            if tc.stats()["size"] != keys or not dl <= 1e-4 or \
                    not worst <= 1e-2:
                raise AssertionError(f"cached against full-table: losses "
                                     f"{dl}, step change {worst}, "
                                     f"{tc.stats()['size']} cached of "
                                     f"{keys} keys")
            print(f"3g(2) {n2} steps with every key cached "
                  f"(capacity {tc.capacity}, {keys} keys, none evicted), "
                  f"both from make_train_step's state after {warm} steps on "
                  f"the full tables: losses within {dl:.3e} of 1 + |ref| "
                  f"of its next {n2} (limit 1e-4), the changed rows' step "
                  f"change |d_cached - d_full| / |d_full| {worst:.3e} "
                  f"(limit 1e-2)", flush=True)
            moms = tc.host_mom
            tc.close()
            del tc, full, st_f, step_f, params_f
            torch.cuda.empty_cache()

            # (3) the kernels on against off at 32, 16 and 8 bits, each from
            # (2)'s state
            held_b = stream[warm + n2:warm + n2 + 6]
            sd0 = {k: v.clone() for k, v in model.state_dict().items()}
            dst0 = {k: v.clone() for k, v in dst.items()}
            del model, dst
            cached_on_off(
                lambda p, on: trainer(p) if on else trainer(
                    p, cfg=off_cfg, opt=off_t),
                work, moms, sd0, dst0, held_b, (32, 16, 8), "3g(3)")
            del work, base, stream, moms
            path = {k: launches[k] for k in (
                "interaction_fwd", "interaction_bwd", "gather_rows",
                "gather_rows_dequant_int8", "scatter_sub_sorted",
                "rwsadagrad_sorted")}
            if never_launched(path, tuple(path)[:-1]):
                raise AssertionError(f"a kernel of the cached path never "
                                     f"ran: {launches}")
            print(f"train_cached path launches: {json.dumps(path)}",
                  flush=True)
            return path

    # ------------------------------------------------------- 3h the mesh
    def phase_3h(serve3):
        """The port's multi-GPU modules at world 1 over NCCL, in this
        process (NCCL takes one card a rank; more ranks than one card are
        held on the CPU by the tests): the psum route (the row-sharded step
        at the full Kaggle width, rwsadagrad and sgd, dense and dedup
        exchange, 20 steps each against `make_train_step` from the same
        state; `run_training(mesh=)` against `run_training` on one device;
        the sharded eval against `evaluate`), the butterfly route (the
        planner's order, 5 steps against the psum route, then 5 more
        against its plain gather and update from the same state), and
        `ShardedDeviceC1Cache` (fp32 at 64,000 entries and int8
        at the C1+C2+C3 script's size against `NativeDeviceC1Cache`, then
        `run_inference(mesh=)` at depth 2 against phase 3's scores).
        Returns the launch counts of the paths train_sharded,
        train_butterfly and serve_sharded."""
        import torch.distributed as dist

        from evstore_tpu_torch.drivers.train import run_training
        from evstore_tpu_torch.parallel import butterfly as bf
        from evstore_tpu_torch.parallel import sharded as sh
        from evstore_tpu_torch.parallel.mesh import make_mesh
        from evstore_tpu_torch.parallel.multihost import init_multihost
        from evstore_tpu_torch.parallel.planner import plan_table_shards
        from evstore_tpu_torch.train.train_loop import make_eval_step
        paths = {p: dict.fromkeys(wrappers, 0) for p in (
            "train_sharded", "train_butterfly", "serve_sharded")}

        def counted(path, fn):
            """fn() with every count set to 0 just before; its launches go
            to `path`."""
            reset_counts()
            out = fn()
            for k, v in read_counts().items():
                paths[path][k] += v
            return out

        def gib(n):
            return f"{n / 2 ** 30:.2f} GiB"

        def held(a, b, what, worst):
            """Bit for bit (as floats), else phase 3b's rule: 1e-4·(1 +
            |ref|); the largest difference kept in `worst`."""
            a, b = a.detach(), b.detach()
            if torch.equal(a, b):
                return
            ok, d = within(a, b, 1e-4)
            worst[what] = max(worst.get(what, 0.0), d)
            if not ok:
                raise AssertionError(f"{what} differs: max|d| {d}")

        def held_sums(a, b, what, worst):
            if torch.equal(a, b):
                return
            ok, d = within_own(a, b, 1e-4)
            worst[what] = max(worst.get(what, 0.0), d)
            if not ok:
                raise AssertionError(f"{what} differs: {d}")

        def held_losses(got, ref, what, worst):
            for k, (g, r) in enumerate(zip(got, ref)):
                if g == r:
                    continue
                d = abs(g - r) / abs(r)
                worst[what] = max(worst.get(what, 0.0), d)
                if not d <= 1e-5:
                    raise AssertionError(f"{what} {k}: loss {g}, ref {r}")

        def parted(worst):
            return ("bit for bit" if not worst else
                    "parted, within phase 3b's rule: " + ", ".join(
                        f"{k} {v:.3e}" for k, v in worst.items()))

        def steps_per_s(step, batches, windows=2):
            """Steps/s of `step` over the batches, the median window."""
            rates = []
            for _ in range(windows):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for b in batches:
                    step(*b)
                torch.cuda.synchronize()
                rates.append(len(batches) / (time.perf_counter() - t0))
            return sorted(rates)[len(rates) // 2], rates

        with Phase("3h mesh"):
            _, world = init_multihost(device=dev.type, timeout_s=120)
            mesh = make_mesh(device=dev)
            nccl = torch.cuda.nccl.version()
            nccl = ".".join(map(str, nccl)) if isinstance(nccl, tuple) \
                else str(nccl)
            print(f"mesh: NCCL {nccl}, backend {dist.get_backend()}, world {world} in this "
                  f"process ({torch.cuda.device_count()} card(s)), mesh "
                  f"{mesh.shape}, rank (d, m) = ({mesh.d}, {mesh.m}) on "
                  f"{mesh.device}", flush=True)
            B = 128
            rws = TrainConfig(batch_size=B, learning_rate=0.1,
                              optimizer="rwsadagrad")
            sgd = dataclasses.replace(rws, optimizer="sgd")
            stream = list(random_batches(RandomDataConfig(
                num_dense=cfg.num_dense_features, table_sizes=cfg.table_sizes,
                batch_size=B, num_batches=20 + 2 * 20 + 2, seed=args.seed + 9,
                distribution="grouped_zipf", zipf_alpha=1.05,
                group_noise=0.1)))
            checked, timed, evals = stream[:20], stream[20:40], stream[60:]
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            base = DLRM(cfg, device=dev, seed=args.seed)
            print(f"set-up: the Kaggle model on {dev} in "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)

            # the sharded eval against evaluate on the same weights
            sm, _ = sh.shard_dlrm_params(base, mesh)
            seval = sh.make_sharded_eval_step(cfg, mesh)
            got = torch.cat([seval(sm, d, i) for d, i, _ in evals])
            ref = torch.cat([make_eval_step(cfg)(base, d, i)
                             for d, i, _ in evals])
            worst = {}
            held(got, ref, "eval probabilities", worst)
            m_got = evaluate(sm, cfg, evals, seval)
            m_ref = evaluate(base, cfg, evals)
            if m_got != m_ref:
                raise AssertionError(f"sharded eval {m_got} != {m_ref}")
            print(f"make_sharded_eval_step over {len(evals)} batches of {B}: "
                  f"probabilities {parted(worst)} against evaluate's; "
                  f"metrics equal ({m_ref})", flush=True)
            del sm

            # the psum route: 20 steps against make_train_step from the
            # same state (the reference a whole copy of the same weights):
            # the dense exchange compounding from one state, the dedup
            # exchange each step from the reference's state (its unique
            # rows' grads are summed in another order)
            @torch.no_grad()
            def sync(dst, dst_st, src, src_st):
                for a_, b_ in zip(dst.parameters(), src.parameters()):
                    a_.copy_(b_)
                for part in ("dense", "sparse"):
                    for k, v in getattr(src_st, part).items():
                        getattr(dst_st, part)[k].copy_(v)
                dst_st.step = src_st.step

            def compare(sm, st, ref, ref_st, worst):
                for i in range(cfg.num_tables):
                    held(sm.tables[i], ref.tables[i], "tables", worst)
                for k, v in ref_st.sparse.items():
                    held_sums(st.sparse[k], v, "row sums", worst)
                for k, v in ref_st.dense.items():
                    held_sums(st.dense[k], v, "dense sums", worst)
                for a_, b_ in zip(sm.parameters(), ref.parameters()):
                    if a_.requires_grad:
                        held(a_, b_, "MLPs", worst)

            for t in (rws, sgd):
                step_ref = make_train_step(cfg, t)
                for dedup in (False, True):
                    ref, ref_st = sh.shard_dlrm_params(
                        base, mesh, init_opt_state(base, t))
                    sm, st = sh.shard_dlrm_params(base, mesh,
                                                  init_opt_state(base, t))
                    step = sh.make_sharded_train_step(cfg, t, mesh,
                                                      dedup_exchange=dedup)
                    worst = {}
                    if not dedup:
                        ref_losses = [float(step_ref(ref, ref_st, *b))
                                      for b in checked]
                        losses = counted("train_sharded", lambda: [
                            float(step(sm, st, *b)) for b in checked])
                        held_losses(losses, ref_losses, "loss", worst)
                        compare(sm, st, ref, ref_st, worst)
                        mode = "compounding from one state"
                    else:
                        for b in checked:
                            sync(sm, st, ref, ref_st)
                            lr_ = float(step_ref(ref, ref_st, *b))
                            ls_ = counted("train_sharded",
                                          lambda: float(step(sm, st, *b)))
                            held_losses([ls_], [lr_], "loss", worst)
                            compare(sm, st, ref, ref_st, worst)
                        mode = "each from the reference's state"
                    rate, rates = counted("train_sharded", lambda: steps_per_s(
                        lambda *b: step(sm, st, *b), timed))
                    print(f"psum route, {t.optimizer}, "
                          f"{'dedup' if dedup else 'dense'} exchange [{card}]:"
                          f" 20 steps {mode} against make_train_step: "
                          f"losses, tables, sums and MLPs {parted(worst)}; "
                          f"{rate:.2f} steps/s (windows "
                          f"{', '.join(f'{r:.2f}' for r in rates)}; phase 3b "
                          f"{t.optimizer} in this run: "
                          f"{train_rates[t.optimizer]:.2f})", flush=True)
                    del sm, st, step, ref, ref_st
                    torch.cuda.empty_cache()
            # run_training over the mesh against run_training on one
            # device, from the same weights and batches (a loss logged
            # every 5 steps); the mesh's result is on rank 0's host
            logged = dataclasses.replace(rws, print_freq=5)
            lines, one_lines = [], []
            one = run_training(cfg, logged, lambda: checked, seed=args.seed,
                               log_fn=one_lines.append,
                               model=copy.deepcopy(base))
            res = counted("train_sharded", lambda: run_training(
                cfg, logged, lambda: checked, seed=args.seed, mesh=mesh,
                log_fn=lines.append, model=base))
            rate_line = next(x for x in lines if x.startswith("trained "))
            one_rate = next(x for x in one_lines if x.startswith("trained "))
            if res.steps != 20 or res.opt_state.step != one.opt_state.step \
                    or [s for s, _ in res.history["loss"]] != [5, 10, 15, 20]:
                raise AssertionError(f"run_training(mesh=) gave {res.steps}"
                                     f" steps, logged {res.history['loss']}")
            if res.model.tables[0].device.type != "cpu":
                raise AssertionError("run_training(mesh=)'s result is not "
                                     "on the host")
            worst = {}
            held_losses([x for _, x in res.history["loss"]],
                        [x for _, x in one.history["loss"]], "loss", worst)
            for i in range(cfg.num_tables):
                held(res.model.tables[i].to(dev), one.model.tables[i],
                     "tables", worst)
            for part, what in (("sparse", "row sums"),
                               ("dense", "dense sums")):
                for k, v in getattr(one.opt_state, part).items():
                    held_sums(getattr(res.opt_state, part)[k].to(dev), v,
                              what, worst)
            for a_, b_ in zip(res.model.parameters(),
                              one.model.parameters()):
                if a_.requires_grad:
                    held(a_.to(dev), b_, "MLPs", worst)
            print(f"run_training(mesh=make_mesh(1, 1)), rwsadagrad, 20 "
                  f"steps against run_training on one device from the same "
                  f"weights and batches: losses (steps 5-20), tables, sums "
                  f"and MLPs {parted(worst)}; the result on rank 0's host; "
                  f"{rate_line} (one device: {one_rate}) [{card}]",
                  flush=True)
            del res, one
            torch.cuda.empty_cache()
            print(f"psum route: peak device memory {gib(torch.cuda.max_memory_allocated())} "
                  f"(the model, its reference copy and the shard with their "
                  f"sums)", flush=True)

            # the butterfly route: the planner's order, 5 steps against
            # the psum route's
            sm, st = sh.shard_dlrm_params(base, mesh, init_opt_state(base,
                                                                     rws))
            step = sh.make_sharded_train_step(cfg, rws, mesh)
            p_losses = [float(step(sm, st, *b)) for b in checked[:5]]
            order, imb = plan_table_shards(cfg.table_sizes, mesh.world)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            bst = bf.init_butterfly_state(base, rws, mesh, order)
            torch.cuda.synchronize()
            print(f"butterfly: order {order} (imbalance {imb:.2f}), stack "
                  f"{tuple(bst.stack.shape)} built in "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
            bstep = bf.make_butterfly_train_step(cfg, rws, mesh,
                                                 table_order=order)
            b_losses = counted("train_butterfly", lambda: [
                float(bstep(bst, *b)) for b in checked[:5]])
            worst = {}
            held_losses(b_losses, p_losses, "loss", worst)
            for t, n in enumerate(cfg.table_sizes):     # plain tables
                slot = order.index(t)
                held(bst.stack[slot, :n], sm.tables[t], "tables", worst)
                held_sums(bst.row_state[slot, :n],
                          st.sparse[f"tables.{t}"], "row sums", worst)
            # then 5 more steps from that state with K2 and K5, and the
            # same 5 from the same state through the plain gather and
            # update: the grouped K2 over the 26 slots and the grouped K5
            # over the flat row state at their largest shapes, against
            # their plain versions.  From the fresh state (zero sums) the
            # first rwsadagrad step moves each weight by lr times the sign
            # of its gradient, so rounding would choose the sign where a
            # gradient cancels; after 5 steps the sums are not zero, as
            # 3g(2) starts its held comparison after warm-up steps.  What
            # both runs start from: the rows the 5 batches touch, the
            # MLPs, their sums and the step, and per slot the integer sum
            # of every other row's bits
            held_b = checked[5:10]
            slots = [order.index(t) for t in range(cfg.num_tables)]
            touched = [torch.from_numpy(np.unique(np.concatenate(
                [np.asarray(b[1])[:, t] for b in held_b]))).to(dev)
                for t in range(cfg.num_tables)]

            def touched_rows():
                return ([bst.stack[j, touched[t]].clone()
                         for t, j in enumerate(slots)],
                        [bst.row_state[j, touched[t]].clone()
                         for t, j in enumerate(slots)])

            def rest_bits():
                out = []
                for x in (bst.stack, bst.row_state):
                    for t, j in enumerate(slots):
                        v = x[j].view(torch.int32)
                        out.append(int(v.sum()) - int(v[touched[t]].sum()))
                return out

            def mlps():
                return {k: v.detach().clone()
                        for k, v in bst.model.named_parameters()}

            init_rows, init_sums = touched_rows()
            init_mlps, init_bits, init_step = mlps(), rest_bits(), bst.step
            init_dense = {k: v.clone() for k, v in bst.dense_state.items()}
            k_losses = counted("train_butterfly", lambda: [
                float(bstep(bst, *b)) for b in held_b])
            k_rows, k_sums = touched_rows()
            k_mlps, k_bits = mlps(), rest_bits()
            with torch.no_grad():
                for t, j in enumerate(slots):
                    bst.stack[j, touched[t]] = init_rows[t]
                    bst.row_state[j, touched[t]] = init_sums[t]
                for k, p_ in bst.model.named_parameters():
                    p_.copy_(init_mlps[k])
                for k, v in init_dense.items():
                    bst.dense_state[k].copy_(v)
            bst.step = init_step
            plain_step = bf.make_butterfly_train_step(
                dataclasses.replace(cfg, use_gather_kernel=False),
                dataclasses.replace(rws, use_update_kernel=False), mesh,
                table_order=order)
            pl_losses = [float(plain_step(bst, *b)) for b in held_b]
            pworst = {}
            held_losses(k_losses, pl_losses, "loss", pworst)
            pl_rows, pl_sums = touched_rows()
            for t in range(cfg.num_tables):
                held(k_rows[t], pl_rows[t], "touched rows", pworst)
                held_sums(k_sums[t], pl_sums[t], "row sums", pworst)
            for k, v in mlps().items():
                held(k_mlps[k], v, "MLPs", pworst)
            pl_bits = rest_bits()
            if not k_bits == pl_bits == init_bits:
                raise AssertionError("the butterfly changed rows that its "
                                     "batches do not touch: kernels "
                                     f"{k_bits != init_bits}, plain "
                                     f"{pl_bits != init_bits}")
            print(f"butterfly route, rwsadagrad, K2 and K5 against their "
                  f"plain versions [{card}]: 5 steps from the same state "
                  f"after 5 warm-up steps (stack {tuple(bst.stack.shape)}, "
                  f"flat row state {bst.row_state.numel()} rows): losses, "
                  f"the {sum(len(x) for x in touched)} touched rows, their "
                  f"sums and the MLPs {parted(pworst)}; every other row of "
                  f"the {len(slots)} slots unchanged in both (integer sums "
                  f"of their bits)", flush=True)
            del init_rows, init_sums, k_rows, k_sums, pl_rows, pl_sums
            rate, rates = counted("train_butterfly", lambda: steps_per_s(
                lambda *b: bstep(bst, *b), timed))
            print(f"butterfly route, rwsadagrad [{card}]: 5 steps against "
                  f"the psum route: losses, tables and row sums "
                  f"{parted(worst)}; {rate:.2f} steps/s (windows "
                  f"{', '.join(f'{r:.2f}' for r in rates)}); peak device "
                  f"memory {gib(torch.cuda.max_memory_allocated())} (the "
                  f"stack pads 26 tables to {max(cfg.table_sizes)} rows: "
                  f"{gib(bst.stack.nbytes)}, row sums "
                  f"{gib(bst.row_state.nbytes)})", flush=True)
            del bst, bstep, sm, st, step, base
            torch.cuda.empty_cache()

            # ShardedDeviceC1Cache against NativeDeviceC1Cache, on phase 3's
            # stream: the native cache's rows first, then the sharded one's
            tables = init_embedding_tables(cfg.table_sizes, cfg.embedding_dim,
                                           np.random.default_rng(args.seed))
            storage = StorageManager("dummy", dim=cfg.embedding_dim).load(
                tables=tables)
            ccfg1 = CacheConfig(policy="evlfu", n_caching_layers=1,
                                total_size=64000, main_precision=32)
            ccfg3 = CacheConfig(policy="evlfu", n_caching_layers=3,
                                total_size=75425, main_precision=8,
                                secondary_precision=4,
                                size_proportion=(48, 48, 4))
            resolver = AltKeyResolver(seeded_altkeys())
            n_b = 40
            for label, cc in (("fp32, 64,000 entries", ccfg1),
                              ("int8 C1 + C2 + C3, 75,425 entries", ccfg3)):
                it = serve_stream()
                batches = [next(it)[1] for _ in range(n_b)]
                one = build_cache(cc, cfg, storage, resolver,
                                  use_device_cache=True, device=dev)
                with torch.inference_mode():
                    want = [one.lookup_batch(i).cpu() for i in batches]
                s_one = one.stats()
                one.close()
                del one
                shard = build_cache(cc, cfg, storage, resolver,
                                    use_device_cache=True, device=dev,
                                    mesh=mesh)
                with torch.inference_mode():
                    got = counted("serve_sharded", lambda: [
                        shard.lookup_batch(i) for i in batches])
                    for k, (g, w) in enumerate(zip(got, want)):
                        if not torch.equal(g.cpu(), w):
                            raise AssertionError(f"{label}: batch {k}'s rows"
                                                 f" differ from the native "
                                                 f"cache's")
                    if cc.main_precision == 32:
                        for k, i in enumerate(batches):
                            rows = np.stack([tables[t][i[:, t]] for t in
                                             range(cfg.num_tables)], axis=1)
                            if not np.array_equal(got[k].cpu().numpy(),
                                                  rows):
                                raise AssertionError("sharded rows differ "
                                                     "from the store's")
                s_sh = shard.stats()
                for key in ("requests", "perfect_hits", "size", "hit_rate",
                            "bytes_shipped", "hbm_bytes", "c2", "c3"):
                    if s_one.get(key) != s_sh.get(key):
                        raise AssertionError(f"{label}: stats {key} "
                                             f"{s_sh.get(key)} != "
                                             f"{s_one.get(key)}")
                if s_sh["hbm_bytes_per_chip"] * mesh.world != \
                        s_sh["hbm_bytes"]:
                    raise AssertionError(f"hbm bytes {s_sh}")
                store = (" and the store's" if cc.main_precision == 32
                         else "")
                print(f"ShardedDeviceC1Cache {label} [{card}]: {n_b} batches "
                      f"of 2048, rows equal to NativeDeviceC1Cache's{store}"
                      f", stats equal (hit_rate {s_sh['hit_rate']:.6f}, "
                      f"perfect_hits {s_sh['perfect_hits']}, hbm_bytes_per_"
                      f"chip {s_sh['hbm_bytes_per_chip']})", flush=True)
                shard.close()
                del shard, got, want
            # run_inference over the mesh at depth 2, on phase 3's stream
            model = DLRM(cfg, device=dev, seed=args.seed, tables=False)
            it = serve_stream()
            warm = [next(it) for _ in range(serve3["warm"])]
            scored = [next(it) for _ in range(N_SCORED)]
            res = counted("serve_sharded", lambda: run_inference(
                model, cfg, ccfg1, scored, storage, warmup_batches=warm,
                use_device_cache=True, pipeline_depth=2, mesh=mesh,
                log_fn=lambda *a: None))
            if not np.array_equal(res.scores, serve3["scores"]):
                raise AssertionError("run_inference(mesh=) scores differ "
                                     "from phase 3's")
            print(f"run_inference(mesh=), ShardedDeviceC1Cache fp32, "
                  f"pipeline_depth 2 [{card}]: {res.requests} requests in "
                  f"{res.elapsed_s:.3f} s = "
                  f"{res.requests / res.elapsed_s:.1f} requests/s (phase 3 "
                  f"in this run: {serve3['depth 2']:.1f} at depth 2); p50 "
                  f"{res.latency['p50_s'] * 1e6:.2f} us, p99 "
                  f"{res.latency['p99_s'] * 1e6:.2f} us; scores equal to "
                  f"phase 3's", flush=True)
            del model, res, storage, tables, resolver
            torch.cuda.empty_cache()
            dist.destroy_process_group()
            wanted = {"train_sharded": ("interaction_fwd", "interaction_bwd",
                                        "gather_rows_grouped",
                                        "scatter_sub_sorted"),
                      "train_butterfly": ("interaction_fwd",
                                          "interaction_bwd",
                                          "gather_rows_grouped",
                                          "scatter_sub_sorted"),
                      "serve_sharded": ("interaction_fwd", "gather_rows",
                                        "gather_rows_dequant_int8")}
            out = {}
            for p, names in wanted.items():
                k5 = ("rwsadagrad_sorted",) * ("scatter_sub_sorted" in names)
                out[p] = {k: paths[p][k] for k in names + k5}
                if never_launched(paths[p], names):
                    raise AssertionError(f"a kernel of {p} never ran: "
                                         f"{paths[p]}")
            print(f"mesh path launches: {json.dumps(out)}", flush=True)
            return out

    # ------------------------- 3i the sharded trainable cache and the tools
    SHARDED_N = 100         # held steps a 3i(a) run, after 16 warm-up ones
    KNN_ROWS = 1_000_000    # rows of the alt-key kNN on the card
    KNN_CPU_ROWS = 20_000   # rows it is held to the CPU on
    EXPORT_ROWS = 100_000   # rows a table keeps in the export

    def phase_3i(d):
        """The sharded trainable cache at world 1 over NCCL and the offline
        tools, at the full Kaggle width: (a) `ShardedTrainableDeviceCache`
        beside `TrainableDeviceCache`, per batch, at fp32 and int8, then
        over 3f's exported .bin files (`from_files`), bit for bit, `save`'s
        files byte-equal, steps/s and device memory; (b)
        `run_cached_training(mesh=)` beside the one-device driver with a
        periodic eval, bit for bit; (c) `gen_altkeys` on the card (K7)
        over the first 1,000,000 rows, held to its CPU run on 20,000 of
        them by the rule (`knn_rule`); (d)
        the export of the model with its tables cut to 100,000 rows, saved,
        loaded and scoring one batch against `DLRM.predict`; (e) the CLIs
        of `reduce_precision`, `visualize` and `plot_cdf` over 3f's files.
        Returns the launch counts of the paths train_cached_sharded,
        export and tools."""
        import contextlib
        import filecmp

        import torch.distributed as dist

        from evstore_tpu_torch.cache import trainable as trn
        from evstore_tpu_torch.data.synthetic import learnable_batches
        from evstore_tpu_torch.drivers.train import run_cached_training
        from evstore_tpu_torch.models.dlrm import init_host_tables
        from evstore_tpu_torch.parallel.mesh import make_mesh
        from evstore_tpu_torch.parallel.multihost import init_multihost
        from evstore_tpu_torch.tools import (export_model, gen_altkeys,
                                             plot_cdf, reduce_precision,
                                             visualize)
        paths = {p: dict.fromkeys(wrappers, 0) for p in (
            "train_cached_sharded", "export", "tools")}

        def counted(path, fn):
            """fn() with every count set to 0 just before; its launches go
            to `path`."""
            reset_counts()
            out = fn()
            for k, v in read_counts().items():
                paths[path][k] += v
            return out

        def captured(fn, argv):
            """A tool's `main(argv)`, which must return 0: -> its output."""
            tee = Tee(sys.stdout)
            with contextlib.redirect_stdout(tee):
                rc = fn(argv)
            if rc != 0:
                raise AssertionError(f"{fn.__module__}.main returned {rc}")
            return "\n".join(tee.text)

        with Phase("3i sharded cache and tools"):
            init_multihost(device=dev.type, timeout_s=120)
            mesh = make_mesh(1, 1, device=dev)
            kcfg = dataclasses.replace(cfg, compute_dtype="float32")
            sizes, D = kcfg.table_sizes, kcfg.embedding_dim
            tcfg = TrainConfig(batch_size=CACHED_B, learning_rate=0.1,
                               optimizer="rwsadagrad")
            t0 = time.perf_counter()
            base = init_host_tables(kcfg, args.seed + 41)
            work = {k: [t.copy() for t in base] for k in ("one", "mesh")}
            stream = list(learnable_batches(RandomDataConfig(
                num_dense=kcfg.num_dense_features, table_sizes=sizes,
                batch_size=CACHED_B, num_batches=16 + SHARDED_N + 4,
                seed=args.seed + 43, distribution="grouped_zipf",
                zipf_alpha=1.05, group_noise=0.1)))
            gb = sum(sizes) * D * 4 / 1e9
            print(f"3i set-up: {gb:.3f} GB of masters and "
                  f"{sum(sizes) * 4 / 1e9:.3f} GB of row sums a trainer in "
                  f"host memory, two copies, {len(stream)} learnable "
                  f"grouped_zipf batches of {CACHED_B}, in "
                  f"{time.perf_counter() - t0:.2f} s; world "
                  f"{dist.get_world_size()} over {dist.get_backend()}, mesh "
                  f"{mesh.shape}", flush=True)

            def reset(batches):
                for t in range(len(sizes)):
                    rows = np.unique(np.concatenate(
                        [np.asarray(b[1])[:, t] for b in batches]))
                    for w in work.values():
                        w[t][rows] = base[t][rows]

            def drive(tc, batches, path=None):
                """16 warm-up and the held per-batch steps from the seed's
                MLPs: -> (model, dstate, losses, steps/s of the held)."""
                model = DLRM(kcfg, device=dev, seed=args.seed, tables=False)
                dst = trn.init_dense_state(model)

                def steps(part, first):
                    return [float(tc.train_batch(model, dst, first + k, *b)[2])
                            for k, b in enumerate(part)]

                run = (lambda f: counted(path, f)) if path else \
                    (lambda f: f())
                losses = run(lambda: steps(batches[:16], 1))
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                losses += run(lambda: steps(batches[16:], 17))
                torch.cuda.synchronize()
                return model, dst, losses, (len(batches) - 16) / (
                    time.perf_counter() - t1)

            def same(one, sh, a, b, what):
                """Bit for bit: losses, MLPs and sums, cells, the flushed
                masters and sums."""
                (m1, d1, l1, _), (m2, d2, l2, _) = a, b
                bad = [k for k, v in m1.state_dict().items()
                       if not torch.equal(v, m2.state_dict()[k])]
                bad += [k for k in d1 if not torch.equal(d1[k], d2[k])]
                if l1 != l2 or bad or not torch.equal(one.cache_values,
                                                      sh.cache_values):
                    raise AssertionError(f"3i(a) {what}: losses equal "
                                         f"{l1 == l2}, MLPs or sums {bad}")
                for t in range(len(sizes)):
                    if not (np.array_equal(one.host_tables[t],
                                           sh.host_tables[t])
                            and np.array_equal(one.host_mom[t],
                                               sh.host_mom[t])):
                        raise AssertionError(f"3i(a) {what}: table {t}")

            # (a) in-memory masters at fp32 (with save) and int8
            rate = {}
            for precision in (32, 8):
                cc = CacheConfig(total_size=CACHED_C1,
                                 main_precision=precision)
                one = trn.TrainableDeviceCache(kcfg, tcfg, cc, work["one"],
                                               copy_tables=False, device=dev)
                a = drive(one, stream[:16 + SHARDED_N])
                one.flush_to_host()
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                mem0 = torch.cuda.memory_allocated()
                sh = trn.ShardedTrainableDeviceCache(
                    kcfg, tcfg, cc, work["mesh"], mesh, copy_tables=False)
                b = drive(sh, stream[:16 + SHARDED_N],
                          "train_cached_sharded")
                added = torch.cuda.max_memory_allocated() - mem0
                counted("train_cached_sharded", sh.flush_to_host)
                same(one, sh, a, b, f"{precision} bits")
                st = sh.stats()
                if st["hbm_bytes_per_chip"] != st["hbm_bytes"] or \
                        st["hbm_bytes"] != one.stats()["hbm_bytes"]:
                    raise AssertionError(f"3i(a) stats {st}")
                rate[precision] = (a[3], b[3])
                saved = ""
                if precision == 32:
                    t1 = time.perf_counter()
                    for tc, k in ((one, "one"), (sh, "mesh")):
                        tc.save(os.path.join(d, f"save_{k}"))
                    names = sorted(os.listdir(os.path.join(d, "save_one")))
                    match, miss, err = filecmp.cmpfiles(
                        os.path.join(d, "save_one"),
                        os.path.join(d, "save_mesh"), names, shallow=False)
                    if miss or err or len(match) != 2 * len(sizes):
                        raise AssertionError(f"3i(a) save files differ: "
                                             f"{miss} {err}")
                    for k in ("one", "mesh"):
                        shutil.rmtree(os.path.join(d, f"save_{k}"))
                    saved = (f"; save's {len(match)} files byte-equal "
                             f"({time.perf_counter() - t1:.2f} s for both "
                             f"saves and the comparison)")
                g = cached_rates.get(("batch", 32))
                print(f"3i(a) ShardedTrainableDeviceCache, world 1 over "
                      f"NCCL, {precision} bits [{card}]: {SHARDED_N} "
                      f"per-batch steps after 16 bit for bit with "
                      f"TrainableDeviceCache.train_batch (losses, "
                      f"{len(sizes)} flushed tables and row sums, MLPs and "
                      f"their sums, cells); {b[3]:.2f} steps/s against the "
                      f"one-device class's {a[3]:.2f} in this phase ("
                      f"{b[3] / a[3]:.3f}x)"
                      + (f" and 3g's per-batch {g:.2f}" if g and
                         precision == 32 else "")
                      + f"; device memory added {added / 2**20:.1f} MiB; "
                      f"hbm_bytes {st['hbm_bytes']}{saved}", flush=True)
                one.close()
                sh.close()
                del one, sh, a, b
                reset(stream)

            # (a) the masters mapped from 3f's exported files
            ev = os.path.join(d, "ev")
            t1 = time.perf_counter()
            tabs = [np.fromfile(os.path.join(ev, f"ev-table-{t + 1}.bin"),
                                np.float32).reshape(n, D)
                    for t, n in enumerate(sizes)]
            moms = [np.fromfile(os.path.join(ev, f"mom-{t + 1}.bin"),
                                np.float32) for t in range(len(sizes))]
            cc = CacheConfig(total_size=CACHED_C1)
            one = trn.TrainableDeviceCache(kcfg, tcfg, cc, tabs,
                                           copy_tables=False, device=dev)
            one.host_mom = moms
            sh = trn.ShardedTrainableDeviceCache.from_files(
                kcfg, tcfg, cc, ev, sizes, mesh=mesh)
            a = drive(one, stream[:16 + SHARDED_N])
            b = drive(sh, stream[:16 + SHARDED_N], "train_cached_sharded")
            one.flush_to_host()
            counted("train_cached_sharded", sh.flush_files)
            same(one, sh, a, b, "from_files")
            for t, n in enumerate(sizes):
                if not np.array_equal(np.fromfile(os.path.join(
                        ev, f"ev-table-{t + 1}.bin"), np.float32),
                        one.host_tables[t].ravel()):
                    raise AssertionError(f"3i(a) from_files: the file of "
                                         f"table {t} differs")
            print(f"3i(a) from_files over 3f's {len(sizes)} .bin files "
                  f"[{card}]: {SHARDED_N} steps after 16 bit for bit with "
                  f"the one-device class over the same masters in memory, "
                  f"the files after flush_files equal to its tables; "
                  f"{b[3]:.2f} steps/s against {a[3]:.2f}; "
                  f"{time.perf_counter() - t1:.2f} s with the reads",
                  flush=True)
            one.close()
            sh.close()
            del one, sh, a, b, tabs, moms

            # (b) run_cached_training over the mesh beside one device
            drv = dataclasses.replace(tcfg, test_freq=50, print_freq=25)
            # 100 steps, a multiple of test_freq: the one-device driver
            # cuts its stream there, as the mesh's evals every 50 steps
            train_b, test_b = stream[:100], stream[-4:]
            runs = {}
            for label, m in (("one", None), ("mesh", mesh)):
                lines = []
                model = DLRM(kcfg, device=dev, seed=args.seed, tables=False)

                def run_it(m=m, model=model, lines=lines):
                    return run_cached_training(
                        kcfg, drv, CacheConfig(total_size=CACHED_C1),
                        lambda: iter(train_b), tables=base, mesh=m,
                        make_test_batches=lambda: iter(test_b), model=model,
                        device=dev, log_fn=lines.append)

                res = (counted("train_cached_sharded", run_it) if m
                       else run_it())
                got = re.search(r"trained (\d+) steps in [\d.]+ s "
                                r"\(([\d.]+) steps/s\)", "\n".join(lines))
                runs[label] = (res, float(got.group(2)),
                               {k: v.clone() for k, v in
                                res.model.state_dict().items()})
            (r1, s1, w1), (r2, s2, w2) = runs["one"], runs["mesh"]
            if r1.history != r2.history or r1.best_metric != r2.best_metric \
                    or r1.steps != r2.steps or any(
                        not torch.equal(w1[k], w2[k]) for k in w1):
                raise AssertionError("3i(b) run_cached_training(mesh=) "
                                     "differs from one device")
            print(f"3i(b) run_cached_training(mesh=make_mesh(1, 1)) "
                  f"[{card}]: {r2.steps} steps and "
                  f"{len(r2.history['eval'])} evals bit for bit with the "
                  f"one-device (pipelined) run: losses, evals (best "
                  f"{r2.best_metric:.6f}), MLPs; {s2:.2f} steps/s against "
                  f"{s1:.2f} ({s2 / s1:.3f}x; against (a)'s sharded "
                  f"{rate[32][1]:.2f}: {s2 / rate[32][1]:.3f}x)", flush=True)
            del runs, r1, r2, w1, w2, work

            # (c) the alt-key kNN on the card, through K7
            sub, n_rows = [], 0
            for t in base:
                k = min(len(t), KNN_ROWS - n_rows)
                sub.append(t[:k])
                n_rows += k
                if n_rows == KNN_ROWS:
                    break
            torch.cuda.synchronize()
            knn_topk.rows = knn_topk.swept = 0
            t1 = time.perf_counter()
            alts = counted("tools", lambda: gen_altkeys.generate_altkeys(
                sub, n_neighbors=10, device=dev))
            secs = time.perf_counter() - t1
            swept, n_q = knn_topk.swept, knn_topk.rows
            lens = [len(x) for x in sub]
            if [len(a_) for a_ in alts] != lens or (gen_altkeys.altkey_rows(
                    np.concatenate(alts), lens) < 0).any():
                raise AssertionError("3i(c) an alt key names no row")
            # 20,000 of the rows against the CPU run of the tool (the
            # plain version), by the rule
            rows20 = np.concatenate(sub)[:KNN_CPU_ROWS]
            cpu = gen_altkeys._topk_neighbors_blocked(rows20, 11,
                                                      device="cpu")
            gpu = counted("tools", lambda: gen_altkeys._topk_neighbors_blocked(
                rows20, 10, device=dev))
            r20 = torch.from_numpy(rows20)
            n_sep, n_sep1 = knn_rule(torch, r20, torch.arange(len(r20)),
                                     torch.from_numpy(gpu),
                                     torch.from_numpy(cpu), 10, "3i(c)")
            full = sum(sizes)
            flop = 2.0 * KNN_ROWS * KNN_ROWS * D
            print(f"3i(c) gen_altkeys on the card through K7 [{card}]: "
                  f"{KNN_ROWS} rows of the first {len(sub)} tables, k=10, in "
                  f"{secs:.2f} s ({KNN_ROWS / secs:.0f} rows/s, "
                  f"{flop / secs / 1e12:.1f} TFLOP/s; the plain addmm and "
                  f"topk path took 21.1 s); {swept} of {n_q} rows swept "
                  f"exactly; "
                  f"{KNN_CPU_ROWS} of them against the CPU run: neighbour "
                  f"sets equal on all {n_sep} rows whose 10th and 11th "
                  f"distances differ by more than 1e-5 relative, the nearest "
                  f"on all {n_sep1} whose 1st and 2nd do. The full kNN over "
                  f"{full} rows runs under --only altkeys", flush=True)
            del sub, alts, rows20, cpu, gpu, r20

            # (d) the export
            torch.cuda.empty_cache()
            t1 = time.perf_counter()
            whole = DLRM(kcfg, device=dev, seed=args.seed, tables=base)
            small = export_model.truncate_tables(whole, EXPORT_ROWS)
            del whole, base
            torch.cuda.empty_cache()
            t_build = time.perf_counter() - t1
            mb = sum(t.numel() * t.element_size() for t in small.tables) / 1e6
            path = os.path.join(d, "export", "dlrm.pt2")
            os.makedirs(os.path.dirname(path))
            t1 = time.perf_counter()
            prog = export_model.trace_program(small, 2048)
            t_trace = time.perf_counter() - t1
            t1 = time.perf_counter()
            torch.export.save(prog, path)
            t_save = time.perf_counter() - t1
            t1 = time.perf_counter()
            fn = export_model.load_exported(path)
            t_load = time.perf_counter() - t1
            ops = prog.graph_module.code.count("evstore.dot_interaction")
            dx, idx, _ = next(random_batches(RandomDataConfig(
                num_dense=kcfg.num_dense_features,
                table_sizes=small.cfg.table_sizes, batch_size=2048,
                num_batches=1, seed=args.seed + 45,
                distribution="grouped_zipf", zipf_alpha=1.05,
                group_noise=0.1)))
            dxt = torch.from_numpy(np.asarray(dx, np.float32)).to(dev)
            idt = torch.from_numpy(np.asarray(idx, np.int32)).to(dev)
            with torch.no_grad():
                want = small.predict(dxt, idt)
            counted("export", lambda: fn(dxt, idt))     # the first call
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got = counted("export", lambda: fn(dxt, idt))
            torch.cuda.synchronize()
            t_score = time.perf_counter() - t1
            ok, dmax = within(got, want, 1e-5)
            if not ok or ops != 1 or paths["export"]["interaction_fwd"] != 2:
                raise AssertionError(f"3i(d) the exported program: scores "
                                     f"max|d| {dmax}, {ops} K1 ops, "
                                     f"launches {paths['export']}")
            print(f"3i(d) the export [{card}]: the Kaggle model with its "
                  f"tables cut to {EXPORT_ROWS} rows by truncate_tables "
                  f"({mb:.1f} MB, built in {t_build:.2f} s); "
                  f"torch.export at batch 2048 {t_trace:.2f} s, save "
                  f"{t_save:.2f} s ({os.path.getsize(path) / 1e6:.1f} MB), "
                  f"load {t_load:.2f} s, one scored batch "
                  f"{t_score * 1e3:.3f} ms; scores within {dmax:.3e} of "
                  f"DLRM.predict (limit 1e-5 (1 + |ref|)); the program holds "
                  f"{ops} evstore.dot_interaction op, which launched K1 "
                  f"{paths['export']['interaction_fwd']} times in 2 calls",
                  flush=True)
            del small, prog, fn, dxt, idt, want, got
            torch.cuda.empty_cache()

            # (e) the tools' CLIs
            plots = visualize.have("matplotlib")
            dash = "-".join(str(n) for n in sizes)
            t1 = time.perf_counter()
            captured(reduce_precision.main, [
                "--in-dir", ev, "--out-dir", os.path.join(d, "ev8"),
                "--table-sizes", dash, "--dim", str(D),
                "--new-precision", "8"])
            t_red = time.perf_counter() - t1
            for t, n in enumerate(sizes):
                if os.path.getsize(os.path.join(
                        d, "ev8", f"ev-table-{t + 1}.bin")) != n * D:
                    raise AssertionError(f"3i(e) 8-bit table {t}")
            shutil.rmtree(os.path.join(d, "ev8"))
            t1 = time.perf_counter()
            viz = captured(visualize.main, [
                "--ev-table-path", ev, "--dim", str(D), "--table-sizes",
                dash, "--table", "2", "--sample", "2000", "--out-dir",
                os.path.join(d, "viz")])
            t_viz = time.perf_counter() - t1
            with open(os.path.join(d, "viz", "report.json")) as f:
                report = json.load(f)
            t1 = time.perf_counter()
            cdf = captured(plot_cdf.main, [
                os.path.join(d, "cdf.csv"), "--out",
                os.path.join(d, "cdf.png")])
            t_cdf = time.perf_counter() - t1
            sk = visualize.have("sklearn")
            said = {"visualize plots": plots or "no plots" in viz,
                    "visualize neighbours": sk or "NumPy fallback" in viz,
                    "plot_cdf": ("wrote" in cdf) if plots else
                    ("ASCII fallback" in cdf and "p99=" in cdf)}
            if set(report) != {"norms", "neighbors"} or \
                    not all(said.values()):
                raise AssertionError(f"3i(e) the tools: {said}, report "
                                     f"{sorted(report)}")
            print(f"3i(e) the tools' CLIs over 3f's files [{card}]: "
                  f"reduce_precision 32 -> 8 bits over {sum(sizes)} rows "
                  f"{t_red:.2f} s; visualize (table 2, 2000 rows) "
                  f"{t_viz:.2f} s; plot_cdf {t_cdf:.2f} s; matplotlib "
                  f"{'present' if plots else 'absent'}, sklearn "
                  f"{'present' if sk else 'absent'}: each tool said which "
                  f"path it took", flush=True)
            dist.destroy_process_group()
            wanted = {"train_cached_sharded": (
                "interaction_fwd", "interaction_bwd", "gather_rows",
                "gather_rows_dequant_int8", "scatter_sub_sorted"),
                "export": ("interaction_fwd",), "tools": ("knn_topk",)}
            out = {}
            for p, names in wanted.items():
                k5 = ("rwsadagrad_sorted",) * ("scatter_sub_sorted" in names)
                out[p] = {k: paths[p][k] for k in names + k5}
                if never_launched(paths[p], names):
                    raise AssertionError(f"a kernel of {p} never ran: "
                                         f"{paths[p]}")
            print(f"3i path launches: {json.dumps(out)}", flush=True)
            return out

    # ----------------------------------------------- 3j the MLPerf shape
    MLPERF_C1 = 4_000_000   # cells: scripts/mlperf_rehearsal.py's default
    MLPERF_BIG = (64_000_000, 16_000_000)   # the large cell, largest first
    MLPERF_M = 16_384       # miss-buffer rows of phase 2's cases
    MLPERF_B = 2048         # bench/run_and_time.sh's batch
    MLPERF_CLI_N = 32       # batches of random data through the CLI
    MLPERF_WARM, MLPERF_N = 6, 32   # warm-up and timed batches a driver run
    TB_WARM, TB_N = 5, 50   # 3j(d): warm-up and timed steps an optimizer
    MLPERF_PROF = 3         # pipelined steps under the profiler, a cell
    MLPERF_CUT_WARM, MLPERF_CUT_N = 20, 10  # 3j(c): warm-up, held steps
    # the recipe's flags that set data, cadence and logging, not the model
    RECIPE_DROP = {"--data-generation": 1, "--data-set": 1,
                   "--print-freq": 1, "--test-freq": 1,
                   "--mlperf-logging": 0, "--mlperf-auc-threshold": 1}

    def recipe_flags():
        """bench/run_and_time.sh's model, loss and schedule flags."""
        flags, out, k = bench_flags("run_and_time.sh"), [], 0
        while k < len(flags):
            if flags[k] in RECIPE_DROP:
                k += 1 + RECIPE_DROP[flags[k]]
                continue
            out.append(flags[k])
            k += 1
        return out

    def phase_3j():
        """The MLPerf recipe's shape (bench/run_and_time.sh: dim 128, the
        26 Terabyte tables capped at 40M rows, 204,184,588 rows or 104.5
        GB at float32, bottom 13-512-256-128, top 1024-1024-512-256-1, B
        2048, lr 1.0 with 2,750 warm-up steps) trained through the
        trainable cache from sparse masters (`MemoryFiles`), and the
        Terabyte shape (bench/dlrm_s_criteo_terabyte.sh: dim 64, tables
        capped at 10M rows, 13.87 GB) with its tables on the card: (0) the
        room (card, free RAM and disk) and the pages the runs can touch;
        (a) `cli.main` with the recipe's model, loss and schedule flags plus
        `--data-generation random --use-evstore True --optimizer
        rwsadagrad --emb-cache-size 4000000 --ev-table-path <sparse
        masters>`; (b) `TrainableDeviceCache.from_files` per batch and
        pipelined from fresh masters, bit for bit, on grouped_zipf batches
        (alpha 1.05, group noise 0.1) at fp32 and int8 with 4,000,000
        cells and fp32 with 64,000,000 (16,000,000 where those do not
        fit), with steps/s, the host split, the window's hit rate, the
        device memory added, host RSS, the pages the files took and a
        profiled window; (c) the shape cut to 1M rows a table, its tables
        drawn and written with `write_ev_tables_binary`, the cache from
        those files held to `make_train_step` by 3g(2)'s rules and the
        kernels on against off by 3g(3)'s at fp32 and int8; (d) the
        Terabyte shape's step held by 3b's rules under sgd and rwsadagrad
        (lr 0.1), with steps/s.  K1, K2, K4 and K5 must launch in every
        part of the path, K3 in the int8 cell.  Returns the path's launch
        counts (`train_mlperf`)."""
        import contextlib

        from evstore_tpu_torch import cli
        from evstore_tpu_torch.cache import trainable as trn
        launches = dict.fromkeys(wrappers, 0)
        need = ("interaction_fwd", "interaction_bwd", "scatter_sub_sorted")

        def counted(fn, what, gather=("gather_rows",), extra=()):
            """fn() with every count set to 0 just before; its launches go
            to the path's, and K1, K4, K5, the gathers `gather` and the
            kernels `extra` must each have launched."""
            reset_counts()
            out = fn()
            got = read_counts()
            for k, v in got.items():
                launches[k] += v
            idle = never_launched(got, need + tuple(gather) + tuple(extra))
            if idle:
                raise AssertionError(f"3j {what}: {idle} never launched: "
                                     f"{got}")
            return out

        def ids_of(batches, t):
            return np.unique(np.concatenate(
                [np.asarray(b[1])[:, t] for b in batches]))

        def pages(batches, dim):
            """The pages of the tables and sums that `batches` can touch:
            an upper bound on what a run from fresh masters lands."""
            per = 4096 // (dim * 4)
            return sum(len(np.unique(r // per)) + len(np.unique(r // 1024))
                       for r in (ids_of(batches, t)
                                 for t in range(len(batches[0][1][0]))))

        def fence():
            torch.cuda.synchronize()

        def held_down(losses):
            """The recipe's schedule keeps training from diverging: every
            loss finite and under 2 ln 2, twice a constant guess's on
            random labels (without the warm-up the loss diverges within
            two steps).  Within the warm-up a printed loss passes 0.75 in
            the JAX package too, on the recipe's flags and random labels
            (tests/test_torch_mlperf_shape.py), so that is counted, not
            held."""
            return all(np.isfinite(losses)) and max(losses) < 2 * np.log(2)

        with Phase("3j mlperf shape"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            d = tempfile.mkdtemp(prefix="mlperf-")
            live = []       # MemoryFiles to close
            try:
                flags = recipe_flags()
                parsed = cli.build_parser().parse_args(flags)
                rcfg, rt, _ = cli.configs_from_args(parsed)
                if rcfg.embedding_dim != 128 or sum(rcfg.table_sizes) != \
                        204_184_588 or rt.lr_num_warmup_steps != 2750:
                    raise AssertionError(f"run_and_time.sh's flags gave "
                                         f"{rcfg}, {rt}")
                cfg = dataclasses.replace(rcfg, compute_dtype="float32")
                tcfg = dataclasses.replace(rt, optimizer="rwsadagrad")
                sizes, D, T = cfg.table_sizes, cfg.embedding_dim, \
                    cfg.num_tables
                gb = sum(sizes) * D * 4 / 1e9

                # (0) the room
                ram = meminfo_kb("MemAvailable") * 1024
                disk = shutil.disk_usage(d).free
                room = min(ram, disk) / 4
                stream = list(random_batches(RandomDataConfig(
                    num_dense=13, table_sizes=sizes, batch_size=MLPERF_B,
                    num_batches=MLPERF_WARM + MLPERF_N + MLPERF_PROF,
                    seed=args.seed + 61, distribution="grouped_zipf",
                    zipf_alpha=1.05, group_noise=0.1)))
                cli_argv = flags + [
                    "--data-generation", "random", "--num-batches",
                    str(MLPERF_CLI_N), "--print-freq",
                    str(max(1, MLPERF_CLI_N // 5)), "--use-evstore",
                    "True", "--optimizer", "rwsadagrad", "--emb-cache-size",
                    str(MLPERF_C1)]
                cli_args = cli.build_parser().parse_args(cli_argv)
                cli_stream = list(cli._make_data(cli_args, rcfg)[0]())
                n_cli = len(cli_stream)
                while n_cli > 1 and pages(cli_stream[:n_cli], D) * 4096 \
                        > room:
                    n_cli //= 2
                worst = max(pages(stream, D), pages(cli_stream[:n_cli], D))
                if worst * 4096 > room:
                    raise AssertionError(f"3j: {worst} pages a run over "
                                         f"the room of {room / 1e9:.1f} GB")
                cli_argv[cli_argv.index("--num-batches") + 1] = str(n_cli)
                print(f"3j(0) room [{card}]: {ram / 1e9:.1f} GB of host "
                      f"RAM available, {disk / 1e9:.1f} GB of disk free "
                      f"under {d}; a run from fresh masters touches at "
                      f"most {worst} pages of 4 KB ({worst * 4096 / 1e9:.2f}"
                      f" GB; the CLI's {n_cli} uniform batches or the "
                      f"drivers' {len(stream)} grouped_zipf ones), within a "
                      f"quarter of the smaller, {room / 1e9:.1f} GB",
                      flush=True)

                def masters(name):
                    m = MemoryFiles(os.path.join(d, name), sizes, D)
                    live.append(m)
                    return m

                def release(m):
                    m.close()
                    live.remove(m)

                # what the first touch of a memory file's page costs: one
                # of rows read from the largest table's holes, then the
                # same rows written
                probe = MemoryFiles(os.path.join(d, "probe"),
                                    [max(sizes)], D)
                live.append(probe)
                tab = np.memmap(os.path.join(probe.dir, "ev-table-1.bin"),
                                np.float32, mode="r+", shape=(max(sizes), D))
                rows = np.random.default_rng(args.seed).choice(
                    max(sizes), 20_000, replace=False)
                t0 = time.perf_counter()
                tab[rows].sum()
                t1 = time.perf_counter()
                tab[rows] = 1.0
                t2 = time.perf_counter()
                print(f"3j(0) a memory file's pages: the first read of a "
                      f"row {(t1 - t0) / len(rows) * 1e6:.2f} us, a write "
                      f"to it then {(t2 - t1) / len(rows) * 1e6:.2f} us "
                      f"({len(rows)} random rows of a {max(sizes)}-row "
                      f"table; {probe.touched_mb():.1f} MB of pages)",
                      flush=True)
                del tab
                release(probe)

                # (a) the CLI
                m = masters("cli")
                print(f"3j(0) sparse masters: {len(m.fds)} files, "
                      f"{m.virtual / 1e9:.1f} GB ({gb:.1f} GB of tables), "
                      f"{m.touched_mb():.1f} MB of pages after making them "
                      f"(st_blocks reports {m.blocks_mb() / 1e3:.1f} GB)",
                      flush=True)
                argv = cli_argv + ["--ev-table-path", m.dir]
                tee = Tee(sys.stdout)
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(tee):
                    rc = counted(lambda: cli.main(argv), "(a) the CLI")
                secs = time.perf_counter() - t0
                out = "\n".join(tee.text)
                trained = re.search(r"trained (\d+) steps in ([\d.]+) s "
                                    r"\(([\d.]+) steps/s\)", out)
                seen = re.findall(r"step (\d+): loss ([-\d.naif]+) .*hit "
                                  r"rate ([\d.]+)", out)
                losses = [float(x) for _, x, _ in seen]
                if rc != 0 or trained is None or \
                        int(trained.group(1)) != n_cli or not losses or \
                        not held_down(losses):
                    raise AssertionError(f"3j(a) the CLI: rc {rc}, "
                                         f"losses {losses}")
                rate = float(trained.group(3))
                print(f"3j(a) cli [{card}]: run_and_time.sh's model, loss "
                      f"and schedule flags + --data-generation random "
                      f"--use-evstore True --emb-cache-size {MLPERF_C1} "
                      f"over {gb:.1f} GB of sparse masters (bf16 compute, "
                      f"the CLI's default): {n_cli} steps at {rate:.2f} "
                      f"steps/s ({rate * MLPERF_B:.0f} samples/s); the run "
                      f"took {secs:.2f} s with the flush; losses "
                      f"{', '.join(f'{x:.4f}' for x in losses)} (finite,"
                      f" under 2 ln 2; above 0.75: "
                      f"{sum(x >= 0.75 for x in losses)} of {len(losses)})"
                      f"; hit rate {seen[-1][2]}; host RSS "
                      f"{rss_gb():.2f} GB; the files took "
                      f"{m.touched_mb():.1f} MB", flush=True)
                release(m)

                # (b) the two drivers on fresh sparse masters, per cell
                free_card = torch.cuda.mem_get_info()[0]
                big = next((c for c in MLPERF_BIG
                            if c * (D * 4 + 4) + (8 << 30) < free_card),
                           MLPERF_BIG[-1])
                item = {32: 4, 8: 1}

                def run(label, bits, cap, how):
                    mst = masters(f"{label}-{how}")
                    model = DLRM(cfg, device=dev, seed=args.seed,
                                 tables=False)
                    dst = trn.init_dense_state(model)
                    fence()
                    mem0 = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.perf_counter()
                    tc = trn.TrainableDeviceCache.from_files(
                        cfg, tcfg, CacheConfig(total_size=cap,
                                               main_precision=bits),
                        mst.dir, sizes, device=dev)
                    t_init, rss_init = time.perf_counter() - t0, rss_gb()
                    if rss_init > meminfo_kb("MemTotal") * 1024 / 2e9:
                        tc.close()
                        raise MemoryError(f"{cap} cells: host RSS "
                                          f"{rss_init:.1f} GB")
                    mark = {}

                    def window():
                        fence()
                        mark["t"] = time.perf_counter()
                        mark["s"] = tc.stats()
                        for k in tc.host_s:
                            tc.host_s[k] = 0.0

                    def drive():
                        losses = []
                        if how == "batch":
                            for k, b in enumerate(stream[:MLPERF_WARM
                                                         + MLPERF_N]):
                                if k == MLPERF_WARM:
                                    window()
                                losses.append(tc.train_batch(
                                    model, dst, k + 1, *b)[2])
                        else:
                            for k, (_, _, loss) in enumerate(
                                    tc.train_batches(model, dst, stream[
                                        :MLPERF_WARM + MLPERF_N])):
                                losses.append(loss)
                                if k + 1 == MLPERF_WARM:
                                    window()
                        fence()
                        return [float(x) for x in losses]

                    losses = counted(drive, f"(b) {label} {how}",
                                     extra=("gather_rows_dequant_int8",)
                                     if bits == 8 else ())
                    secs = time.perf_counter() - mark["t"]
                    s0, s1 = mark["s"], tc.stats()
                    L0, L1 = s0["requests"] * T, s1["requests"] * T
                    hit = (s1["hit_rate"] * L1 - s0["hit_rate"] * L0) / \
                        (L1 - L0)
                    persist = torch.cuda.memory_allocated() - mem0
                    peak = torch.cuda.max_memory_allocated() - mem0
                    # the cells and their sums, and the buffer's rows and
                    # sums; at most 256 MiB more (scratch, staging)
                    cells = cap * (D * item[bits] + 4)
                    buf = tc._buf.shape[0] * (D * 4 + 4)
                    if not held_down(losses) or \
                            s1["hbm_bytes"] != cells or \
                            persist > cells + buf + (256 << 20):
                        raise AssertionError(f"3j(b) {label} {how}: losses "
                                             f"{losses}, {s1}")
                    split = ", ".join(f"{k} {v / MLPERF_N * 1e3:.2f}"
                                      for k, v in tc.host_s.items())
                    print(f"3j(b) {label} {how} [{card}]: from_files and "
                          f"the engine in {t_init:.2f} s (host RSS "
                          f"{rss_init:.2f} GB); {MLPERF_N} steps after "
                          f"{MLPERF_WARM} in {secs:.3f} s = "
                          f"{MLPERF_N / secs:.2f} steps/s "
                          f"({MLPERF_N * MLPERF_B / secs:.0f} samples/s); "
                          f"host ms a step: {split}; C1 hit rate of the "
                          f"window {hit:.4f}, {s1['size']} of {cap} cells "
                          f"({'full' if s1['size'] >= cap else 'not full'});"
                          f" device memory added {persist / 2**30:.3f} GiB "
                          f"(peak {peak / 2**30:.3f} GiB) against cells x "
                          f"(row + 4) {cells / 2**30:.3f} GiB + the buffer "
                          f"{buf / 2**30:.3f} GiB; host RSS {rss_gb():.2f} "
                          f"GB; the files took {mst.touched_mb():.1f} MB "
                          f"(st_blocks reports {mst.blocks_mb() / 1e3:.1f} "
                          f"GB); losses {losses[0]:.4f} .. {losses[-1]:.4f}"
                          f" (max {max(losses):.4f}, above 0.75: "
                          f"{sum(x >= 0.75 for x in losses)} of "
                          f"{len(losses)})", flush=True)
                    keys, slots = tc.assigner.resident_keys()
                    order = np.argsort(keys)
                    sl = torch.from_numpy(slots[order]).long().to(dev)
                    rec = dict(
                        losses=losses, stats=s1, keys=keys[order],
                        slots=slots[order],
                        cells=tc.cache_values[sl].cpu(),
                        sums=tc.cache_mom[sl].cpu(),
                        model={k: v.to("cpu", copy=True) for k, v in
                               model.state_dict().items()},
                        dst={k: v.to("cpu", copy=True)
                             for k, v in dst.items()})
                    del sl
                    t0 = time.perf_counter()
                    tc.flush_files()
                    t_flush = time.perf_counter() - t0
                    tabs = [np.memmap(os.path.join(
                        mst.dir, f"ev-table-{t + 1}.bin"), np.float32,
                        mode="r", shape=(n, D)) for t, n in enumerate(sizes)]
                    moms = [np.memmap(os.path.join(
                        mst.dir, f"mom-{t + 1}.bin"), np.float32, mode="r",
                        shape=(n,)) for t, n in enumerate(sizes)]
                    ids = [ids_of(stream[:MLPERF_WARM + MLPERF_N], t)
                           for t in range(T)]
                    rec["rows"] = [(np.array(tabs[t][r]),
                                    np.array(moms[t][r]))
                                   for t, r in enumerate(ids)]
                    del tabs, moms
                    if how == "pipelined":
                        # a profiled window of the pipelined driver
                        more = tc.train_batches(
                            model, dst, stream[MLPERF_WARM + MLPERF_N:],
                            start_step=MLPERF_WARM + MLPERF_N + 1)

                        def profiled():
                            wall, on_card = profile_steps(
                                torch, lambda: next(more), MLPERF_PROF)
                            for _ in more:
                                pass
                            return wall, on_card

                        wall, on_card = counted(
                            profiled, f"(b) {label} profiled",
                            extra=("gather_rows_dequant_int8",)
                            if bits == 8 else ())
                        busy = sum(t for _, t in on_card.values())
                        print(f"3j(b) {label} a profiled window of "
                              f"{MLPERF_PROF} pipelined steps: {wall:.2f} "
                              f"ms wall, device busy {busy:.3f} ms "
                              f"({busy / wall:.1%}), "
                              f"{sum(c for c, _ in on_card.values())} "
                              f"kernels and copies; " + by_kernel(
                                  on_card, MLPERF_PROF, CACHED_KERNELS)
                              + f"; flush_files {t_flush:.2f} s", flush=True)
                    tc.close()
                    del tc, model, dst
                    torch.cuda.empty_cache()
                    return mst, rec

                cells_run = [("fp32-4M", 32, MLPERF_C1),
                             ("int8-4M", 8, MLPERF_C1),
                             (f"fp32-{big // 10**6}M", 32, big)]
                for label, bits, cap in cells_run:
                    t_cell = time.perf_counter()
                    try:
                        m_a, a = run(label, bits, cap, "batch")
                    except MemoryError as e:
                        if cap == MLPERF_BIG[-1]:
                            raise
                        print(f"3j(b) {label}: {e}; stepping down to "
                              f"{MLPERF_BIG[-1]} cells", flush=True)
                        release(live[-1])
                        label, cap = f"fp32-{MLPERF_BIG[-1] // 10**6}M", \
                            MLPERF_BIG[-1]
                        m_a, a = run(label, bits, cap, "batch")
                    m_b, b = run(label, bits, cap, "pipelined")
                    parted = [k for k, ok in (
                        ("losses", a["losses"] == b["losses"]),
                        ("stats", a["stats"] == b["stats"]),
                        ("resident keys", np.array_equal(a["keys"],
                                                         b["keys"])),
                        ("their slots", np.array_equal(a["slots"],
                                                       b["slots"])),
                        ("cells", torch.equal(a["cells"], b["cells"])),
                        ("cell sums", torch.equal(a["sums"], b["sums"])),
                        ("MLPs", all(torch.equal(a["model"][k],
                                                 b["model"][k])
                                     for k in a["model"])),
                        ("MLP sums", all(torch.equal(a["dst"][k],
                                                     b["dst"][k])
                                         for k in a["dst"])),
                        ("rows from the files", all(
                            np.array_equal(x[0], y[0])
                            for x, y in zip(a["rows"], b["rows"]))),
                        ("sums from the files", all(
                            np.array_equal(x[1], y[1])
                            for x, y in zip(a["rows"], b["rows"]))))
                        if not ok]
                    if parted:
                        raise AssertionError(f"3j(b) {label}: per-batch and "
                                             f"pipelined part in {parted}")
                    n_rows = sum(len(r[0]) for r in a["rows"])
                    print(f"3j(b) {label}: per-batch and pipelined bit for "
                          f"bit over {MLPERF_WARM + MLPERF_N} steps: "
                          f"losses, stats, {len(a['keys'])} resident cells "
                          f"and their sums, the MLPs and their sums, and "
                          f"{n_rows} rows and sums read back from the "
                          f"files; the cell took "
                          f"{time.perf_counter() - t_cell:.1f} s", flush=True)
                    release(m_a)
                    release(m_b)
                    del a, b

                # (c) the shape cut to 1M rows a table, held to the
                # full-table step
                t_part = time.perf_counter()
                cfg1 = mlperf_dlrm_config(max_ind_range=1_000_000,
                                          compute_dtype="float32")
                s1 = cfg1.table_sizes
                g1 = torch.Generator(device=dev).manual_seed(args.seed + 71)
                t0 = time.perf_counter()
                tabs = [torch.empty(n, D, device=dev).uniform_(
                    -float(np.sqrt(1.0 / n)), float(np.sqrt(1.0 / n)),
                    generator=g1) for n in s1]
                ev1 = os.path.join(d, "cut1m")
                write_ev_tables_binary([t.cpu().numpy() for t in tabs], ev1,
                                       32)
                full = DLRM(cfg1, device=dev, seed=args.seed, tables=tabs)
                del tabs
                torch.cuda.empty_cache()
                cut = list(random_batches(RandomDataConfig(
                    num_dense=13, table_sizes=s1, batch_size=MLPERF_B,
                    num_batches=MLPERF_CUT_WARM + MLPERF_CUT_N + 6,
                    seed=args.seed + 73, distribution="grouped_zipf",
                    zipf_alpha=1.05, group_noise=0.1)))
                print(f"3j(c) the 1M cut: {sum(s1)} rows x {D} "
                      f"({sum(s1) * D * 4 / 1e9:.2f} GB) drawn on the card, "
                      f"written with write_ev_tables_binary and loaded "
                      f"for make_train_step in "
                      f"{time.perf_counter() - t0:.2f} s", flush=True)
                st_f = init_opt_state(full, tcfg)
                step_f = make_train_step(cfg1, tcfg)
                warm_b = cut[:MLPERF_CUT_WARM]
                held = cut[MLPERF_CUT_WARM:MLPERF_CUT_WARM + MLPERF_CUT_N]
                for b_ in warm_b:
                    step_f(full, st_f, *b_)
                keys1 = sum(len(ids_of(held, t)) for t in range(T))
                tc = trn.TrainableDeviceCache.from_files(
                    cfg1, tcfg, CacheConfig(total_size=keys1), ev1, s1,
                    device=dev)
                for t in range(T):
                    rows = ids_of(warm_b, t)
                    rows_d = torch.from_numpy(rows).to(dev)
                    tc.host_tables[t][rows] = full.tables[t][rows_d].cpu()
                    tc.host_mom[t][rows] = \
                        st_f.sparse[f"tables.{t}"][rows_d].cpu()
                model = DLRM(cfg1, device=dev, seed=args.seed, tables=False)
                dst = trn.init_dense_state(model)
                with torch.no_grad():
                    params_f = dict(full.named_parameters())
                    for n_, p_ in model.named_parameters():
                        p_.copy_(params_f[n_])
                        dst[n_].copy_(st_f.dense[n_])
                worst = cache_against_full(
                    torch, tc, model, dst, full, st_f, step_f, held,
                    MLPERF_CUT_WARM,
                    run=lambda fn: counted(fn, "(c) the cut"))
                if tc.stats()["size"] != keys1:
                    raise AssertionError(f"3j(c): {tc.stats()['size']} "
                                         f"cached of {keys1} keys")
                print(f"3j(c) {MLPERF_CUT_N} steps with every key cached "
                      f"(capacity {keys1}, none evicted), from "
                      f"make_train_step's state after {MLPERF_CUT_WARM} "
                      f"steps on the full tables, under the recipe's "
                      f"schedule, each step from one state (the full "
                      f"tables take the batch's rows and sums from the "
                      f"cache, and its MLPs and their sums, before each): "
                      f"losses within {worst['loss']:.3e} of 1 + |ref| "
                      f"(limit 1e-4), the rows' step change |d_cached - "
                      f"d_full| / |d_full| at most {worst['rows']:.3e} "
                      f"(limit 1e-2), the row sums {worst['row sums']:.3e}"
                      f" and the MLPs' sums {worst['MLP sums']:.3e} of "
                      f"their own size, the MLPs max|d|/(1+|ref|) "
                      f"{worst['MLPs']:.3e} (limits 1e-4)", flush=True)
                work, moms = tc.host_tables, tc.host_mom
                tc.close()
                sd0 = {k: v.clone() for k, v in model.state_dict().items()}
                dst0 = {k: v.clone() for k, v in dst.items()}
                del tc, model, dst, full, st_f, step_f, params_f
                torch.cuda.empty_cache()

                off1 = dataclasses.replace(cfg1, use_gather_kernel=False,
                                           use_interaction_kernel=False)
                off_t = dataclasses.replace(tcfg, use_update_kernel=False)
                on_off = cut[MLPERF_CUT_WARM + MLPERF_CUT_N:]
                keys6 = sum(len(ids_of(on_off, t)) for t in range(T))

                def trainer1(bits, on):
                    c_, o_ = (cfg1, tcfg) if on else (off1, off_t)
                    tc_ = trn.TrainableDeviceCache(
                        c_, o_, CacheConfig(total_size=keys6,
                                            main_precision=bits), work,
                        copy_tables=False, device=dev)
                    m_ = DLRM(c_, device=dev, seed=args.seed, tables=False)
                    return tc_, m_, trn.init_dense_state(m_)

                cached_on_off(trainer1, work, moms, sd0, dst0, on_off,
                              (32, 8), "3j(c)",
                              step0=MLPERF_CUT_WARM + MLPERF_CUT_N + 1)
                del work, moms, cut, held, warm_b
                torch.cuda.empty_cache()
                print(f"3j(c) took {time.perf_counter() - t_part:.1f} s",
                      flush=True)
                t_part = time.perf_counter()

                # (d) the Terabyte shape with its tables on the card
                tb = terabyte_dlrm_config(compute_dtype="float32")
                g2 = torch.Generator(device=dev).manual_seed(args.seed + 81)
                t0 = time.perf_counter()
                tabs = [torch.empty(n, tb.embedding_dim, device=dev).uniform_(
                    -float(np.sqrt(1.0 / n)), float(np.sqrt(1.0 / n)),
                    generator=g2) for n in tb.table_sizes]
                model = DLRM(tb, device=dev, seed=args.seed, tables=tabs)
                del tabs
                torch.cuda.empty_cache()
                plain = DLRM(dataclasses.replace(
                    tb, use_gather_kernel=False,
                    use_interaction_kernel=False), device=dev,
                    seed=args.seed, tables=list(model.tables))
                fence()
                tb_gb = sum(tb.table_sizes) * tb.embedding_dim * 4 / 1e9
                print(f"3j(d) the Terabyte shape: {sum(tb.table_sizes)} rows"
                      f" x {tb.embedding_dim} ({tb_gb:.2f} GB) drawn on the "
                      f"card, two copies of the model in "
                      f"{time.perf_counter() - t0:.2f} s, "
                      f"{torch.cuda.memory_allocated() / 1e9:.2f} GB "
                      f"allocated", flush=True)
                tb_stream = iter(list(random_batches(RandomDataConfig(
                    num_dense=13, table_sizes=tb.table_sizes,
                    batch_size=MLPERF_B,
                    num_batches=2 * (2 * 5 + TB_WARM + TB_N),
                    seed=args.seed + 83, distribution="grouped_zipf",
                    zipf_alpha=1.05, group_noise=0.1))))

                def take(n):
                    return [next(tb_stream) for _ in range(n)]

                opts = [TrainConfig(learning_rate=0.1, optimizer=o)
                        for o in ("sgd", "rwsadagrad")]

                def checks():
                    for o in opts:
                        held_on_off(o, model, plain, take,
                                    label=f"3j(d) terabyte {o.optimizer} ")

                counted(checks, "(d) the Terabyte checks",
                        gather=("gather_rows_grouped",))
                del plain
                torch.cuda.empty_cache()

                def rates():
                    out = {}
                    for o in opts:
                        train(model, tb, o, take(TB_WARM))
                        out[o.optimizer] = train(model, tb, o, take(TB_N))[
                            2]["it_per_s"]
                    return out

                tb_rates = counted(rates, "(d) the Terabyte windows",
                                   gather=("gather_rows_grouped",))
                print(f"3j(d) terabyte train B={MLPERF_B} lr 0.1 [{card}]: "
                      + "; ".join(
                          f"{o} {r:.2f} steps/s ({r * MLPERF_B:.0f} "
                          f"samples/s; all {TB_N} steps of `train` after "
                          f"{TB_WARM} over all their time)"
                          for o, r in tb_rates.items())
                      + f"; (d) took {time.perf_counter() - t_part:.1f} s",
                      flush=True)
                del model
                torch.cuda.empty_cache()
            finally:
                for m in list(live):
                    m.close()
                shutil.rmtree(d, ignore_errors=True)
            if os.path.exists(d):
                raise AssertionError(f"3j: {d} is still there")
            print(f"3j: the phase's directory is gone", flush=True)
            path = {k: launches[k] for k in (
                "interaction_fwd", "interaction_bwd", "gather_rows",
                "gather_rows_grouped", "gather_rows_dequant_int8",
                "scatter_sub_sorted", "rwsadagrad_sorted")}
            print(f"train_mlperf path launches: {json.dumps(path)}",
                  flush=True)
            return path

    # ------------------------------------------- 3k the MLPerf shape served
    SERVE_C1 = "dlrm_s_criteo_kaggle_C1.sh"
    SERVE_C3 = "dlrm_s_criteo_kaggle_C1_C2_C3.sh"
    MLPERF_SERVE_W = 60     # warm-up batches allowed for the tiers to fill
    MLPERF_SERVE_N = 64     # scored batches of 2048 a run
    GIB = 1 << 30

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

    def int8_apply_held(cache, idx, what):
        """One more batch through an int8 device cache: the apply's rows
        bit for bit the plain version's on the same cache state and miss
        buffer, and every value on the int8 grid."""
        assign = cache.assigner.assign_batch(idx)
        with torch.inference_mode():
            rows = cache._apply_assign(assign)
            slots, _, _, buf = assign
            bk = cache.insert_bucket
            buf_q = np.zeros((max(bk, -(-len(buf) // bk) * bk), cache.dim),
                             np.float32)
            buf_q[:len(buf)] = buf
            ref = gather_rows_dequant_int8_ref(
                cache.cache_values, torch.from_numpy(slots).to(dev),
                torch.from_numpy(np_quantize_int8(buf_q)).to(dev))
            grid = dequantize_int8(torch.arange(256, device=dev,
                                                dtype=torch.uint8))
            if not torch.equal(rows.view(torch.int32),
                               ref.view(torch.int32)):
                raise AssertionError(f"{what}: the int8 apply's rows differ "
                                     f"from the plain version's")
            if not bool(torch.isin(rows, grid).all()):
                raise AssertionError(f"{what}: an int8 row value is off the "
                                     f"grid")

    def window_rates(s0, s1):
        """C1's hit rate and C3's hits over the requests between two
        stats."""
        n = s1["requests"] - s0["requests"]
        hr = (s1["hit_rate"] * s1["requests"]
              - s0["hit_rate"] * s0["requests"]) / n
        c3 = (s1["c3"]["hits"] - s0["c3"]["hits"]) if "c3" in s1 else None
        return n, hr, c3

    def path_counter(launches, phase):
        """counted(fn, what, need) for a phase: fn() with every count set
        to 0 just before, its launches added to `launches`, and the kernels
        `need` must each have launched."""
        def counted(fn, what, need):
            reset_counts()
            out = fn()
            got = read_counts()
            for k, v in got.items():
                launches[k] += v
            idle = never_launched(got, need)
            if idle:
                raise AssertionError(f"{phase} {what}: {idle} never "
                                     f"launched: {got}")
            return out
        return counted

    def c1_held_to_files(cache, maps, what):
        """Every row in an fp32 device C1's slots bit for bit the files'
        (np.memmaps [N, D] a table) -> (rows held, entries, nonzero rows).
        The policy's entries without a slot are served from the batch's
        buffer alone, so at least 90% of the entries must hold a slot."""
        keys, slots = cache.assigner.resident_keys()
        tk, rk = keys >> 40, keys & ((1 << 40) - 1)
        want = np.empty((len(keys), cache.dim), np.float32)
        for t in range(len(maps)):
            sel = tk == t
            want[sel] = maps[t][rk[sel]]
        got = cache.cache_values[torch.from_numpy(
            slots.astype(np.int64)).to(dev)].cpu().numpy()
        n_held, n_size = len(keys), cache.stats()["size"]
        if n_held < 0.9 * n_size or not np.array_equal(
                got.view(np.int32), want.view(np.int32)):
            raise AssertionError(f"{what}: C1 holds {n_held} rows (stats "
                                 f"{n_size}), "
                                 f"{int((got != want).any(1).sum())} of "
                                 f"them differ from the files'")
        return n_held, n_size, int((np.abs(want).sum(1) > 0).sum())

    def serve_flags(script):
        """A bench/ serving script's cache and store flags: its model, its
        data and its CDF path left out."""
        flags, out, k = bench_flags(script), [], 0
        while k < len(flags):
            if flags[k].startswith("--arch-") or flags[k] in (
                    "--data-generation", "--write-cdf-file"):
                k += 2
                continue
            out.append(flags[k])
            k += 1
        return out

    def phase_3k():
        """The MLPerf recipe's shape (bench/run_and_time.sh: dim 128, the 26
        Terabyte tables capped at 40M rows, 204,184,588 rows, 104.5 GB at
        float32; top 1024-1024-512-256-1) served through EVStore's tiers
        with the tables in memory files on the host (`MemoryFiles`) and
        only the cache on the card, by a model that holds no tables: (0)
        the room, and a seeded float32 row written into every row that one
        grouped_zipf stream (alpha 1.05, group noise 0.1, B = 2048, 60 + 64
        + 1 batches) reaches, and nothing else; (a) the device C1 at fp32
        with the C1 script's cache (EvLFU, 64,000 entries) through
        `NativeDeviceC1Cache.open_table_files` and `run_inference`, warmed
        up until full and scored over 64 batches at `pipeline_depth` 0 and
        2 (equal scores and stats), C1's rows bit for bit against the
        files, the scores against `DLRM.predict` with every kernel off on
        rows read from a np.memmap of the files; (b) the published
        three-tier configuration (int8 C1, 4-bit C2, alt-key C3 at
        48-48-4, 75,425 entries) over the same files, each row's alt key a
        uniform row of its table among those the stream reaches, warmed up
        until every tier is full and scored at depth 2, C2 and C3 live,
        one more batch's int8 rows against the plain version.  (The CLI
        serves this shape in 3l, with the model 3l trains.)  The card's
        peak allocated memory stays under 2 GiB.  K1, K2 and K3 must
        launch.  Returns the path's launch counts (`serve_mlperf`)."""
        from evstore_tpu_torch import cli
        from evstore_tpu_torch.cache.device_cache import NativeDeviceC1Cache
        launches = dict.fromkeys(wrappers, 0)
        counted = path_counter(launches, "3k")

        def peak(after):
            p = torch.cuda.max_memory_allocated()
            print(f"3k device memory after {after} [{card}]: peak "
                  f"{p / GIB:.3f} GiB allocated (the phase began with "
                  f"{mem0 / GIB:.3f}) beside {gb:.1f} GB of tables in the "
                  f"files", flush=True)
            if p >= 2 * GIB:
                raise AssertionError(f"3k {after}: {p} bytes on the card")

        with Phase("3k mlperf serving"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            d = tempfile.mkdtemp(prefix="mlperf-serve-")
            live = []       # caches and MemoryFiles to close
            try:
                parse = cli.build_parser().parse_args
                flags = recipe_flags()
                rcfg, _, _ = cli.configs_from_args(parse(flags))
                if rcfg.embedding_dim != 128 or sum(rcfg.table_sizes) != \
                        204_184_588 or tuple(rcfg.mlp_top[1:]) != \
                        (1024, 1024, 512, 256, 1):
                    raise AssertionError(f"run_and_time.sh's flags gave "
                                         f"{rcfg}")
                cfg = dataclasses.replace(rcfg, compute_dtype="float32")
                sizes, D, T = cfg.table_sizes, cfg.embedding_dim, \
                    cfg.num_tables
                gb = sum(sizes) * D * 4 / 1e9
                _, _, ccfg1 = cli.configs_from_args(parse(
                    flags + serve_flags(SERVE_C1)))
                _, _, ccfg3 = cli.configs_from_args(parse(
                    flags + serve_flags(SERVE_C3)))
                if (ccfg1.policy, ccfg1.total_size, ccfg1.n_caching_layers,
                        ccfg1.main_precision) != ("evlfu", 64000, 1, 32) or \
                        (ccfg3.total_size, ccfg3.main_precision,
                         ccfg3.secondary_precision,
                         tuple(ccfg3.size_proportion)) != \
                        (75425, 8, 4, (48, 48, 4)):
                    raise AssertionError(f"the serving scripts gave "
                                         f"{ccfg1}, {ccfg3}")

                # (0) the room and the rows the stream reaches
                ram = meminfo_kb("MemAvailable") * 1024
                disk = shutil.disk_usage(d).free
                room = min(ram, disk) / 4
                t0 = time.perf_counter()
                stream = list(random_batches(RandomDataConfig(
                    num_dense=13, table_sizes=sizes, batch_size=2048,
                    num_batches=MLPERF_SERVE_W + MLPERF_SERVE_N + 1,
                    seed=args.seed + 71, distribution="grouped_zipf",
                    zipf_alpha=1.05, group_noise=0.1)))
                reach = [np.unique(np.concatenate(
                    [b[1][:, t] for b in stream])).astype(np.int64)
                    for t in range(T)]
                per = 4096 // (D * 4)
                n_pages = sum(len(np.unique(r // per)) for r in reach)
                if n_pages * 4096 > room:
                    raise AssertionError(f"3k: {n_pages} pages over the "
                                         f"room of {room / 1e9:.1f} GB")
                print(f"3k(0) room [{card}]: {ram / 1e9:.1f} GB of host "
                      f"RAM available, {disk / 1e9:.1f} GB of disk free "
                      f"under {d}; the stream's {len(stream)} grouped_zipf "
                      f"batches reach {sum(len(r) for r in reach)} distinct "
                      f"rows on {n_pages} pages of 4 KB: "
                      f"{n_pages * 4096 / 1e9:.2f} GB within a quarter of "
                      f"the smaller, {room / 1e9:.1f} GB (stream made in "
                      f"{time.perf_counter() - t0:.2f} s)", flush=True)
                print("3k(0) distinct rows per table: " + ", ".join(
                    f"{t + 1}: {len(r)} of {n}"
                    for t, (r, n) in enumerate(zip(reach, sizes))),
                    flush=True)

                mf = MemoryFiles(os.path.join(d, "ev"), sizes, D)
                live.append(mf)
                # a seeded row at the init's scale into every reached row,
                # table by table in row order, one pwrite a run of rows
                wrng = np.random.default_rng(args.seed + 72)
                t0 = time.perf_counter()
                n_runs = 0
                for t, rows in enumerate(reach):
                    b = np.sqrt(1.0 / sizes[t])
                    vals = wrng.uniform(-b, b, (len(rows), D)).astype(
                        np.float32)
                    cut = np.flatnonzero(np.diff(rows) != 1) + 1
                    starts = np.concatenate([[0], cut])
                    ends = np.concatenate([cut, [len(rows)]])
                    fd = mf.fds[2 * t]
                    for a, e in zip(starts.tolist(), ends.tolist()):
                        os.pwrite(fd, vals[a:e], int(rows[a]) * D * 4)
                    n_runs += len(starts)
                t_write = time.perf_counter() - t0
                written = sum(len(r) for r in reach)
                print(f"3k(0) memory files [{card}]: {len(mf.fds)} files "
                      f"({gb:.1f} GB of tables and their untouched sums); "
                      f"{written} rows written in {n_runs} runs in "
                      f"{t_write:.2f} s ({t_write / written * 1e6:.2f} us a "
                      f"row); the files took {mf.touched_mb():.1f} MB of "
                      f"pages ({n_pages * 4096 / 2**20:.1f} MB of 4 KB "
                      f"pages reached)", flush=True)
                if mf.touched_mb() * 2**20 > room:
                    raise AssertionError("3k(0): the files took more than "
                                         "the room")
                maps = [np.memmap(os.path.join(mf.dir,
                                               f"ev-table-{t + 1}.bin"),
                                  np.float32, mode="r", shape=(n, D))
                        for t, n in enumerate(sizes)]

                def file_rows(idx):
                    """[B, T] -> the files' rows [B, T, D], through the
                    np.memmaps."""
                    return np.stack([maps[t][idx[:, t]] for t in range(T)],
                                    axis=1)

                # a read of a written row through the mapping, first touch
                n_probe = min(20_000, len(reach[0]))
                probe_rows = np.sort(reach[0][np.random.default_rng(
                    args.seed).choice(len(reach[0]), n_probe,
                                      replace=False)])
                t0 = time.perf_counter()
                maps[0][probe_rows].sum()
                print(f"3k(0) a written row's first read through np.memmap: "
                      f"{(time.perf_counter() - t0) / n_probe * 1e6:.2f} us "
                      f"({n_probe} rows of table 1)", flush=True)

                def open_cache(ccfg_, alts=None):
                    c = NativeDeviceC1Cache(ccfg_, T, D, device=dev)
                    live.append(c)
                    c.open_table_files(mf.dir, sizes, 32)
                    if alts is not None:
                        c.load_altkeys(alts)
                    return c

                def release(c):
                    c.close()
                    live.remove(c)

                def warm_up_k(cache, full):
                    """Lookups over the stream until `full(stats)` (within
                    MLPERF_SERVE_W batches) -> (warm-up, scored, one
                    more)."""
                    n = 0
                    with torch.inference_mode():
                        while not full(cache.stats()):
                            if n == MLPERF_SERVE_W:
                                raise AssertionError(
                                    f"3k: the tiers were not full after "
                                    f"{n} warm-up batches: {cache.stats()}")
                            cache.lookup_batch(stream[n][1])
                            n += 1
                    torch.cuda.synchronize()
                    cache.host_s = dict.fromkeys(cache.host_s, 0.0)
                    return (stream[:n], stream[n:n + MLPERF_SERVE_N],
                            stream[n + MLPERF_SERVE_N])

                # (a) the device C1, fp32, at depth 0 and 2
                torch.cuda.synchronize()
                mem0 = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                model = DLRM(cfg, device=dev, seed=args.seed, tables=False)
                if model.has_sparse():
                    raise AssertionError("3k: the serving model holds "
                                         "tables")
                runs = {}
                for depth in (0, 2):
                    t0 = time.perf_counter()
                    cache = open_cache(ccfg1)
                    warm, scored, extra = warm_up_k(
                        cache, lambda s: s["size"] >= s["capacity"])
                    t_warm = time.perf_counter() - t0
                    s0 = cache.stats()
                    res = counted(lambda: run_inference(
                        model, cfg, ccfg1, scored, None,
                        use_device_cache=True, pipeline_depth=depth,
                        cache=cache, device=dev),
                        f"(a) depth {depth}",
                        ("interaction_fwd", "gather_rows"))
                    runs[depth] = (res, dict(cache.host_s), len(warm), s0,
                                   t_warm)
                    if depth == 0:
                        n_held, n_size, n_nonzero = c1_held_to_files(
                            cache, maps, "3k(a)")
                        # what a miss read costs the engine: one more
                        # batch's 53,248 rows read on its pool of 4, pread
                        # by pread
                        fidx = extra[1].astype(np.int64)
                        t1 = time.perf_counter()
                        fetched = cache.assigner.fetch_rows_arrays(
                            np.tile(np.arange(T, dtype=np.int32),
                                    len(fidx)), fidx.reshape(-1))
                        t_fetch = time.perf_counter() - t1
                        if not np.array_equal(
                                fetched.reshape(fidx.shape + (D,)).view(
                                    np.int32),
                                file_rows(fidx).view(np.int32)):
                            raise AssertionError("3k(a): the engine's reads "
                                                 "differ from the files'")
                    release(cache)
                    del cache
                (res0, split0, w0, s00, tw0), (res2, split2, _, _, tw2) = \
                    runs[0], runs[2]
                if not np.array_equal(res2.scores, res0.scores):
                    raise AssertionError("3k(a): pipeline_depth 2 changed "
                                         "the scores")
                if res2.cache_stats != res0.cache_stats:
                    raise AssertionError(f"3k(a): pipeline_depth 2 changed "
                                         f"the stats: {res2.cache_stats} "
                                         f"!= {res0.cache_stats}")
                if res0.scores is None or res0.scores.shape != (
                        MLPERF_SERVE_N * 2048,) or \
                        not np.isfinite(res0.scores).all():
                    raise AssertionError("3k(a): scores missing, misshapen "
                                         "or not finite")
                # the plain version: DLRM.predict, every kernel off, on the
                # files' rows through np.memmap
                plain = DLRM(dataclasses.replace(
                    cfg, use_interaction_kernel=False,
                    use_gather_kernel=False), device=dev, seed=args.seed,
                    tables=False)
                t0 = time.perf_counter()
                t_read = 0.0
                ref = []
                with torch.inference_mode():
                    for dense, idx, _ in scored:
                        t1 = time.perf_counter()
                        rows = torch.from_numpy(file_rows(idx)).to(dev)
                        t_read += time.perf_counter() - t1
                        ref.append(plain.predict(
                            torch.from_numpy(dense).to(dev), emb_rows=rows))
                ref = torch.cat(ref).cpu().numpy()
                t_plain = time.perf_counter() - t0
                sdiff = float(np.abs(res0.scores - ref).max())
                if not bool((np.abs(res0.scores - ref)
                             <= 1e-5 * (1 + np.abs(ref))).all()):
                    raise AssertionError(f"3k(a): scores differ from the "
                                         f"plain version's: max|d| {sdiff}")
                del plain, ref
                serve_line("3k(a) MLPerf shape, NativeDeviceC1Cache fp32 "
                           "over memory files, pipeline_depth 0", res0,
                           split0)
                serve_line("3k(a) MLPerf shape, NativeDeviceC1Cache fp32 "
                           "over memory files, pipeline_depth 2", res2,
                           split2)
                n_req, hr, _ = window_rates(s00, res0.cache_stats)
                s = res0.cache_stats
                print(f"3k(a) cache [{card}]: {w0} warm-up batches until C1 "
                      f"held {ccfg1.total_size} rows ({tw0:.2f} s with the "
                      f"engine's set-up; {tw2:.2f} s the second time); over "
                      f"the {n_req} scored requests C1 hit_rate {hr:.6f}; "
                      f"at the end hit_rate {s['hit_rate']:.6f} perfect_hits "
                      f"{s['perfect_hits']} bytes_shipped "
                      f"{s['bytes_shipped']} requests {s['requests']}; "
                      f"depth 2's scores and stats equal depth 0's",
                      flush=True)
                print(f"3k(a) check: the {n_held} rows in C1's slots after "
                      f"depth 0's run ({n_size} entries) bit for bit the "
                      f"files' ({n_nonzero} of them nonzero); scores against DLRM.predict with every "
                      f"kernel off on the files' rows max|d| {sdiff:.3e} "
                      f"(plain pass {t_plain:.2f} s, of it the np.memmap "
                      f"reads {t_read:.2f} s); auc "
                      f"{res0.metrics['auc']:.4f} (random weights and "
                      f"labels)", flush=True)
                print(f"3k(a) the engine's reads [{card}]: one batch's "
                      f"{fidx.size} rows (every lookup a read) in "
                      f"{t_fetch * 1e3:.3f} ms on its pool of 4, "
                      f"{t_fetch / fidx.size * 1e6:.3f} us a row, bit for "
                      f"bit the files'", flush=True)
                peak("(a)")
                del res0, res2

                # (b) the published three tiers, int8 C1
                t0 = time.perf_counter()
                arng = np.random.default_rng(args.seed + 73)
                alts = [altkey_encode(t, r[arng.integers(0, len(r), n)]
                                      ).astype(np.uint32)
                        for t, (r, n) in enumerate(zip(reach, sizes))]
                t_alts = time.perf_counter() - t0
                caps = ccfg3.tier_capacities()
                t0 = time.perf_counter()
                cache = open_cache(ccfg3, alts)
                alt_mb = sum(a.nbytes for a in alts) / 1e6
                del alts
                t_load = time.perf_counter() - t0
                warm3, scored3, extra3 = warm_up_k(
                    cache, lambda s: (s["size"] >= caps[0]
                                      and s["c2"]["size"] >= caps[1]
                                      and s["c3"]["size"] >= caps[2]))
                s_start = cache.stats()
                res3 = counted(lambda: run_inference(
                    model, cfg, ccfg3, scored3, None, use_device_cache=True,
                    pipeline_depth=2, cache=cache, device=dev),
                    "(b) three tiers",
                    ("interaction_fwd", "gather_rows_dequant_int8"))
                split3 = dict(cache.host_s)
                s3 = res3.cache_stats
                if not (s3["c2"]["hit_rate"] > 0 and s3["c3"]["size"] > 0):
                    raise AssertionError(f"3k(b): C2 or C3 is not live: "
                                         f"{s3}")
                if res3.scores is None or res3.scores.shape != (
                        MLPERF_SERVE_N * 2048,) or \
                        not np.isfinite(res3.scores).all():
                    raise AssertionError("3k(b): scores missing, misshapen "
                                         "or not finite")
                # one more batch (not counted above)
                int8_apply_held(cache, extra3[1], "3k(b)")
                release(cache)
                del cache
                serve_line("3k(b) MLPerf shape, three tiers, "
                           "NativeDeviceC1Cache int8, uniform alt keys, "
                           "pipeline_depth 2", res3, split3)
                n_req, hr, c3_hits = window_rates(s_start, s3)
                print(f"3k(b) cache [{card}]: tiers {caps}; alt keys "
                      f"({alt_mb:.1f} MB of uint32) drawn in {t_alts:.2f} s, "
                      f"engine and keys loaded in {t_load:.2f} s; "
                      f"{len(warm3)} warm-up batches until C1, C2 and C3 "
                      f"were full; over the {n_req} scored requests C1 "
                      f"hit_rate {hr:.6f}, C3 hits {c3_hits}; C2 cumulative "
                      f"hit_rate {s_start['c2']['hit_rate']:.6f} at the "
                      f"start, {s3['c2']['hit_rate']:.6f} at the end; at "
                      f"the end: C1 {s3['size']} of {s3['capacity']}, C2 "
                      f"{s3['c2']}, C3 {s3['c3']}, perfect_hits "
                      f"{s3['perfect_hits']}, bytes_shipped "
                      f"{s3['bytes_shipped']}", flush=True)
                print(f"3k(b) check: the extra batch's int8 rows bit for "
                      f"bit the plain version's on the same state and "
                      f"buffer, all on the int8 grid; auc "
                      f"{res3.metrics['auc']:.4f} (random weights and "
                      f"labels)", flush=True)
                peak("(b)")
                del res3, model, maps
                torch.cuda.empty_cache()
            finally:
                # the engines first, then the memory files
                for c in reversed(live):
                    c.close()
                shutil.rmtree(d, ignore_errors=True)
            if os.path.exists(d):
                raise AssertionError(f"3k: {d} is still there")
            path = {k: launches[k] for k in ("interaction_fwd",
                                             "gather_rows",
                                             "gather_rows_dequant_int8")}
            print(f"serve_mlperf path launches: {json.dumps(path)}",
                  flush=True)
            return path

    # ------------------------------ 3l the MLPerf shape, trained then served
    HANDOFF_N = 32          # the CLI's synthetic training batches
    HANDOFF_TEST = 16       # its test batches at most (it makes at least 10)
    HANDOFF_W = 120         # warm-up batches allowed for (c)'s tiers to fill

    def phase_3l():
        """The MLPerf recipe's shape (bench/run_and_time.sh: dim 128, the 26
        Terabyte tables capped at 40M rows, 204,184,588 rows, 104.5 GB at
        float32) trained through the CLI and the trainable cache over
        memory-file masters, then served from what it saved: (0) the room,
        fresh `MemoryFiles` masters (the rows zero) and the pages the runs
        can touch, held to a quarter of the smaller of free RAM and disk;
        (a) `cli.main` with the recipe's model, loss and schedule flags plus
        `--data-generation synthetic --use-evstore True --optimizer
        rwsadagrad --emb-cache-size 64000 --ev-table-path <masters>
        --save-model <ck> --test-freq -1`, 32 batches: it must end
        `training done` with every loss finite and under 2 ln 2 and leave
        `dense_params.npz` in <ck>, whose MLPs differ from the seed's; (b) a
        `DLRM(tables=False)` with the MLPs `restore_npz_mlps` reads from
        <ck>, served through the C1 script's device C1 (EvLFU, 64,000 fp32)
        over the trained files on the CLI's own test batches (seed + 1,
        10-16 of 2048) after a warm-up pass over them, at `pipeline_depth` 0
        and 2 (equal scores and stats), C1's rows bit for bit the files',
        the scores within 1e-5·(1+|ref|) of `DLRM.predict` with every
        kernel off on rows read through np.memmap, at least half the
        lookups reading a row training wrote, and the seed's MLPs on the
        same rows scoring outside that bound (the witness); (c) the
        published three tiers (int8 C1, 4-bit C2, alt-key C3, 48-48-4,
        75,425) over the same files, each row's alt key a uniform row of
        its table among those training wrote, warmed up until every tier is
        full on the CLI's synthetic stream (the training batches, then the
        batches that follow them) and scored at depth 2, C2 and C3 live,
        one more batch's int8 rows the plain version's bit for bit;
        (d) `cli.main` with the recipe's flags, the C1 script's serving
        flags and `--use-device-cache True --ev-table-path <masters>
        --load-model <ck> --data-generation synthetic --compute-dtype
        float32` on the same test batches: it must end `inference done`
        with a model that holds no table and metrics equal to the plain
        eval of (b)'s batches by 3f's rule.  The card's peak allocated
        memory after (b), (c) and (d) stays under 2 GiB.  K1, K2, K4 and K5
        must launch in (a), K1 and K2 in (b) and (d), K1 and K3 in (c).
        Returns the path's launch counts (`handoff_mlperf`)."""
        import contextlib

        from evstore_tpu_torch import cli
        from evstore_tpu_torch.cache import device_cache as dc_mod
        from evstore_tpu_torch.cache import trainable as trn
        from evstore_tpu_torch.drivers import infer as infer_mod
        from evstore_tpu_torch.models import dlrm as dlrm_mod
        from evstore_tpu_torch.train.metrics import binary_metrics
        from evstore_tpu_torch.utils.checkpoint import restore_npz_mlps
        launches = dict.fromkeys(wrappers, 0)
        counted = path_counter(launches, "3l")

        def peak(after):
            p = torch.cuda.max_memory_allocated()
            print(f"3l device memory after {after} [{card}]: peak "
                  f"{p / GIB:.3f} GiB allocated since (b) began ((a) "
                  f"training: {peak_a / GIB:.3f} GiB) beside {gb:.1f} GB of "
                  f"tables in the files", flush=True)
            if p >= 2 * GIB:
                raise AssertionError(f"3l {after}: {p} bytes on the card")

        with Phase("3l mlperf train to serve"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            d = tempfile.mkdtemp(prefix="mlperf-handoff-")
            live = []       # caches and MemoryFiles to close
            try:
                parse = cli.build_parser().parse_args
                flags = recipe_flags()
                rcfg, rt, _ = cli.configs_from_args(parse(flags))
                if rcfg.embedding_dim != 128 or sum(rcfg.table_sizes) != \
                        204_184_588 or rt.lr_num_warmup_steps != 2750:
                    raise AssertionError(f"run_and_time.sh's flags gave "
                                         f"{rcfg}, {rt}")
                cfg = dataclasses.replace(rcfg, compute_dtype="float32")
                sizes, D, T = cfg.table_sizes, cfg.embedding_dim, \
                    cfg.num_tables
                gb = sum(sizes) * D * 4 / 1e9
                _, _, ccfg1 = cli.configs_from_args(parse(
                    flags + serve_flags(SERVE_C1)))
                _, _, ccfg3 = cli.configs_from_args(parse(
                    flags + serve_flags(SERVE_C3)))
                ck = os.path.join(d, "ck")
                train_argv = flags + [
                    "--data-generation", "synthetic", "--num-batches",
                    str(HANDOFF_N), "--print-freq", str(HANDOFF_N // 8),
                    "--use-evstore", "True", "--optimizer", "rwsadagrad",
                    "--emb-cache-size", str(ccfg1.total_size),
                    "--save-model", ck, "--test-freq", "-1"]
                serve_argv = flags + serve_flags(SERVE_C1) + [
                    "--use-device-cache", "True", "--data-generation",
                    "synthetic", "--nbatches-test", str(HANDOFF_TEST),
                    "--compute-dtype", "float32", "--load-model", ck,
                    "--write-cdf-file", os.path.join(d, "cdf.csv")]
                seed = parse(train_argv).numpy_rand_seed

                # (0) the room and the rows the streams reach
                ram = meminfo_kb("MemAvailable") * 1024
                disk = shutil.disk_usage(d).free
                room = min(ram, disk) / 4
                t0 = time.perf_counter()
                train_b = list(cli._make_data(parse(train_argv), rcfg)[0]())
                test_b = list(cli._make_data(parse(serve_argv), rcfg)[1]())
                per = 4096 // (D * 4)

                def pages(batches, sums):
                    """The table pages (and sum pages) `batches` reach."""
                    n = 0
                    for t in range(T):
                        r = np.unique(np.concatenate(
                            [b[1][:, t] for b in batches]))
                        n += len(np.unique(r // per))
                        n += len(np.unique(r // 1024)) if sums else 0
                    return n

                n_test = len(test_b)
                p_train = pages(train_b, True)
                while n_test > 10 and (p_train + pages(
                        test_b[:n_test], False)) * 4096 > room:
                    n_test -= 2
                worst = p_train + pages(test_b[:n_test], False)
                if worst * 4096 > room:
                    raise AssertionError(f"3l: {worst} pages over the room "
                                         f"of {room / 1e9:.1f} GB")
                test_b = test_b[:n_test]
                serve_argv[serve_argv.index("--nbatches-test") + 1] = \
                    str(n_test)
                reach = [np.unique(np.concatenate(
                    [b[1][:, t] for b in train_b])).astype(np.int64)
                    for t in range(T)]
                print(f"3l(0) room [{card}]: {ram / 1e9:.1f} GB of host RAM "
                      f"available, {disk / 1e9:.1f} GB of disk free under "
                      f"{d}; the CLI's {len(train_b)} synthetic (zipf 1.05) "
                      f"training batches of 2048 reach "
                      f"{sum(len(r) for r in reach)} distinct rows, and "
                      f"with their sums and its {n_test} test batches at "
                      f"most {worst} pages of 4 KB ({worst * 4096 / 1e9:.2f}"
                      f" GB) within a quarter of the smaller, "
                      f"{room / 1e9:.1f} GB (streams made in "
                      f"{time.perf_counter() - t0:.2f} s)", flush=True)
                mf = MemoryFiles(os.path.join(d, "ev"), sizes, D)
                live.append(mf)
                print(f"3l(0) fresh masters: {len(mf.fds)} memory files, "
                      f"{mf.virtual / 1e9:.1f} GB ({gb:.1f} GB of tables, "
                      f"every row zero), {mf.touched_mb():.1f} MB of pages",
                      flush=True)

                # (a) train through the CLI, the cache's counters read
                # through a spy on the instance the driver makes
                made = []
                real_ff = trn.TrainableDeviceCache.__dict__["from_files"]

                def spied_ff(cls, *a, **kw):
                    tc = real_ff.__func__(cls, *a, **kw)
                    rec = {"land writes": 0, "flush writes": 0,
                           "flushing": False}
                    write, flush, close = (tc._write_masters,
                                           tc.flush_files, tc.close)

                    def spy_write(ts, *rest):
                        rec["flush writes" if rec["flushing"]
                            else "land writes"] += len(ts)
                        write(ts, *rest)

                    def spy_flush():
                        rec["flushing"] = True
                        t1 = time.perf_counter()
                        flush()
                        rec["flush_s"] = time.perf_counter() - t1

                    def spy_close():
                        rec["stats"], rec["host_s"] = tc.stats(), \
                            dict(tc.host_s)
                        close()

                    tc._write_masters, tc.flush_files, tc.close = \
                        spy_write, spy_flush, spy_close
                    made.append(rec)
                    return tc

                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                tee = Tee(sys.stdout)
                trn.TrainableDeviceCache.from_files = classmethod(spied_ff)
                t0 = time.perf_counter()
                try:
                    with contextlib.redirect_stdout(tee):
                        rc = counted(lambda: cli.main(train_argv + [
                            "--ev-table-path", mf.dir]), "(a) training",
                            ("interaction_fwd", "interaction_bwd",
                             "gather_rows", "scatter_sub_sorted"))
                finally:
                    trn.TrainableDeviceCache.from_files = real_ff
                secs = time.perf_counter() - t0
                peak_a = torch.cuda.max_memory_allocated()
                lines = [x for x in tee.text if x.strip()]
                out = "\n".join(lines)
                trained = re.search(r"trained (\d+) steps in ([\d.]+) s "
                                    r"\(([\d.]+) steps/s\)", out)
                losses = [float(x) for x in re.findall(
                    r"step \d+: loss ([-\d.naif]+)", out)]
                if rc != 0 or not lines or \
                        not lines[-1].startswith("training done") or \
                        trained is None or \
                        int(trained.group(1)) != len(train_b) or \
                        not losses or not np.isfinite(losses).all() or \
                        max(losses) >= 2 * np.log(2) or len(made) != 1:
                    raise AssertionError(f"3l(a) the CLI: rc {rc}, losses "
                                         f"{losses}, last line "
                                         f"{lines[-1:]}")
                if not os.path.exists(os.path.join(ck, "dense_params.npz")):
                    raise AssertionError(f"3l(a): no dense_params.npz in "
                                         f"{os.listdir(ck)}")
                rec = made[0]
                n_steps = int(trained.group(1))
                # the rows training wrote: the masters started at zero
                maps = [np.memmap(os.path.join(mf.dir,
                                               f"ev-table-{t + 1}.bin"),
                                  np.float32, mode="r", shape=(n, D))
                        for t, n in enumerate(sizes)]
                t0 = time.perf_counter()
                wrote = [r[np.abs(maps[t][r]).sum(1) > 0]
                         for t, r in enumerate(reach)]
                t_scan = time.perf_counter() - t0
                n_wrote = sum(len(w) for w in wrote)
                if n_wrote < 0.9 * sum(len(r) for r in reach):
                    raise AssertionError(f"3l(a): {n_wrote} rows written of "
                                         f"the {sum(len(r) for r in reach)}"
                                         f" reached")
                split = ", ".join(f"{k} {v / n_steps * 1e3:.2f}"
                                  for k, v in rec["host_s"].items())
                st = rec["stats"]
                print(f"3l(a) cli [{card}]: run_and_time.sh's model, loss "
                      f"and schedule flags + --data-generation synthetic "
                      f"--use-evstore True --optimizer rwsadagrad "
                      f"--emb-cache-size {ccfg1.total_size} --ev-table-path "
                      f"<fresh masters> --save-model <ck> --test-freq -1 "
                      f"(bf16 compute, the CLI's default): {n_steps} steps "
                      f"at {trained.group(3)} steps/s "
                      f"({float(trained.group(3)) * 2048:.0f} samples/s); "
                      f"host ms a step: {split}; flush_files "
                      f"{rec['flush_s']:.2f} s; the run took {secs:.2f} s; "
                      f"C1 hit rate {st['hit_rate']:.4f} over "
                      f"{st['requests']} requests, {st['size']} of "
                      f"{st['capacity']} cells; row write-backs: "
                      f"{rec['land writes']} landed during the run, "
                      f"{rec['flush writes']} flushed at its end; "
                      f"{n_wrote} rows of the files nonzero (scanned in "
                      f"{t_scan:.2f} s); losses "
                      f"{', '.join(f'{x:.4f}' for x in losses)} (finite, "
                      f"under 2 ln 2); the files took {mf.touched_mb():.1f} "
                      f"MB; peak device memory {peak_a / GIB:.3f} GiB; "
                      f"host RSS {rss_gb():.2f} GB", flush=True)

                # (b) the trained files and MLPs through the device C1
                model = DLRM(cfg, device=dev, seed=seed, tables=False)
                step = restore_npz_mlps(ck, model)
                seed_model = DLRM(cfg, device=dev, seed=seed, tables=False)
                moved = max(float((a - b).abs().max()) for a, b in zip(
                    model.state_dict().values(),
                    seed_model.state_dict().values()))
                if step != n_steps or moved == 0.0:
                    raise AssertionError(f"3l(a): best.json's step {step}, "
                                         f"the MLPs moved {moved}")
                del seed_model
                print(f"3l(a) dense_params.npz: step {step}; its MLPs differ "
                      f"from the seed's by max|d| {moved:.4e}", flush=True)

                def file_rows(idx):
                    return np.stack([maps[t][idx[:, t]] for t in range(T)],
                                    axis=1)

                def open_cache(ccfg_, alts=None):
                    c = dc_mod.NativeDeviceC1Cache(ccfg_, T, D, device=dev)
                    live.append(c)
                    c.open_table_files(mf.dir, sizes, 32)
                    if alts is not None:
                        c.load_altkeys(alts)
                    return c

                def release(c):
                    c.close()
                    live.remove(c)

                def warm(cache, batches):
                    """The CLI's warm-up pass: lookups without scoring."""
                    with torch.inference_mode():
                        for b in batches:
                            cache.lookup_batch(b[1])
                    torch.cuda.synchronize()
                    cache.host_s = dict.fromkeys(cache.host_s, 0.0)

                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                runs = {}
                for depth in (0, 2):
                    cache = open_cache(ccfg1)
                    warm(cache, test_b)
                    s0 = cache.stats()
                    res = counted(lambda: run_inference(
                        model, cfg, ccfg1, test_b, None,
                        use_device_cache=True, pipeline_depth=depth,
                        cache=cache, device=dev), f"(b) depth {depth}",
                        ("interaction_fwd", "gather_rows"))
                    runs[depth] = (res, dict(cache.host_s), s0)
                    if depth == 0:
                        n_held, n_size, n_nonzero = c1_held_to_files(
                            cache, maps, "3l(b)")
                    release(cache)
                    del cache
                (res0, split0, s00), (res2, split2, _) = runs[0], runs[2]
                if not np.array_equal(res2.scores, res0.scores) or \
                        res2.cache_stats != res0.cache_stats:
                    raise AssertionError("3l(b): pipeline_depth 2 changed "
                                         "the scores or the stats")
                if res0.scores is None or res0.scores.shape != (
                        n_test * 2048,) or not np.isfinite(res0.scores).all():
                    raise AssertionError("3l(b): scores missing, misshapen "
                                         "or not finite")
                # the plain version with the loaded MLPs, and the witness
                # with the seed's, on the files' rows through np.memmap
                off = dataclasses.replace(cfg, use_interaction_kernel=False,
                                          use_gather_kernel=False)
                plain = DLRM(off, device=dev, tables=False)
                plain.load_state_dict(model.state_dict())
                witness = DLRM(off, device=dev, seed=seed, tables=False)
                t0 = time.perf_counter()
                ref, wit, labels = [], [], []
                n_trained = n_hit = 0
                with torch.inference_mode():
                    for dense, idx, y in test_b:
                        rows_np = file_rows(idx)
                        n_trained += int((np.abs(rows_np).sum(-1) > 0).sum())
                        n_hit += sum(int(np.isin(idx[:, t], reach[t]).sum())
                                     for t in range(T))
                        rows = torch.from_numpy(rows_np).to(dev)
                        dense_t = torch.from_numpy(dense).to(dev)
                        ref.append(plain.predict(dense_t, emb_rows=rows))
                        wit.append(witness.predict(dense_t, emb_rows=rows))
                        labels.append(y)
                ref = torch.cat(ref).cpu().numpy()
                wit = torch.cat(wit).cpu().numpy()
                labels = np.concatenate(labels)
                t_plain = time.perf_counter() - t0
                n_look = n_test * 2048 * T
                sdiff = float(np.abs(res0.scores - ref).max())
                wdiff = float(np.abs(wit - res0.scores).max())
                if not bool((np.abs(res0.scores - ref)
                             <= 1e-5 * (1 + np.abs(ref))).all()):
                    raise AssertionError(f"3l(b): scores differ from the "
                                         f"plain version's: max|d| {sdiff}")
                if bool((np.abs(wit - res0.scores)
                         <= 1e-5 * (1 + np.abs(res0.scores))).all()):
                    raise AssertionError(f"3l(b): the seed's MLPs score "
                                         f"within the bound (max|d| "
                                         f"{wdiff}): the check cannot tell "
                                         f"them from the trained ones")
                if n_trained < 0.5 * n_look:
                    raise AssertionError(f"3l(b): {n_trained} of {n_look} "
                                         f"lookups read a trained row")
                plain_m = binary_metrics(ref, labels)
                del plain, witness, wit
                serve_line("3l(b) MLPerf shape trained by (a), "
                           "NativeDeviceC1Cache fp32 over its files, "
                           "pipeline_depth 0", res0, split0)
                serve_line("3l(b) MLPerf shape trained by (a), "
                           "NativeDeviceC1Cache fp32 over its files, "
                           "pipeline_depth 2", res2, split2)
                n_req, hr, _ = window_rates(s00, res0.cache_stats)
                print(f"3l(b) cache [{card}]: a warm-up pass over the "
                      f"{n_test} test batches, then over the {n_req} scored "
                      f"requests C1 hit_rate {hr:.6f}; at the end "
                      f"{json.dumps(res0.cache_stats)}; depth 2's scores and "
                      f"stats equal depth 0's", flush=True)
                print(f"3l(b) check: the {n_held} rows in C1's slots "
                      f"({n_size} entries, {n_nonzero} nonzero) bit for bit "
                      f"the trained files'; scores against DLRM.predict "
                      f"with every kernel off on the files' rows max|d| "
                      f"{sdiff:.3e} (plain pass {t_plain:.2f} s); "
                      f"{n_trained} of {n_look} lookups "
                      f"({n_trained / n_look:.4f}) read a row training "
                      f"wrote ({n_hit / n_look:.4f} an id its stream "
                      f"reached); the seed's MLPs on the same rows max|d| "
                      f"{wdiff:.4e} from the served scores; auc "
                      f"{res0.metrics['auc']:.4f} (random labels)",
                      flush=True)
                peak("(b)")
                del res2

                # (c) the published three tiers over the trained files
                t0 = time.perf_counter()
                arng = np.random.default_rng(seed + 3)
                alts = [altkey_encode(t, w[arng.integers(0, len(w), n)]
                                      ).astype(np.uint32)
                        for t, (w, n) in enumerate(zip(wrote, sizes))]
                t_alts = time.perf_counter() - t0
                caps = ccfg3.tier_capacities()
                cache = open_cache(ccfg3, alts)
                del alts
                # the CLI's stream run on: its first batches are (a)'s
                more = train_argv[:]
                more[more.index("--num-batches") + 1] = str(HANDOFF_W + 1)
                stream = cli._make_data(parse(more), rcfg)[0]()
                n_warm = 0
                with torch.inference_mode():
                    for b in stream:
                        s = cache.stats()
                        if s["size"] >= caps[0] and \
                                s["c2"]["size"] >= caps[1] and \
                                s["c3"]["size"] >= caps[2]:
                            break
                        if n_warm < len(train_b) and not np.array_equal(
                                b[1], train_b[n_warm][1]):
                            raise AssertionError("3l(c): the stream does "
                                                 "not begin with (a)'s")
                        cache.lookup_batch(b[1])
                        n_warm += 1
                    else:
                        raise AssertionError(
                            f"3l(c): the tiers were not full after "
                            f"{n_warm} warm-up batches: {s}")
                torch.cuda.synchronize()
                cache.host_s = dict.fromkeys(cache.host_s, 0.0)
                s_start = cache.stats()
                res3 = counted(lambda: run_inference(
                    model, cfg, ccfg3, test_b, None, use_device_cache=True,
                    pipeline_depth=2, cache=cache, device=dev),
                    "(c) three tiers",
                    ("interaction_fwd", "gather_rows_dequant_int8"))
                split3 = dict(cache.host_s)
                s3 = res3.cache_stats
                if not (s3["c2"]["hit_rate"] > 0 and s3["c3"]["size"] > 0):
                    raise AssertionError(f"3l(c): C2 or C3 is not live: "
                                         f"{s3}")
                if res3.scores is None or res3.scores.shape != (
                        n_test * 2048,) or \
                        not np.isfinite(res3.scores).all():
                    raise AssertionError("3l(c): scores missing, misshapen "
                                         "or not finite")
                int8_apply_held(cache, b[1], "3l(c)")
                release(cache)
                del cache
                serve_line("3l(c) MLPerf shape trained by (a), three tiers, "
                           "NativeDeviceC1Cache int8, pipeline_depth 2",
                           res3, split3)
                n_req, hr, c3_hits = window_rates(s_start, s3)
                print(f"3l(c) cache [{card}]: tiers {caps}; alt keys among "
                      f"the {n_wrote} trained rows drawn in {t_alts:.2f} s; "
                      f"{n_warm} warm-up batches of the CLI's stream "
                      f"until C1, C2 and C3 were full; over the {n_req} "
                      f"scored requests C1 hit_rate {hr:.6f}, C3 hits "
                      f"{c3_hits}; at the end C2 {s3['c2']}, C3 {s3['c3']}; "
                      f"one more batch's int8 rows bit for bit the plain "
                      f"version's on the same state and buffer, on the "
                      f"grid", flush=True)
                peak("(c)")
                del res3, model
                torch.cuda.empty_cache()

                # (d) the CLI serves what (a) saved
                built, served = [], []
                real_dlrm, real_ri = dlrm_mod.DLRM, infer_mod.run_inference

                def spy_dlrm(*a, **kw):
                    built.append(real_dlrm(*a, **kw))
                    return built[-1]

                def spy_ri(*a, **kw):
                    res_ = real_ri(*a, **kw)
                    served.append((res_, dict(kw["cache"].host_s)
                                   if isinstance(kw.get("cache"),
                                                 dc_mod.NativeDeviceC1Cache)
                                   else None))
                    return res_

                tee = Tee(sys.stdout)
                dlrm_mod.DLRM, infer_mod.run_inference = spy_dlrm, spy_ri
                t0 = time.perf_counter()
                try:
                    with contextlib.redirect_stdout(tee):
                        rc = counted(lambda: cli.main(serve_argv + [
                            "--ev-table-path", mf.dir]), "(d) the CLI",
                            ("interaction_fwd", "gather_rows"))
                finally:
                    dlrm_mod.DLRM, infer_mod.run_inference = real_dlrm, \
                        real_ri
                secs = time.perf_counter() - t0
                out = "\n".join(tee.text)
                done = re.search(r"inference done: metrics=(\{.*?\}) "
                                 r"perfect_hits=(\S+)", out)
                if rc != 0 or done is None or len(served) != 1 or \
                        served[0][1] is None or \
                        f"cached training's step {n_steps} " not in out:
                    raise AssertionError(f"3l(d) the CLI: rc {rc}")
                if len(built) != 1 or built[0].has_sparse():
                    raise AssertionError(f"3l(d): the CLI's model holds "
                                         f"tables ({len(built)} built)")
                del built
                m = metrics_of(done.group(1))
                n_pos = int(labels.sum())
                tie = 1.0 / max(n_pos * (len(labels) - n_pos), 1)
                if m.keys() != plain_m.keys() or any(
                        abs(m[k] - v) > (tie + 1e-12 if k == "auc"
                                         else 1e-6)
                        for k, v in plain_m.items()):
                    raise AssertionError(f"3l(d): the CLI's metrics {m} "
                                         f"against the plain eval's "
                                         f"{plain_m}")
                res_d, split_d = served[0]
                n_b = 2 * n_test       # the warm-up pass and the scored
                lat = res_d.latency
                print(f"3l(d) cli [{card}]: run_and_time.sh's model flags + "
                      f"{SERVE_C1}'s serving flags + --use-device-cache "
                      f"True --ev-table-path <trained files> --load-model "
                      f"<ck> --data-generation synthetic --compute-dtype "
                      f"float32: {res_d.requests} requests of {n_test} "
                      f"batches scored after the warm-up pass, "
                      f"{res_d.requests / res_d.elapsed_s:.1f} requests/s; "
                      f"p50 {lat['p50_s'] * 1e6:.2f} us, p99 "
                      f"{lat['p99_s'] * 1e6:.2f} us per request; host ms a "
                      f"batch over both passes: " + ", ".join(
                          f"{k} {v / n_b * 1e3:.3f}"
                          for k, v in split_d.items())
                      + f"; C1 hit_rate {res_d.cache_stats['hit_rate']:.6f} "
                      f"(cumulative); the run took {secs:.2f} s; the model "
                      f"holds no table; metrics equal the plain eval of (b)'s"
                      f" batches (atol 1e-6, auc within one tied pair): auc "
                      f"{m['auc']:.6f}, accuracy {m['accuracy']:.6f}; the "
                      f"files took {mf.touched_mb():.1f} MB", flush=True)
                peak("(d)")
                del maps, res_d, served
            finally:
                # the engines first, then the memory files
                for c in reversed(live):
                    c.close()
                shutil.rmtree(d, ignore_errors=True)
            if os.path.exists(d):
                raise AssertionError(f"3l: {d} is still there")
            path = {k: launches[k] for k in (
                "interaction_fwd", "interaction_bwd", "gather_rows",
                "gather_rows_dequant_int8", "scatter_sub_sorted",
                "rwsadagrad_sorted")}
            print(f"handoff_mlperf path launches: {json.dumps(path)}",
                  flush=True)
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
            want = {"gather_rows_grouped": 0, "scatter_sub_sorted": 0,
                    "rwsadagrad_sorted": 0}
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
                    # K5 per update group: sgd one subtract launch;
                    # adagrad (the factorised tables' rule under
                    # rwsadagrad too) two, the run sums and the update;
                    # rwsadagrad's row-wise rule one fused call
                    for u in updates:
                        want["scatter_sub_sorted"] += steps * {
                            "sgd": 1, "adagrad": 2}.get(u.rule, 0)
                        want["rwsadagrad_sorted"] += \
                            steps * (u.rule == "rwsadagrad")
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
                                 "scatter_sub_sorted", "rwsadagrad_sorted")}
            got = {k: launches[k] for k in want}
            if min(launches.values()) < 1 or got != want or \
                    read_counts()["gather_rows"] != 0:
                raise AssertionError(f"train_factored launches "
                                     f"{read_counts()}, expected {want} "
                                     f"(one grouped gather per width group"
                                     f" and one grouped row update per "
                                     f"update group a step: one K5 launch "
                                     f"under sgd, two under adagrad, one "
                                     f"fused call under rwsadagrad's "
                                     f"row-wise rule), K1 and K4 at least "
                                     f"once and no flat gather")
            print(f"train_factored launches: {json.dumps(launches)} (one "
                  f"grouped gather per width group and one grouped row "
                  f"update per update group a step, one K5 launch under "
                  f"sgd, two under adagrad and one fused call under "
                  f"rwsadagrad's row-wise rule, as expected)")
            return launches

    def phase_altkeys():
        """The C3 tier's offline kNN at its real size: query rows A:B (all by
        default) of the seeded Kaggle tables (33,762,577 rows, dim 36)
        against all their rows, k = 10, through `gen_altkeys` and K7 on the
        card: the whole range through `generate_altkeys`, a part through
        `knn_neighbours`.  Prints the seconds, rows/s, effective TFLOP/s,
        peak device memory and the share of rows certified (not swept);
        checks that every alt key names a row and holds 2,048 sampled rows
        to the plain version over all rows by the rule."""
        kcfg = kaggle_dlrm_config()
        n_all = sum(kcfg.table_sizes)
        a, b = ((0, n_all) if args.query_rows is None else
                tuple(int(v) for v in args.query_rows.split(":")))
        if not 0 <= a < b <= n_all:
            raise ValueError(f"--query-rows {args.query_rows}: not within "
                             f"0:{n_all}")
        with Phase("altkeys full kNN"):
            t0 = time.perf_counter()
            tabs = init_embedding_tables(kcfg.table_sizes,
                                         kcfg.embedding_dim,
                                         np.random.default_rng(args.seed))
            gb = n_all * kcfg.embedding_dim * 4 / 1e9
            print(f"set-up: {len(tabs)} tables, {n_all} rows x "
                  f"{kcfg.embedding_dim}, {gb:.2f} GB, in "
                  f"{time.perf_counter() - t0:.2f} s; query rows {a}:{b}",
                  flush=True)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            mem0 = torch.cuda.memory_allocated()
            knn_topk.launches = knn_topk.rows = knn_topk.swept = 0
            t0 = time.perf_counter()
            if (a, b) == (0, n_all):
                alts = gen_altkeys.generate_altkeys(tabs, n_neighbors=10,
                                                    device=dev)
                secs = time.perf_counter() - t0
                if [len(a_) for a_ in alts] != list(kcfg.table_sizes):
                    raise AssertionError("alt keys: a table's count differs")
                nearest = gen_altkeys.altkey_rows(np.concatenate(alts),
                                                  kcfg.table_sizes)
                if (nearest < 0).any():
                    raise AssertionError("an alt key names no row")
            else:
                x = torch.from_numpy(np.concatenate(tabs)).to(dev)
                nearest = gen_altkeys.knn_neighbours(
                    x, torch.arange(a, b, device=dev), 10)[:, 0]
                secs = time.perf_counter() - t0
                del x
                if nearest.min() < 0 or nearest.max() >= n_all:
                    raise AssertionError("a neighbour names no row")
                nearest = np.concatenate([np.zeros(a, np.int64), nearest])
            peak = torch.cuda.max_memory_allocated() - mem0
            n_q, swept = knn_topk.rows, knn_topk.swept
            if knn_topk.launches < 1 or n_q != b - a:
                raise AssertionError(f"K7 ran {knn_topk.launches} times over "
                                     f"{n_q} of {b - a} rows")
            flop = 2.0 * (b - a) * n_all * kcfg.embedding_dim
            print(f"altkeys [{card}]: the kNN (k=10) of rows {a}:{b} over all "
                  f"{n_all} rows in {secs:.2f} s ({secs / 60:.2f} min; "
                  f"{(b - a) / secs:.0f} rows/s; {flop / secs / 1e12:.1f} "
                  f"TFLOP/s at 2 x 36 flop a pair); peak device memory "
                  f"{peak / 2**30:.3f} GiB; {n_q - swept} of {n_q} rows "
                  f"certified ({100.0 * (n_q - swept) / n_q:.4f}%), {swept} "
                  f"swept exactly", flush=True)
            # 2,048 sampled rows: K7's neighbours against the plain version
            # over all rows (the nearest is the alt key)
            x = torch.from_numpy(np.concatenate(tabs)).to(dev)
            del tabs
            srng = np.random.default_rng(args.seed + 8)
            ids = torch.from_numpy(np.sort(srng.choice(
                np.arange(a, b), min(2048, b - a), replace=False))).to(dev)
            got = torch.from_numpy(gen_altkeys.knn_neighbours(x, ids, 10)
                                   ).to(dev)
            if not torch.equal(got[:, 0].cpu(), torch.from_numpy(
                    nearest[ids.cpu().numpy()])):
                raise AssertionError("the sampled rows' nearest differ from "
                                     "the run's alt keys")
            ref = knn_plain(torch, knn_topk_ref, x, ids, 11, 64)
            n_sep, n_sep1 = knn_rule(torch, x, ids, got, ref, 10, "altkeys")
            print(f"altkeys check: every alt key names a row; {len(ids)} "
                  f"sampled rows against the plain version over all rows: "
                  f"neighbour sets equal on all {n_sep} separated rows, the "
                  f"nearest (the alt key) on all {n_sep1}", flush=True)
            del got, ref
            # where a block of the run's time goes: one K7 call over
            # gen_altkeys' block of query rows, by kernel (profiler)
            nq = min(gen_altkeys.CARD_BLOCK, b - a)
            qi = torch.arange(a, a + nq, device=dev)
            qx = x[a:a + nq].contiguous()
            knn_topk(qx, qi, x, 10)
            torch.cuda.synchronize()
            cuda = torch.autograd.DeviceType.CUDA
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                knn_topk(qx, qi, x, 10)
                torch.cuda.synchronize()
            parts = {}
            for e in prof.key_averages():
                if e.device_type == cuda and e.device_time_total > 0:
                    m_ = re.search(r"knn_\w+", e.key)
                    name = m_.group(0) if m_ else "the wrapper's other ops"
                    parts[name] = parts.get(name, 0.0) + \
                        e.device_time_total / 1e3
            total = sum(parts.values())
            print(f"altkeys: one K7 call of {nq} query rows over all {n_all} "
                  f"rows [{card}]: {total:.2f} device ms, " + ", ".join(
                      f"{k_} {v:.3f} ms" for k_, v in sorted(
                          parts.items(), key=lambda kv: -kv[1])[:4]),
                  flush=True)
            del x, qx, qi
            torch.cuda.empty_cache()

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
                                      (2048, 26, 64), (2048, 26, 128),
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
            sets = [(x, ly)]
            if B == 2048 and D in (64, 128):
                # phase 3j's widths, timed over copies that pass L2 4x
                sets += [(x.clone(), ly.clone()) for _ in range(
                    n_sets(B * (T + 1) * D * es) - 1)]
            call = rotating([lambda a=a, b=b: dot_interaction_kernel(
                a, b, si) for a, b in sets])
            k_ms = time_ms(torch, call)
            p_ms = time_ms(torch, rotating([
                lambda a=a, b=b: dot_interaction_ref(a, b, si)
                for a, b in sets]))
            split, dev_ms = "", None
            if dt == "float32" and not si and not off and T == 26 and (
                    D == 36 and B in (128, 2048, 65536)
                    or B == 2048 and D in (64, 128)):
                split, dev_ms = on_device(*device_host_us(torch, call), bms)
            if len(sets) > 1:
                split += f" (over {len(sets)} input sets)"
            del sets
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
                    max_abs_err=err, ms=k_ms, device_ms=dev_ms,
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
                     (2048, 26, 64, "float32", False, False),
                     (2048, 26, 64, "bfloat16", False, False),
                     (2048, 26, 128, "float32", False, False),
                     (2048, 26, 128, "bfloat16", False, False),
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
            sets = [(x, ly, g)]
            if B == 2048 and D in (64, 128):
                # phase 3j's widths, timed over copies that pass L2 4x
                sets += [(x.clone(), ly.clone(), g.clone()) for _ in range(
                    n_sets((B * F * D + B * (D + P)) * es) - 1)]
            call = rotating([lambda a=a, b=b, c=c: dot_interaction_bwd_kernel(
                a, b, c, si) for a, b, c in sets])
            k_ms = time_ms(torch, call)
            p_ms = time_ms(torch, rotating([
                lambda a=a, b=b, c=c: dot_interaction_bwd_ref(a, b, c, si)
                for a, b, c in sets]))
            split, dev_ms = "", None
            if dt == "float32" and not si and not off and T == 26 and (
                    D == 36 and B in (128, 2048, 65536)
                    or B == 2048 and D in (64, 128)):
                split, dev_ms = on_device(*device_host_us(torch, call), bms)
            if len(sets) > 1:
                split += f" (over {len(sets)} input sets)"
            del sets
            print(f"interaction_bwd {label}: max|d| {err:.3e}, two launches "
                  f"bitwise equal; kernel_ms {k_ms:.4f}{split} plain_ms "
                  f"{p_ms:.4f} bound_us {bms * 1e3:.2f} ({by}) library_ms "
                  f"none (no single PyTorch call computes it) [{card}]",
                  flush=True)
            if (B, T, D, dt, si, off) == (128, 26, 36, "float32", False,
                                          False):
                report["interaction_bwd"] = dict(
                    max_abs_err=err, ms=k_ms, device_ms=dev_ms,
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
            split, dev_ms = "", None
            if not si:
                split, dev_ms = on_device(*device_host_us(torch, call), bms)
            print(f"interaction_gram B={B} T={T} D={D} {dt} self={si}: "
                  f"max|d| {err:.3e} vs plain, bit for bit equal to K1; "
                  f"kernel_ms {k_ms:.4f}{split} K1_ms {k1_ms:.4f} plain_ms "
                  f"{p_ms:.4f} "
                  f"bound_us {bms * 1e3:.2f} ({by}) library_ms none (no "
                  f"single PyTorch call computes it) [{card}]", flush=True)
            if (B, dt, si) == (2048, "float32", False):
                report["interaction_gram"] = dict(
                    max_abs_err=err, ms=k_ms, device_ms=dev_ms,
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
        def k2_case(C, M, R, D, dt, label, cold=False):
            """cold: timed over idx draws whose rows pass L2 4x together
            (each checked too), so that no call reads rows the call
            before left in L2."""
            tdt = getattr(torch, dt)
            primary = torch.randn(C, D, generator=gen, device=dev).to(tdt)
            secondary = (torch.randn(M, D, generator=gen, device=dev).to(tdt)
                         if M else None)
            rb = D * primary.element_size()

            def draw():
                idx = torch.randint(0, C + M, (R,), generator=gen,
                                    device=dev, dtype=torch.int32)
                if M:   # cache slots, buffer rows and repeats, all mixed
                    q = R // 4
                    idx[:q] = idx[q:2 * q]
                    idx[R // 2: R // 2 + M] = torch.arange(
                        C, C + M, device=dev, dtype=torch.int32)
                return idx

            idxs = [draw()]
            if cold:
                idxs += [draw() for _ in range(n_sets(
                    int(torch.unique(idxs[0]).numel()) * rb) - 1)]
            iv = torch.int16 if primary.element_size() == 2 else torch.int32
            err = 0.0
            for idx in idxs:
                got = gather_rows(primary, idx, secondary)
                ref = gather_rows_ref(primary, idx, secondary)
                torch.cuda.synchronize()
                if not torch.equal(got.view(iv), ref.view(iv)):
                    raise AssertionError(f"gather_rows differs at {label}")
                err = max(err, float((got.float() - ref.float()).abs().max()))
            del got, ref
            uniq = float(np.mean([torch.unique(i).numel() for i in idxs]))
            bms, by = bound_ms(uniq * rb + R * 4 + R * rb, 0.0, dt)
            combined = (primary if secondary is None
                        else torch.cat([primary, secondary]))
            call = rotating([lambda i=i: gather_rows(primary, i, secondary)
                             for i in idxs])
            k_ms = time_ms(torch, call)
            split, dev_ms = on_device(*device_host_us(torch, call), bms)
            p_ms = time_ms(torch, rotating([
                lambda i=i: gather_rows_ref(primary, i, secondary)
                for i in idxs]))
            lib = rotating([lambda i=i: torch.index_select(combined, 0, i)
                            for i in idxs])
            l_ms = time_ms(torch, lib)
            l_dev, l_host = device_host_us(torch, lib)
            over = f", over {len(idxs)} idx draws" if cold else ""
            print(f"gather_rows {label}: bit-exact{over}, kernel_ms "
                  f"{k_ms:.4f}{split} plain_ms {p_ms:.4f} bound_us "
                  f"{bms * 1e3:.2f} ({by}) library_ms {l_ms:.4f} device_us "
                  f"{l_dev:.2f} host_us {l_host:.2f} (index_select on one "
                  f"table) [{card}]", flush=True)
            return dict(max_abs_err=err, ms=k_ms, device_ms=dev_ms,
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
        # the MLPerf shape's cached step: 4,000,000 cells of 128 and a miss
        # buffer, the batch's 2048 x 26 positions
        for dt in ("float32", "bfloat16"):
            k2_case(MLPERF_C1, MLPERF_M, 2048 * 26, 128, dt,
                    f"cache {MLPERF_C1}x128 + buffer {MLPERF_M}, "
                    f"R=2048*26 {dt} (the MLPerf shape's cached step)",
                    cold=True)
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
        split, dev_ms = on_device(*device_host_us(torch, call), bms)
        p_ms = time_ms(torch, lambda: gather_rows_grouped_ref(ktabs, kidx_d))
        print(f"gather_rows_grouped 26 Kaggle tables (33,762,577 x 36 f32), "
              f"idx [128, 26] (one training step): bit-exact, kernel_ms "
              f"{k_ms:.4f}{split} "
              f"plain_ms {p_ms:.4f} bound_us {bms * 1e3:.2f} ({by}) "
              f"library_ms none (no single PyTorch call gathers 26 tables) "
              f"[{card}]", flush=True)
        report["gather_rows_grouped"] = dict(
            max_abs_err=0.0, ms=k_ms, device_ms=dev_ms, plain_ms=p_ms,
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

        def k3_case(C, M, R, D, label, cold=False):
            """cold: timed over idx draws whose rows pass L2 4x together,
            each checked as the first."""
            cache = torch.randint(0, 256, (C, D), generator=gen, device=dev,
                                  dtype=torch.uint8)
            buf = torch.randint(0, 256, (M, D), generator=gen, device=dev,
                                dtype=torch.uint8)

            def draw():
                idx = torch.randint(0, C + M, (R,), generator=gen,
                                    device=dev, dtype=torch.int32)
                q = R // 4
                idx[:q] = idx[q:2 * q]
                idx[R // 2: R // 2 + M] = torch.arange(
                    C, C + M, device=dev, dtype=torch.int32)
                return idx

            idxs = [draw()]
            if cold:
                idxs += [draw() for _ in range(n_sets(
                    int(torch.unique(idxs[0]).numel()) * D) - 1)]
            for idx in idxs:
                k3_check(cache, idx, buf, label)
            uniq = float(np.mean([torch.unique(i).numel() for i in idxs]))
            bms, by = bound_ms(uniq * D + R * 4 + R * D * 4, 3.0 * R * D,
                               "float32")
            call = rotating([lambda i=i: gather_rows_dequant_int8(
                cache, i, buf) for i in idxs])
            k_ms = time_ms(torch, call)
            split, dev_ms = on_device(*device_host_us(torch, call), bms)
            p_ms = time_ms(torch, rotating([
                lambda i=i: gather_rows_dequant_int8_ref(cache, i, buf)
                for i in idxs]))
            over = f", over {len(idxs)} idx draws" if cold else ""
            print(f"gather_rows_dequant_int8 {label}: bit-exact, two launches "
                  f"bitwise equal{over}; kernel_ms {k_ms:.4f}{split} "
                  f"plain_ms {p_ms:.4f} bound_us {bms * 1e3:.2f} ({by}) "
                  f"library_ms none (no single PyTorch call computes it) "
                  f"[{card}]", flush=True)
            return dict(max_abs_err=0.0, ms=k_ms, device_ms=dev_ms,
                        plain_ms=p_ms, bound_ms=bms, bound_by=by,
                        library_ms=None)

        report["gather_rows_dequant_int8"] = k3_case(
            36204, 4096, 2048 * 26, 36,
            "cache 36204x36 u8 + buffer 4096, R=2048*26")
        k3_case(36204, 4096, 65536 * 26, 36,
                "cache 36204x36 u8 + buffer 4096, R=65536*26")
        k3_case(36204, 4096, 2048 * 26, 7,
                "cache 36204x7 u8 + buffer 4096, R=2048*26 (byte path)")
        k3_case(MLPERF_C1, MLPERF_M, 2048 * 26, 128,
                f"cache {MLPERF_C1}x128 u8 + buffer {MLPERF_M}, R=2048*26 "
                f"(the MLPerf shape's int8 cells)", cold=True)

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
            split, dev_ms = on_device(*device_host_us(torch, call), bms)
            p_ms = time_ms(torch,
                           lambda: scatter_sub_sorted_ref(tab_ref, rows, vals))
            lib = lambda: tab_ref.index_add_(0, lib_rows,  # noqa: E731
                                             lib_vals)
            l_ms = time_ms(torch, lib)
            l_dev, l_host = device_host_us(torch, lib)
            print(f"scatter_sub_sorted {label}: {uniq.numel()} rows, longest "
                  f"run {int(counts.max())}, max|d| {err:.3e}, two launches "
                  f"bitwise equal; kernel_ms {k_ms:.4f}{split} plain_ms "
                  f"{p_ms:.4f} bound_us {bms * 1e3:.2f} ({by}) library_ms "
                  f"{l_ms:.4f} device_us {l_dev:.2f} host_us {l_host:.2f} "
                  f"(index_add_ of the valid entries"
                  f"{', values in bf16' if dt == 'bfloat16' else ''})"
                  f" [{card}]", flush=True)
            return dict(max_abs_err=err, ms=k_ms, device_ms=dev_ms,
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
        split, dev_ms = on_device(*device_host_us(torch, call), bms)
        ref_tabs = [t.clone() for t in ktabs]
        p_ms = time_ms(torch, lambda: scatter_sub_sorted_grouped_ref(
            ref_tabs, grows, gvals))
        print(f"scatter_sub_sorted grouped, 26 Kaggle tables (33,762,577 x 36"
              f" f32), K=3328 (one training step): {uniq} rows, max|d| "
              f"{err:.3e}, two launches bitwise equal; kernel_ms {k_ms:.4f}"
              f"{split} plain_ms {p_ms:.4f} bound_us {bms * 1e3:.2f} ({by}) "
              f"library_ms none (no single PyTorch call updates 26 tables) "
              f"[{card}]",
              flush=True)
        report["scatter_sub_sorted"] = dict(
            max_abs_err=err, ms=k_ms, device_ms=dev_ms, plain_ms=p_ms,
            bound_ms=bms, bound_by=by, library_ms=None)
        del ktabs, ref_tabs
        torch.cuda.empty_cache()

        def grouped_k5_case(tabs, id_sets, label):
            """The grouped K5 over `tabs` on the sorted global ids
            id_sets[0], on two copies (bitwise equal) against the plain
            version (within 1e-6 (1 + |ref|)), timed beside it and its
            bound rotating over id_sets, whose rows pass L2 4x together."""
            D_ = tabs[0].shape[1]
            sets = [(torch.from_numpy(i.astype(np.int32)).to(dev),
                     torch.randn(len(i), D_, generator=gen, device=dev)
                     * 1e-3) for i in id_sets]
            rows, vals = sets[0]
            K_ = rows.numel()
            ref_t = [t.clone() for t in tabs]
            twice_t = [t.clone() for t in tabs]
            scatter_sub_sorted(tabs, rows, vals)
            scatter_sub_sorted(twice_t, rows, vals)
            scatter_sub_sorted_grouped_ref(ref_t, rows, vals)
            torch.cuda.synchronize()
            err_ = 0.0
            for t, (a_, b_, c_) in enumerate(zip(tabs, ref_t, twice_t)):
                ok, e_ = within(a_, b_, 1e-6)
                err_ = max(err_, e_)
                if not ok or not torch.equal(a_, c_):
                    raise AssertionError(f"grouped scatter_sub_sorted "
                                         f"differs or is not deterministic "
                                         f"at {label}, table {t}: max|d| "
                                         f"{e_}")
            del twice_t
            uniq_ = float(np.mean([len(np.unique(i)) for i in id_sets]))
            bms_, by_ = bound_ms(K_ * 4 + K_ * D_ * 4 + 2 * uniq_ * D_ * 4,
                                 float(K_ * D_ + uniq_ * D_), "float32")
            call_ = rotating([lambda r=r, v=v: scatter_sub_sorted(
                tabs, r, v) for r, v in sets])
            k_ms_ = time_ms(torch, call_)
            split_, _ = on_device(*device_host_us(torch, call_), bms_)
            p_ms_ = time_ms(torch, rotating([
                lambda r=r, v=v: scatter_sub_sorted_grouped_ref(ref_t, r, v)
                for r, v in sets]))
            print(f"scatter_sub_sorted grouped, {label}: {uniq_:.0f} rows, "
                  f"max|d| {err_:.3e}, two launches bitwise equal, over "
                  f"{len(sets)} id draws; kernel_ms {k_ms_:.4f}{split_} "
                  f"plain_ms {p_ms_:.4f} bound_us "
                  f"{bms_ * 1e3:.2f} ({by_}) library_ms none (no single "
                  f"PyTorch call updates a group of tables) [{card}]",
                  flush=True)
            del ref_t, sets

        def shifted(ids_by_table, sizes_, D_):
            """Draws of the same ids, each table's shifted by a share of
            its size (mod the size) so that the draws touch other rows,
            as many as pass L2 4x: -> sorted global ids, one per draw."""
            base = np.concatenate([[0], np.cumsum(sizes_)])[:-1]
            K_ = ids_by_table.size
            uniq_ = sum(len(np.unique(ids_by_table[:, t]))
                        for t in range(ids_by_table.shape[1]))
            n = n_sets(2 * uniq_ * D_ * 4 + K_ * D_ * 4)
            sz = np.asarray(sizes_, np.int64)
            return [np.sort(((ids_by_table + s * (sz // n)) % sz
                             + base).reshape(-1)) for s in range(n)]

        # the grouped K5 at the new widths, K = 2048 x 26 Zipf entries: D=64
        # over the 26 Terabyte tables (a grouped_zipf batch of phase 3j(d)'s
        # shape, each table's ids offset by its base); D=128 over the
        # MLPerf cached step's group, 4,000,000 cells and the miss buffer
        # (Zipf ids over the cells and the buffer), which takes K5's
        # column tiles of 40, 40, 40 and 8
        tcfg_tb = terabyte_dlrm_config()
        tb_tabs = [torch.empty(n, 64, device=dev).uniform_(
            -float(np.sqrt(1.0 / n)), float(np.sqrt(1.0 / n)), generator=gen)
            for n in tcfg_tb.table_sizes]
        tb_idx = next(random_batches(RandomDataConfig(
            num_dense=1, table_sizes=tcfg_tb.table_sizes, batch_size=2048,
            num_batches=1, seed=args.seed + 53, distribution="grouped_zipf",
            zipf_alpha=1.05, group_noise=0.1)))[1]
        grouped_k5_case(tb_tabs, shifted(tb_idx, tcfg_tb.table_sizes, 64),
                        f"26 Terabyte tables ({sum(tcfg_tb.table_sizes):,} "
                        f"x 64 f32), K=2048*26 grouped_zipf (one step of "
                        f"phase 3j(d))")
        del tb_tabs
        torch.cuda.empty_cache()
        cells = [torch.empty(n, 128, device=dev).uniform_(-0.05, 0.05,
                                                          generator=gen)
                 for n in (MLPERF_C1, MLPERF_M)]
        c_ids = next(random_batches(RandomDataConfig(
            num_dense=1, table_sizes=(MLPERF_C1 + MLPERF_M,),
            batch_size=2048 * 26, num_batches=1, seed=args.seed + 54,
            distribution="zipf", zipf_alpha=1.05)))[1][:, 0]
        grouped_k5_case(cells, shifted(c_ids[:, None],
                                       (MLPERF_C1 + MLPERF_M,), 128),
                        f"{MLPERF_C1} cells + {MLPERF_M} buffer rows x 128 "
                        f"f32, K=2048*26 zipf(1.05) (the MLPerf shape's "
                        f"cached step)")
        del cells
        torch.cuda.empty_cache()

        # K7, the alt-key kNN: held to its plain version by the
        # correctness rule (knn_rule), every case launched twice, bit for
        # bit.  The timed case is the tool's call on the card: CARD_BLOCK
        # (131,072) queries (every 8th row, with their ids) against the
        # first 1,048,576 rows of the Kaggle tables at their init scales,
        # k = 10; the plain version runs in blocks of 2,048 queries so that
        # its [2048, N] distances fit
        def kaggle_keys(n, dim=36, tables=None):
            """n rows at the Kaggle init's scales, the tables in order
            (or, given `tables`, rows of those tables in turn)."""
            sizes = kcfg.table_sizes
            if tables is None:
                counts, left = [], n
                for sz in sizes:
                    counts.append(min(sz, left))
                    left -= counts[-1]
                scale = torch.cat([torch.full((c,), float(np.sqrt(1.0 / sz)),
                                              device=dev)
                                   for c, sz in zip(counts, sizes) if c])
            else:
                scale = torch.tensor([float(np.sqrt(1.0 / sizes[t]))
                                      for t in tables], device=dev)[
                    torch.arange(n, device=dev) % len(tables)]
            return (torch.rand(n, dim, generator=gen, device=dev) * 2 - 1) \
                * scale[:, None]

        def k7_case(q, qids, keys, k, label, swept_all=False):
            """Two launches bitwise equal, the rule against the plain
            version; -> (rows the rule held, swept rows)."""
            knn_topk.swept = 0
            got = knn_topk(q, qids, keys, k)
            again = knn_topk(q, qids, keys, k)
            torch.cuda.synchronize()
            swept = knn_topk.swept // 2
            if not torch.equal(got, again):
                raise AssertionError(f"knn_topk is not deterministic at "
                                     f"{label}")
            ref = knn_plain(torch, knn_topk_ref, keys, qids, k + 1, 2048,
                            queries=q)
            held = knn_rule(torch, keys, q, got, ref, k, label)
            if swept_all and swept < len(q):
                raise AssertionError(f"knn_topk {label}: {swept} of "
                                     f"{len(q)} near-tie rows failed the "
                                     f"certificate")
            return held, swept

        K7_Q, K7_N, K7_K = gen_altkeys.CARD_BLOCK, 1 << 20, 10
        keys7 = kaggle_keys(K7_N)
        ids7 = torch.arange(0, K7_N, K7_N // K7_Q, device=dev)
        q7 = keys7[ids7].contiguous()
        (n_sep, n_sep1), swept = k7_case(q7, ids7, keys7, K7_K,
                                         f"{K7_Q} x 1M Kaggle rows")
        # each input read once (queries, their ids, keys), the ids written
        # once; the function's two operations a pair and dimension (D =
        # 36), at the TF32 tensor-core peak and at the f32 FMA peak
        nbytes = 4 * (K7_Q + K7_N) * 36 + 8 * K7_Q * (1 + K7_K)
        flop = 2.0 * K7_Q * K7_N * 36
        bms, by = bound_ms(nbytes, flop, "float32")
        bms_tc, by_tc = bound_ms(nbytes, flop, "tfloat32")
        call = lambda: knn_topk(q7, ids7, keys7, K7_K)  # noqa: E731
        k_ms = time_ms(torch, call, reps=10, warmup=2)
        split, dev_ms = on_device(*device_host_us(torch, call, reps=5,
                                                  calls=10), bms_tc)
        # one call: each takes seconds, and k7_case's has warmed it up
        p_ms = time_ms(torch, lambda: knn_plain(
            torch, knn_topk_ref, keys7, ids7, K7_K, 2048), reps=1, warmup=0)
        print(f"knn_topk Q={K7_Q} N={K7_N} D=36 k={K7_K} (the first 1M rows "
              f"of the Kaggle tables at their init scales): neighbour sets "
              f"equal to the plain version's on all {n_sep} separated rows, "
              f"nearest on {n_sep1}; {swept} rows swept exactly; two "
              f"launches bitwise equal; kernel_ms {k_ms:.4f}{split} "
              f"plain_ms {p_ms:.4f} (blocks of 2048) bound_us "
              f"{bms_tc * 1e3:.2f} ({by_tc}, the TF32 peak) and "
              f"{bms * 1e3:.2f} ({by}, the f32 FMA peak); "
              f"{flop / k_ms / 1e9:.1f} TFLOP/s; library_ms none (no single "
              f"PyTorch call computes it) [{card}]", flush=True)
        report["knn_topk"] = dict(max_abs_err=0.0, ms=k_ms, device_ms=dev_ms,
                                  plain_ms=p_ms, bound_ms=bms_tc,
                                  bound_by=by_tc, library_ms=None)
        del keys7, q7, ids7
        torch.cuda.empty_cache()

        # the cases that break K7's design, checked and not timed
        def uniform(n, dim):
            return torch.rand(n, dim, generator=gen, device=dev) * 2 - 1

        def own(keys, n):
            ids = torch.randperm(len(keys), generator=gen, device=dev)[:n]
            return keys[ids].contiguous(), ids

        cases = []
        for N, label in ((1013, "N = 1013, not a multiple of the key tile"),
                         (37, "N = 37 < k + m")):
            keys = uniform(N, 36)
            cases.append((*own(keys, 64), keys, 10, label))
        keys = kaggle_keys(100_000)
        for Q in (1, 3, 2049):
            cases.append((*own(keys, Q), keys, 10, f"Q = {Q}"))
        for D in (7, 36, 64, 128):
            keys = uniform(20_000, D)
            cases.append((*own(keys, 300), keys, 10, f"D = {D}"))
        keys = kaggle_keys(50_000)
        for k in (1, 10, 11, 32):
            cases.append((*own(keys, 300), keys, k, f"k = {k}"))
        keys = uniform(50_000, 36)
        keys[100:110] = keys[7]         # copies of row 7
        keys[200:240] = keys[8]         # more copies than k + m
        keys[300:320] = 0.0             # zero rows
        ids = torch.cat([torch.tensor([7, 8, 100, 200, 239, 300, 319],
                                      device=dev),
                         torch.randperm(50_000, generator=gen,
                                        device=dev)[:250]])
        cases.append((keys[ids].contiguous(), ids, keys, 10,
                       "duplicate and zero rows"))
        keys = uniform(50_000, 36)
        cases.append((uniform(512, 36), torch.full((512,), -1, device=dev),
                      keys, 10, "query ids of -1"))
        keys = kaggle_keys(60_000, tables=[8, 2])   # |x| about 1.0 and 1e-3
        cases.append((*own(keys, 512), keys, 10,
                      "the init's extreme scales side by side (3 and "
                      "10,131,227 rows)"))
        keys = kaggle_keys(60_000, tables=list(range(26)))
        cases.append((*own(keys, 512), keys, 10, "all 26 scales side by side"))
        rows = []
        for label_args in cases:
            (n_sep, n_sep1), swept = k7_case(*label_args)
            rows.append(f"{label_args[4]}: {n_sep} and {n_sep1} rows held, "
                        f"{swept} swept")
        # near-ties: each query's own cluster, k keys at squared distance
        # 1 and 2k + m more at 1 + 2e-5 (each spread 1e-7), inside TF32's
        # band, so every row fails the certificate, while its k-th and
        # k+1-th distances stay separated by 2e-5
        nq, per = 64, 3 * 10 + 32
        qn = torch.randn(nq, 36, generator=gen, device=dev,
                         dtype=torch.float64)
        qn /= qn.norm(dim=1, keepdim=True)
        u = torch.randn(nq, per, 36, generator=gen, device=dev,
                        dtype=torch.float64)
        u /= u.norm(dim=2, keepdim=True)
        r2 = torch.where(torch.arange(per, device=dev) < 10, 1.0, 1.0 + 2e-5) \
            + 1e-7 * torch.rand(nq, per, generator=gen, device=dev,
                                dtype=torch.float64)
        keys = torch.cat([(qn[:, None] + r2.sqrt()[..., None] * u).reshape(
            -1, 36), 3.0 + torch.randn(10_000, 36, generator=gen, device=dev,
                                       dtype=torch.float64)]).float()
        (n_sep, _), swept = k7_case(qn.float(), torch.full(
            (nq,), -1, device=dev), keys, 10, "near-ties", swept_all=True)
        rows.append(f"near-ties: {n_sep} rows held, {swept} of {nq} swept")
        print(f"knn_topk: {len(rows)} edge cases, each launched twice bit "
              f"for bit and held to the plain version by the rule: "
              + "; ".join(rows), flush=True)
        del keys, cases
        torch.cuda.empty_cache()

    if args.only in ("3j", "3k", "3l"):
        {"3j": phase_3j, "3k": phase_3k, "3l": phase_3l}[args.only]()
        print(f"total: {time.perf_counter() - t_all:.2f} s (phases 0-2 "
              f"and {args.only})")
        return 0
    if args.only == "altkeys":
        phase_altkeys()
        print(f"total: {time.perf_counter() - t_all:.2f} s (phases 0-2 "
              f"and the full kNN)")
        return 0
    phase_2b()

    # ------------------------------------------------------- 3 main path
    N_SCORED = 64           # scored batches of 2048 per serving run
    WARM_CAP = 200          # warm-up batches allowed for the tiers to fill

    def serve_stream():
        """The request stream of the serving phases, from --seed."""
        return random_batches(RandomDataConfig(
            num_dense=cfg.num_dense_features, table_sizes=cfg.table_sizes,
            batch_size=2048, num_batches=WARM_CAP + N_SCORED + 1,
            seed=args.seed + 1, distribution="grouped_zipf", zipf_alpha=1.05,
            group_noise=0.1))

    def warm_up(cache, full, n_scored=N_SCORED, cap=WARM_CAP):
        """run_inference's warm-up pass, done here on the stream until
        `full(cache.stats())` holds (within `cap` batches), so that the
        scored batches see the tiers in steady state and the host split
        counts them only.  Returns the warm-up batches, the scored ones and
        one more."""
        it = serve_stream()
        warm = []
        look = getattr(cache, "lookup_batch", None) or cache.request_batch
        with torch.inference_mode():
            for b in it:
                look(b[1])
                warm.append(b)
                if full(cache.stats()):
                    break
                if len(warm) == cap:
                    raise AssertionError(f"the tiers were not full after "
                                         f"{cap} warm-up batches: "
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
        # what phase 3h's sharded cache serves against
        serve3 = {"warm": len(warmup), "scores": res.scores,
                  "depth 2": res2.requests / res2.elapsed_s}

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
    ALT_W = 60              # warm-up cap of 3c and 3d(b) (they fill in ~30)
    ALT_SAMPLE = 2048       # query rows held to the plain version
    with Phase("3c three tiers int8"):
        # bench/dlrm_s_criteo_kaggle_C1_C2_C3.sh: int8 C1, 4-bit C2,
        # alt-key C3, 48-48-4, 75,425 entries.  First the alt keys the
        # reference's offline kNN gives C3 (gen_altkeys: each row's 10
        # nearest rows over all 26 tables, the most accessed of them by the
        # workload's counts), for every row the serving stream reaches in
        # its first ALT_W + N_SCORED + 1 batches, which hold every key C3
        # is asked about; the other rows keep one uniform row of their
        # table, from --seed.  The configuration is served with the
        # uniform keys first (as before the kNN existed), then with the
        # kNN's.
        ccfg3 = CacheConfig(policy="evlfu", n_caching_layers=3,
                            total_size=75425, main_precision=8,
                            secondary_precision=4, size_proportion=(48, 48, 4))
        caps = ccfg3.tier_capacities()
        int8_launches = dict.fromkeys(("interaction_fwd",
                                       "gather_rows_dequant_int8"), 0)
        c3_side = {}

        def serve_3c(keys_label, alts3):
            """The published configuration with these alt keys, warmed up
            until every tier is full and scored: its checks, its lines, and
            its C3 stats kept for the side-by-side line."""
            t0 = time.perf_counter()
            resolver = AltKeyResolver(alts3)
            cache = build_cache(ccfg3, cfg, storage, resolver,
                                use_device_cache=True, device=dev)
            print(f"set-up ({keys_label} alt keys): tiers {caps}, alt keys "
                  f"and engine in {time.perf_counter() - t0:.2f} s")
            warmup3, scored3, extra3 = warm_up(
                cache, lambda s: (s["size"] >= caps[0]
                                  and s["c2"]["size"] >= caps[1]
                                  and s["c3"]["size"] >= caps[2]),
                cap=ALT_W)
            s_start = cache.stats()
            print(f"warm-up: {len(warmup3)} batches of 2048 until C1, C2 and "
                  f"C3 were full: {s_start}; {N_SCORED} scored batches follow")
            reset_counts()
            res3 = run_inference(model, cfg, ccfg3, scored3, storage,
                                 altkey_resolver=resolver,
                                 use_device_cache=True, pipeline_depth=2,
                                 cache=cache, device=dev)
            run_launches = read_counts()
            split3 = dict(cache.host_s)
            for k_ in int8_launches:
                int8_launches[k_] += run_launches[k_]
            if min(run_launches[k_] for k_ in int8_launches) < 1:
                raise AssertionError(f"a kernel of the path never ran: "
                                     f"{run_launches}")
            s3 = res3.cache_stats
            if not (s3["c2"]["hit_rate"] > 0 and s3["c3"]["size"] > 0):
                raise AssertionError(f"C2 or C3 is not live: {s3}")
            if res3.scores is None or \
                    res3.scores.shape != (N_SCORED * 2048,) or \
                    not np.isfinite(res3.scores).all():
                raise AssertionError("scores missing, misshapen or not "
                                     "finite")

            # one more batch (not counted above)
            int8_apply_held(cache, extra3[1], "3c")
            serve_line(f"three tiers, NativeDeviceC1Cache int8, {keys_label} "
                       f"alt keys, pipeline_depth 2", res3, split3)
            n_req = s3["requests"] - s_start["requests"]
            c1_hr = (s3["hit_rate"] * s3["requests"] - s_start["hit_rate"]
                     * s_start["requests"]) / n_req
            c3_hits = s3["c3"]["hits"] - s_start["c3"]["hits"]
            c3_side[keys_label] = (c1_hr, c3_hits, c3_hits / n_req,
                                   s3["c2"]["hit_rate"], s3["c3"],
                                   res3.requests / res3.elapsed_s)
            print(f"cache [{card}]: over the {n_req} scored requests (every "
                  f"tier full at their start): C1 hit_rate {c1_hr:.6f}, C3 "
                  f"hits {c3_hits}; C2 cumulative hit_rate "
                  f"{s_start['c2']['hit_rate']:.6f} at the start, "
                  f"{s3['c2']['hit_rate']:.6f} at the end; at the end: C1 "
                  f"{s3['size']} of {s3['capacity']}, C2 {s3['c2']}, C3 "
                  f"{s3['c3']}, perfect_hits {s3['perfect_hits']}, "
                  f"bytes_shipped {s3['bytes_shipped']}, requests "
                  f"{s3['requests']} (warm-up included)")
            print(f"check: the extra batch's int8 rows bit-exact vs the "
                  f"plain version on the same state and buffer, all on the "
                  f"int8 grid; auc {res3.metrics['auc']:.4f} (random weights "
                  f"and labels)")
            cache.close()
            del cache, resolver, warmup3, scored3
            torch.cuda.empty_cache()

        serve_3c("uniform", seeded_altkeys())

        # the kNN's alt keys, for the rows the stream reaches
        t0 = time.perf_counter()
        offs = np.concatenate([[0], np.cumsum(cfg.table_sizes)])
        seen = np.concatenate([
            (b[1].astype(np.int64) + offs[:-1]).reshape(-1)
            for _, b in zip(range(ALT_W + N_SCORED + 1), serve_stream())])
        q_ids, counts = np.unique(seen, return_counts=True)
        x = torch.empty(int(offs[-1]), cfg.embedding_dim, device=dev)
        for t, tab in enumerate(tables):
            x[offs[t]:offs[t + 1]] = torch.from_numpy(tab).to(dev)
        torch.cuda.synchronize()
        t_up = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        knn_topk.rows = knn_topk.swept = 0
        t1 = time.perf_counter()
        neigh = gen_altkeys.knn_neighbours(x, torch.from_numpy(q_ids).to(dev),
                                           10)
        t_knn = time.perf_counter() - t1
        altkeys_launches = {"knn_topk": read_counts()["knn_topk"]}
        peak = torch.cuda.max_memory_allocated()
        if altkeys_launches["knn_topk"] < 1:
            raise AssertionError("3c: K7 never ran")
        # the most accessed of the 10 by the stream's counts (ties: the
        # nearer), as generate_altkeys picks with workload frequencies
        freq = np.zeros(int(offs[-1]), np.int64)
        freq[q_ids] = counts
        alt = gen_altkeys.pick_altkeys(neigh, cfg.table_sizes, freq)
        knn_alts = seeded_altkeys()
        q_tbl = np.searchsorted(offs, q_ids, side="right") - 1
        for t in range(cfg.num_tables):
            sel = q_tbl == t
            knn_alts[t][q_ids[sel] - offs[t]] = alt[sel]
        # ALT_SAMPLE query rows against the plain version over all keys
        srng = np.random.default_rng(args.seed + 7)
        pick = np.sort(srng.choice(len(q_ids), ALT_SAMPLE, replace=False))
        ids_s = torch.from_numpy(q_ids[pick]).to(dev)
        t1 = time.perf_counter()
        ref = knn_plain(torch, knn_topk_ref, x, ids_s, 11, 64)
        t_ref = time.perf_counter() - t1
        n_sep, n_sep1 = knn_rule(torch, x, ids_s,
                                 torch.from_numpy(neigh[pick]).to(dev), ref,
                                 10, "3c")
        n_all = int(offs[-1])
        tflop = 2.0 * len(q_ids) * n_all * cfg.embedding_dim / 1e12
        print(f"3c alt keys [{card}]: the kNN (k=10) of the {len(q_ids)} rows "
              f"the stream's first {ALT_W + N_SCORED + 1} batches reach, over "
              f"all {n_all} rows, through K7 in {t_knn:.2f} s "
              f"({tflop / t_knn:.1f} TFLOP/s; {knn_topk.swept} rows swept "
              f"exactly; peak device "
              f"memory {peak / 2**30:.2f} GiB with the keys' "
              f"{x.numel() * 4 / 2**30:.2f}), the keys' upload {t_up:.2f} s; "
              f"{ALT_SAMPLE} sampled rows against the plain version over all "
              f"rows (blocks of 64, {t_ref:.2f} s): neighbour sets equal on "
              f"all {n_sep} separated rows, the nearest on all {n_sep1}; each "
              f"row's alt key the most accessed of its 10; the other "
              f"{n_all - len(q_ids)} rows keep uniform alt keys (no request "
              f"reaches them)", flush=True)
        del x, ref, neigh
        torch.cuda.empty_cache()

        serve_3c("kNN", knn_alts)
        print("3c C3 side by side [" + card + "] (random tables: not a "
              "quality number): " + "; ".join(
                  f"{k_} alt keys: C3 hits {v[1]} ({v[2]:.6f} a scored "
                  f"request), C1 hit_rate {v[0]:.6f}, C2 cumulative hit_rate "
                  f"{v[3]:.6f}, C3 at the end {v[4]}, {v[5]:.1f} requests/s"
                  for k_, v in c3_side.items()), flush=True)

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
        alts = knn_alts         # 3c's: the kNN's keys where a request reaches
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
                            and s["c3"]["size"] >= caps[2]), cap=ALT_W)
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
        del res, res2, model, storage
        torch.cuda.empty_cache()
        B = 128                 # the reference recipe's batch and lr
        tcfg = TrainConfig(learning_rate=0.1, optimizer="rwsadagrad")
        sgd = dataclasses.replace(tcfg, optimizer="sgd")
        off_cfg = dataclasses.replace(cfg, use_interaction_kernel=False,
                                      use_gather_kernel=False)
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

        step_k, st_k = held_on_off(tcfg, model, plain, take)
        del plain
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
                          "K5 row update": ("chunk_sums_kernel",
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
        train_rates = dict(rates)       # beside phase 3h's routes
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
                                   "scatter_sub_sorted", "rwsadagrad_sorted")}
        if min(train_launches.values()) < 1:
            raise AssertionError(f"a kernel of the path never ran: "
                                 f"{train_launches}")
        # one grouped gather per train or eval step; with the kernels on,
        # one fused K5 call per rwsadagrad step (its row-wise rule) and
        # one subtract launch per sgd step: rwsadagrad 5 + 5 checked, 5
        # profiled, 3 + 3 x 20 through train(); sgd 3 + 3 x 20 through
        # train(), 5 profiled; 2 eval
        rws_steps = 5 + 5 + 5 + (3 + 3 * 20)
        sgd_steps = 3 + 3 * 20 + 5
        want = {"gather_rows_grouped": rws_steps + sgd_steps + 2,
                "scatter_sub_sorted": sgd_steps,
                "rwsadagrad_sorted": rws_steps}
        got = {k: train_launches[k] for k in want}
        if got != want or read_counts()["gather_rows"] != 0:
            raise AssertionError(f"train path launches {read_counts()}, "
                                 f"expected {want} and no flat gather")
        print(f"train path launches: {json.dumps(got)} (one grouped gather "
              f"per train or eval step; K5 once per step: the fused "
              f"row-wise rule under rwsadagrad, the subtract rule under "
              f"sgd)")
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"evaluate gave {metrics}")
        print(f"evaluate over 2 batches: auc {metrics['auc']:.4f}, accuracy "
              f"{metrics['accuracy']:.4f} (random weights and labels)")

    del model, st_k, step_k, st_s, step_s
    torch.cuda.empty_cache()
    factored_launches = phase_3e(tables)
    del tables
    work_dir = tempfile.TemporaryDirectory()
    try:
        cli_launches = phase_3f(work_dir.name)
        cached_launches = phase_3g(work_dir.name)
        mesh_launches = phase_3h(serve3)
        mesh_launches.update(phase_3i(work_dir.name))
    finally:
        work_dir.cleanup()
    mlperf_launches = phase_3j()
    serve_mlperf_launches = phase_3k()
    handoff_launches = phase_3l()

    dcnv2_launches, report["rwsadagrad_sorted"] = phase_3m()

    # ---------------------------------------------------- 4 kernels line
    with Phase("4 kernels line"):
        print(f"kernels: serve {json.dumps(serve_launches)}; serve_int8 "
              f"{json.dumps(int8_launches)}; altkeys "
              f"{json.dumps(altkeys_launches)}; serve_host "
              f"{json.dumps(host_launches)}; gram_ab "
              f"{json.dumps(gram_launches)}; train "
              f"{json.dumps(train_launches)}; train_factored "
              f"{json.dumps(factored_launches)}; cli "
              f"{json.dumps(cli_launches)}; train_cached "
              f"{json.dumps(cached_launches)}; " + "; ".join(
                  f"{p} {json.dumps(c)}" for p, c in mesh_launches.items())
              + f"; train_mlperf {json.dumps(mlperf_launches)}; "
              f"serve_mlperf {json.dumps(serve_mlperf_launches)}; "
              f"handoff_mlperf {json.dumps(handoff_launches)}; "
              f"train_dcnv2 {json.dumps(dcnv2_launches)}")
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
            # K5's fused row-wise rule, the rwsadagrad route of the same
            # TPU kernel (rwsadagrad_row_update_pallas)
            "rwsadagrad_sorted": ("evstore_tpu_torch/csrc/row_update.cu",
                                  "evstore_tpu/ops/pallas_update.py:60"),
            # no TPU kernel: the JAX package's kNN block is XLA
            "knn_topk": ("evstore_tpu_torch/csrc/knn_topk.cu",
                         "evstore_tpu/tools/gen_altkeys.py:36::block_topk "
                         "(XLA)"),
        }
        paths = {"serve": serve_launches, "serve_int8": int8_launches,
                 "altkeys": altkeys_launches,
                 "serve_host": host_launches, "gram_ab": gram_launches,
                 "train": train_launches,
                 "train_factored": factored_launches, "cli": cli_launches,
                 "train_cached": cached_launches, **mesh_launches,
                 "train_mlperf": mlperf_launches,
                 "serve_mlperf": serve_mlperf_launches,
                 "handoff_mlperf": handoff_launches,
                 "train_dcnv2": dcnv2_launches}
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
