"""Training DLRM with device memory bounded by the C1 cache.

Port of `TrainableDeviceCache` and `ShardedTrainableDeviceCache` from
`evstore_tpu/cache/trainable.py`.  The reference trains with whole tables
on the accelerator and serves through EVStore; here the sparse updates
write through the cache tier:

- The masters live in host memory: the float32 tables and their rwsadagrad
  row sums (`host_tables`, `host_mom`; numpy, or `np.memmap` over the EV
  .bin files under `from_files`).
- The card holds only the working set: `cache_values [C, D]` (float32,
  bfloat16, or uint8 codes of the 8-bit codec) and `cache_mom [C]` float32,
  plus the batch's miss buffer.
- Per batch, the C++ engine's training assigner
  (`native/__init__.py::NativeAssigner.assign_batch_train`) runs EvLFU with
  deferred slot reuse and reports the evictions; the evicted cells are
  written back to the masters, the misses are read from them, and the step
  inserts the misses, runs the forward and backward on the cached rows and
  applies rwsadagrad to the cells in device memory.
- A position's gradient lands on its key's final home: its cache slot, its
  buffer row (written back after the step), or the dying cell of a key
  evicted within the batch (carried back by a second write-back).  No
  update is dropped.  A key evicted and missed again within one batch takes
  its update in two parts, as in the reference.

The step reads the rows through the gather kernels (K2 `gather_rows`, its
two-source form over [cache | buffer] at float32; K3
`gather_rows_dequant_int8` for uint8 cells), runs the model (K1 and K4 in
the interaction) and updates the rows through K5 (`ops/cuda_update.py`):
at float32 one sort and one call of its fused row-wise rule cover the
cache and the buffer, whose global ids are the step's
gather indices and whose sums are one flat buffer, [cache_mom | buffer
sums].  A bfloat16 cache and the float32 buffer
take one call each.  uint8 cells decode, update in float32 and re-encode
with stochastic rounding where their gradient is not zero (plain PyTorch,
as XLA computes it in the reference); every other cell keeps its bytes,
and misses are inserted with the deterministic encode.  The cfg's
`use_gather_kernel` and `use_interaction_kernel` and the tcfg's
`use_update_kernel` switch the kernels to their plain versions.

Three drivers give the same trajectory bit for bit:
- `train_batch`, one batch per call, synchronous;
- `train_batches`, pipelined: one pinned upload and one non-blocking
  download a batch; batch k's write-backs land before batch k+1's misses
  are read, and a key evicted and missed again within a batch takes its
  row from the dying cell on the card;
- `train_batches_windowed`, K batches per upload and download, a window
  ahead on the host.

`ShardedTrainableDeviceCache` shards the cells over a mesh's model axis,
one process per rank (its docstring).

Departures from the JAX class: stochastic rounding draws from a
`torch.Generator` seeded with the step index, not from `jax.random`; the
static bucket sizes (`insert_bucket`, `_bucket`) are a TPU lowering and
went, so nothing is padded; host ids outside their table raise ValueError
(`check_ids`).  `host_s` adds up the host seconds a batch spends in the
assign, the miss fetch, the landing of write-backs and the step.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from evstore_tpu_torch.cache.device_cache import (broadcast_array,
                                                  broadcast_header)
from evstore_tpu_torch.cache.storage import write_ev_tables_binary
from evstore_tpu_torch.config import CacheConfig, DLRMConfig, TrainConfig
from evstore_tpu_torch.models.dlrm import dlrm_loss
from evstore_tpu_torch.models.embedding import check_ids
from evstore_tpu_torch.native import NativeAssigner, NativeTieredCache
from evstore_tpu_torch.ops.cuda_gather import (gather_rows,
                                               gather_rows_dequant_int8,
                                               gather_rows_dequant_int8_ref,
                                               gather_rows_ref)
from evstore_tpu_torch.ops.cuda_update import (rwsadagrad_row_update_global,
                                               segment_sums)
from evstore_tpu_torch.ops.quant import dequantize_int8
from evstore_tpu_torch.ops.table_desc import INT32_MAX
from evstore_tpu_torch.parallel.sharded import (_all_gather_cat, _slice,
                                                mean_over_data)
from evstore_tpu_torch.train.optim import (dense_parameters, lr_schedule,
                                           make_optimizer, row_update)
from evstore_tpu_torch.utils.device import resolve_device

KEY_ROW = (1 << 40) - 1     # packed key: table << 40 | row


# --- the 8-bit row codec of the training tier ------------------------------
# The reference's 8-bit codec: encode round(((x + 1) / 2) * 254), decode
# (v / 254) * 2 - 1 (script/reduce_precision.py:270,283).  Updated cells are
# re-encoded with stochastic rounding, whose decode is x on average, so that
# small updates are not lost to round-to-nearest.

def _q8_decode(v: torch.Tensor) -> torch.Tensor:
    return dequantize_int8(v)


def _q8_encode_det(x: torch.Tensor) -> torch.Tensor:
    y = (torch.clamp(x, -1.0, 1.0) + 1.0) * 0.5 * 254.0
    return torch.round(y).to(torch.uint8)


def _q8_encode_sr(x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """floor(y + u) with u ~ U[0, 1) drawn from `gen` (on x's device), one
    draw per element of x."""
    y = (torch.clamp(x, -1.0, 1.0) + 1.0) * 0.5 * 254.0
    u = torch.rand(x.shape, generator=gen, dtype=torch.float32,
                   device=x.device)
    return torch.clamp(torch.floor(y + u), 0, 254).to(torch.uint8)


def init_dense_state(model) -> Dict[str, torch.Tensor]:
    """Zero rwsadagrad sums of the model's dense parameters (the MLPs)."""
    return {n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in dense_parameters(model).items()}


class _Staging:
    """A host buffer for one copy to or from the card at a time: pinned on
    the card's machine, and not handed out again before the copy that last
    used it has finished (a CUDA event, not a device-wide wait)."""

    def __init__(self, dev: torch.device, dtype: torch.dtype):
        self.dev, self.dtype = dev, dtype
        self.buf: Optional[torch.Tensor] = None
        self.event = None

    def take(self, n: int) -> torch.Tensor:
        self.wait()
        if self.buf is None or self.buf.numel() < n:
            size = max(n, 2 * (0 if self.buf is None else self.buf.numel()))
            self.buf = torch.empty(size, dtype=self.dtype,
                                   pin_memory=self.dev.type == "cuda")
        return self.buf[:n]

    def mark(self) -> None:
        """Call after queueing the copy that reads or fills the buffer."""
        if self.dev.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(self.dev))

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()
            self.event = None


def _map_files(bin_dir: str, table_sizes: Sequence[int], dim: int):
    """The float32 `ev-table-<t+1>.bin` files mapped read-write, and the
    `mom-<t+1>.bin` row-sum files beside them (created zeroed if absent:
    sparse, since holes read as zero, so that no bytes are written; at
    the MLPerf shape the sums are 817 MB): -> (tables, sums), lists of
    `np.memmap`."""
    tables, moms = [], []
    for t, n in enumerate(table_sizes):
        p = os.path.join(bin_dir, f"ev-table-{t + 1}.bin")
        tables.append(np.memmap(p, np.float32, mode="r+", shape=(n, dim)))
        mp = os.path.join(bin_dir, f"mom-{t + 1}.bin")
        if not os.path.exists(mp):
            with open(mp, "wb") as f:
                f.truncate(n * 4)
        moms.append(np.memmap(mp, np.float32, mode="r+", shape=(n,)))
    return tables, moms


def _offsets(parts) -> np.ndarray:
    """Where each part starts in one buffer of all of them, and the end."""
    return np.cumsum([0] + [int(np.asarray(p).size) for p in parts])


class TrainableDeviceCache:
    """Device-memory-bounded embedding training state and its step."""

    def __init__(self, cfg: DLRMConfig, tcfg: TrainConfig, ccfg: CacheConfig,
                 tables: Sequence, eps: float = 1e-10,
                 copy_tables: bool = True, device=None):
        if tcfg.optimizer != "rwsadagrad":
            raise ValueError("cached training supports rwsadagrad (the "
                             "reference's sparse optimizer)")
        if ccfg.main_precision not in (32, 16, 8):
            raise ValueError("trainable cache rows are fp32, bf16 or int8 "
                             "(main_precision 32/16/8); the int4 codec is "
                             "inference-tier only")
        if cfg.qr_flag or cfg.md_flag or cfg.weighted_pooling or \
                cfg.multi_hot_sizes:
            raise ValueError("cached training takes plain one-hot tables "
                             "(no qr, md, weighted pooling or bags of a "
                             "length per table)")
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.capacity = ccfg.total_size
        self.dim = cfg.embedding_dim
        self.n_tables = cfg.num_tables
        self.eps = eps
        # bf16 cells halve the cache's memory, uint8 codes quarter it;
        # updates compute in float32, and the masters and sums stay float32
        self.cache_dtype = {32: torch.float32, 16: torch.bfloat16,
                            8: torch.uint8}[ccfg.main_precision]
        self.engine = self.assigner = None
        self.host_tables = self.host_mom = None
        if self._holds_masters():
            self._init_masters(ccfg, tables, copy_tables)
        self._init_cells(*self._cell_layout())
        self.lr_fn = lr_schedule(tcfg.learning_rate, tcfg.lr_num_warmup_steps,
                                 tcfg.lr_decay_start_step,
                                 tcfg.lr_num_decay_steps)
        self._dense_update = make_optimizer("rwsadagrad", eps)[1]
        self._gen = torch.Generator(device=self.device)
        self._up = _Staging(self.device, torch.int32)
        self._down = _Staging(self.device, torch.float32)
        self.dropped_updates = 0
        self.host_s = dict.fromkeys(("assign", "fetch", "land", "step"), 0.0)

    def _holds_masters(self) -> bool:
        """Whether this process holds the masters, the engine and the
        assigner (every process of one device; rank 0 of a mesh)."""
        return True

    def _init_masters(self, ccfg: CacheConfig, tables: Sequence,
                      copy_tables: bool) -> None:
        cfg = self.cfg
        # The masters are the engine's store, borrowed without a copy, so
        # that a miss read sees the write-backs made before it.  A copy is
        # C-ordered float32 numpy: a borrow of anything else would copy
        # silently and serve every miss its initial value.
        if copy_tables:
            self.host_tables = [
                np.array(t.detach().to("cpu", torch.float32).numpy()
                         if isinstance(t, torch.Tensor) else t,
                         np.float32, copy=True, order="C")
                for t in tables]
        else:
            for t in tables:
                if not isinstance(t, np.ndarray) or t.dtype != np.float32 \
                        or not t.flags["C_CONTIGUOUS"] \
                        or not t.flags["WRITEABLE"]:
                    raise ValueError("copy_tables=False requires writable "
                                     "C-contiguous float32 buffers")
            self.host_tables = list(tables)
        if [t.shape for t in self.host_tables] != \
                [(n, self.dim) for n in cfg.table_sizes]:
            raise ValueError(f"tables {[t.shape for t in self.host_tables]} "
                             f"do not match the config's "
                             f"{list(cfg.table_sizes)} x {self.dim}")
        self.host_mom = [np.zeros(t.shape[0], np.float32)
                         for t in self.host_tables]
        eng_cfg = CacheConfig(policy="evlfu", n_caching_layers=1,
                              total_size=1)
        self.engine = NativeTieredCache(eng_cfg, self.n_tables, self.dim, 4)
        self.engine.borrow_tables(self.host_tables)
        for t, (mine, theirs) in enumerate(
                zip(self.host_tables, self.engine._borrowed_refs)):
            if mine.ctypes.data != theirs.ctypes.data:
                raise RuntimeError(
                    f"table {t}: the engine's borrow is not aliased to "
                    "host_tables (non-contiguous input?); write-backs would "
                    "be invisible to miss reads")
        self.assigner = NativeAssigner(self.engine, self.capacity,
                                       ccfg.flush_rate, ccfg.perfect_item_cap)

    def _cell_layout(self):
        """(this process's cells, scratch rows past them)."""
        return self.capacity, 0

    def _init_cells(self, n_own: int, scratch: int) -> None:
        """The cells on the card: `_store` [n_own + scratch, D] of the
        cache's type (the cells the step's ids address; `cache_values` its
        first n_own rows, this process's cells) and `_mom`, one flat float32
        buffer [store's sums | buffer sums], so that one grouped update
        covers the cells and the buffer (grown with the buffer).  A buffer
        row m has the id `_cells` + m."""
        self._cells = n_own + scratch
        dev = self.device
        self._store = torch.zeros((self._cells, self.dim),
                                  dtype=self.cache_dtype, device=dev)
        self.cache_values = self._store[:n_own]
        self._mom = torch.zeros(self._cells, dtype=torch.float32, device=dev)
        self.cache_mom = self._mom[:n_own]
        self._buf = torch.zeros((0, self.dim), dtype=torch.float32,
                                device=dev)

    @classmethod
    def from_files(cls, cfg: DLRMConfig, tcfg: TrainConfig, ccfg: CacheConfig,
                   bin_dir: str, table_sizes: Sequence[int], **kw):
        """Masters on disk: the float32 `ev-table-<t+1>.bin` files
        (`write_ev_tables_binary`'s format) mapped read-write, and
        `mom-<t+1>.bin` row-sum files beside them (created zeroed if
        absent).  Host memory holds only the page cache's working set;
        write-backs land in the mapped pages and reach the files with
        `flush_files`."""
        tables, moms = _map_files(bin_dir, table_sizes, cfg.embedding_dim)
        obj = cls(cfg, tcfg, ccfg, tables, copy_tables=False, **kw)
        obj.host_mom = moms
        return obj

    def flush_files(self):
        """Write the cache back to the masters and the mapped masters and
        sums to their files (for in-memory masters, a flush only)."""
        self.flush_to_host()
        for arr in list(self.host_tables or []) + list(self.host_mom or []):
            if isinstance(arr, np.memmap):
                arr.flush()

    # ------------------------------------------------------------ the step

    def _reserve(self, n: int) -> None:
        """Room for n buffer rows (and their sums after the cells')."""
        n = max(n, 1)
        if n <= self._buf.shape[0]:
            return
        n = max(n, 2 * self._buf.shape[0])
        C = self._cells
        mom = torch.zeros(C + n, dtype=torch.float32, device=self.device)
        mom[:C] = self._mom[:C]
        self._mom = mom
        self.cache_mom = mom[:self.cache_values.shape[0]]
        self._buf = torch.zeros((n, self.dim), dtype=torch.float32,
                                device=self.device)

    def _encode_det(self, x: torch.Tensor) -> torch.Tensor:
        if self.cache_dtype == torch.uint8:
            return _q8_encode_det(x)
        return x.to(self.cache_dtype)

    def _read_slots(self, slots: torch.Tensor) -> torch.Tensor:
        """Float32 rows of the cache cells `slots` (int32 on the card)."""
        kern = self.cfg.use_gather_kernel
        if self.cache_dtype == torch.uint8:
            return (gather_rows_dequant_int8 if kern
                    else gather_rows_dequant_int8_ref)(self.cache_values,
                                                       slots)
        return (gather_rows if kern else gather_rows_ref)(
            self.cache_values, slots).float()

    def _read_rows(self, gi: torch.Tensor) -> torch.Tensor:
        """The batch's rows [B, T, D] float32: gi < C = `_cells` reads the
        cell, gi = C + m buffer row m, any other id a zero row.  The
        float32 buffer is never rounded to the cache's type."""
        C = self._cells
        kern = self.cfg.use_gather_kernel
        take = gather_rows if kern else gather_rows_ref
        if self.cache_dtype == torch.float32:
            return take(self._store, gi, self._buf)
        in_c = (gi < C)[..., None]
        from_buf = take(self._buf, gi - C)
        return torch.where(in_c, self._read_slots(gi), from_buf)

    def _row_update(self, gi: torch.Tensor, g: torch.Tensor, lr: float,
                    seed: int) -> None:
        """rwsadagrad on the cells the batch read, keyed by gi [K] (ids
        as `_read_rows` takes them; any other id is inert): the gradients
        g [K, D] of one cell coalesce before its sum moves."""
        C = self._cells
        kern = self.tcfg.use_update_kernel
        if self.cache_dtype == torch.float32 and kern:
            rwsadagrad_row_update_global(self._mom, [self._store, self._buf],
                                         gi, g, lr, self.eps)
            return
        in_c = gi < C
        buf_ids = torch.where(in_c, INT32_MAX, gi - C)

        def update(state, table, ids):
            if kern:
                rwsadagrad_row_update_global(state, [table], ids, g, lr,
                                             self.eps)
            else:
                row_update("rwsadagrad", state, table, ids, g, lr, self.eps,
                           use_kernel=False)

        update(self._mom[C:], self._buf, buf_ids)
        if self.cache_dtype != torch.uint8:
            update(self.cache_mom, self.cache_values,
                   torch.where(in_c, gi, INT32_MAX))
            return
        # uint8 cells: the JAX step's dense form over the cache; only cells
        # whose gradient is not zero are decoded, updated and re-encoded.
        # A cell's gradient is its run's sum over the sorted positions (the
        # kernel's, or with the kernels off an `index_add_`).
        cell = torch.where(in_c, gi, C).long()      # the others: row C
        gc = torch.zeros((C + 1, self.dim), dtype=torch.float32,
                         device=g.device)
        if kern:
            rows_sorted, order = torch.sort(cell.to(torch.int32),
                                            stable=True)
            _, _, Gc, valid, seg_at = segment_sums(rows_sorted, g[order], C)
            gc[torch.where(valid, seg_at, C)] = Gc
        else:
            gc.index_add_(0, cell, g)
        gc = gc[:self.cache_values.shape[0]]
        inc = torch.mean(gc * gc, dim=1)
        touched = inc > 0
        mom2 = self.cache_mom + inc
        std = torch.sqrt(mom2) + self.eps
        upd = _q8_decode(self.cache_values) - \
            (lr * gc / std[:, None]) * touched[:, None]
        self._gen.manual_seed(self._sr_seed(seed))
        enc = _q8_encode_sr(upd, self._gen)
        self.cache_values.copy_(torch.where(touched[:, None], enc,
                                            self.cache_values))
        self.cache_mom.copy_(torch.where(touched, mom2, self.cache_mom))

    def _step(self, model, dstate, gi, scat_slots, scat_src, dense_x,
              labels, lr: float, seed: int) -> torch.Tensor:
        """One step on the card.  gi [B, T] int32 indexes [cache | buffer];
        cache cells scat_slots take buffer rows scat_src (with their sums)
        before the forward.  Updates the cache, the buffer, the model's
        dense parameters and dstate in place; returns the loss."""
        C = self._cells
        with torch.no_grad():
            if scat_slots.numel():
                src = scat_src.long()
                slots = self._scatter_rows(scat_slots)
                self._store.index_copy_(
                    0, slots, self._encode_det(self._buf.index_select(0, src)))
                self._mom.index_copy_(
                    0, slots, self._mom[C:].index_select(0, src))
            emb = self._exchange(self._read_rows(self._read_ids(gi)))
        emb.requires_grad_(True)
        params = dense_parameters(model)
        for p in params.values():
            p.grad = None
        loss = dlrm_loss(model(dense_x, None, emb_rows=emb), labels,
                         self.tcfg.loss_function, self.tcfg.loss_weights)
        loss.backward()
        with torch.no_grad():
            loss = self._mean_over_data(loss.detach(), params)
            self._dense_update(dstate, params, lr)
            ids, g = self._row_grads(gi, emb.grad)
            self._row_update(ids, g, lr, seed)
        return loss

    # the step's hooks: one device as they are; the sharded class
    # (`ShardedTrainableDeviceCache`) maps ids to its cells and exchanges

    def _scatter_rows(self, scat_slots: torch.Tensor) -> torch.Tensor:
        """The `_store` rows the misses inserted at `scat_slots` land in."""
        return scat_slots.long()

    def _read_ids(self, gi: torch.Tensor) -> torch.Tensor:
        """The ids `_read_rows` takes for the gather indices gi [B, T]."""
        return gi

    def _exchange(self, rows: torch.Tensor) -> torch.Tensor:
        return rows

    def _mean_over_data(self, loss: torch.Tensor, params) -> torch.Tensor:
        """The loss, and the dense grads in place, of the global batch."""
        return loss

    def _row_grads(self, gi: torch.Tensor, grad: torch.Tensor):
        """(ids [K], grads [K, D]) of the row update from the gather
        indices and the rows' cotangent."""
        return gi.reshape(-1), grad.reshape(-1, self.dim)

    def _sr_seed(self, seed: int) -> int:
        """The seed of a step's stochastic rounding: the step's index."""
        return seed

    def _check_model(self, model) -> None:
        if model.cfg != self.cfg:
            raise ValueError("the model was built from another DLRMConfig")
        dev = next(model.parameters()).device
        if dev != self.device:
            raise ValueError(f"the model is on {dev}, the cache on "
                             f"{self.device}")

    # ------------------------------------------------------ host bookkeeping

    def _assign(self, idx: np.ndarray):
        """The assigner's training call for one batch: (the final gather
        and gradient target per position [B, T], scat_slots, scat_m, M,
        the evicted keys packed, their slots, buf_t, buf_r)."""
        t0 = time.perf_counter()
        check_ids(idx, self.cfg.table_sizes)
        (slots, scat_slots, scat_m, buf, ev_keys, ev_slots,
         upd) = self.assigner.assign_batch_train_raw(idx)
        M = buf.shape[0]
        buf_t, buf_r = self._buffer_keys_arrays(idx, slots, M)
        gather_idx = np.where(upd == INT32_MAX, slots, upd).astype(np.int32)
        self.host_s["assign"] += time.perf_counter() - t0
        return (gather_idx, scat_slots, scat_m, M, ev_keys.astype(np.int64),
                ev_slots, buf_t, buf_r)

    def _fetch(self, buf_t, buf_r):
        """The misses' rows and sums from the masters."""
        t0 = time.perf_counter()
        rows = self.assigner.fetch_rows_arrays(buf_t, buf_r)
        moms = np.zeros(len(buf_t), np.float32)
        for t in np.unique(buf_t):
            sel = buf_t == t
            moms[sel] = self.host_mom[t][buf_r[sel]]
        self.host_s["fetch"] += time.perf_counter() - t0
        return rows, moms

    def _write_masters(self, ts, rs, rows, moms) -> None:
        for t in np.unique(ts):
            sel = ts == t
            self.host_tables[t][rs[sel]] = rows[sel]
            self.host_mom[t][rs[sel]] = moms[sel]

    def _upload(self, ints, floats):
        """Every input of a batch or window in one host buffer and one copy
        to the card: -> (the int32 parts, the float32 parts) as tensors on
        the card, in order."""
        io = _offsets(ints)
        fo = _offsets(floats)
        host = self._up.take(int(io[-1] + fo[-1]))
        h = host.numpy()
        hf = h[io[-1]:].view(np.float32)
        for p, a, b in zip(ints, io[:-1], io[1:]):
            h[a:b] = np.asarray(p).reshape(-1)
        for p, a, b in zip(floats, fo[:-1], fo[1:]):
            hf[a:b] = np.asarray(p, np.float32).reshape(-1)
        if self.device.type == "cuda":
            dev = host.to(self.device, non_blocking=True)
            self._up.mark()
        else:
            dev = host.clone()
        df = dev[io[-1]:].view(torch.float32)
        return ([dev[a:b] for a, b in zip(io[:-1], io[1:])],
                [df[a:b] for a, b in zip(fo[:-1], fo[1:])])

    def _download(self, parts: List[torch.Tensor]):
        """Queue one copy of the float32 parts (flattened, concatenated)
        into the download buffer: -> the host view, valid after
        `self._down.wait()`."""
        flat = torch.cat([p.reshape(-1) for p in parts])
        host = self._down.take(flat.numel())
        host.copy_(flat, non_blocking=self.device.type == "cuda")
        self._down.mark()
        return host

    def _buffer_keys_arrays(self, idx, slots, M):
        """(table, row) of every buffer row m, from the positions it serves
        (each buffer row serves at least one)."""
        B, T = idx.shape
        s = np.asarray(slots)
        mask = s >= self.capacity
        ms = (s[mask] - self.capacity).astype(np.int64)
        ts = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))[mask]
        rs = np.asarray(idx)[mask].astype(np.int64)
        buf_t = np.zeros(M, np.int32)
        buf_r = np.zeros(M, np.int64)
        buf_t[ms] = ts
        buf_r[ms] = rs
        return buf_t, buf_r

    def _writeback_evicted(self, ev_keys, ev_slots) -> None:
        """The cells' current rows and sums into the masters; ev_keys are
        packed int64 (table << 40 | row)."""
        if len(ev_keys) == 0:
            return
        ts, rs = (ev_keys >> 40).astype(np.int32), ev_keys & KEY_ROW
        slots = torch.from_numpy(np.ascontiguousarray(
            ev_slots, np.int32)).to(self.device)
        rows = self._read_slots(slots).cpu().numpy()
        moms = self.cache_mom[slots.long()].cpu().numpy()
        self._write_masters(ts, rs, rows, moms)

    def flush_to_host(self):
        """Write every cached cell (and its sum) back to the masters, so
        that `host_tables` hold the trained tables."""
        keys, slots = self.assigner.resident_keys()
        if len(keys):
            self._writeback_evicted(keys, slots)

    # ------------------------------------------------------------- drivers

    def train_batch(self, model, dstate, step_idx: int, dense_x, idx,
                    labels):
        """One step, synchronous: write back the batch's evictions, read
        its misses, step, write back the dying cells again and the buffer
        rows that stay out of the cache.  The model's dense parameters and
        dstate are updated in place.  Returns (model, dstate, loss)."""
        self._check_model(model)
        idx = np.asarray(idx)
        (gather_idx, scat_slots, scat_m, M, ev_keys, ev_slots, buf_t,
         buf_r) = self._assign(idx)
        # before the read: a key evicted and missed again in this batch
        # must read its updated value
        self._writeback_evicted(ev_keys, ev_slots)
        rows, moms = self._fetch(buf_t, buf_r)
        t0 = time.perf_counter()
        loss, _ = self._dispatch(model, dstate, gather_idx, scat_slots,
                                 scat_m, rows, moms, [], [], ev_slots,
                                 dense_x, labels, step_idx)
        # the dying cells may have taken this batch's updates
        self._writeback_evicted(ev_keys, ev_slots)
        # then the buffer rows that are not cached: a key evicted and
        # missed again ends with its buffer value
        nonres = np.ones(M, bool)
        nonres[scat_m[scat_m < M]] = False
        C = self.capacity
        nb = self._buf[:M].cpu().numpy()
        nbm = self._mom[C:C + M].cpu().numpy()
        self._write_masters(buf_t[nonres], buf_r[nonres], nb[nonres],
                            nbm[nonres])
        self.host_s["step"] += time.perf_counter() - t0
        return model, dstate, loss

    def _dispatch(self, model, dstate, gather_idx, scat_slots, scat_m, rows,
                  moms, fw_slots, fw_dst, ev_slots, dense_x, labels,
                  step_idx):
        """Upload one batch's inputs, fill the buffer (and the rows
        store-forwarded from dying cells) and queue its step: -> (the loss,
        the evicted slots on the card)."""
        M = len(rows)
        dense_x = np.asarray(dense_x, np.float32)
        labels = np.asarray(labels, np.float32)
        (gi, ss, sm, fs, fd, es), (r, m, dx, lb) = self._upload(
            [gather_idx, scat_slots, scat_m, fw_slots, fw_dst, ev_slots],
            [rows, moms, dense_x, labels])
        self._reserve(M)
        C = self.capacity
        with torch.no_grad():
            self._buf[:M] = r.view(M, self.dim)
            self._mom[C:C + M] = m
            if fs.numel():
                self._fill_from_cells(fs, fd)
        loss = self._step(model, dstate, gi.view(gather_idx.shape), ss, sm,
                          dx.view(dense_x.shape), lb.view(labels.shape),
                          float(self.lr_fn(step_idx)), int(step_idx))
        return loss, es

    def _fill_from_cells(self, slots: torch.Tensor, dst: torch.Tensor):
        """Buffer rows dst take the rows and sums of cache cells `slots`
        as they are now (the dying cells, before the step)."""
        C = self.capacity
        self._buf[dst.long()] = self._read_slots(slots)
        self._mom[C + dst.long()] = self.cache_mom[slots.long()]

    def train_batches(self, model, dstate, batches, start_step: int = 1):
        """Pipelined training over an iterable of (dense, idx, labels),
        the trajectory of `train_batch` bit for bit.  The host stays a batch
        ahead: batch k's dying-cell snapshot and updated buffer rows come
        back in one copy, landed before batch k+1's misses are read; the
        write-back before the step is left out (earlier batches' evictions
        have landed), and a key evicted and missed again within a batch
        takes its row from the dying cell on the card.  Yields (model,
        dstate, loss on the card) per batch."""
        self._check_model(model)
        C, D = self.capacity, self.dim
        pending = None

        def land(p):
            t0 = time.perf_counter()
            ev_keys, E, buf_t, buf_r, nonres, M, host = p
            self._down.wait()
            arr = host.numpy().reshape(E + M, D + 1)
            if E:
                self._write_masters((ev_keys >> 40).astype(np.int32),
                                    ev_keys & KEY_ROW, arr[:E, :D],
                                    arr[:E, D])
            if M:
                nb = arr[E:]
                self._write_masters(buf_t[nonres], buf_r[nonres],
                                    nb[nonres, :D], nb[nonres, D])
            self.host_s["land"] += time.perf_counter() - t0

        step_idx = start_step
        for dense_x, idx, labels in batches:
            idx = np.asarray(idx)
            (gather_idx, scat_slots, scat_m, M, ev_keys, ev_slots, buf_t,
             buf_r) = self._assign(idx)
            fw_slots = fw_dst = np.zeros(0, np.int32)
            if len(ev_keys) and M:
                pk = (buf_t.astype(np.int64) << 40) | buf_r
                order = np.argsort(ev_keys)
                pos = np.searchsorted(ev_keys[order], pk)
                pos = np.minimum(pos, len(ev_keys) - 1)
                hit = ev_keys[order][pos] == pk
                fw_dst = np.flatnonzero(hit).astype(np.int32)
                fw_slots = ev_slots[order][pos[hit]].astype(np.int32)
            # land batch k-1's write-backs before this read of the masters
            if pending is not None:
                land(pending)
            rows, moms = self._fetch(buf_t, buf_r)
            t0 = time.perf_counter()
            loss, slots = self._dispatch(model, dstate, gather_idx,
                                         scat_slots, scat_m, rows, moms,
                                         fw_slots, fw_dst, ev_slots, dense_x,
                                         labels, step_idx)
            with torch.no_grad():
                snap = torch.cat([self._read_slots(slots),
                                  self.cache_mom[slots.long()][:, None]],
                                 dim=1)
                bufd = torch.cat([self._buf[:M], self._mom[C:C + M, None]],
                                 dim=1)
                host = self._download([snap, bufd])
            self.host_s["step"] += time.perf_counter() - t0
            nonres = np.ones(M, bool)
            nonres[scat_m[scat_m < M]] = False
            pending = (ev_keys, len(ev_slots), buf_t, buf_r, nonres, M, host)
            step_idx += 1
            yield model, dstate, loss
        if pending is not None:
            land(pending)

    # ------------------------------------------------------- windowed mode

    # key states of the window tracker, packed in one int: kind << 48 |
    # payload (payloads are below 2^48)
    _ST_RES = 0 << 48
    _ST_BUF = 1 << 48
    _ST_EV = 2 << 48
    _ST_MASK = (1 << 48) - 1

    def _build_window(self, batch_list, start_step):
        """The assigner over K batches and the window's plan: per batch its
        index arrays, the window's fetch list (one buffer row u per key
        missed anywhere in it, shared by its batches), the fill lists and
        each key's final authority in the window.  Keys are packed table
        << 40 | row; the loop runs once per unique miss."""
        RES, BUF, EV, PAY = (self._ST_RES, self._ST_BUF, self._ST_EV,
                             self._ST_MASK)
        C = self.capacity
        per = []
        U_map = {}                 # packed key -> window buffer row u
        state = {}                 # packed key -> kind << 48 | payload
        fetch_k, fetch_u = [], []
        n_u = 0
        n_e = 0
        for k, (dense_x, idx, labels) in enumerate(batch_list):
            idx = np.asarray(idx)
            (gather, scat_slots, scat_m, M, ev_keys, ev_slots, buf_t,
             buf_r) = self._assign(idx)
            pk = ((buf_t.astype(np.int64) << 40) | buf_r).tolist()
            # (1) evictions -> snapshot rows; this batch's ones are kept
            # apart for the same-batch fill
            ekl = ev_keys.tolist()
            e0 = n_e
            n_e += len(ekl)
            ev_dst = np.arange(e0, n_e, dtype=np.int32)
            state.update(zip(ekl, range(EV | e0, EV | n_e)))
            batch_ev = dict(zip(ekl, zip(range(e0, n_e),
                                         ev_slots.tolist())))
            # (2) buffer rows -> shared window rows and fills
            mu_l = []
            fc_slot, fc_dst, fe_src, fe_dst = [], [], [], []
            uget = U_map.get
            sget = state.get
            for key in pk:
                u = uget(key)
                st = sget(key)
                if u is None:
                    u = n_u
                    n_u += 1
                    U_map[key] = u
                    if st is None or st < EV:
                        fetch_k.append(key)
                        fetch_u.append(u)
                        mu_l.append(u)
                        continue
                elif st is None or st < EV:
                    mu_l.append(u)
                    continue
                # the key's row went stale while it was cached: refill it
                # from its eviction snapshot, or from the dying cell when
                # the eviction is this batch's
                e = st & PAY
                be = batch_ev.get(key)
                if be is not None and be[0] == e:
                    fc_slot.append(be[1])
                    fc_dst.append(u)
                else:
                    fe_src.append(e)
                    fe_dst.append(u)
                mu_l.append(u)
            state.update(zip(pk, [BUF | u for u in mu_l]))
            mu = np.asarray(mu_l, np.int64)
            # (3) insertions -> cache-resident
            state.update((pk[m], RES) for m in scat_m.tolist())
            gather = gather.astype(np.int64)
            over = gather >= C
            gather[over] = C + mu[gather[over] - C]
            per.append({
                "gather": gather.astype(np.int32),
                "scat_slots": scat_slots.astype(np.int32),
                "scat_u": mu[scat_m].astype(np.int32),
                "fc_slot": np.asarray(fc_slot, np.int32),
                "fc_dst": np.asarray(fc_dst, np.int32),
                "fe_src": np.asarray(fe_src, np.int32),
                "fe_dst": np.asarray(fe_dst, np.int32),
                "ev_slots": np.asarray(ev_slots, np.int32),
                "ev_dst": ev_dst,
                "dense_x": np.asarray(dense_x, np.float32),
                "labels": np.asarray(labels, np.float32),
                "lr": float(self.lr_fn(start_step + k)),
                "seed": start_step + k,
            })
        return per, state, (fetch_k, fetch_u), n_u, n_e

    def _plan_window(self, batch_list, step_idx, prev_state):
        """One window's plan: the assigner and the tracker, the landing
        list, and U0/Um0 with the clean misses read (keys whose master is
        current).  Dirty keys, whose authority is still on the card in the
        window in flight, wait for its landing."""
        per, state, (fk, fu), n_u, n_e = self._build_window(batch_list,
                                                            step_idx)
        land_k = np.fromiter(state.keys(), np.int64, len(state))
        land_s = np.fromiter(state.values(), np.int64, len(state))
        kind = land_s >> 48
        keep = kind != 0                       # cached keys do not land
        land_k = land_k[keep]
        ev_sel = kind[keep] == 2
        land_pay = (land_s[keep] & self._ST_MASK).astype(np.int64)
        p = {"per": per, "state": state, "K": len(batch_list),
             "land_k": land_k, "ev_sel": ev_sel, "land_pay": land_pay,
             "out_u": land_pay[~ev_sel], "Up": n_u, "Ew": n_e}
        U0 = np.zeros((n_u, self.dim), np.float32)
        Um0 = np.zeros((n_u,), np.float32)
        dirty_k, dirty_u, clean_k, clean_u = [], [], [], []
        for key, u in zip(fk, fu):
            if key in prev_state:
                dirty_k.append(key)
                dirty_u.append(u)
            else:
                clean_k.append(key)
                clean_u.append(u)
        if clean_k:
            self._fetch_into(U0, Um0, clean_k, clean_u)
        p["U0"], p["Um0"] = U0, Um0
        p["dirty"] = (dirty_k, dirty_u)
        return p

    def _fetch_into(self, U0, Um0, keys, us):
        kk = np.asarray(keys, np.int64)
        uu = np.asarray(us, np.int64)
        rows, moms = self._fetch((kk >> 40).astype(np.int32), kk & KEY_ROW)
        U0[uu] = rows
        Um0[uu] = moms

    def _land_window(self, pend):
        """Write one window's download into the masters; -> its losses."""
        t0 = time.perf_counter()
        self._down.wait()
        Ew, n_out = pend["Ew"], len(pend["out_u"])
        flat = pend["host"].numpy()
        arr = flat[:(Ew + n_out) * (self.dim + 1)].reshape(Ew + n_out,
                                                           self.dim + 1)
        losses = flat[(Ew + n_out) * (self.dim + 1):].copy()
        land_k, ev_sel = pend["land_k"], pend["ev_sel"]
        if len(land_k):
            src = np.empty(len(land_k), np.int64)
            src[ev_sel] = pend["land_pay"][ev_sel]
            src[~ev_sel] = Ew + np.arange(n_out)
            self._write_masters((land_k >> 40).astype(np.int32),
                                land_k & KEY_ROW, arr[src, :-1],
                                arr[src, -1])
        self.host_s["land"] += time.perf_counter() - t0
        return losses

    def _dispatch_window(self, p, model, dstate):
        """One upload, the window's K steps queued on the card, one
        download of the eviction snapshots, the buffer rows that land and
        the losses."""
        t0 = time.perf_counter()
        per, K = p["per"], p["K"]
        Up, Ew = p["Up"], p["Ew"]
        names = ("gather", "scat_slots", "scat_u", "fc_slot", "fc_dst",
                 "fe_src", "fe_dst", "ev_slots", "ev_dst")
        ints = [q[n] for q in per for n in names] + [p["out_u"]]
        floats = [p["U0"], p["Um0"]] + [a for q in per
                                         for a in (q["dense_x"],
                                                   q["labels"])]
        di, df = self._upload(ints, floats)
        C, D = self.capacity, self.dim
        self._reserve(Up)
        losses = []
        with torch.no_grad():
            self._buf[:Up] = df[0].view(Up, D)
            self._mom[C:C + Up] = df[1]
            evbuf = torch.zeros((Ew, D + 1), dtype=torch.float32,
                                device=self.device)
        for k, q in enumerate(per):
            (gi, ss, su, fcs, fcd, fes, fed, es, ed) = \
                di[k * len(names):(k + 1) * len(names)]
            dx, lb = df[2 + 2 * k], df[3 + 2 * k]
            with torch.no_grad():
                # same-batch evict and miss: the dying cell before the step
                if fcs.numel():
                    self._fill_from_cells(fcs, fcd)
                # evicted in an earlier batch of the window: its snapshot
                if fes.numel():
                    er = evbuf[fes.long()]
                    self._buf[fed.long()] = er[:, :D]
                    self._mom[C + fed.long()] = er[:, D]
            losses.append(self._step(
                model, dstate, gi.view(q["gather"].shape), ss, su,
                dx.view(q["dense_x"].shape), lb.view(q["labels"].shape),
                q["lr"], q["seed"]))
            # the dying cells after the step, before a later scatter can
            # reuse their slots
            if es.numel():
                with torch.no_grad():
                    evbuf[ed.long()] = torch.cat(
                        [self._read_slots(es),
                         self.cache_mom[es.long()][:, None]], dim=1)
        with torch.no_grad():
            out = di[-1].long()
            host = self._download([
                evbuf, torch.cat([self._buf[out],
                                  self._mom[C + out][:, None]], dim=1),
                torch.stack(losses)])
        self.host_s["step"] += time.perf_counter() - t0
        return {"host": host, "K": K, "land_k": p["land_k"],
                "ev_sel": p["ev_sel"], "land_pay": p["land_pay"],
                "out_u": p["out_u"], "Ew": Ew}

    def train_batches_windowed(self, model, dstate, batches,
                               window: int = 16, start_step: int = 1):
        """K = `window` batches per upload and download, the trajectory of
        `train_batch` bit for bit.  The window's batches share one miss
        buffer (a key missed in several gets one row, which later batches
        read as the per-batch path reads it back from the masters); a key
        evicted and missed again is refilled on the card from its eviction
        snapshot, or from its dying cell within one batch; each step ends
        by snapshotting its dying cells.  The host plans window w+1 while
        w runs; only the misses whose authority is still on the card wait
        for w's landing.  Yields (model, dstate, loss) per batch."""
        self._check_model(model)
        step_idx = start_step
        batch_it = iter(batches)
        pending = None
        prev_state = {}
        while True:
            batch_list = []
            for _ in range(window):
                try:
                    batch_list.append(next(batch_it))
                except StopIteration:
                    break
            plan = None
            if batch_list:
                plan = self._plan_window(batch_list, step_idx, prev_state)
            if pending is not None:
                losses = self._land_window(pending)
                if plan is not None and plan["dirty"][0]:
                    # the masters are current now: read the deferred rows
                    self._fetch_into(plan["U0"], plan["Um0"], *plan["dirty"])
                new_pending = None
                if plan is not None:
                    new_pending = self._dispatch_window(plan, model, dstate)
                for k in range(pending["K"]):
                    yield model, dstate, losses[k]
                if plan is None:
                    return
                pending = new_pending
            else:
                if plan is None:
                    return
                pending = self._dispatch_window(plan, model, dstate)
            prev_state = plan["state"]
            step_idx += plan["K"]

    # ------------------------------------------------------------ the rest

    # The files below are written by the process that holds the masters
    # (rank 0 of a mesh); the flush before them is collective.

    def save(self, out_dir: str):
        """Flush, then each table's rows and sums as `table_<t>.npy` and
        `mom_<t>.npy` (the JAX package's files, which it reads too)."""
        self.flush_to_host()
        if self.host_tables is None:
            return
        os.makedirs(out_dir, exist_ok=True)
        for t, (tab, mom) in enumerate(zip(self.host_tables, self.host_mom)):
            np.save(os.path.join(out_dir, f"table_{t}.npy"), tab)
            np.save(os.path.join(out_dir, f"mom_{t}.npy"), mom)

    def load(self, in_dir: str):
        """Restore the masters and sums from `save`'s files; the cache
        starts cold and refills through misses."""
        for t in range(self.n_tables if self.host_tables is not None
                       else 0):
            self.host_tables[t][:] = np.load(
                os.path.join(in_dir, f"table_{t}.npy"))
            self.host_mom[t][:] = np.load(
                os.path.join(in_dir, f"mom_{t}.npy"))
        return self

    def export_ev_tables(self, out_dir: str, precision: int = 32):
        """The trained tables as EV .bin files for the serving tiers
        (dlrm_s_pytorch.py:1780-1796): -> their paths ([] where no
        masters are held)."""
        self.flush_to_host()
        if self.host_tables is None:
            return []
        return write_ev_tables_binary(self.host_tables, out_dir, precision)

    def stats(self) -> dict:
        """The assigner's counters (where it runs) with `hbm_bytes`, the
        whole cache's cells and sums, and `hbm_bytes_per_chip`, this
        process's."""
        s = self.assigner.stats() if self.assigner is not None else {}
        item = torch.empty((), dtype=self.cache_dtype).element_size()
        row = self.dim * item + 4
        s.update({"capacity": self.capacity,
                  "hbm_bytes_per_chip": int(self.cache_values.shape[0] * row),
                  "hbm_bytes": int(self.capacity * row),
                  "dropped_updates": self.dropped_updates})
        return s

    def close(self):
        if self.engine is not None:
            self.engine.close()


class ShardedTrainableDeviceCache(TrainableDeviceCache):
    """The trainable cache with its cells sharded over the "model" axis of
    a mesh (`parallel/mesh.py`), so that the cache's capacity grows with the
    cards, and the batch data-parallel over "data".  Port of the JAX
    package's `ShardedTrainableDeviceCache`, one process per rank; every
    rank calls each method with the same arguments (the global batch).

    - Cells: model rank m holds the cells [m·Cl, (m+1)·Cl), Cl = C /
      n_model (`cache_values` [Cl, D], `cache_mom` [Cl]), and a scratch
      row past them for the misses other ranks own.  The miss buffer is
      whole on every rank.
    - Host: rank 0 alone holds the masters (in memory, or mapped files
      under `from_files`), the engine and its training assigner.  A batch:
      rank 0 assigns and broadcasts a size header, then the gather indices,
      the scatter lists and the evicted cells (`device_cache.py::
      broadcast_header`, `broadcast_array`, as `ShardedDeviceC1Cache`
      does), then, after the evicted cells have landed, the miss rows and
      their sums.
    - Step: each rank writes the misses it owns into its cells and reads
      its data slice's rows with the two-source gather (K2, or K3 for uint8
      cells) over [its cells | the buffer]: a foreign cell reads -1, a zero
      row, and only model rank 0 serves buffer rows; one all-reduce over
      the model group gives the rows, which become the autograd leaf (the
      psum route's `_Lookup`).  The loss and the dense grads take one
      all-reduce over the data group (`parallel/sharded.py::
      mean_over_data`); the rows' grads, divided by n_data, one all-gather
      over it, and every replica of a shard applies the same rwsadagrad
      (K5) to its cells and to the whole buffer, a foreign cell's id
      PAD_ROW.  uint8 cells re-encode with stochastic rounding seeded by
      the step and the model index (model rank 0 takes the one-device
      seed), not the data index, so the replicas of a shard hold the same
      bytes.
    - Write-backs: the ranks of data row 0 read the dying cells they own
      (zero rows elsewhere) and a reduce over the model group delivers
      them to rank 0, which writes the masters; the buffer rows go back
      from rank 0's copy.  `flush_to_host` lands the resident cells the
      same way, at most Cl at a time; `save`, `export_ev_tables` and
      `flush_files` then write the one-device class's files on rank 0.
    - Drivers: `train_batch`.  `train_batches` and `train_batches_windowed`
      yield its per-batch stream, which is the pipelined and windowed
      trajectory (JAX's `run_cached_training` drives its sharded class
      one batch at a time too).

    At world 1 it equals `TrainableDeviceCache` bit for bit."""

    def __init__(self, cfg: DLRMConfig, tcfg: TrainConfig, ccfg: CacheConfig,
                 tables: Optional[Sequence], mesh, eps: float = 1e-10,
                 copy_tables: bool = True):
        self.mesh = mesh
        self.n_cache_shards = mesh.n_model
        if ccfg.total_size % self.n_cache_shards:
            raise ValueError(f"capacity {ccfg.total_size} must divide the "
                             f"{self.n_cache_shards}-shard model axis")
        self.c_local = ccfg.total_size // self.n_cache_shards
        self.r0 = mesh.m * self.c_local
        super().__init__(cfg, tcfg, ccfg, tables, eps=eps,
                         copy_tables=copy_tables, device=mesh.device)

    @classmethod
    def from_files(cls, cfg: DLRMConfig, tcfg: TrainConfig, ccfg: CacheConfig,
                   bin_dir: str, table_sizes: Sequence[int], mesh=None,
                   **kw):
        """The masters mapped from the .bin files by rank 0 (the other
        ranks read no file)."""
        tables = moms = None
        if mesh.rank == 0:
            tables, moms = _map_files(bin_dir, table_sizes,
                                      cfg.embedding_dim)
        obj = cls(cfg, tcfg, ccfg, tables, mesh, copy_tables=False, **kw)
        if moms is not None:
            obj.host_mom = moms
        return obj

    def _holds_masters(self) -> bool:
        return self.mesh.rank == 0

    def _cell_layout(self):
        return self.c_local, 1          # a scratch row for foreign misses

    # ------------------------------------------------------ the step hooks

    def _own(self, gi: torch.Tensor):
        """(whether each global cell id is this rank's, its local cell)."""
        loc = gi.long() - self.r0
        return (loc >= 0) & (loc < self.c_local), loc

    def _scatter_rows(self, scat_slots: torch.Tensor) -> torch.Tensor:
        own, loc = self._own(scat_slots)
        return torch.where(own, loc, self.c_local)      # the scratch row

    def _read_ids(self, gi: torch.Tensor) -> torch.Tensor:
        lo, hi = _slice(gi.shape[0], self.mesh)
        g = gi[lo:hi].long()
        own, loc = self._own(g)
        C = self.capacity
        serve = (g >= C) & (self.mesh.m == 0)
        return torch.where(own, loc, torch.where(
            serve, g - C + self._cells, -1)).to(torch.int32)

    def _exchange(self, rows: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(rows, group=self.mesh.model_group)
        return rows

    def _mean_over_data(self, loss: torch.Tensor, params) -> torch.Tensor:
        return mean_over_data(loss, params, self.mesh)

    def _row_grads(self, gi: torch.Tensor, grad: torch.Tensor):
        n = self.mesh.n_data
        g = _all_gather_cat(grad, self.mesh.data_group, n) / n
        own, loc = self._own(gi)
        ids = torch.where(own, loc, torch.where(
            gi.long() >= self.capacity, gi.long() - self.capacity
            + self._cells, INT32_MAX))
        return ids.reshape(-1), g.reshape(-1, self.dim)

    def _sr_seed(self, seed: int) -> int:
        return seed + (self.mesh.m << 40)

    # ------------------------------------------------------ the host side

    def _land_cells(self, slots: torch.Tensor, keys) -> None:
        """The current rows and sums of the cells `slots` (global ids on
        every rank's device) into rank 0's masters at `keys` (packed
        table << 40 | row, on rank 0): each rank of data row 0 reads the
        cells it owns, zeros elsewhere, and a sum over its model group
        gives rank 0 every one (collective over data row 0)."""
        if slots.numel() == 0 or self.mesh.d != 0:
            return
        own, loc = self._own(slots)
        rows = self._read_slots(torch.where(own, loc, -1).to(torch.int32))
        sums = torch.where(own, self._mom[torch.where(own, loc, 0)], 0.0)
        both = torch.cat([rows, sums[:, None]], dim=1)
        dist.reduce(both, dst=0, group=self.mesh.model_group)
        if self.host_tables is not None:
            arr = both.cpu().numpy()
            keys = np.asarray(keys, np.int64)
            self._write_masters((keys >> 40).astype(np.int32),
                                keys & KEY_ROW, arr[:, :self.dim],
                                arr[:, self.dim])

    def train_batch(self, model, dstate, step_idx: int, dense_x, idx,
                    labels):
        """One step of the global batch on every rank (see the class):
        -> (model, dstate, the global batch's loss)."""
        self._check_model(model)
        idx = np.asarray(idx)
        check_ids(idx, self.cfg.table_sizes)
        B, T = idx.shape
        D, mesh = self.dim, self.mesh
        head = ints = ev_keys = None
        if self.assigner is not None:
            (gather_idx, scat_slots, scat_m, M, ev_keys, ev_slots, buf_t,
             buf_r) = self._assign(idx)
            head = (len(scat_slots), M, len(ev_slots))
            ints = np.concatenate([gather_idx.ravel(), scat_slots, scat_m,
                                   ev_slots]).astype(np.int32, copy=False)
        n_s, M, E = broadcast_header(head, 3, mesh)
        ints = broadcast_array(ints, (B * T + 2 * n_s + E,), torch.int32,
                               mesh)
        o = B * T
        gi, ss, sm, es = (ints[:o].view(B, T), ints[o:o + n_s],
                          ints[o + n_s:o + 2 * n_s], ints[o + 2 * n_s:])
        # before the read: a key evicted and missed again in this batch
        # must read its updated value
        t0 = time.perf_counter()
        self._land_cells(es, ev_keys)
        self.host_s["land"] += time.perf_counter() - t0
        floats = None
        if self.assigner is not None:
            rows, moms = self._fetch(buf_t, buf_r)
            floats = np.concatenate([rows.reshape(-1), moms])
        floats = broadcast_array(floats, (M * (D + 1),), torch.float32, mesh)
        t0 = time.perf_counter()
        self._reserve(M)
        C = self._cells
        with torch.no_grad():
            self._buf[:M] = floats[:M * D].view(M, D)
            self._mom[C:C + M] = floats[M * D:]
        lo, hi = _slice(B, mesh)
        dense_x = np.asarray(dense_x, np.float32)[lo:hi]
        labels = np.asarray(labels, np.float32)[lo:hi]
        _, (dx, lb) = self._upload([], [dense_x, labels])
        loss = self._step(model, dstate, gi, ss, sm, dx.view(dense_x.shape),
                          lb.view(labels.shape),
                          float(self.lr_fn(step_idx)), int(step_idx))
        # the dying cells may have taken this batch's updates
        self._land_cells(es, ev_keys)
        if self.host_tables is not None:
            # then the buffer rows that are not cached
            nonres = np.ones(M, bool)
            nonres[scat_m[scat_m < M]] = False
            nb = self._buf[:M].cpu().numpy()
            nbm = self._mom[C:C + M].cpu().numpy()
            self._write_masters(buf_t[nonres], buf_r[nonres], nb[nonres],
                                nbm[nonres])
        self.host_s["step"] += time.perf_counter() - t0
        return model, dstate, loss

    def train_batches(self, model, dstate, batches, start_step: int = 1):
        """`train_batch` over (dense, idx, labels) batches: yields (model,
        dstate, loss) per batch."""
        for k, (dense_x, idx, labels) in enumerate(batches):
            yield self.train_batch(model, dstate, start_step + k, dense_x,
                                   idx, labels)

    def train_batches_windowed(self, model, dstate, batches,
                               window: int = 16, start_step: int = 1):
        """The per-batch stream (`train_batches`): the windowed driver's
        trajectory is the per-batch one."""
        del window
        return self.train_batches(model, dstate, batches, start_step)

    def flush_to_host(self):
        """Land every resident cell in rank 0's masters, at most Cl cells
        at a time (collective)."""
        keys = slots = None
        if self.assigner is not None:
            keys, slots = self.assigner.resident_keys()
        n, = broadcast_header(None if slots is None else (len(slots),), 1,
                              self.mesh)
        slots = broadcast_array(slots, (n,), torch.int32, self.mesh)
        for a in range(0, n, self.c_local):
            self._land_cells(slots[a:a + self.c_local],
                             None if keys is None
                             else keys[a:a + self.c_local])
