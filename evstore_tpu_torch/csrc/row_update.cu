// Sorted row updates of embedding tables over a group of tables, for Hopper
// (sm_90a): the subtract rule (`scatter_sub_sorted`: sgd, adagrad's second
// launch) and rwsadagrad's row-wise rule, fused (`rwsadagrad_sorted`).
//
// Replaces the TPU kernel evstore_tpu/ops/pallas_update.py::
// _sub_sweep_kernel (reached through rwsadagrad_row_update_pallas).  The
// tables of a group share one global row space: table t holds the global
// ids [bases[t], bases[t+1]).  Over K entries sorted by global id, in place,
// the subtract rule does
//
//   table_t[r - bases[t]] -= G_r = sum of vals[k] over the run rows[k] == r
//
// for every r in [0, bases[T]).  The row-wise rule takes the grads unsorted,
// entry k's values being grads[order[k]], and with the run sums G_r taken
// the same way, in the same order, does
//
//   st = state[r] + sum_d G_r[d]^2 / D;  state[r] = st;
//   table_t[r - bases[t]][d] -= lr * G_r[d] / (sqrt(st) + eps)
//
// so that no run sum reaches device memory.  Ids outside [0, bases[T])
// (PAD_ROW = INT32_MAX, negative ids) are inert.  One table is the group of
// T = 1.  f32 and bf16 tables (one type per group); the values are f32 and
// each row rounds once, at its store.  The descriptor `desc` is int64
// [2T + 1]: the T tables' base addresses, then the T + 1 cumulative row
// offsets.
//
// Bound on this card: bytes, and only those of the batch (K ids and K x D
// values read once, each distinct row read and written once; the row-wise
// rule adds the order and the state); the TPU kernel sweeps the whole
// table.  The design answers three things:
//
// - The Zipf head.  Ids are skewed: at K = 65,536 zipf(1.05) one run holds
//   3,819 entries.  So the work is cut by entries, not by runs: block c
//   takes the fixed chunk [c E, (c + 1) E) of the sorted list (E = 128, a
//   thread an entry), whatever the ids, and a long run is spread over
//   ceil(run / E) blocks.  Each warp sums every run's columns by a
//   segmented scan over its 32 lanes (shuffles), so every lane works
//   whatever D is; runs that cross warps are chained in shared memory in
//   warp order.  A run that lies inside the chunk is finished by the chunk,
//   once.  A run that crosses a chunk boundary leaves its partial sums in
//   scratch [n_chunks, 2, D] (slot 0: the chunk's first run, begun in an
//   earlier chunk; slot 1: its last run, begun here and going on); a second
//   small kernel lets the chunk where such a run begins add the partials in
//   chunk order (compensated) and finish the row once.  The order of every
//   sum is fixed by the ids alone, so the result is bit-deterministic from
//   run to run, and no two threads write one row or one state: no atomics,
//   and an inert run touches nothing.
// - The subtract rule's tiles.  Its block stages its values (contiguous)
//   and the old values of the rows it writes in shared memory 40 columns at
//   a time, with 4-byte cp.async all in flight at once, and writes each
//   tile of the rows as soon as it is summed, coalesced.
// - The row-wise rule's width.  It needs every column of a run before it
//   may write one (the mean of G^2), so its block keeps all D columns of
//   the chunk in dynamic shared memory: each entry's grad row, contiguous,
//   comes from grads[order[k]] by cp.async (16-byte units where D % 4 == 0
//   and the rows are aligned), E x D x 4 bytes, 66 KB at D = 128.  A width
//   whose chunk does not fit (D above 444) takes the wrapper's composite
//   path.  The rows and states of the runs that begin and end in the chunk
//   are asked of L2 while the grads come in; those runs then take the rule
//   a sub-warp a run (a power of two of lanes that covers the row), four
//   runs in flight each: G^2 summed in a fixed order, the state and the row
//   read once and written once.  The second kernel gives each chunk
//   that owns a crossing run one warp, its lanes over the columns, which
//   adds the partials as the subtract rule's does and applies the rule.
// - The launch floor.  The training step updates all 26 tables with one
//   call here (global ids), not one per table, and the row-wise rule is one
//   call, not two and the ~30 tensor passes between them.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using evstore::from_f32;
using evstore::load_f32;
using evstore::store_f32;
using evstore::to_f32;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int CHUNK = THREADS;  // sorted entries a block; the wrapper's CHUNK
constexpr int TILE = 40;        // columns staged at once
constexpr int STRIDE = TILE + 1;  // odd: a lane's row, read across lanes,
                                  // hits 32 banks
constexpr unsigned FULL = 0xffffffffu;
// the row-wise rule: its dynamic shared memory at most (the block's static
// arrays, under 3 KB, keep the rest of the 227 KB; the wrapper's
// ROWWISE_SMEM), and the runs a sub-warp applies at once
constexpr int ROWWISE_SMEM = evstore::kMaxDynamicSmem - 4096;
constexpr int IN_FLIGHT = 4;

// The table of global id r, for 0 <= r < bases[T]: the largest t with
// bases[t] <= r (an empty table is never chosen).
__device__ __forceinline__ int find_table(const int64_t* bases, int T,
                                          int64_t r) {
  int lo = 0, hi = T;  // bases[lo] <= r < bases[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(bases + mid) <= r) lo = mid; else hi = mid;
  }
  return lo;
}

template <typename T>
__device__ __forceinline__ T* row_of(const int64_t* desc, int nt, int D,
                                     int64_t r) {
  const int t = find_table(desc + nt, nt, r);
  return (T*)(uintptr_t)__ldg(desc + t) + (r - __ldg(desc + nt + t)) * D;
}

// Steps (e, d) through a row-major [., W] block THREADS elements at a time.
struct Walk {
  int e, d, de, dd, W;
  __device__ Walk(int i, int W_) : e(i / W_), d(i % W_), de(THREADS / W_),
                                   dd(THREADS % W_), W(W_) {}
  __device__ void next() {
    e += de;
    d += dd;
    if (d >= W) { d -= W; ++e; }
  }
};

// What a block learns of its chunk's runs from the ids alone (shared
// memory).  head: the warp's first run began before it (slot 0 filled);
// tail: its last run began in it and goes on (slot 1 filled); pass: the
// warp is one run, begun before it and going on past it.
struct ChunkRuns {
  int16_t slot[WARPS][2];  // the lanes of slots 0 and 1
  int count[WARPS];        // the runs that lie in the warp
  bool head[WARPS], tail[WARPS], pass[WARPS];
};

// One thread's entry of the chunk.
struct Entry {
  int64_t start;  // the chunk's first entry
  int n;          // the chunk's entries
  bool valid;     // the thread has an entry
  int32_t r;      // its id
  int dist;       // its distance from its run's first lane in the warp
  int role;       // of a run's last lane: 0 none, 1 finish the run (it lies
                  // in the warp), 2 slot 0, 3 slot 1
  int n1, k;      // the block's role-1 lanes; this lane's place among them
};

// Block c's chunk [c CHUNK, (c + 1) CHUNK), a lane an entry.  From the ids
// alone each run's last lane in a warp learns its role: finish its run
// (the run lies in the warp), or leave a partial for a run that crosses
// the warp (slot 0: the warp's first run, begun before it; slot 1: its
// last run, begun in it and going on).  Ends with a __syncthreads().
__device__ __forceinline__ Entry chunk_runs(const int64_t* desc, int nt,
                                            const int32_t* rows, int64_t K,
                                            ChunkRuns& s) {
  Entry q;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  q.start = (int64_t)blockIdx.x * CHUNK;
  q.n = (int)min((int64_t)CHUNK, K - q.start);
  const int nw = max(0, min(32, q.n - 32 * w));  // the warp's entries
  const int64_t e = q.start + tid;
  q.valid = lane < nw;
  q.r = q.valid ? __ldg(rows + e) : 0;
  const bool head = q.valid && (e == 0 || __ldg(rows + e - 1) != q.r);
  // each lane's segment start within the warp (lane 0 starts one always)
  const unsigned heads = __ballot_sync(FULL, head);
  const int seg = 31 - __clz((heads | 1u) & (FULL >> (31 - lane)));
  q.dist = lane - seg;
  const bool after = q.valid && e + 1 < K && __ldg(rows + e + 1) == q.r;
  const bool live = q.valid && !(lane < nw - 1 && after) && q.r >= 0 &&
                    (int64_t)q.r < __ldg(desc + 2 * nt);  // a run's last lane
  const bool before = seg == 0 && !(heads & 1u);   // begun before the warp
  q.role = !live ? 0 : before ? 2 : after ? 3 : 1;
  const unsigned r1 = __ballot_sync(FULL, q.role == 1);
  const unsigned r2 = __ballot_sync(FULL, q.role == 2);
  const unsigned r3 = __ballot_sync(FULL, q.role == 3);
  const unsigned cont = __ballot_sync(FULL, q.valid && lane == nw - 1 &&
                                                after);
  if (lane == 0) {
    s.count[w] = __popc(r1);
    s.head[w] = r2 != 0;
    s.tail[w] = r3 != 0;
    s.pass[w] = heads == 0 && cont != 0;
  }
  if (q.role >= 2) s.slot[w][q.role - 2] = (int16_t)tid;
  __syncthreads();
  q.n1 = 0;
  q.k = 0;
  for (int w2 = 0; w2 < WARPS; ++w2) {
    if (w2 == w) q.k = q.n1 + __popc(r1 & ((1u << lane) - 1u));
    q.n1 += s.count[w2];
  }
  return q;
}

// Chains, for column d of the summed rows `sv` (row stride `stride`), the
// partials of the runs that cross warp boundaries, in warp order, as
// thread (w0, d): if w0 == 0 and the block's first run began before it,
// its partial goes to slot0[d]; if a run begins in warp w0 and goes on,
// its partial goes to slot1[d] if it goes past the block, else its sum to
// done(w_end, sum), w_end the warp where it ends.
template <typename Done>
__device__ __forceinline__ void chain_warps(const ChunkRuns& s,
                                            const float* sv, int stride,
                                            int w0, int d, float* slot0,
                                            float* slot1, Done done) {
  if (w0 == 0 && s.head[0]) {  // the block's first run began before it
    float acc = sv[s.slot[0][0] * stride + d];
    bool on = s.pass[0];
    for (int w2 = 0; on && w2 + 1 < WARPS;) {
      acc += sv[s.slot[++w2][0] * stride + d];
      on = s.pass[w2];
    }
    slot0[d] = acc;
  }
  if (s.tail[w0]) {  // a run begins in warp w0 and goes on
    float acc = sv[s.slot[w0][1] * stride + d];
    bool on = true;    // the run goes on past warp w2
    int w2 = w0;
    while (on && w2 + 1 < WARPS) {
      acc += sv[s.slot[++w2][0] * stride + d];
      on = s.pass[w2];
    }
    if (on) {  // past the block too: the cross-chunk pass's
      slot1[d] = acc;
    } else {
      done(w2, acc);
    }
  }
}

// The subtract rule.  After `chunk_runs`, asynchronous copies bring, all
// in flight at once, the chunk's values (coalesced) and the old values of
// the rows to be written into shared memory, a tile of columns at a time;
// a segmented scan over each warp's lanes (5 shuffles a column) leaves
// each run's sum in its last lane's row there; the rows are written
// coalesced, a thread a (row, column); and one thread a (warp, column)
// chains the partials in warp order: it writes the row of a run that ends
// in the block, or leaves the block's partial in scratch for the
// cross-chunk pass.  The loops stay loops: the kernel's code is small, as
// a launch of one block waits on its instruction fetch.
template <typename T>
__global__ void __launch_bounds__(THREADS)
chunk_sums_kernel(const int64_t* __restrict__ desc, int nt, int D,
                  const int32_t* __restrict__ rows,
                  const float* __restrict__ vals, int64_t K,
                  float* __restrict__ scratch) {
  __shared__ float s_v[CHUNK * STRIDE];  // the values, then the run sums
  __shared__ __align__(16) T s_old[CHUNK * TILE];  // old values, written rows
  __shared__ T* s_dst[CHUNK];            // the rows the warps write, and
  __shared__ int16_t s_src[CHUNK];       // their run-end lanes
  __shared__ T* s_tail_row[WARPS];
  __shared__ ChunkRuns s;
  const int tid = threadIdx.x, w = tid >> 5;
  const int64_t c = blockIdx.x;
  const Entry q = chunk_runs(desc, nt, rows, K, s);
  const int n = q.n, n1 = q.n1;
  if (q.role == 1) {
    s_dst[q.k] = row_of<T>(desc, nt, D, q.r);
    s_src[q.k] = (int16_t)tid;
  } else if (q.role == 3) {
    s_tail_row[w] = row_of<T>(desc, nt, D, q.r);
  }
  __syncthreads();

  for (int c0 = 0; c0 < D; c0 += TILE) {
    const int W = min(TILE, D - c0);
    // the copies, all in flight at once
    for (Walk it(tid, W); it.e < n; it.next())
      __pipeline_memcpy_async(s_v + it.e * STRIDE + it.d,
                              vals + (q.start + it.e) * D + c0 + it.d, 4);
    constexpr int PER = 4 / sizeof(T);  // table elements a 4-byte copy
    if (W % PER == 0 && D % PER == 0) {
      for (Walk it(tid, W / PER); it.e < n1; it.next())
        __pipeline_memcpy_async(s_old + it.e * W + it.d * PER,
                                s_dst[it.e] + c0 + it.d * PER, 4);
    } else {  // an odd width of 2-byte elements
      for (Walk it(tid, W); it.e < n1; it.next())
        s_old[it.e * W + it.d] = s_dst[it.e][c0 + it.d];
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    // segmented inclusive scan over the lanes, column by column: after the
    // step of `off`, lane l holds the sum over [max(seg, l - 2 off + 1), l]
    float* mine = s_v + tid * STRIDE;
#pragma unroll 4
    for (int j = 0; j < W; ++j) {
      float x = q.valid ? mine[j] : 0.0f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(FULL, x, off);
        if (q.dist >= off) x += y;
      }
      mine[j] = x;
    }
    __syncthreads();
    for (Walk it(tid, W); it.e < n1; it.next()) {
      T* p = s_dst[it.e] + c0 + it.d;
      *p = from_f32<T>(to_f32(s_old[it.e * W + it.d]) -
                       s_v[s_src[it.e] * STRIDE + it.d]);
    }
    for (int u = tid; u < WARPS * W; u += THREADS) {
      const int w0 = u / W, d = u - w0 * W;
      chain_warps(s, s_v, STRIDE, w0, d, scratch + (c * 2) * D + c0,
                  scratch + (c * 2 + 1) * D + c0, [&](int, float acc) {
                    T* p = s_tail_row[w0] + c0 + d;
                    *p = from_f32<T>(to_f32(*p) - acc);
                  });
    }
    __syncthreads();
  }
}

// Asks L2 for a run's row (D elements at `row`) and its state word ahead
// of their use, so that they come in while the chunk's grads do.
template <typename T>
__device__ __forceinline__ void prefetch_run(const T* row, int D,
                                             const float* st) {
  const char* p = (const char*)row;
  const int bytes = D * (int)sizeof(T);
  for (int o = 0; o < bytes; o += 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p + o));
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p + bytes - 1));
  asm volatile("prefetch.global.L2 [%0];" ::"l"(st));
}

// A staged row's stride in floats for the row-wise rule: an odd number of
// V-float units, so that the lanes of a warp, a row each, reading V floats
// at a time spread over the banks.
template <int V>
__host__ __device__ __forceinline__ int rowwise_stride(int D) {
  return V * ((D / V) | 1);
}

// The row-wise rule (V = 4: 16-byte staging and vector rows; V = 1:
// 4-byte).  After `chunk_runs` the block lists the runs it finishes (its
// role-1 lanes, and each run chained from one warp to a later one), asks
// L2 for their rows and states, and brings each entry's grad row
// grads[order[k]] into s_v [CHUNK][SV], all in flight at once; the same scan as the subtract rule's, over every
// column, and the same chain leave each run's sum G in the row of its last
// lane (a chained run: its last warp's slot 0 lane); a run that crosses
// the chunk leaves its partials in scratch.  Then sub-warps of SW lanes
// finish the listed runs, IN_FLIGHT at once: G^2 summed over the lanes'
// columns in order, a butterfly, and the first lane's total taken by all;
// the state read, the row read and written coalesced, the state written.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
chunk_sums_kernel(const int64_t* __restrict__ desc, int nt, int D, int SV,
                  const int32_t* __restrict__ rows,
                  const int64_t* __restrict__ order,
                  const float* __restrict__ grads, float* __restrict__ state,
                  float lr, float eps, int64_t K,
                  float* __restrict__ scratch) {
  extern __shared__ __align__(16) float s_v[];  // the grads, then the sums
  __shared__ int64_t s_ord[CHUNK];
  // the runs the block finishes: the row of s_v that holds the sum (-1:
  // none), the id and its table row; the role-1 lanes' first, then one a
  // warp
  __shared__ int16_t s_src[CHUNK + WARPS];
  __shared__ int32_t s_gid[CHUNK + WARPS];
  __shared__ T* s_dst[CHUNK + WARPS];
  __shared__ ChunkRuns s;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int64_t c = blockIdx.x;
  const Entry q = chunk_runs(desc, nt, rows, K, s);
  if (tid < q.n) s_ord[tid] = __ldg(order + q.start + tid);
  if (q.role == 1) {
    T* row = row_of<T>(desc, nt, D, q.r);
    s_src[q.k] = (int16_t)tid;
    s_gid[q.k] = q.r;
    s_dst[q.k] = row;
    prefetch_run(row, D, state + q.r);
  }
  if (tid < WARPS) {  // the run begun in warp tid that ends in a later one
    int src = -1;
    if (s.tail[tid]) {
      int w2 = tid;
      bool on = true;
      while (on && w2 + 1 < WARPS) on = s.pass[++w2];
      if (!on) src = s.slot[w2][0];
    }
    s_src[q.n1 + tid] = (int16_t)src;
    if (src >= 0) {
      const int32_t r = __ldg(rows + q.start + src);
      T* row = row_of<T>(desc, nt, D, r);
      s_gid[q.n1 + tid] = r;
      s_dst[q.n1 + tid] = row;
      prefetch_run(row, D, state + r);
    }
  }
  __syncthreads();

  // the chunk's grad rows, all in flight at once
  for (Walk it(tid, D / V); it.e < q.n; it.next())
    __pipeline_memcpy_async(s_v + it.e * SV + it.d * V,
                            grads + s_ord[it.e] * D + it.d * V, 4 * V);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  // the segmented scan, V columns at a time, each as the subtract rule's
  float* mine = s_v + tid * SV;
  for (int j = 0; j < D; j += V) {
    float x[V];
    if (q.valid) {
      load_f32<V>(mine + j, x);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) x[v] = 0.0f;
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(FULL, x[v], off);
        if (q.dist >= off) x[v] += y;
      }
    }
    store_f32<V>(mine + j, x);
  }
  __syncthreads();
  for (int u = tid; u < WARPS * D; u += THREADS) {
    const int w0 = u / D, d = u - w0 * D;
    chain_warps(s, s_v, SV, w0, d, scratch + (c * 2) * D,
                scratch + (c * 2 + 1) * D, [&](int w_end, float acc) {
                  s_v[s.slot[w_end][0] * SV + d] = acc;
                });
  }
  __syncthreads();

  // the rule: a sub-warp of SW lanes a run, IN_FLIGHT runs at once
  int SW = 1;
  while (SW < 32 && SW * V < D) SW <<= 1;
  const int sub = lane / SW, sl = lane & (SW - 1);
  const int n_done = q.n1 + WARPS;
  const int per_warp = 32 / SW * IN_FLIGHT;
  for (int j0 = w * per_warp; j0 < n_done; j0 += WARPS * per_warp) {
    int src[IN_FLIGHT];
    int32_t gid[IN_FLIGHT];
    T* dst[IN_FLIGHT];
    float sq[IN_FLIGHT];
#pragma unroll
    for (int b = 0; b < IN_FLIGHT; ++b) {
      const int j = j0 + sub * IN_FLIGHT + b;
      src[b] = j < n_done ? s_src[j] : -1;
      gid[b] = src[b] >= 0 ? s_gid[j] : 0;
      dst[b] = src[b] >= 0 ? s_dst[j] : nullptr;
      float acc = 0.0f;
      if (src[b] >= 0) {
        const float* g = s_v + src[b] * SV;
        for (int d0 = sl * V; d0 < D; d0 += SW * V) {
          float x[V];
          load_f32<V>(g + d0, x);
#pragma unroll
          for (int v = 0; v < V; ++v) acc += x[v] * x[v];
        }
      }
      for (int off = SW >> 1; off > 0; off >>= 1)
        acc += __shfl_xor_sync(FULL, acc, off);
      sq[b] = __shfl_sync(FULL, acc, 0, SW);  // one lane's total for all
    }
    float st[IN_FLIGHT], den[IN_FLIGHT];
#pragma unroll
    for (int b = 0; b < IN_FLIGHT; ++b)
      st[b] = src[b] >= 0 ? state[gid[b]] : 0.0f;
#pragma unroll
    for (int b = 0; b < IN_FLIGHT; ++b) {
      st[b] += sq[b] / (float)D;
      den[b] = sqrtf(st[b]) + eps;
    }
    for (int d0 = sl * V; d0 < D; d0 += SW * V) {
      float old[IN_FLIGHT][V];
#pragma unroll
      for (int b = 0; b < IN_FLIGHT; ++b)
        if (src[b] >= 0) load_f32<V>(dst[b] + d0, old[b]);
#pragma unroll
      for (int b = 0; b < IN_FLIGHT; ++b) {
        if (src[b] < 0) continue;
        float x[V];
        load_f32<V>(s_v + src[b] * SV + d0, x);
#pragma unroll
        for (int v = 0; v < V; ++v) x[v] = old[b][v] - (lr * x[v]) / den[b];
        store_f32<V>(dst[b] + d0, x);
      }
    }
    if (sl == 0) {
#pragma unroll
      for (int b = 0; b < IN_FLIGHT; ++b)
        if (src[b] >= 0) state[gid[b]] = st[b];
    }
  }
}

// The sum, for column d, of the run r that chunk c owns (it begins in c
// and goes on past it): `first`, c's slot 1, then the slot 0 of each
// following chunk the run reaches, in chunk order, Kahan-compensated.
__device__ __forceinline__ float run_sum(const float* scratch,
                                         const int32_t* rows, int64_t K,
                                         int64_t n_chunks, int D, int64_t c,
                                         int d, int32_t r, float first) {
  float acc = first, comp = 0.0f;
  constexpr int AHEAD = 16;  // chunks whose partials are loaded at once
  bool more = true;
  for (int64_t c2 = c + 1; more; c2 += AHEAD) {
    float part[AHEAD];
    bool goes_on[AHEAD];
#pragma unroll
    for (int j = 0; j < AHEAD; ++j) {
      const int64_t cj = c2 + j;
      const int64_t ej = min((cj + 1) * CHUNK, K);
      part[j] = cj < n_chunks ? __ldg(scratch + cj * 2 * D + d) : 0.0f;
      goes_on[j] = cj < n_chunks && ej < K && __ldg(rows + ej) == r;
    }
#pragma unroll
    for (int j = 0; j < AHEAD; ++j) {
      if (!more) break;
      const float y = part[j] - comp;  // Kahan-compensated
      const float t = acc + y;
      comp = (t - acc) - y;
      acc = t;
      more = goes_on[j];
    }
  }
  return acc;
}

// The id of the run chunk c owns, or -1: the chunk's last run, if it
// begins in c, goes on past it and is a row of the group.
__device__ __forceinline__ int64_t owned_run(const int64_t* desc, int nt,
                                             const int32_t* rows, int64_t K,
                                             int64_t c) {
  const int64_t start = c * CHUNK, end = min(start + CHUNK, K);
  const int32_t r = __ldg(rows + end - 1);
  if (end >= K || __ldg(rows + end) != r) return -1;         // ends here
  if (start > 0 && __ldg(rows + start - 1) == r) return -1;  // not its start
  if (r < 0 || (int64_t)r >= __ldg(desc + 2 * nt)) return -1;  // inert
  return r;
}

// The subtract rule's second pass: one thread per (chunk, column); the
// owner of a crossing run adds its partials and writes the row.
template <typename T>
__global__ void __launch_bounds__(THREADS)
cross_chunk_kernel(const int64_t* __restrict__ desc, int nt, int D,
                   const int32_t* __restrict__ rows, int64_t K,
                   int64_t n_chunks, const float* __restrict__ scratch) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_chunks * D) return;
  const int64_t c = i / D;
  const int d = (int)(i - c * D);
  const int64_t r = owned_run(desc, nt, rows, K, c);
  if (r < 0) return;
  const float acc = run_sum(scratch, rows, K, n_chunks, D, c, d, (int32_t)r,
                            __ldg(scratch + (c * 2 + 1) * D + d));
  T* dst = row_of<T>(desc, nt, D, r) + d;
  *dst = from_f32<T>(to_f32(*dst) - acc);
}

// The row-wise rule's second pass: one warp per chunk, its lanes over the
// columns.  The owner of a crossing run adds its partials as the subtract
// rule's pass does, keeping each column's sum in its own slot 1 (no other
// chunk reads it), then applies the rule as the first kernel does.
template <typename T>
__global__ void __launch_bounds__(THREADS)
cross_chunk_kernel(const int64_t* __restrict__ desc, int nt, int D,
                   const int32_t* __restrict__ rows, int64_t K,
                   int64_t n_chunks, float* __restrict__ scratch,
                   float* __restrict__ state, float lr, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t c = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (c >= n_chunks) return;
  const int64_t r = owned_run(desc, nt, rows, K, c);  // one for the warp
  if (r < 0) return;
  float* own = scratch + (c * 2 + 1) * D;
  float sq = 0.0f;
  for (int d = lane; d < D; d += 32) {
    const float g = run_sum(scratch, rows, K, n_chunks, D, c, d, (int32_t)r,
                            own[d]);
    own[d] = g;
    sq += g * g;
  }
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(FULL, sq, off);
  sq = __shfl_sync(FULL, sq, 0);
  const float st = state[r] + sq / (float)D;
  const float den = sqrtf(st) + eps;
  T* row = row_of<T>(desc, nt, D, r);
  for (int d = lane; d < D; d += 32)
    row[d] = from_f32<T>(to_f32(row[d]) - (lr * own[d]) / den);
  if (lane == 0) state[r] = st;
}

template <typename T>
void launch(const int64_t* desc, int nt, int D, const int32_t* rows,
            const float* vals, int64_t K, float* scratch, int64_t n_chunks,
            cudaStream_t st) {
  chunk_sums_kernel<T><<<(unsigned)n_chunks, THREADS, 0, st>>>(
      desc, nt, D, rows, vals, K, scratch);
  if (n_chunks > 1) {
    const int64_t blocks = (n_chunks * D + THREADS - 1) / THREADS;
    cross_chunk_kernel<T><<<(unsigned)blocks, THREADS, 0, st>>>(
        desc, nt, D, rows, K, n_chunks, scratch);
  }
}

template <typename T, int V>
int launch_rowwise(const int64_t* desc, int nt, int D, const int32_t* rows,
                   const int64_t* order, const float* grads, float* state,
                   float lr, float eps, int64_t K, float* scratch,
                   int64_t n_chunks, int device, cudaStream_t st) {
  const int SV = rowwise_stride<V>(D);
  const int64_t smem = (int64_t)CHUNK * SV * 4;
  if (smem > ROWWISE_SMEM) return (int)cudaErrorInvalidValue;
  // the row-wise overload of the name, as a pointer
  void (*kernel)(const int64_t*, int, int, int, const int32_t*,
                 const int64_t*, const float*, float*, float, float, int64_t,
                 float*) = chunk_sums_kernel<T, V>;
  // raise the block's dynamic shared memory limit once per device
  static bool ready[64] = {};
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ROWWISE_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    ready[device] = true;
  }
  kernel<<<(unsigned)n_chunks, THREADS, (size_t)smem, st>>>(
      desc, nt, D, SV, rows, order, grads, state, lr, eps, K, scratch);
  if (n_chunks > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cross_chunk_kernel<T><<<(unsigned)((n_chunks + WARPS - 1) / WARPS),
                            THREADS, 0, st>>>(desc, nt, D, rows, K, n_chunks,
                                              scratch, state, lr, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int scatter_sub_sorted(const void* desc, int nt, int D,
                                  const void* rows, const void* vals,
                                  int64_t K, void* scratch,
                                  int64_t scratch_chunks, int is_bf16,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t n_chunks = (K + CHUNK - 1) / CHUNK;
  if (K <= 0 || nt < 1 || D < 1 || n_chunks > 0x7fffffff ||
      (n_chunks > 1 && n_chunks > scratch_chunks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    launch<__nv_bfloat16>((const int64_t*)desc, nt, D, (const int32_t*)rows,
                          (const float*)vals, K, (float*)scratch, n_chunks,
                          st);
  } else {
    launch<float>((const int64_t*)desc, nt, D, (const int32_t*)rows,
                  (const float*)vals, K, (float*)scratch, n_chunks, st);
  }
  return (int)cudaGetLastError();
}

// vec: 16-byte staging and vector rows (D % 4 == 0, the grads 16-byte and
// the tables' rows 4-element aligned; the wrapper checks the tables).
extern "C" int rwsadagrad_sorted(const void* desc, int nt, int D,
                                 const void* rows, const void* order,
                                 const void* grads, void* state, int64_t K,
                                 float lr, float eps, void* scratch,
                                 int64_t scratch_chunks, int is_bf16,
                                 int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t n_chunks = (K + CHUNK - 1) / CHUNK;
  if (K <= 0 || nt < 1 || D < 1 || n_chunks > 0x7fffffff ||
      (n_chunks > 1 && n_chunks > scratch_chunks) ||
      (vec && (D % 4 != 0 || (uintptr_t)grads % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t* d_ = (const int64_t*)desc;
  const int32_t* r_ = (const int32_t*)rows;
  const int64_t* o_ = (const int64_t*)order;
  const float* g_ = (const float*)grads;
  float* s_ = (float*)state;
  float* x_ = (float*)scratch;
  if (is_bf16) {
    return vec ? launch_rowwise<__nv_bfloat16, 4>(d_, nt, D, r_, o_, g_, s_,
                                                  lr, eps, K, x_, n_chunks,
                                                  device, st)
               : launch_rowwise<__nv_bfloat16, 1>(d_, nt, D, r_, o_, g_, s_,
                                                  lr, eps, K, x_, n_chunks,
                                                  device, st);
  }
  return vec ? launch_rowwise<float, 4>(d_, nt, D, r_, o_, g_, s_, lr, eps, K,
                                        x_, n_chunks, device, st)
             : launch_rowwise<float, 1>(d_, nt, D, r_, o_, g_, s_, lr, eps, K,
                                        x_, n_chunks, device, st);
}
