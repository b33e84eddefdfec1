// Sorted scatter-subtract of embedding-row updates over a group of tables,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel evstore_tpu/ops/pallas_update.py::
// _sub_sweep_kernel (reached through rwsadagrad_row_update_pallas).  The
// tables of a group share one global row space: table t holds the global
// ids [bases[t], bases[t+1]).  Over K entries sorted by global id, in place:
//
//   table_t[r - bases[t]] -= sum of vals[k] over the run with rows[k] == r
//
// for every r in [0, bases[T]).  Ids outside that range (PAD_ROW =
// INT32_MAX, negative ids) are inert.  One table is the group of T = 1.
// f32 and bf16 tables (one type per group); the values are f32 and each row
// rounds once, at its store.  The descriptor `desc` is int64 [2T + 1]: the
// T tables' base addresses, then the T + 1 cumulative row offsets.
//
// Bound on this card: bytes, and only those of the batch (K ids and K x D
// values read once, each distinct row read and written once); the TPU
// kernel sweeps the whole table.  The design answers two things:
//
// - The Zipf head.  Ids are skewed: at K = 65,536 zipf(1.05) one run holds
//   3,819 entries.  So the work is cut by entries, not by runs: block c
//   takes the fixed chunk [c E, (c + 1) E) of the sorted list (E = 128, a
//   thread an entry), whatever the ids, and a long run is spread over
//   ceil(run / E) blocks.  The block stages its values (contiguous, E x D
//   x 4 bytes) and the old values of the rows it writes in shared memory
//   with 4-byte cp.async, all in flight at once, and each warp sums every
//   run's columns by a segmented scan over its 32 lanes (shuffles), so
//   every lane works whatever D is; the rows are then written coalesced.
//   Runs that cross warps are chained in shared memory in warp order.  A
//   run that lies inside the chunk is written by the chunk, once.  A run
//   that crosses a chunk boundary leaves its partial sums in scratch
//   [n_chunks, 2, D] (slot 0: the chunk's first run, begun in an earlier
//   chunk; slot 1: its last run, begun here and going on); a second small
//   kernel, one thread per (chunk, column), lets the chunk where such a
//   run begins add the partials in chunk order (compensated) and write the
//   row once.  The order of every sum is fixed by the ids alone, so the
//   result is bit-deterministic from run to run, and no two threads write
//   one row: no atomics.
// - The launch floor.  The training step updates all 26 tables with one
//   call here (global ids), not one per table.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using evstore::from_f32;
using evstore::to_f32;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int CHUNK = THREADS;  // sorted entries a block; the wrapper's CHUNK
constexpr int TILE = 40;        // columns staged at once
constexpr int STRIDE = TILE + 1;  // odd: a lane's row, read across lanes,
                                  // hits 32 banks
constexpr unsigned FULL = 0xffffffffu;

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

// Block c sums the chunk [c CHUNK, (c + 1) CHUNK) of the sorted entries,
// a lane an entry.  From the ids alone each run's last lane in a warp
// learns its role: write its row (the run lies in the warp), or leave a
// partial for a run that crosses the warp (slot 0: the warp's first run,
// begun before it; slot 1: its last run, begun in it and going on).  Then
// asynchronous copies bring, all in flight at once, the chunk's values
// (coalesced) and the old values of the rows to be written into shared
// memory; a segmented scan over each warp's lanes (5 shuffles a column)
// leaves each run's sum in its last lane's row there; the rows are
// written coalesced, a thread a (row, column); and one thread a (warp,
// column) chains the partials in warp order: it writes the row of a run
// that ends in the block, or leaves the block's partial in scratch (same
// slots) for the cross-chunk pass.  The loops stay loops: the kernel's
// code is small, as a launch of one block waits on its instruction fetch.
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
  __shared__ int16_t s_slot[WARPS][2];   // the lanes of slots 0 and 1
  __shared__ int s_count[WARPS];
  // s_head: the warp's first run began before it (slot 0 filled); s_tail:
  // its last run began in it and goes on (slot 1 filled); s_pass: the warp
  // is one run, begun before it and going on past it
  __shared__ bool s_head[WARPS], s_tail[WARPS], s_pass[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int64_t c = blockIdx.x;
  const int64_t start = c * CHUNK;
  const int n = (int)min((int64_t)CHUNK, K - start);
  const int nw = max(0, min(32, n - 32 * w));  // the warp's entries
  const int64_t e = start + tid;
  const bool valid = lane < nw;
  const int32_t r = valid ? __ldg(rows + e) : 0;
  const bool head = valid && (e == 0 || __ldg(rows + e - 1) != r);
  // each lane's segment start within the warp (lane 0 starts one always)
  const unsigned heads = __ballot_sync(FULL, head);
  const int seg = 31 - __clz((heads | 1u) & (FULL >> (31 - lane)));
  const int dist = lane - seg;
  const bool after = valid && e + 1 < K && __ldg(rows + e + 1) == r;
  const bool live = valid && !(lane < nw - 1 && after) && r >= 0 &&
                    (int64_t)r < __ldg(desc + 2 * nt);   // a run's last lane
  const bool before = seg == 0 && !(heads & 1u);   // begun before the warp
  // role of a run's last lane: 0 none, 1 write the row, 2 slot 0, 3 slot 1
  const int role = !live ? 0 : before ? 2 : after ? 3 : 1;
  const unsigned r1 = __ballot_sync(FULL, role == 1);
  const unsigned r2 = __ballot_sync(FULL, role == 2);
  const unsigned r3 = __ballot_sync(FULL, role == 3);
  const unsigned cont = __ballot_sync(FULL, valid && lane == nw - 1 && after);
  if (lane == 0) {
    s_count[w] = __popc(r1);
    s_head[w] = r2 != 0;
    s_tail[w] = r3 != 0;
    s_pass[w] = heads == 0 && cont != 0;
  }
  if (role >= 2) s_slot[w][role - 2] = (int16_t)tid;
  __syncthreads();
  int n1 = 0, k = 0;  // rows the warps write; this lane's place among them
  for (int w2 = 0; w2 < WARPS; ++w2) {
    if (w2 == w) k = n1 + __popc(r1 & ((1u << lane) - 1u));
    n1 += s_count[w2];
  }
  if (role == 1) {
    s_dst[k] = row_of<T>(desc, nt, D, r);
    s_src[k] = (int16_t)tid;
  } else if (role == 3) {
    s_tail_row[w] = row_of<T>(desc, nt, D, r);
  }
  __syncthreads();

  for (int c0 = 0; c0 < D; c0 += TILE) {
    const int W = min(TILE, D - c0);
    // the copies, all in flight at once
    for (Walk it(tid, W); it.e < n; it.next())
      __pipeline_memcpy_async(s_v + it.e * STRIDE + it.d,
                              vals + (start + it.e) * D + c0 + it.d, 4);
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
      float x = valid ? mine[j] : 0.0f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(FULL, x, off);
        if (dist >= off) x += y;
      }
      mine[j] = x;
    }
    __syncthreads();
    for (Walk it(tid, W); it.e < n1; it.next()) {
      T* p = s_dst[it.e] + c0 + it.d;
      *p = from_f32<T>(to_f32(s_old[it.e * W + it.d]) -
                       s_v[s_src[it.e] * STRIDE + it.d]);
    }
    // chain the partials of runs that cross warp boundaries, in warp order
    for (int u = tid; u < WARPS * W; u += THREADS) {
      const int w0 = u / W, d = u - w0 * W;
      if (w0 == 0 && s_head[0]) {  // the block's first run began before it
        float acc = s_v[s_slot[0][0] * STRIDE + d];
        bool on = s_pass[0];
        for (int w2 = 0; on && w2 + 1 < WARPS;) {
          acc += s_v[s_slot[++w2][0] * STRIDE + d];
          on = s_pass[w2];
        }
        scratch[(c * 2) * D + c0 + d] = acc;
      }
      if (s_tail[w0]) {  // a run begins in warp w0 and goes on
        float acc = s_v[s_slot[w0][1] * STRIDE + d];
        bool on = true;    // the run goes on past warp w2
        for (int w2 = w0; on && w2 + 1 < WARPS;) {
          acc += s_v[s_slot[++w2][0] * STRIDE + d];
          on = s_pass[w2];
        }
        if (on) {  // past the block too: the cross-chunk pass's
          scratch[(c * 2 + 1) * D + c0 + d] = acc;
        } else {
          T* p = s_tail_row[w0] + c0 + d;
          *p = from_f32<T>(to_f32(*p) - acc);
        }
      }
    }
    __syncthreads();
  }
}

// One thread per (chunk, column).  The chunk whose last run begins in it
// and goes on past it owns that run: it adds its slot 1 and the slot 0 of
// each following chunk the run reaches, in chunk order, and writes the row.
template <typename T>
__global__ void __launch_bounds__(THREADS)
cross_chunk_kernel(const int64_t* __restrict__ desc, int nt, int D,
                   const int32_t* __restrict__ rows, int64_t K,
                   int64_t n_chunks, const float* __restrict__ scratch) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_chunks * D) return;
  const int64_t c = i / D;
  const int d = (int)(i - c * D);
  const int64_t start = c * CHUNK, end = min(start + CHUNK, K);
  const int32_t r = __ldg(rows + end - 1);
  if (end >= K || __ldg(rows + end) != r) return;         // ends here
  if (start > 0 && __ldg(rows + start - 1) == r) return;  // not its start
  if (r < 0 || (int64_t)r >= __ldg(desc + 2 * nt)) return;  // inert
  float acc = __ldg(scratch + (c * 2 + 1) * D + d), comp = 0.0f;
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
  T* dst = row_of<T>(desc, nt, D, r) + d;
  *dst = from_f32<T>(to_f32(*dst) - acc);
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
