// Sorted scatter-subtract of embedding-row updates for Hopper (sm_90a).
//
// Replaces the TPU kernel evstore_tpu/ops/pallas_update.py::
// _sub_sweep_kernel (reached through rwsadagrad_row_update_pallas).  Over
// K entries sorted by row id, in place:
//
//   table[r] -= sum of vals[k] over the run of entries with rows[k] == r
//
// for every r in [0, N).  Entries whose id lies outside [0, N) (PAD_ROW =
// INT32_MAX, negative ids) are inert.  f32 and bf16 tables; the values are
// f32 and each run is summed with Kahan compensation, so a run of thousands
// of entries (a Zipf head) keeps the sum to a few f32 ulps; the row rounds
// once, at the store.
//
// Bound on this card: bytes, and only those of the rows in the batch.  The
// TPU kernel sweeps the whole table (a sequential grid over row tiles, the
// scatter as a one-hot matmul): on a 10M-row, dim-36 f32 table that is
// 2.9 GB of traffic per call, whatever K is.  Here one warp owns one run of
// equal ids.  The warp whose entry starts a run (rows[k] != rows[k-1])
// finds the run's end 32 ids at a time with a ballot, sums the run's values
// lane by lane (lane l owns columns l, l+32, ...) in entry order, and
// read-modify-writes its row once.  The other warps return at once.  No two
// warps touch one row, so no atomics are needed, and the fixed summation
// order makes the result deterministic.  A very long run (a Zipf head) is
// summed by one warp alone; balancing it across warps is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using evstore::from_f32;
using evstore::to_f32;

template <typename T>
__global__ void scatter_sub_sorted_kernel(T* __restrict__ table, int64_t N,
                                          int D,
                                          const int32_t* __restrict__ rows,
                                          const float* __restrict__ vals,
                                          int64_t K) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       i < K; i += warps) {
    const int32_t r = __ldg(rows + i);
    if ((i > 0 && __ldg(rows + i - 1) == r) || r < 0 || (int64_t)r >= N)
      continue;  // not the head of its run, or an inert id
    int64_t end = i + 1;
    for (;;) {
      const int64_t k = end + lane;
      const bool same = k < K && __ldg(rows + k) == r;
      const unsigned m = __ballot_sync(0xffffffffu, same);
      if (m != 0xffffffffu) {
        end += __ffs(~m) - 1;
        break;
      }
      end += 32;
    }
    T* dst = table + (int64_t)r * D;
    for (int d = lane; d < D; d += 32) {
      float acc = 0.0f, comp = 0.0f;  // Kahan-compensated sum
#pragma unroll 4
      for (int64_t k = i; k < end; ++k) {
        const float y = __ldg(vals + k * D + d) - comp;
        const float t = acc + y;
        comp = (t - acc) - y;
        acc = t;
      }
      dst[d] = from_f32<T>(to_f32(dst[d]) - acc);
    }
  }
}

}  // namespace

extern "C" int scatter_sub_sorted(void* table, int64_t N, int D,
                                  const void* rows, const void* vals,
                                  int64_t K, int is_bf16, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K <= 0 || N < 0 || D < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;  // 8 warps, 8 entries per block
  int64_t blocks = (K + 7) / 8;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride beyond this
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    scatter_sub_sorted_kernel<__nv_bfloat16>
        <<<(unsigned)blocks, threads, 0, st>>>(
            (__nv_bfloat16*)table, N, D, (const int32_t*)rows,
            (const float*)vals, K);
  } else {
    scatter_sub_sorted_kernel<float><<<(unsigned)blocks, threads, 0, st>>>(
        (float*)table, N, D, (const int32_t*)rows, (const float*)vals, K);
  }
  return (int)cudaGetLastError();
}
