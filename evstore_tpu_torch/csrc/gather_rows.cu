// Embedding-row gathers for Hopper (sm_90a).
//
// Replaces the TPU kernel evstore_tpu/ops/pallas_gather.py::_gather_kernel
// (a ring of 16 row DMAs, reached through gather_rows).  Two entry points
// share one inner loop:
//
//   gather_rows, over a flat [R] int32 index:
//     out[r] = primary[idx[r]]            if idx[r] <  C
//            = secondary[idx[r] - C]      if C <= idx[r] < C + M
//   With no secondary (M == 0) this is exactly the TPU kernel's table[idx].
//   The two-source form serves the device C1 cache: indices below C read a
//   cache slot, the others a row of this segment's shipped miss buffer, so
//   concat(cache, buffer) is never materialised.
//
//   gather_rows_grouped, over idx [B, T] and T tables of one width:
//     out[b, t] = table_t[idx[b, t]]
//   The training step's lookup of all 26 tables in one launch, written
//   straight into the [B, T, D] rows.  The tables come as a descriptor,
//   int64 [2T + 1]: their base addresses, then the cumulative row offsets.
//
// Rows are moved as bytes, so every row is bit-exact: any 4-byte-multiple
// row (f32, or bf16 with an even width), and in the grouped form also a
// bf16 row of odd width, such as a table's pooling weights [N, 1], in
// 2-byte units.  An index outside its source writes a zero row instead of
// reading out of bounds; callers validate ids on the host.
//
// Bound on this card: bytes (each index read once, each distinct row read
// once, each output row written once).  At 65,536 x 26 rows of 144 B that
// is ~490 MB, ~146 us at 3.35 TB/s; at the serving batch of 2048 x 26 rows
// ~4.6 us, and the 64,000-row cache (9.2 MB) sits in the 50 MB L2.  What
// approaches the bound is bytes in flight.  So the work is cut into (row,
// vector) units of 16 bytes (8 or 4 where the row or the pointers allow no
// more): a 144-byte row is 9 units, a warp moves 32 units, about 3.5 rows,
// and no lane idles on a row narrower than a warp.  Each thread takes 4
// units a block's width apart (consecutive threads, consecutive bytes),
// issues all their index loads, then all their row loads, then the
// stores.  TMA and wgmma have nothing to do here: a gather of scattered
// 144-byte rows has no tile for a tensor map, and no arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNITS = 4;  // units in flight per thread

template <typename V>
struct TwoSources {
  const V* primary;
  int64_t C;
  const V* secondary;
  int64_t M;
  __device__ __forceinline__ const V* row(int64_t /*r*/, int64_t k,
                                          int64_t nvec) const {
    if (k >= 0 && k < C) return primary + k * nvec;
    if (k >= C && k < C + M) return secondary + (k - C) * nvec;
    return nullptr;
  }
};

template <typename V>
struct Grouped {
  const int64_t* desc;
  int nt;
  __device__ __forceinline__ const V* row(int64_t r, int64_t k,
                                          int64_t nvec) const {
    const int t = (int)(r % nt);
    const int64_t n = __ldg(desc + nt + t + 1) - __ldg(desc + nt + t);
    if (k < 0 || k >= n) return nullptr;
    return (const V*)(uintptr_t)__ldg(desc + t) + k * nvec;
  }
};

// I: the unit index type, 32-bit where R * nvec allows it (cheaper
// division).
template <typename V, typename I, typename Src>
__global__ void __launch_bounds__(THREADS)
gather_kernel(Src src, const int32_t* __restrict__ idx, V* __restrict__ out,
              I total, I nvec) {
  const I step = (I)gridDim.x * THREADS * UNITS;
  for (I u0 = (I)blockIdx.x * THREADS * UNITS + threadIdx.x; u0 < total;
       u0 += step) {
    I r[UNITS];
    int32_t k[UNITS];
#pragma unroll
    for (int j = 0; j < UNITS; ++j) {
      const I u = u0 + (I)j * THREADS;
      r[j] = u / nvec;
      k[j] = u < total ? __ldg(idx + r[j]) : -1;
    }
    V val[UNITS];
#pragma unroll
    for (int j = 0; j < UNITS; ++j) {
      const I u = u0 + (I)j * THREADS;
      const V* p = u < total ? src.row((int64_t)r[j], k[j], nvec) : nullptr;
      val[j] = p != nullptr ? __ldg(p + (u - r[j] * nvec)) : V{};
    }
#pragma unroll
    for (int j = 0; j < UNITS; ++j) {
      const I u = u0 + (I)j * THREADS;
      if (u < total) out[u] = val[j];
    }
  }
}

template <typename V, typename Src>
void launch(Src src, const void* idx, void* out, int64_t R, int64_t nvec,
            cudaStream_t st) {
  const int64_t total = R * nvec;
  int64_t blocks = (total + THREADS * UNITS - 1) / (THREADS * UNITS);
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride beyond this
  if (total + THREADS * UNITS * blocks < ((int64_t)1 << 32)) {
    gather_kernel<V, uint32_t, Src><<<(unsigned)blocks, THREADS, 0, st>>>(
        src, (const int32_t*)idx, (V*)out, (uint32_t)total, (uint32_t)nvec);
  } else {
    gather_kernel<V, uint64_t, Src><<<(unsigned)blocks, THREADS, 0, st>>>(
        src, (const int32_t*)idx, (V*)out, (uint64_t)total, (uint64_t)nvec);
  }
}

// The widest vector (16, 8, 4 or 2 bytes) that divides the row and
// `align`.
int vector_bytes(int64_t row_bytes, uintptr_t align) {
  for (int v = 16; v > 2; v >>= 1)
    if (row_bytes % v == 0 && align % v == 0) return v;
  return 2;
}

}  // namespace

extern "C" int gather_rows(const void* primary, int64_t C,
                           const void* secondary, int64_t M, const void* idx,
                           void* out, int64_t R, int64_t row_bytes,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || row_bytes <= 0 || row_bytes % 4 != 0 || C < 0 || M < 0 ||
      (M > 0 && secondary == nullptr))
    return (int)cudaErrorInvalidValue;
  const uintptr_t align = (uintptr_t)primary | (uintptr_t)out |
                          (M > 0 ? (uintptr_t)secondary : 0);
  // the lowest set bit of the pointers is their common alignment
  const int vb = vector_bytes(row_bytes, align & (~align + 1));
  cudaStream_t st = (cudaStream_t)stream;
  if (vb == 16) {
    launch<uint4>(TwoSources<uint4>{(const uint4*)primary, C,
                                    (const uint4*)secondary, M},
                  idx, out, R, row_bytes / 16, st);
  } else if (vb == 8) {
    launch<uint2>(TwoSources<uint2>{(const uint2*)primary, C,
                                    (const uint2*)secondary, M},
                  idx, out, R, row_bytes / 8, st);
  } else {
    launch<uint32_t>(TwoSources<uint32_t>{(const uint32_t*)primary, C,
                                          (const uint32_t*)secondary, M},
                     idx, out, R, row_bytes / 4, st);
  }
  return (int)cudaGetLastError();
}

// src_align: the common alignment of the tables' base addresses, which
// live on the card in `desc` (the wrapper knows them).
extern "C" int gather_rows_grouped(const void* desc, int nt, const void* idx,
                                   void* out, int64_t R, int64_t row_bytes,
                                   int64_t src_align, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || nt < 1 || R % nt != 0 || row_bytes <= 0 ||
      row_bytes % 2 != 0 || src_align <= 0)
    return (int)cudaErrorInvalidValue;
  const uintptr_t a = (uintptr_t)src_align | (uintptr_t)out;
  const int vb = vector_bytes(row_bytes, a & (~a + 1));
  const int64_t* d = (const int64_t*)desc;
  cudaStream_t st = (cudaStream_t)stream;
  if (vb == 16) {
    launch<uint4>(Grouped<uint4>{d, nt}, idx, out, R, row_bytes / 16, st);
  } else if (vb == 8) {
    launch<uint2>(Grouped<uint2>{d, nt}, idx, out, R, row_bytes / 8, st);
  } else if (vb == 4) {
    launch<uint32_t>(Grouped<uint32_t>{d, nt}, idx, out, R, row_bytes / 4,
                     st);
  } else {
    launch<uint16_t>(Grouped<uint16_t>{d, nt}, idx, out, R, row_bytes / 2,
                     st);
  }
  return (int)cudaGetLastError();
}
