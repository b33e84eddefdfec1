// Embedding-row gather for Hopper (sm_90a).
//
// Replaces the TPU kernel evstore_tpu/ops/pallas_gather.py::_gather_kernel
// (a ring of 16 row DMAs, reached through gather_rows).  Over a flat [R]
// int32 index:
//
//   out[r] = primary[idx[r]]              if idx[r] <  C
//          = secondary[idx[r] - C]        if C <= idx[r] < C + M
//
// With no secondary (M == 0) this is exactly the TPU kernel's table[idx].
// The two-source form serves the device C1 cache: indices below C read a
// cache slot, the others a row of this segment's shipped miss buffer, so
// concat(cache, buffer) is never materialised.  Rows are moved as bytes, so
// any 4-byte-multiple row (f32, or bf16 with an even width) is bit-exact.
// An index outside [0, C + M) writes a zero row instead of reading out of
// bounds; callers validate indices on the host before upload.
//
// Bound on this card: bytes.  At 65536 x 26 rows of 144 B, reading and
// writing the rows is ~490 MB (~146 us at 3.35 TB/s); at the serving batch
// of 2048 x 26 rows it is ~4.6 us, where launch cost dominates.  One warp
// moves one row with 16-byte vector loads and stores when the row and the
// base pointers allow it (144 B = 9 vectors), else with 4-byte words; row
// offsets are 64-bit (Terabyte tables reach 227M rows).  Several rows per
// warp for narrow rows, and fusing this gather into the interaction's
// staging, are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void gather_rows_kernel(const V* __restrict__ primary, int64_t C,
                                   const V* __restrict__ secondary, int64_t M,
                                   const int32_t* __restrict__ idx,
                                   V* __restrict__ out, int64_t R,
                                   int64_t nvec) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t r = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       r < R; r += warps) {
    const int64_t k = __ldg(idx + r);
    const V* src = nullptr;
    if (k >= 0 && k < C) {
      src = primary + k * nvec;
    } else if (k >= C && k < C + M) {
      src = secondary + (k - C) * nvec;
    }
    V* dst = out + r * nvec;
    for (int64_t v = lane; v < nvec; v += 32) {
      V val{};
      if (src != nullptr) val = __ldg(src + v);
      dst[v] = val;
    }
  }
}

template <typename V>
void launch(const void* primary, int64_t C, const void* secondary, int64_t M,
            const void* idx, void* out, int64_t R, int64_t nvec,
            cudaStream_t st) {
  const int threads = 256;  // 8 warps, 8 rows in flight per block
  int64_t blocks = (R + 7) / 8;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride beyond this
  gather_rows_kernel<V><<<(unsigned)blocks, threads, 0, st>>>(
      (const V*)primary, C, (const V*)secondary, M, (const int32_t*)idx,
      (V*)out, R, nvec);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

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
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec16 = row_bytes % 16 == 0 && aligned16(primary) &&
                     aligned16(out) && (M == 0 || aligned16(secondary));
  if (vec16) {
    launch<uint4>(primary, C, secondary, M, idx, out, R, row_bytes / 16, st);
  } else {
    launch<uint32_t>(primary, C, secondary, M, idx, out, R, row_bytes / 4,
                     st);
  }
  return (int)cudaGetLastError();
}
