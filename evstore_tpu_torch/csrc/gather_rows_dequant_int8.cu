// Row gather with int8 dequantisation for Hopper (sm_90a).
//
// Replaces the TPU kernel evstore_tpu/ops/pallas_gather.py::
// gather_rows_dequant_int8 (the row DMA ring of _gather_kernel over an int32
// view of the uint8 rows, with the unpack and dequantisation in XLA).  Over
// a flat [R] int32 index, with uint8 rows of the 8-bit codec:
//
//   out[r, d] = (float(src[r][d]) / 254) * 2 - 1      (float32 [R, D])
//   src[r]    = primary[idx[r]]                if idx[r] <  C
//             = secondary[idx[r] - C]          if C <= idx[r] < C + M
//
// The two-source form serves the int8 device C1 cache: an index below C
// reads a cache slot, the others a row of the batch's shipped miss buffer,
// so concat(cache, buffer) is never built.  An index outside [0, C + M)
// writes a zero row instead of reading out of bounds, as gather_rows does.
//
// Rounding: the division is IEEE (__fdiv_rn, never a reciprocal multiply),
// then *2 (exact) and -1, so the result is bit for bit the codec's formula
// as numpy, the plain PyTorch version (ops/quant.py) and the C++ engine's
// dec8 compute it.  Do not build this file with --use_fast_math.
//
// Bound on this card: bytes.  At the serving batch, R = 2048 x 26 rows of
// 36 B read and 144 B written, moving them takes ~3 us at 3.35 TB/s, well
// under the cost of a launch.  One warp moves one row: with a row of a
// multiple of 4 bytes and 4-byte aligned sources, each lane loads one
// 4-byte word, unpacks its 4 codes and stores 4 floats as one 16-byte
// vector (Kaggle's 36-byte row is 9 words); any other row goes byte by
// byte.  Several rows per warp for narrow rows is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float dequant8(uint32_t v) {
  return __fadd_rn(__fmul_rn(__fdiv_rn((float)v, 254.0f), 2.0f), -1.0f);
}

__device__ __forceinline__ const uint8_t* source(
    const uint8_t* primary, int64_t C, const uint8_t* secondary, int64_t M,
    int64_t k, int64_t D) {
  if (k >= 0 && k < C) return primary + k * D;
  if (k >= C && k < C + M) return secondary + (k - C) * D;
  return nullptr;
}

// D % 4 == 0 and 4-byte aligned sources: one word (4 codes) per lane
__global__ void gather_dequant_words(const uint8_t* __restrict__ primary,
                                     int64_t C,
                                     const uint8_t* __restrict__ secondary,
                                     int64_t M,
                                     const int32_t* __restrict__ idx,
                                     float* __restrict__ out, int64_t R,
                                     int64_t D) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int64_t nw = D >> 2;
  for (int64_t r = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       r < R; r += warps) {
    const uint8_t* src = source(primary, C, secondary, M, __ldg(idx + r), D);
    float4* dst = reinterpret_cast<float4*>(out + r * D);
    for (int64_t w = lane; w < nw; w += 32) {
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (src != nullptr) {
        const uint32_t v = __ldg(reinterpret_cast<const uint32_t*>(src) + w);
        f.x = dequant8(v & 0xFF);            // little-endian byte order
        f.y = dequant8((v >> 8) & 0xFF);
        f.z = dequant8((v >> 16) & 0xFF);
        f.w = dequant8(v >> 24);
      }
      dst[w] = f;
    }
  }
}

// any D: one code per lane
__global__ void gather_dequant_bytes(const uint8_t* __restrict__ primary,
                                     int64_t C,
                                     const uint8_t* __restrict__ secondary,
                                     int64_t M,
                                     const int32_t* __restrict__ idx,
                                     float* __restrict__ out, int64_t R,
                                     int64_t D) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t r = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       r < R; r += warps) {
    const uint8_t* src = source(primary, C, secondary, M, __ldg(idx + r), D);
    float* dst = out + r * D;
    for (int64_t d = lane; d < D; d += 32) {
      dst[d] = src != nullptr ? dequant8(__ldg(src + d)) : 0.f;
    }
  }
}

bool aligned(const void* p, uintptr_t n) { return ((uintptr_t)p % n) == 0; }

}  // namespace

extern "C" int gather_rows_dequant_int8(const void* primary, int64_t C,
                                        const void* secondary, int64_t M,
                                        const void* idx, void* out, int64_t R,
                                        int64_t D, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || D <= 0 || C < 0 || M < 0 || (M > 0 && secondary == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;  // 8 warps, 8 rows in flight per block
  int64_t blocks = (R + 7) / 8;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride beyond this
  const bool words = D % 4 == 0 && aligned(primary, 4) && aligned(out, 16) &&
                     (M == 0 || aligned(secondary, 4));
  if (words) {
    gather_dequant_words<<<(unsigned)blocks, threads, 0, st>>>(
        (const uint8_t*)primary, C, (const uint8_t*)secondary, M,
        (const int32_t*)idx, (float*)out, R, D);
  } else {
    gather_dequant_bytes<<<(unsigned)blocks, threads, 0, st>>>(
        (const uint8_t*)primary, C, (const uint8_t*)secondary, M,
        (const int32_t*)idx, (float*)out, R, D);
  }
  return (int)cudaGetLastError();
}
