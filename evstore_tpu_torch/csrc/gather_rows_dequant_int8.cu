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
// Rounding: each block fills a 256-entry table in shared memory with the
// codec's formula, one thread a code: IEEE division (__fdiv_rn, never a
// reciprocal multiply), then *2 (exact) and -1.  Every output is a table
// entry, so the result is bit for bit the formula as numpy, the plain
// PyTorch version (ops/quant.py) and the C++ engine's dec8 compute it.  Do
// not build this file with --use_fast_math.
//
// Bound on this card: bytes, and nearly all of them writes.  At R = 65,536
// x 26 rows of D = 36 it writes 245 MB of f32 rows (~73 us at 3.35 TB/s)
// and reads 6.8 MB of indices and at most 1.45 MB of distinct codes (the
// 36,204-row cache and the 4,096-row buffer, which stay in the 50 MB L2).
// So the design keeps many coalesced 16-byte stores in flight, as
// gather_rows.cu does:
//
// - Units of (row, word): a 4-byte word of 4 codes becomes one 16-byte
//   float4 store (a 36-byte row is 9 units), so no lane idles on a row
//   narrower than a warp, and consecutive threads write consecutive
//   float4s, one coalesced span across row boundaries.  Rows of D % 4 != 0
//   codes, or sources not 4-byte aligned, take (row, code) units and
//   4-byte stores, by the same scheme.
// - Each thread takes 4 units a block's width apart and issues all their
//   index loads, then all their word loads, then all their stores, so a
//   warp has up to 4 x 32 rows' loads in flight.
// - A unit finds its row by a multiply-high and a shift (a magic divisor
//   for the units a row, computed on the host), not by a division.
// - A persistent grid, as many blocks as the SMs hold at once, so the
//   table is built once a block.
// Offsets into global memory are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // one thread a code while the table fills
constexpr int UNITS = 4;      // units in flight a thread

__device__ __forceinline__ float dequant8(uint32_t v) {
  return __fadd_rn(__fmul_rn(__fdiv_rn((float)v, 254.0f), 2.0f), -1.0f);
}

struct TwoSources {
  const uint8_t* primary;
  int64_t C;
  const uint8_t* secondary;
  int64_t M;
  __device__ __forceinline__ const uint8_t* row(int64_t k, int64_t D) const {
    if (k >= 0 && k < C) return primary + k * D;
    if (k >= C && k < C + M) return secondary + (k - C) * D;
    return nullptr;
  }
};

// n / d for every n < 2^32: (umulhi(n, magic) + n) >> shift, with
// shift = ceil(log2 d) and magic = 2^32 (2^shift - d) / d + 1 (the
// round-up method of Granlund and Montgomery, the 33rd bit of the
// multiplier carried by the "+ n").
struct Div32 {
  uint32_t magic;
  int shift;
  __device__ __forceinline__ uint32_t operator()(uint32_t n) const {
    return (uint32_t)(((uint64_t)__umulhi(n, magic) + n) >> shift);
  }
};

Div32 make_div32(uint32_t d) {
  int shift = 0;
  while ((uint64_t)1 << shift < d) ++shift;
  const uint64_t magic =
      ((uint64_t)1 << 32) * (((uint64_t)1 << shift) - d) / d + 1;
  return {(uint32_t)magic, shift};
}

// 64-bit units (more than 2^32 of them): a plain division
struct Div64 {
  uint64_t d;
  __device__ __forceinline__ uint64_t operator()(uint64_t n) const {
    return n / d;
  }
};

// I: the unit index type; WORDS: (row, word) units and float4 stores, else
// (row, code) units and float stores.  nu: units a row.
template <typename I, typename Div, bool WORDS>
__global__ void __launch_bounds__(THREADS)
gather_dequant_kernel(TwoSources src, const int32_t* __restrict__ idx,
                      float* __restrict__ out, I total, I nu, int64_t D,
                      Div div) {
  __shared__ float lut[256];
  lut[threadIdx.x] = dequant8(threadIdx.x);
  __syncthreads();
  const I step = (I)gridDim.x * THREADS * UNITS;
  for (I u0 = (I)blockIdx.x * THREADS * UNITS + threadIdx.x; u0 < total;
       u0 += step) {
    I r[UNITS];
    int32_t k[UNITS];
#pragma unroll
    for (int j = 0; j < UNITS; ++j) {
      const I u = u0 + (I)j * THREADS;
      r[j] = div(u);
      k[j] = u < total ? __ldg(idx + r[j]) : -1;
    }
    uint32_t v[UNITS];
    bool hit[UNITS];
#pragma unroll
    for (int j = 0; j < UNITS; ++j) {
      const I u = u0 + (I)j * THREADS;
      const uint8_t* p = u < total ? src.row(k[j], D) : nullptr;
      hit[j] = p != nullptr;
      const I w = u - r[j] * nu;
      if constexpr (WORDS)
        v[j] = hit[j] ? __ldg(reinterpret_cast<const uint32_t*>(p) + w)
                      : 0u;
      else
        v[j] = hit[j] ? (uint32_t)__ldg(p + w) : 0u;
    }
#pragma unroll
    for (int j = 0; j < UNITS; ++j) {
      const I u = u0 + (I)j * THREADS;
      if (u >= total) continue;
      if constexpr (WORDS) {
        const uint32_t c = v[j];  // little-endian: code d is byte d % 4
        reinterpret_cast<float4*>(out)[u] =
            hit[j] ? make_float4(lut[c & 0xFF], lut[(c >> 8) & 0xFF],
                                 lut[(c >> 16) & 0xFF], lut[c >> 24])
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        out[u] = hit[j] ? lut[v[j]] : 0.f;
      }
    }
  }
}

// The blocks of the persistent grid: as many as the SMs hold at once (the
// occupancy of this instantiation, asked once per device), no more than
// the units need.
template <typename I, typename Div, bool WORDS>
cudaError_t grid_blocks(int device, int64_t total, int64_t* blocks) {
  static int resident[64] = {};
  if (resident[device] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gather_dequant_kernel<I, Div, WORDS>, THREADS, 0);
    if (err != cudaSuccess) return err;
    if (sms * per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[device] = sms * per_sm;
  }
  const int64_t need = (total + THREADS * UNITS - 1) / (THREADS * UNITS);
  *blocks = need < resident[device] ? need : resident[device];
  return cudaSuccess;
}

template <bool WORDS>
int launch(TwoSources src, const void* idx, void* out, int64_t R, int64_t D,
           int device, cudaStream_t st) {
  const int64_t nu = WORDS ? D / 4 : D;
  const int64_t total = R * nu;
  int64_t blocks = 0;
  cudaError_t err =
      grid_blocks<uint32_t, Div32, WORDS>(device, total, &blocks);
  if (err != cudaSuccess) return (int)err;
  // 32-bit units where every unit index, and u0 + step, stays below 2^32
  if (total + blocks * THREADS * UNITS < ((int64_t)1 << 32)) {
    gather_dequant_kernel<uint32_t, Div32, WORDS>
        <<<(unsigned)blocks, THREADS, 0, st>>>(
            src, (const int32_t*)idx, (float*)out, (uint32_t)total,
            (uint32_t)nu, D, make_div32((uint32_t)nu));
  } else {
    err = grid_blocks<uint64_t, Div64, WORDS>(device, total, &blocks);
    if (err != cudaSuccess) return (int)err;
    gather_dequant_kernel<uint64_t, Div64, WORDS>
        <<<(unsigned)blocks, THREADS, 0, st>>>(
            src, (const int32_t*)idx, (float*)out, (uint64_t)total,
            (uint64_t)nu, D, Div64{(uint64_t)nu});
  }
  return (int)cudaGetLastError();
}

bool aligned(const void* p, uintptr_t n) { return ((uintptr_t)p % n) == 0; }

}  // namespace

extern "C" int gather_rows_dequant_int8(const void* primary, int64_t C,
                                        const void* secondary, int64_t M,
                                        const void* idx, void* out, int64_t R,
                                        int64_t D, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || D <= 0 || C < 0 || M < 0 || (M > 0 && secondary == nullptr) ||
      device < 0 || device >= 64)
    return (int)cudaErrorInvalidValue;
  const TwoSources src{(const uint8_t*)primary, C, (const uint8_t*)secondary,
                       M};
  cudaStream_t st = (cudaStream_t)stream;
  const bool words = D % 4 == 0 && aligned(primary, 4) && aligned(out, 16) &&
                     (M == 0 || aligned(secondary, 4));
  return words ? launch<true>(src, idx, out, R, D, device, st)
               : launch<false>(src, idx, out, R, D, device, st);
}
