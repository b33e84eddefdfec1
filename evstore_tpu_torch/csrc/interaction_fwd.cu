// DLRM dot-interaction forward for Hopper (sm_90a).
//
// Replaces the TPU kernel evstore_tpu/ops/pallas_interaction.py::
// _blocked_fwd_kernel (reached through dot_interaction_blocked).  For each
// sample b, with feat[b] = [x[b]; ly[b, 0..T-1]] (F = T+1 rows of width D):
//
//   out[b, :D]    = x[b]
//   out[b, D + p] = <feat[b, li[p]], feat[b, lj[p]]>
//
// where (li, lj) walk np.tril_indices(F, k=-1) in row-major order (k=0 with
// self_interaction).  f32 and bf16 inputs; every pair is one fmaf chain in
// f32 in d order 0..D-1 (the order of interaction_gram.cu, so the two agree
// bit for bit), and bf16 rounds once at the store, the JAX rounding chain
// (f32 gram -> cast -> exact 0/1 selection).
//
// Bound on this card: bytes.  At B=65536, T=26, D=36, f32 it reads 254.8 MB
// and writes 101.4 MB (~106 us at 3.35 TB/s) for 1.66 GFLOP (~25 us on the
// f32 CUDA cores); at the train and serve batches (128, 2048) the bound is
// 0.2-3.3 us, so what matters there is that every SM has work.  The design:
//
// - Geometry from B (ops/cuda_interaction.py::interaction_geometry): a
//   group of `spg` consecutive samples is one unit of work, few samples at
//   small B so that the groups cover the SMs, up to 8 at large B; a
//   persistent grid of up to three blocks per SM walks the groups.
// - Staging: a group's x rows are one contiguous span, each sample's ly
//   rows another.  They move into shared memory as 16-byte cp.async units
//   (common.cuh, stage_span), into a two-stage ring: the next group's
//   copies are in flight while this group computes.  No integer division
//   per element.
// - Register tiles: the F x F Gram's lower triangle is cut into 4 x 4
//   tiles (F = 27 -> 7 tile rows, 28 tiles); a thread owns a (sample, tile)
//   and reads each of its 8 rows' d-slices once per 4 d as one 16-byte
//   (f32) or 8-byte (bf16) shared load, for 64 FMAs: 0.125 loads per FMA
//   where one thread per pair needed 2.  Rows past F are clamped, and pairs
//   on or above the diagonal of a diagonal tile are computed and not stored.
// - Bank conflicts: with the raw 144-byte rows, rows 8 apart share a bank
//   group, so lanes that own tiles of one sample collide.  Lanes take the
//   samples of one tile instead, and each sample's ly region is an odd
//   number of 16-byte units long, so a quarter warp's 8 loads hit 8
//   distinct bank groups.
// - Stores: the group's output rows [x, pairs] are one contiguous span; the
//   pairs land in shared memory at their tril column (i (i -+ 1) / 2 + j,
//   no square root) and the span leaves as 16-byte stores.  When F is so
//   large that one sample's output row does not fit, the pairs are stored
//   straight to global memory instead.
// - No tensor cores: the reference computes at Precision.HIGHEST and 3xTF32
//   changes the bits; the FFMA work is a quarter of the byte time.
// Offsets into global memory are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using evstore::from_f32;
using evstore::load_f32;
using evstore::pair_of;
using evstore::phase16;
using evstore::span_bytes;
using evstore::to_f32;

constexpr int THREADS = 256;
constexpr int R = 4;  // a tile is R x R pairs

// The shared region of one sample's ly rows (`bytes` of them): an odd
// number of 16-byte units, so that the regions of 8 consecutive samples
// start in 8 distinct bank groups.
int64_t sample_stride(int64_t bytes) {
  const int64_t s = span_bytes(bytes);
  return s / 16 % 2 ? s : s + 16;
}

// T: storage type; V: values per shared load (4 when D % 4 == 0 and the
// rows are aligned for it, else 1).
template <typename T, int V>
__global__ void __launch_bounds__(THREADS, 3)
interaction_fwd_kernel(const T* __restrict__ x, const T* __restrict__ ly,
                       T* __restrict__ out, int64_t B, int nt, int D, int P,
                       int self, int spg, int stage_out, int xr, int lss) {
  extern __shared__ __align__(16) char smem[];
  const int F = nt + 1;
  const int W = D + P;
  const int nti = (F + R - 1) / R;
  const int ntiles = nti * (nti + 1) / 2;
  const int tid = threadIdx.x;
  const int64_t ngroups = (B + spg - 1) / spg;
  const int stage = xr + spg * lss;
  char* obuf = smem + 2 * stage;

  auto issue = [&](int64_t g, char* st) {
    const int64_t b0 = g * spg;
    const int ns = (int)(B - b0 < spg ? B - b0 : spg);
    evstore::stage_span(st, x + b0 * D, ns * D, tid, THREADS);
    for (int q = 0; q < ns; ++q)
      evstore::stage_span(st + xr + q * lss, ly + (b0 + q) * nt * D, nt * D,
                          tid, THREADS);
  };

  int64_t g = blockIdx.x;
  issue(g, smem);
  evstore::cp_async_commit();
  for (int it = 0; g < ngroups; g += gridDim.x, ++it) {
    char* cur = smem + (it & 1) * stage;
    if (g + gridDim.x < ngroups)
      issue(g + gridDim.x, smem + (~it & 1) * stage);
    evstore::cp_async_commit();
    evstore::cp_async_wait<1>();
    __syncthreads();

    const int64_t b0 = g * spg;
    const int ns = (int)(B - b0 < spg ? B - b0 : spg);
    const T* xs = (const T*)(cur + phase16(x + b0 * D));
    T* o = out + b0 * W;
    T* ob = stage_out ? (T*)(obuf + phase16(o)) : o;

    for (int e = tid; e < ns * D; e += THREADS) {
      const int q = e / D;
      ob[q * W + (e - q * D)] = xs[e];
    }
    // samples vary fastest across the lanes: at 8 samples a group, the 8
    // lanes of a quarter warp read one row of 8 samples, whose regions
    // start in 8 distinct 16-byte bank groups
    for (int w = tid; w < ns * ntiles; w += THREADS) {
      const int t = w / ns;
      const int q = w - t * ns;
      int ti, tj;
      pair_of(t, 1, &ti, &tj);  // tile t = ti (ti + 1) / 2 + tj
      const T* lq = (const T*)(cur + xr + q * lss +
                               phase16(ly + (b0 + q) * nt * D));
      // the tile's rows in the staged spans (row 0 is x)
      const T* ra[R];
      const T* rc[R];
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const int i = min(ti * R + a, F - 1);
        const int j = min(tj * R + a, F - 1);
        ra[a] = i == 0 ? xs + q * D : lq + (i - 1) * D;
        rc[a] = j == 0 ? xs + q * D : lq + (j - 1) * D;
      }
      float acc[R][R];
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int c = 0; c < R; ++c) acc[a][c] = 0.0f;
      for (int d = 0; d < D; d += V) {
        float va[R][V];
#pragma unroll
        for (int a = 0; a < R; ++a) load_f32<V>(ra[a] + d, va[a]);
#pragma unroll
        for (int c = 0; c < R; ++c) {
          float vc[V];
          load_f32<V>(rc[c] + d, vc);
#pragma unroll
          for (int k = 0; k < V; ++k)
#pragma unroll
            for (int a = 0; a < R; ++a)
              acc[a][c] = fmaf(va[a][k], vc[k], acc[a][c]);
        }
      }
      T* orow = ob + q * W + D;
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const int i = ti * R + a;
        const int base = self ? i * (i + 1) / 2 : i * (i - 1) / 2;
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const int j = tj * R + c;
          if (i < F && (j < i || (self && j == i)))
            orow[base + j] = from_f32<T>(acc[a][c]);
        }
      }
    }
    __syncthreads();
    if (stage_out) evstore::store_span(o, obuf, ns * W, tid, THREADS);
  }
  evstore::cp_async_wait<0>();
}

template <typename T, int V>
int launch(const void* x, const void* ly, void* out, int64_t B, int nt,
           int D, int P, int self, int spg, int blocks, int stage_out,
           int xr, int lss, size_t smem, int device, cudaStream_t st) {
  // raise the block's dynamic shared memory limit once per device
  static bool ready[64] = {};
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        interaction_fwd_kernel<T, V>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        evstore::kMaxDynamicSmem);
    if (err != cudaSuccess) return (int)err;
    ready[device] = true;
  }
  interaction_fwd_kernel<T, V><<<blocks, THREADS, smem, st>>>(
      (const T*)x, (const T*)ly, (T*)out, B, nt, D, P, self, spg, stage_out,
      xr, lss);
  return (int)cudaGetLastError();
}

}  // namespace

// spg: samples per group; blocks: the persistent grid; stage_out: stage
// the output rows in shared memory (else store pairs straight to global).
extern "C" int interaction_fwd(const void* x, const void* ly, void* out,
                               int64_t B, int nt, int D, int self_interaction,
                               int is_bf16, int spg, int blocks,
                               int stage_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || nt < 1 || D < 1 || spg < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const int F = nt + 1;
  const int self = self_interaction ? 1 : 0;
  const int P = F * (F - 1) / 2 + (self ? F : 0);
  const int es = is_bf16 ? 2 : 4;
  const int64_t xr = span_bytes((int64_t)spg * D * es);
  const int64_t lss = sample_stride((int64_t)nt * D * es);
  const int64_t orr = stage_out ? span_bytes((int64_t)spg * (D + P) * es) : 0;
  const int64_t smem = 2 * (xr + spg * lss) + orr;
  if (smem > evstore::kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  const int64_t ngroups = (B + spg - 1) / spg;
  if (blocks > ngroups) blocks = (int)ngroups;
  const bool vec = D % 4 == 0 &&
                   (((uintptr_t)x | (uintptr_t)ly) % (4 * es)) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    return vec ? launch<__nv_bfloat16, 4>(x, ly, out, B, nt, D, P, self, spg,
                                          blocks, stage_out, (int)xr,
                                          (int)lss, smem, device, st)
               : launch<__nv_bfloat16, 1>(x, ly, out, B, nt, D, P, self, spg,
                                          blocks, stage_out, (int)xr,
                                          (int)lss, smem, device, st);
  }
  return vec ? launch<float, 4>(x, ly, out, B, nt, D, P, self, spg, blocks,
                                stage_out, (int)xr, (int)lss, smem, device, st)
             : launch<float, 1>(x, ly, out, B, nt, D, P, self, spg, blocks,
                                stage_out, (int)xr, (int)lss, smem, device,
                                st);
}
