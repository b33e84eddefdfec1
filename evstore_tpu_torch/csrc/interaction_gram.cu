// DLRM dot-interaction forward in two stages, for Hopper (sm_90a).
//
// Replaces the TPU kernel evstore_tpu/ops/pallas_interaction.py::
// _interaction_kernel (reached through dot_interaction_pallas).  That
// kernel computes each sample's Gram matrix G = F F^T of its F = T+1
// features (x and the T embedding rows, width D) on the matrix unit, then
// picks the pairs out with F accumulation matmuls against 0/1 selectors,
// because a TPU has no cheap dynamic addressing.  Here the selection is an
// index table:
//
//   out[b, :D]    = x[b]
//   out[b, D + p] = G_b[li[p], lj[p]]
//
// with (li, lj) = np.tril_indices(F, k=-1), or k=0 with self_interaction,
// and tab[p] = li[p] (li[p] + 1) / 2 + lj[p], the pair's place in the
// packed lower triangle (diagonal included), built on the host.
//
// Bound on this card: bytes.  At B=65536, T=26, D=36, f32 it reads 254.8 MB
// and writes 101.4 MB (~106 us at 3.35 TB/s) for 1.66 GFLOP (~25 us on the
// f32 CUDA cores); at the serve batch of 2048 the bound is 3.3 us and at
// the train batch 0.2 us, so there what matters is that every SM has work.
// The design is the one-stage forward's (interaction_fwd.cu), with the
// Gram in shared memory between the two stages:
//
// - Geometry from B (ops/cuda_interaction.py::gram_geometry): a group of
//   `spg` consecutive samples is one unit of work, few samples at small B
//   so that the groups cover the SMs, up to 8 at large B; a persistent
//   grid of up to three blocks per SM walks the groups.
// - Staging: a group's x rows are one contiguous span, each sample's ly
//   rows another (at an odd number of 16-byte units, against bank
//   conflicts); they move into shared memory as 16-byte cp.async units
//   (common.cuh, stage_span) into a two-stage ring, the next group's copies
//   in flight while this group computes.  No integer division per element.
// - Stage 1, register tiles (gram_tile): the lower triangle of G,
//   diagonal included, in 4 x 4 tiles (F = 27: 28 tiles for 378 entries);
//   a thread owns a (sample, tile), lanes the samples of one tile, and
//   writes the tile's entries on or below the diagonal into the sample's
//   packed triangle in shared memory (an odd stride of f32 entries a
//   sample).  Each entry is one fmaf chain in d order, the one-stage
//   kernel's loop, so the two agree bit for bit.
// - Stage 2: the group's output rows [x, pairs], one contiguous span of
//   global memory, leave as 16-byte stores (common.cuh, store_span_of),
//   each value read from the staged x or from the triangle through the
//   pair table, staged once a block (read through L1 instead, bf16 took
//   7% longer at B=65,536); one division a 16-byte unit finds its sample.
//   No output span is staged, so the ring, the table and the triangles of
//   8 samples fit three blocks an SM.  bf16 rounds once, at this store, as
//   the reference's f32 gram -> exact selection -> cast does.
// - No tensor cores: the reference computes at Precision.HIGHEST, TF32
//   loses precision, and a bf16 mma sums in its own order, which would
//   break the equality with the one-stage kernel.
// Offsets into global memory are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using evstore::load_f32;
using evstore::pair_of;
using evstore::phase16;
using evstore::span_bytes;
using evstore::to_f32;

constexpr int THREADS = 256;
constexpr int R = 4;  // a tile is R x R Gram entries

// The shared region of one sample's ly rows (`bytes` of them): an odd
// number of 16-byte units, so that the regions of 8 consecutive samples
// start in 8 distinct bank groups (interaction_fwd.cu's rule).
int64_t sample_stride(int64_t bytes) {
  const int64_t s = span_bytes(bytes);
  return s / 16 % 2 ? s : s + 16;
}

// Tile (ti, tj) of one sample's Gram F F^T: acc[a][c] = <f_i, f_j>,
// i = ti R + a and j = tj R + c clamped to F - 1, each one fmaf chain in d
// order 0..D-1, as interaction_fwd.cu computes each pair.  Feature 0 is
// the sample's x row (at xq), feature f > 0 its ly row f - 1 (at
// lq + (f - 1) D).  Each of the 2R rows' d-slices is one V-wide shared
// load per V values of d.  (interaction_fwd.cu keeps its own copy of this
// loop: calling this one from there slowed it at the train and serve
// batches; PERF.md §6 has the times.)
template <typename T, int V>
__device__ __forceinline__ void gram_tile(const T* xq, const T* lq, int ti,
                                          int tj, int F, int D,
                                          float (&acc)[R][R]) {
  const T* ra[R];
  const T* rc[R];
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int i = min(ti * R + a, F - 1);
    const int j = min(tj * R + a, F - 1);
    ra[a] = i == 0 ? xq : lq + (i - 1) * D;
    rc[a] = j == 0 ? xq : lq + (j - 1) * D;
  }
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
}

// T: storage type; V: values per shared load (4 when D % 4 == 0 and the
// rows are aligned for it, else 1).  gs: f32 entries of a sample's packed
// triangle in shared memory (F (F + 1) / 2 rounded up to odd).
template <typename T, int V>
__global__ void __launch_bounds__(THREADS, 3)
interaction_gram_kernel(const T* __restrict__ x, const T* __restrict__ ly,
                        const int* __restrict__ tab, T* __restrict__ out,
                        int64_t B, int nt, int D, int P, int spg, int xr,
                        int lss, int gs) {
  extern __shared__ __align__(16) char smem[];
  const int F = nt + 1;
  const int W = D + P;
  const int nti = (F + R - 1) / R;
  const int ntiles = nti * (nti + 1) / 2;
  const int tid = threadIdx.x;
  const int64_t ngroups = (B + spg - 1) / spg;
  const int stage = xr + spg * lss;
  float* gram = (float*)(smem + 2 * stage);  // [spg][gs]
  int* ptab = (int*)(gram + spg * gs);        // [P]

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
  for (int p = tid; p < P; p += THREADS) ptab[p] = tab[p];
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

    // stage 1: each sample's packed lower triangle, diagonal included;
    // samples vary fastest across the lanes (8 lanes of a quarter warp
    // read one row of 8 samples, in 8 distinct bank groups)
    for (int w = tid; w < ns * ntiles; w += THREADS) {
      const int t = w / ns;
      const int q = w - t * ns;
      int ti, tj;
      pair_of(t, 1, &ti, &tj);  // tile t = ti (ti + 1) / 2 + tj
      const T* lq = (const T*)(cur + xr + q * lss +
                               phase16(ly + (b0 + q) * nt * D));
      float acc[R][R];
      gram_tile<T, V>(xs + q * D, lq, ti, tj, F, D, acc);
      float* gq = gram + q * gs;
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const int i = ti * R + a;
        const int base = i * (i + 1) / 2;
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const int j = tj * R + c;
          if (i < F && j <= i) gq[base + j] = acc[a][c];
        }
      }
    }
    __syncthreads();

    // stage 2: the group's output rows [x, pairs] through the pair table
    auto fill = [&](int e0, float* v, int cnt) {
      int q = e0 / W;
      int c = e0 - q * W;
#pragma unroll
      for (int k = 0; k < cnt; ++k) {
        v[k] = c < D ? to_f32(xs[q * D + c])
                     : gram[q * gs + ptab[c - D]];
        if (++c == W) {
          c = 0;
          ++q;
        }
      }
    };
    evstore::store_span_of(out + b0 * W, ns * W, tid, THREADS, fill);
    // the next iteration stages into this group's ring slot and triangles
    __syncthreads();
  }
  evstore::cp_async_wait<0>();
}

template <typename T, int V>
int launch(const void* x, const void* ly, const void* tab, void* out,
           int64_t B, int nt, int D, int P, int spg, int blocks, int xr,
           int lss, int gs, size_t smem, int device, cudaStream_t st) {
  // raise the block's dynamic shared memory limit once per device
  static bool ready[64] = {};
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        interaction_gram_kernel<T, V>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        evstore::kMaxDynamicSmem);
    if (err != cudaSuccess) return (int)err;
    ready[device] = true;
  }
  interaction_gram_kernel<T, V><<<blocks, THREADS, smem, st>>>(
      (const T*)x, (const T*)ly, (const int*)tab, (T*)out, B, nt, D, P, spg,
      xr, lss, gs);
  return (int)cudaGetLastError();
}

}  // namespace

// spg: samples per group; blocks: the persistent grid
// (ops/cuda_interaction.py::gram_geometry).
extern "C" int interaction_gram(const void* x, const void* ly,
                                const void* tab, void* out, int64_t B,
                                int nt, int D, int P, int is_bf16, int spg,
                                int blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || nt < 1 || D < 1 || P < 1 || spg < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t F = nt + 1;
  const int es = is_bf16 ? 2 : 4;
  const int64_t xr = span_bytes((int64_t)spg * D * es);
  const int64_t lss = sample_stride((int64_t)nt * D * es);
  const int64_t gs = (F * (F + 1) / 2) | 1;  // odd
  const int64_t smem = 2 * (xr + spg * lss) + (spg * gs + P) * 4;
  if (smem > evstore::kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  const int64_t ngroups = (B + spg - 1) / spg;
  if (blocks > ngroups) blocks = (int)ngroups;
  const bool vec = D % 4 == 0 &&
                   (((uintptr_t)x | (uintptr_t)ly) % (4 * es)) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    return vec ? launch<__nv_bfloat16, 4>(x, ly, tab, out, B, nt, D, P, spg,
                                          blocks, (int)xr, (int)lss, (int)gs,
                                          smem, device, st)
               : launch<__nv_bfloat16, 1>(x, ly, tab, out, B, nt, D, P, spg,
                                          blocks, (int)xr, (int)lss, (int)gs,
                                          smem, device, st);
  }
  return vec ? launch<float, 4>(x, ly, tab, out, B, nt, D, P, spg, blocks,
                                (int)xr, (int)lss, (int)gs, smem, device, st)
             : launch<float, 1>(x, ly, tab, out, B, nt, D, P, spg, blocks,
                                (int)xr, (int)lss, (int)gs, smem, device, st);
}
