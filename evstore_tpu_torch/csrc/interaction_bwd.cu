// DLRM dot-interaction backward (the VJP of interaction_fwd) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel evstore_tpu/ops/pallas_interaction.py::
// _blocked_bwd_kernel (reached through dot_interaction_blocked's VJP).  For
// each sample b, with feat[b] = [x[b]; ly[b, 0..T-1]] (F = T+1 rows of width
// D) and the output cotangent g[b] = [g_x (D) | g_pair (P)]:
//
//   S[i, j] = S[j, i] = g_pair[p]     for each tril pair p = (i, j), i > j
//   S[i, i] = 2 g_pair[p]             for a diagonal pair (self_interaction)
//   dF      = S . feat[b]             ([F, F] x [F, D])
//   dx[b]   = g_x + dF[0],   dly[b, t] = dF[1 + t]
//
// S is dG + dG^T for the lower-triangular pair cotangent dG, so a diagonal
// entry carries twice its cotangent: d(f_i . f_i)/d f_i = 2 f_i.  (The TPU
// kernel's selector puts a single 1 there and returns half of it.)  The pair
// order is np.tril_indices.  f32 and bf16 storage; every product and sum is
// f32 and bf16 rounds once, at the store.
//
// Bound on this card: bytes.  At B=65536, T=26, D=36, f32 it reads 254.8 MB
// of features and 101.4 MB of cotangent and writes 254.8 MB (~182 us at
// 3.35 TB/s) for 3.4 GFLOP (~51 us on the f32 CUDA cores); at the train
// batch of 128 the bound is 0.36 us, so there every SM needs work.  The
// design follows interaction_fwd.cu:
//
// - Geometry from B (ops/cuda_interaction.py::interaction_geometry): groups
//   of `spg` consecutive samples walked by a persistent grid.
// - Staging: a group's x, ly and g rows are three contiguous spans, copied
//   as 16-byte cp.async units into a two-stage ring (common.cuh).
// - S, built once a group: a thread a row f writes S[f, 0..F) as f32 into
//   a [F, F rounded up to 4] matrix, reading g_pair at the tril index of
//   (max(f, j), min(f, j)) (along row f of the tril for j < f, down its
//   column f for j > f), doubled on the diagonal under self_interaction
//   and zero there otherwise.  Every write is one thread's own row: no
//   scattered symmetric stores.  Reading the pair index inside the product
//   loop instead (the first version of this design) cost a divergent
//   three-way choice per row and j, and ran at 34% of the bound; the
//   dense S turns the loop into loads and FMAs.
// - Register tiles of dF: a thread owns 6 rows f x 4 columns d of one
//   sample; per 4 j it reads 6 16-byte rows of S (lanes with the same rows
//   read the same ones) and per j one 16-byte (f32) or 8-byte (bf16) slice
//   of feat[j], for 24 FMAs.  Each output is one fmaf chain over
//   j = 0..F-1.
// - Stores: straight from registers, V values of one row a thread (16 or
//   8 bytes); the 9 lanes of a 144-byte row write it whole, and the rows
//   of a group follow each other, so the stores are coalesced without a
//   pass through shared memory, which keeps S and the ring at three
//   blocks an SM.
// - Deterministic: no atomics, every sum has a fixed order.
// Offsets into global memory are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using evstore::from_f32;
using evstore::load_f32;
using evstore::phase16;
using evstore::span_bytes;
using evstore::to_f32;

constexpr int THREADS = 256;
constexpr int RF = 6;  // rows f a thread owns

// S's row stride: F rounded up to a multiple of 4 (16-byte rows).
__host__ __device__ __forceinline__ int s_stride(int F) {
  return (F + 3) / 4 * 4;
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS, 3)
interaction_bwd_kernel(const T* __restrict__ x, const T* __restrict__ ly,
                       const T* __restrict__ g, T* __restrict__ dx,
                       T* __restrict__ dly, int64_t B, int nt, int D, int P,
                       int self, int spg, int xr, int lr, int gr) {
  extern __shared__ __align__(16) char smem[];
  const int F = nt + 1;
  const int Fp = s_stride(F);
  const int W = D + P;
  const int nft = (F + RF - 1) / RF;
  const int ndc = D / V;
  const int items = nft * ndc;
  const int tid = threadIdx.x;
  const int64_t ngroups = (B + spg - 1) / spg;
  const int stage = xr + lr + gr;
  float* S = (float*)(smem + 2 * stage);  // [spg][F][Fp]

  auto issue = [&](int64_t grp, char* st) {
    const int64_t b0 = grp * spg;
    const int ns = (int)(B - b0 < spg ? B - b0 : spg);
    evstore::stage_span(st, x + b0 * D, ns * D, tid, THREADS);
    evstore::stage_span(st + xr, ly + b0 * nt * D, ns * nt * D, tid,
                        THREADS);
    evstore::stage_span(st + xr + lr, g + b0 * W, ns * W, tid, THREADS);
  };

  int64_t grp = blockIdx.x;
  issue(grp, smem);
  evstore::cp_async_commit();
  for (int it = 0; grp < ngroups; grp += gridDim.x, ++it) {
    char* cur = smem + (it & 1) * stage;
    if (grp + gridDim.x < ngroups)
      issue(grp + gridDim.x, smem + (~it & 1) * stage);
    evstore::cp_async_commit();
    evstore::cp_async_wait<1>();
    __syncthreads();

    const int64_t b0 = grp * spg;
    const int ns = (int)(B - b0 < spg ? B - b0 : spg);
    const T* xs = (const T*)(cur + phase16(x + b0 * D));
    const T* ls = (const T*)(cur + xr + phase16(ly + b0 * nt * D));
    const T* gs = (const T*)(cur + xr + lr + phase16(g + b0 * W));

    // S of each sample, a thread a row f: S[f, j] is the pair cotangent
    // at the tril index of (max(f, j), min(f, j)); its contiguous reads
    // run along row f of the tril for j < f and down column f for j > f
    for (int rr = tid; rr < ns * F; rr += THREADS) {
      const int q = rr / F;
      const int f = rr - q * F;
      const T* gp = gs + q * W + D;
      float* Sr = S + rr * Fp;
      const int tf = self ? f * (f + 1) / 2 : f * (f - 1) / 2;
      for (int j = 0; j < f; ++j) Sr[j] = to_f32(gp[tf + j]);
      Sr[f] = self ? 2.0f * to_f32(gp[tf + f]) : 0.0f;
      int tj = self ? (f + 1) * (f + 2) / 2 : (f + 1) * f / 2;
      for (int j = f + 1; j < F; ++j) {
        Sr[j] = to_f32(gp[tj + f]);
        tj += self ? j + 1 : j;
      }
      for (int j = F; j < Fp; ++j) Sr[j] = 0.0f;
    }
    __syncthreads();

    for (int w = tid; w < ns * items; w += THREADS) {
      const int q = w / items;
      const int r = w - q * items;
      const int ft = r / ndc;
      const int d = (r - ft * ndc) * V;
      const float* Sq = S + q * F * Fp;
      const T* xq = xs + q * D + d;   // feature row 0
      const T* lq = ls + q * nt * D + d;  // row j >= 1 at lq + (j - 1) D
      int srow[RF];
#pragma unroll
      for (int a = 0; a < RF; ++a) srow[a] = min(ft * RF + a, F - 1) * Fp;
      float acc[RF][V];
#pragma unroll
      for (int a = 0; a < RF; ++a)
#pragma unroll
        for (int k = 0; k < V; ++k) acc[a][k] = 0.0f;
      int j = 0;
      for (; j + 4 <= F; j += 4) {
        float s[RF][4];
#pragma unroll
        for (int a = 0; a < RF; ++a) load_f32<4>(Sq + srow[a] + j, s[a]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float v[V];
          load_f32<V>(j + jj == 0 ? xq : lq + (j + jj - 1) * D, v);
#pragma unroll
          for (int a = 0; a < RF; ++a)
#pragma unroll
            for (int k = 0; k < V; ++k)
              acc[a][k] = fmaf(s[a][jj], v[k], acc[a][k]);
        }
      }
      for (; j < F; ++j) {
        float v[V];
        load_f32<V>(j == 0 ? xq : lq + (j - 1) * D, v);
#pragma unroll
        for (int a = 0; a < RF; ++a) {
          const float sv = Sq[srow[a] + j];
#pragma unroll
          for (int k = 0; k < V; ++k) acc[a][k] = fmaf(sv, v[k], acc[a][k]);
        }
      }
      // dx = g_x + dF[0], dly = dF[1:], V values a row
      const int64_t b = b0 + q;
#pragma unroll
      for (int a = 0; a < RF; ++a) {
        const int fa = ft * RF + a;
        if (fa < F) {
          if (fa == 0) {
#pragma unroll
            for (int k = 0; k < V; ++k)
              acc[a][k] += to_f32(gs[q * W + d + k]);
            evstore::store_f32<V>(dx + b * D + d, acc[a]);
          } else {
            evstore::store_f32<V>(dly + (b * nt + fa - 1) * D + d, acc[a]);
          }
        }
      }
    }
    __syncthreads();  // before the next issue overwrites this stage and S
  }
  evstore::cp_async_wait<0>();
}

template <typename T, int V>
int launch(const void* x, const void* ly, const void* g, void* dx, void* dly,
           int64_t B, int nt, int D, int P, int self, int spg, int blocks,
           int xr, int lr, int gr, size_t smem, int device, cudaStream_t st) {
  // raise the block's dynamic shared memory limit once per device
  static bool ready[64] = {};
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        interaction_bwd_kernel<T, V>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        evstore::kMaxDynamicSmem);
    if (err != cudaSuccess) return (int)err;
    ready[device] = true;
  }
  interaction_bwd_kernel<T, V><<<blocks, THREADS, smem, st>>>(
      (const T*)x, (const T*)ly, (const T*)g, (T*)dx, (T*)dly, B, nt, D, P,
      self, spg, xr, lr, gr);
  return (int)cudaGetLastError();
}

}  // namespace

// spg: samples per group; blocks: the persistent grid.
extern "C" int interaction_bwd(const void* x, const void* ly, const void* g,
                               void* dx, void* dly, int64_t B, int nt, int D,
                               int self_interaction, int is_bf16, int spg,
                               int blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || nt < 1 || D < 1 || spg < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const int F = nt + 1;
  const int self = self_interaction ? 1 : 0;
  const int P = F * (F - 1) / 2 + (self ? F : 0);
  const int es = is_bf16 ? 2 : 4;
  const int64_t xr = span_bytes((int64_t)spg * D * es);
  const int64_t lr = span_bytes((int64_t)spg * nt * D * es);
  const int64_t gr = span_bytes((int64_t)spg * (D + P) * es);
  const int64_t smem = 2 * (xr + lr + gr) +
                       (int64_t)spg * F * s_stride(F) * 4;
  if (smem > evstore::kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  const int64_t ngroups = (B + spg - 1) / spg;
  if (blocks > ngroups) blocks = (int)ngroups;
  const bool vec =
      D % 4 == 0 &&
      (((uintptr_t)x | (uintptr_t)ly | (uintptr_t)dx | (uintptr_t)dly) %
       (4 * es)) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    return vec ? launch<__nv_bfloat16, 4>(x, ly, g, dx, dly, B, nt, D, P,
                                          self, spg, blocks, (int)xr,
                                          (int)lr, (int)gr, smem, device, st)
               : launch<__nv_bfloat16, 1>(x, ly, g, dx, dly, B, nt, D, P,
                                          self, spg, blocks, (int)xr,
                                          (int)lr, (int)gr, smem, device,
                                          st);
  }
  return vec ? launch<float, 4>(x, ly, g, dx, dly, B, nt, D, P, self, spg,
                                blocks, (int)xr, (int)lr, (int)gr, smem,
                                device, st)
             : launch<float, 1>(x, ly, g, dx, dly, B, nt, D, P, self, spg,
                                blocks, (int)xr, (int)lr, (int)gr, smem,
                                device, st);
}
