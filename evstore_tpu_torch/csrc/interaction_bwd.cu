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
// order is np.tril_indices, computed by the forward's pair_of.  f32 and bf16
// storage; every product and sum is f32 and bf16 rounds once, at the store.
//
// Bound on this card: bytes.  At B=65536, T=26, D=36, f32 it reads 254.8 MB
// of features and 101.4 MB of cotangent and writes 254.8 MB (~182 us at
// 3.35 TB/s) for 3.4 GFLOP (~51 us on the f32 CUDA cores).  So every input
// is read once: a block stages its samples' F x D features and their
// symmetrised F x F cotangent in shared memory (coalesced feature loads; one
// thread per pair writes its one or two S entries), then one thread per
// output (f, d) sums S[f, j] * feat[j, d] over j in f32 registers.  The
// lanes of a warp walk consecutive d, so the S read is a broadcast and the
// feature reads hit distinct banks; the stores are coalesced.  Offsets into
// global memory are 64-bit.  Tensor-core products are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using evstore::from_f32;
using evstore::pair_of;
using evstore::to_f32;

template <typename T>
__global__ void interaction_bwd_kernel(const T* __restrict__ x,
                                       const T* __restrict__ ly,
                                       const T* __restrict__ g,
                                       T* __restrict__ dx,
                                       T* __restrict__ dly, int64_t B, int nt,
                                       int D, int P, int self, int spb,
                                       int dp, int fp) {
  extern __shared__ float smem[];
  const int F = nt + 1;
  float* feat = smem;                  // [spb][F][dp]
  float* S = smem + spb * F * dp;      // [spb][F][fp]
  const int64_t b0 = (int64_t)blockIdx.x * spb;
  const int64_t rem = B - b0;
  const int ns = rem < spb ? (int)rem : spb;
  const int64_t og = (int64_t)D + P;
  const int fd = F * D;

  for (int e = threadIdx.x; e < ns * fd; e += blockDim.x) {
    const int s = e / fd;
    const int r = e - s * fd;
    const int f = r / D;
    const int d = r - f * D;
    const int64_t b = b0 + s;
    feat[(s * F + f) * dp + d] =
        f == 0 ? to_f32(x[b * D + d])
               : to_f32(ly[(b * nt + (f - 1)) * (int64_t)D + d]);
  }
  // every off-diagonal entry belongs to exactly one pair; the diagonal is
  // written by its pair under self_interaction and is zero otherwise
  if (!self) {
    for (int e = threadIdx.x; e < ns * F; e += blockDim.x) {
      const int s = e / F;
      const int f = e - s * F;
      S[(s * F + f) * fp + f] = 0.0f;
    }
  }
  for (int w = threadIdx.x; w < ns * P; w += blockDim.x) {
    const int s = w / P;
    const int p = w - s * P;
    int i, j;
    pair_of(p, self, &i, &j);
    const float v = to_f32(g[(b0 + s) * og + D + p]);
    float* Ss = S + s * F * fp;
    if (i == j) {
      Ss[i * fp + i] = 2.0f * v;
    } else {
      Ss[i * fp + j] = v;
      Ss[j * fp + i] = v;
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < ns * fd; e += blockDim.x) {
    const int s = e / fd;
    const int r = e - s * fd;
    const int f = r / D;
    const int d = r - f * D;
    const int64_t b = b0 + s;
    const float* Sr = S + (s * F + f) * fp;
    const float* fc = feat + s * F * dp + d;
    float acc = 0.0f;
    for (int j = 0; j < F; ++j) acc = fmaf(Sr[j], fc[j * dp], acc);
    if (f == 0) {
      dx[b * D + d] = from_f32<T>(to_f32(g[b * og + d]) + acc);
    } else {
      dly[(b * nt + (f - 1)) * (int64_t)D + d] = from_f32<T>(acc);
    }
  }
}

}  // namespace

extern "C" int interaction_bwd(const void* x, const void* ly, const void* g,
                               void* dx, void* dly, int64_t B, int nt, int D,
                               int self_interaction, int is_bf16, int spb,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || nt < 1 || D < 1 || spb < 1) return (int)cudaErrorInvalidValue;
  const int F = nt + 1;
  const int P = F * (F - 1) / 2 + (self_interaction ? F : 0);
  const int dp = (D % 2 == 0) ? D + 1 : D;
  const int fp = (F % 2 == 0) ? F + 1 : F;
  const size_t smem = (size_t)spb * F * (dp + fp) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int64_t blocks = (B + spb - 1) / spb;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int self = self_interaction ? 1 : 0;
  if (is_bf16) {
    interaction_bwd_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, smem,
                                            st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)ly,
        (const __nv_bfloat16*)g, (__nv_bfloat16*)dx, (__nv_bfloat16*)dly, B,
        nt, D, P, self, spb, dp, fp);
  } else {
    interaction_bwd_kernel<float><<<(unsigned)blocks, threads, smem, st>>>(
        (const float*)x, (const float*)ly, (const float*)g, (float*)dx,
        (float*)dly, B, nt, D, P, self, spb, dp, fp);
  }
  return (int)cudaGetLastError();
}
