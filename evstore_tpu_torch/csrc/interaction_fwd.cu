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
// self_interaction).  f32 and bf16 inputs; sums accumulate in f32 and bf16
// rounds once at the store, the JAX rounding chain (f32 gram -> cast ->
// exact 0/1 selection).
//
// Bound on this card: bytes.  At B=65536, T=26, D=36, f32 it reads 254.8 MB
// and writes 101.4 MB (~106 us at 3.35 TB/s) for 1.66 GFLOP (~25 us on the
// f32 CUDA cores).  The design therefore reads every input once: a block
// stages its samples' F x D features in shared memory with coalesced loads
// (row stride padded to an odd number of floats, so the lanes of a warp,
// which walk consecutive pairs, hit distinct banks), then each thread owns
// pairs p, accumulates the dot in f32 registers and stores once; consecutive
// threads store consecutive columns.  Offsets into global memory are 64-bit.
// Tensor-core grams (wgmma) and fusing the row gather into the staging are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using evstore::from_f32;
using evstore::pair_of;
using evstore::to_f32;

template <typename T>
__global__ void interaction_fwd_kernel(const T* __restrict__ x,
                                       const T* __restrict__ ly,
                                       T* __restrict__ out, int64_t B, int nt,
                                       int D, int P, int self, int spb,
                                       int dp) {
  extern __shared__ float feat[];  // [spb][F][dp]
  const int F = nt + 1;
  const int64_t b0 = (int64_t)blockIdx.x * spb;
  const int64_t rem = B - b0;
  const int ns = rem < spb ? (int)rem : spb;
  const int64_t od = (int64_t)D + P;
  const int fd = F * D;

  for (int e = threadIdx.x; e < ns * fd; e += blockDim.x) {
    const int s = e / fd;
    const int r = e - s * fd;
    const int f = r / D;
    const int d = r - f * D;
    const int64_t b = b0 + s;
    if (f == 0) {
      const T v = x[b * D + d];
      feat[(s * F) * dp + d] = to_f32(v);
      out[b * od + d] = v;
    } else {
      feat[(s * F + f) * dp + d] =
          to_f32(ly[(b * nt + (f - 1)) * (int64_t)D + d]);
    }
  }
  __syncthreads();

  for (int w = threadIdx.x; w < ns * P; w += blockDim.x) {
    const int s = w / P;
    const int p = w - s * P;
    int i, j;
    pair_of(p, self, &i, &j);
    const float* a = feat + (s * F + i) * dp;
    const float* c = feat + (s * F + j) * dp;
    float acc = 0.0f;
    for (int d = 0; d < D; ++d) acc = fmaf(a[d], c[d], acc);
    out[(b0 + s) * od + D + p] = from_f32<T>(acc);
  }
}

}  // namespace

extern "C" int interaction_fwd(const void* x, const void* ly, void* out,
                               int64_t B, int nt, int D, int self_interaction,
                               int is_bf16, int spb, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || nt < 1 || D < 1 || spb < 1) return (int)cudaErrorInvalidValue;
  const int F = nt + 1;
  const int P = F * (F - 1) / 2 + (self_interaction ? F : 0);
  const int dp = (D % 2 == 0) ? D + 1 : D;
  const size_t smem = (size_t)spb * F * dp * sizeof(float);
  const int threads = 256;
  const int64_t blocks = (B + spb - 1) / spb;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    interaction_fwd_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, smem,
                                            st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)ly,
        (__nv_bfloat16*)out, B, nt, D, P, self_interaction ? 1 : 0, spb, dp);
  } else {
    interaction_fwd_kernel<float><<<(unsigned)blocks, threads, smem, st>>>(
        (const float*)x, (const float*)ly, (float*)out, B, nt, D, P,
        self_interaction ? 1 : 0, spb, dp);
  }
  return (int)cudaGetLastError();
}
