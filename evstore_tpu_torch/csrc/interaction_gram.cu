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
// A block takes `spb` samples:
//   1. it stages their features in shared memory as f32 (coalesced loads;
//      rows padded to an odd stride `dp`, so the lanes of a warp, which
//      walk neighbouring j, hit distinct banks) and the pair table;
//   2. its threads compute every entry of each sample's packed lower
//      triangle, f32 FMAs on the CUDA cores in d order (no TF32, no tensor
//      cores: the reference computes both products at Precision.HIGHEST),
//      into shared memory;
//   3. its threads write the samples' output rows [x, pairs], which are
//      contiguous in memory, as one coalesced stream, the pairs read
//      through the table.  bf16 rounds once, at this store, as the
//      reference's f32 gram -> exact selection -> cast does.
//
// Bound on this card: bytes.  At B=2048, T=26, D=36, f32 it reads 7.96 MB
// and writes 3.17 MB (3.32 us at 3.35 TB/s) for 0.05 GFLOP.  Stage 2
// computes F(F+1)/2 = 378 entries per sample for 351 pairs, the diagonal
// being the price of the TPU kernel's full Gram; the index table costs one
// shared-memory read per pair.  The one-stage kernel interaction_fwd.cu
// computes the same function pair by pair; this is the A/B that the JAX
// package kept its per-sample kernel for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using evstore::from_f32;
using evstore::pair_of;
using evstore::to_f32;

template <typename T>
__global__ void interaction_gram_kernel(const T* __restrict__ x,
                                        const T* __restrict__ ly,
                                        const int* __restrict__ tab,
                                        T* __restrict__ out, int64_t B,
                                        int nt, int D, int P, int spb,
                                        int dp) {
  extern __shared__ float smem[];
  const int F = nt + 1;
  const int NT = F * (F + 1) / 2;           // packed lower triangle
  int* ptab = reinterpret_cast<int*>(smem);  // [P]
  float* feat = smem + P;                    // [spb][F][dp]
  float* gram = feat + spb * F * dp;         // [spb][NT]
  const int64_t b0 = (int64_t)blockIdx.x * spb;
  const int64_t rem = B - b0;
  const int ns = rem < spb ? (int)rem : spb;
  const int fd = F * D;

  for (int p = threadIdx.x; p < P; p += blockDim.x) ptab[p] = tab[p];
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
  __syncthreads();

  // stage 1: each sample's lower-triangle Gram, diagonal included
  for (int w = threadIdx.x; w < ns * NT; w += blockDim.x) {
    const int s = w / NT;
    const int t = w - s * NT;
    int i, j;
    pair_of(t, 1, &i, &j);        // t = i (i + 1) / 2 + j, j <= i
    const float* a = feat + (s * F + i) * dp;
    const float* c = feat + (s * F + j) * dp;
    float acc = 0.0f;
    for (int d = 0; d < D; ++d) acc = fmaf(a[d], c[d], acc);
    gram[s * NT + t] = acc;
  }
  __syncthreads();

  // stage 2: the block's output rows [x, pairs], one contiguous stream
  const int W = D + P;
  T* o = out + b0 * W;
  for (int e = threadIdx.x; e < ns * W; e += blockDim.x) {
    const int s = e / W;
    const int c = e - s * W;
    const float v = c < D ? feat[(s * F) * dp + c]
                          : gram[s * NT + ptab[c - D]];
    o[e] = from_f32<T>(v);
  }
}

}  // namespace

extern "C" int interaction_gram(const void* x, const void* ly,
                                const void* tab, void* out, int64_t B,
                                int nt, int D, int P, int is_bf16, int spb,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || nt < 1 || D < 1 || P < 1 || spb < 1)
    return (int)cudaErrorInvalidValue;
  const int F = nt + 1;
  const int dp = (D % 2 == 0) ? D + 1 : D;
  const size_t smem =
      ((size_t)P + (size_t)spb * ((size_t)F * dp + F * (F + 1) / 2)) *
      sizeof(float);
  const int threads = 256;
  const int64_t blocks = (B + spb - 1) / spb;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    interaction_gram_kernel<__nv_bfloat16>
        <<<(unsigned)blocks, threads, smem, st>>>(
            (const __nv_bfloat16*)x, (const __nv_bfloat16*)ly,
            (const int*)tab, (__nv_bfloat16*)out, B, nt, D, P, spb, dp);
  } else {
    interaction_gram_kernel<float><<<(unsigned)blocks, threads, smem, st>>>(
        (const float*)x, (const float*)ly, (const int*)tab, (float*)out, B,
        nt, D, P, spb, dp);
  }
  return (int)cudaGetLastError();
}
