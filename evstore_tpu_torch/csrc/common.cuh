// Helpers shared by the port's kernels: f32 <-> storage-type conversions
// and the tril pair index of the dot interaction.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace evstore {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Pair p -> (i, j) in np.tril_indices row-major order, the column order of
// the interaction's output.  Row i starts at q(q-1)/2 with q = i (k=-1) or
// q = i+1 (k=0, self_interaction).
__device__ __forceinline__ void pair_of(int p, int self, int* i, int* j) {
  int q = (int)((1.0f + sqrtf(1.0f + 8.0f * (float)p)) * 0.5f);
  while (q * (q - 1) / 2 > p) --q;
  while ((q + 1) * q / 2 <= p) ++q;
  *i = self ? q - 1 : q;
  *j = p - q * (q - 1) / 2;
}

}  // namespace evstore
