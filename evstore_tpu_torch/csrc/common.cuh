// Helpers shared by the port's kernels: f32 <-> storage-type conversions,
// the tril pair index of the dot interaction, 16-byte staging of contiguous
// spans through shared memory, and 16-byte stores of computed spans.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// ---------------------------------------------------------------------------
// Staging contiguous spans between global and shared memory in 16-byte
// units.  A span of n elements at global address p is kept in a 16-byte
// aligned shared region of span_bytes(n) at byte offset phase16(p), so that
// its shared and global addresses agree modulo 16: every 16-byte unit of
// the span that is aligned in global memory is aligned in shared memory
// too, whatever the span's start.  The units move as 16-byte copies
// (cp.async on the way in), the unaligned head and tail element by element.

namespace evstore {

__device__ __forceinline__ int phase16(const void* p) {
  return (int)((uintptr_t)p & 15);
}

// The shared region that holds a span of `bytes`: room for the phase.
__host__ __device__ __forceinline__ int64_t span_bytes(int64_t bytes) {
  return (bytes + 15) / 16 * 16 + 16;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The elements [0, n) of a span split into a head before the first
// 16-byte boundary, whole units, and a tail.
struct SpanSplit {
  int head, units, tail0;  // elements, 16-byte units, first tail element
};

template <typename T>
__device__ __forceinline__ SpanSplit split_span(const void* p, int n) {
  int head = ((16 - phase16(p)) & 15) / (int)sizeof(T);
  if (head > n) head = n;
  const int units = (n - head) * (int)sizeof(T) / 16;
  return {head, units, head + units * 16 / (int)sizeof(T)};
}

// Issue the copy of src[0, n) into `region` (cp.async for the units, plain
// loads and stores for head and tail); the caller commits and waits.
template <typename T>
__device__ __forceinline__ void stage_span(char* region, const T* src, int n,
                                           int tid, int nthreads) {
  T* dst = (T*)(region + phase16(src));
  const SpanSplit s = split_span<T>(src, n);
  const char* gs = (const char*)(src + s.head);
  char* ss = (char*)(dst + s.head);
  for (int u = tid; u < s.units; u += nthreads)
    cp_async16(ss + 16 * u, gs + 16 * u);
  for (int e = tid; e < s.head; e += nthreads) dst[e] = src[e];
  for (int e = s.tail0 + tid; e < n; e += nthreads) dst[e] = src[e];
}

// Write the span staged in `region` (at phase16(dst)) to dst[0, n).
template <typename T>
__device__ __forceinline__ void store_span(T* dst, const char* region, int n,
                                           int tid, int nthreads) {
  const T* src = (const T*)(region + phase16(dst));
  const SpanSplit s = split_span<T>(dst, n);
  const uint4* ss = (const uint4*)(src + s.head);
  uint4* gd = (uint4*)(dst + s.head);
  for (int u = tid; u < s.units; u += nthreads) gd[u] = ss[u];
  for (int e = tid; e < s.head; e += nthreads) dst[e] = src[e];
  for (int e = s.tail0 + tid; e < n; e += nthreads) dst[e] = src[e];
}

// V consecutive values of a staged row as f32: one 16-byte (f32) or 8-byte
// (bf16) shared load for V = 4, a scalar load for V = 1.
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 u = *(const float4*)p;
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  } else {
    v[0] = p[0];
  }
}

template <int V>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float* v) {
  if constexpr (V == 4) {
    const uint2 u = *(const uint2*)p;
    const float2 a = __bfloat1622float2(*(const __nv_bfloat162*)&u.x);
    const float2 b = __bfloat1622float2(*(const __nv_bfloat162*)&u.y);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

// V f32 values stored to consecutive elements (one 16-byte or 8-byte store
// for V = 4, the address aligned for it; bf16 rounds to nearest even).
template <int V>
__device__ __forceinline__ void store_f32(float* p, const float* v) {
  if constexpr (V == 4) {
    *(float4*)p = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

template <int V>
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, const float* v) {
  if constexpr (V == 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *(const unsigned*)&a;
    u.y = *(const unsigned*)&b;
    *(uint2*)p = u;
  } else {
    p[0] = __float2bfloat16_rn(v[0]);
  }
}

// The most dynamic shared memory one block can have on Hopper (227 KB).
constexpr int kMaxDynamicSmem = 232448;

// Write dst[0, n) from fill(e0, v, cnt), which gives the f32 values of the
// cnt elements from e0 on: whole 16-byte units where dst is aligned for
// them (4 f32 or 8 bf16 values, one 16-byte or two 8-byte stores), element
// by element in the head and the tail.  bf16 rounds once, here.
template <typename T, typename Fill>
__device__ __forceinline__ void store_span_of(T* dst, int n, int tid,
                                              int nthreads, Fill fill) {
  constexpr int U = 16 / (int)sizeof(T);
  const SpanSplit s = split_span<T>(dst, n);
  for (int u = tid; u < s.units; u += nthreads) {
    const int e0 = s.head + u * U;
    float v[U];
    fill(e0, v, U);
#pragma unroll
    for (int k = 0; k < U; k += 4) store_f32<4>(dst + e0 + k, v + k);
  }
  for (int e = tid; e < s.head; e += nthreads) {
    float v[1];
    fill(e, v, 1);
    dst[e] = from_f32<T>(v[0]);
  }
  for (int e = s.tail0 + tid; e < n; e += nthreads) {
    float v[1];
    fill(e, v, 1);
    dst[e] = from_f32<T>(v[0]);
  }
}

}  // namespace evstore
