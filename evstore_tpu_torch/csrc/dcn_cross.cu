// The elementwise part of a low-rank cross layer of DCN V2, for Hopper
// (sm_90a): K8.
//
// Replaces no TPU kernel: the JAX package has no cross network.  MLPerf's
// DLRM-DCNv2 (torchrec's LowRankCrossNet) computes, for each of its layers,
//
//   x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l
//
// The two products stay in cuBLAS; u = W_l (V_l x_l) (no bias) comes to
// these kernels, which fuse what is left around them:
//
//   dcn_cross_fwd:  y = x0 * (u + b) + xl              x0, u, xl, y [B, N]
//   dcn_cross_bwd:  gu = g * x0                          (to the products)
//                   gx0 = [gx0 +] g * (u + b) [+ g]      (x0's gradient)
//                   gb = the column sums of gu           (b's gradient)
//
// gx0 sums x0's gradient over the layers in place: the first layer the
// backward reaches writes it, the others add to it, and the layer whose
// input is x0 itself adds its residual's g too.  b's gradient is a sum over
// the batch: each block sums its rows of a column in a register and writes
// one partial a column; `cross_bias_sum_kernel` then adds the partials of a
// column in block order.  No atomics, so every sum has one order and the
// kernels are bitwise repeatable.
//
// Bound on this card: bytes.  At B = 16,384 and N = 27 x 128 = 3,456 a
// layer's forward moves 4 [B, N] float32 arrays (0.91 GB, 0.27 ms at 3.35
// TB/s) and its backward 6 (1.36 GB, 0.41 ms), at 3 and 5 operations an
// element.  So the design is streaming: a block is THREADS columns of
// 16-byte vectors (4 floats) over rows blockIdx.y, blockIdx.y + gridDim.y,
// ...; neighbouring threads read neighbouring 16 bytes of a row, each
// thread keeps ROWS rows' loads in flight, and a column's bias and its
// partial sum stay in registers across the thread's rows.  Rows of another
// width, or arrays off a 16-byte boundary, take the same loop one float at
// a time.

#include <cuda_runtime.h>
#include <stdint.h>

// a named namespace, so that the profiler's name of every kernel here,
// templated or not, ends in "::<kernel>"
namespace dcn {

constexpr int THREADS = 128;
constexpr int ROWS = 4;  // rows whose loads a thread issues together

template <int W> struct Vec { float v[W]; };

template <int W>
__device__ __forceinline__ Vec<W> load(const float* p) {
  Vec<W> r;
  if constexpr (W == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = q.x; r.v[1] = q.y; r.v[2] = q.z; r.v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) r.v[k] = __ldg(p + k);
  }
  return r;
}

// a plain load, for gx0, which the kernel also writes
template <int W>
__device__ __forceinline__ Vec<W> load_rw(const float* p) {
  Vec<W> r;
  if constexpr (W == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    r.v[0] = q.x; r.v[1] = q.y; r.v[2] = q.z; r.v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) r.v[k] = p[k];
  }
  return r;
}

template <int W>
__device__ __forceinline__ void store(float* p, const Vec<W>& r) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2],
                                                r.v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) p[k] = r.v[k];
  }
}

// y = x0 * (u + b) + xl over rows [blockIdx.y :: gridDim.y) of column
// vector c
template <int W>
__global__ void __launch_bounds__(THREADS)
cross_fwd_kernel(const float* __restrict__ x0, const float* __restrict__ u,
                 const float* __restrict__ b, const float* __restrict__ xl,
                 float* __restrict__ y, int64_t B, int N) {
  const int c = (blockIdx.x * THREADS + threadIdx.x) * W;
  if (c >= N) return;
  const Vec<W> bc = load<W>(b + c);
  const int64_t step = gridDim.y;
  for (int64_t r0 = blockIdx.y; r0 < B; r0 += step * ROWS) {
    Vec<W> a[ROWS], p[ROWS], q[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int64_t r = r0 + j * step;
      if (r < B) {
        const int64_t o = r * N + c;
        a[j] = load<W>(x0 + o);
        p[j] = load<W>(u + o);
        q[j] = load<W>(xl + o);
      }
    }
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int64_t r = r0 + j * step;
      if (r < B) {
        Vec<W> o;
#pragma unroll
        for (int k = 0; k < W; ++k)
          o.v[k] = a[j].v[k] * (p[j].v[k] + bc.v[k]) + q[j].v[k];
        store<W>(y + r * N + c, o);
      }
    }
  }
}

// gu = g * x0; gx0 = [gx0 +] g * (u + b) [+ g]; partial[blockIdx.y, c] =
// the sum of gu over the block's rows, in row order
template <int W>
__global__ void __launch_bounds__(THREADS)
cross_bwd_kernel(const float* __restrict__ g, const float* __restrict__ x0,
                 const float* __restrict__ u, const float* __restrict__ b,
                 float* __restrict__ gu, float* gx0,
                 float* __restrict__ partial, int64_t B, int N,
                 int accumulate, int residual) {
  const int c = (blockIdx.x * THREADS + threadIdx.x) * W;
  if (c >= N) return;
  const Vec<W> bc = load<W>(b + c);
  const float res = residual ? 1.0f : 0.0f;
  Vec<W> sum;
#pragma unroll
  for (int k = 0; k < W; ++k) sum.v[k] = 0.0f;
  const int64_t step = gridDim.y;
  for (int64_t r0 = blockIdx.y; r0 < B; r0 += step * ROWS) {
    Vec<W> gg[ROWS], a[ROWS], p[ROWS], acc[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int64_t r = r0 + j * step;
      if (r < B) {
        const int64_t o = r * N + c;
        gg[j] = load<W>(g + o);
        a[j] = load<W>(x0 + o);
        p[j] = load<W>(u + o);
        if (accumulate) acc[j] = load_rw<W>(gx0 + o);
      }
    }
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int64_t r = r0 + j * step;
      if (r < B) {
        Vec<W> du, dx;
#pragma unroll
        for (int k = 0; k < W; ++k) {
          du.v[k] = gg[j].v[k] * a[j].v[k];
          const float t = gg[j].v[k] * (p[j].v[k] + bc.v[k]) +
                          res * gg[j].v[k];
          dx.v[k] = accumulate ? acc[j].v[k] + t : t;
          sum.v[k] += du.v[k];
        }
        const int64_t o = r * N + c;
        store<W>(gu + o, du);
        store<W>(gx0 + o, dx);
      }
    }
  }
  store<W>(partial + (int64_t)blockIdx.y * N + c, sum);
}

// gb[c] = the sum of partial[0..blocks, c], in block order
__global__ void __launch_bounds__(THREADS)
cross_bias_sum_kernel(const float* __restrict__ partial,
                      float* __restrict__ gb, int blocks, int N) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= N) return;
  float s = 0.0f;
  for (int j = 0; j < blocks; ++j) s += __ldg(partial + (int64_t)j * N + c);
  gb[c] = s;
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

inline dim3 grid_of(int N, int W, int row_blocks) {
  const int cols = (N / W + THREADS - 1) / THREADS;
  return dim3((unsigned)cols, (unsigned)row_blocks);
}

}  // namespace dcn

using dcn::aligned16;
using dcn::cross_bias_sum_kernel;
using dcn::cross_bwd_kernel;
using dcn::cross_fwd_kernel;
using dcn::grid_of;
using dcn::THREADS;

extern "C" int dcn_cross_fwd(const void* x0, const void* u, const void* b,
                             const void* xl, void* y, int64_t B, int N,
                             int row_blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || N <= 0 || row_blocks <= 0 || row_blocks > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool v4 = N % 4 == 0 && aligned16(x0) && aligned16(u) &&
                  aligned16(b) && aligned16(xl) && aligned16(y);
  if (v4) {
    cross_fwd_kernel<4><<<grid_of(N, 4, row_blocks), THREADS, 0, st>>>(
        (const float*)x0, (const float*)u, (const float*)b, (const float*)xl,
        (float*)y, B, N);
  } else {
    cross_fwd_kernel<1><<<grid_of(N, 1, row_blocks), THREADS, 0, st>>>(
        (const float*)x0, (const float*)u, (const float*)b, (const float*)xl,
        (float*)y, B, N);
  }
  return (int)cudaGetLastError();
}

// partial: float32 [row_blocks, N] scratch
extern "C" int dcn_cross_bwd(const void* g, const void* x0, const void* u,
                             const void* b, void* gu, void* gx0,
                             void* partial, void* gb, int64_t B, int N,
                             int row_blocks, int accumulate, int residual,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || N <= 0 || row_blocks <= 0 || row_blocks > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool v4 = N % 4 == 0 && aligned16(g) && aligned16(x0) &&
                  aligned16(u) && aligned16(b) && aligned16(gu) &&
                  aligned16(gx0) && aligned16(partial);
  if (v4) {
    cross_bwd_kernel<4><<<grid_of(N, 4, row_blocks), THREADS, 0, st>>>(
        (const float*)g, (const float*)x0, (const float*)u, (const float*)b,
        (float*)gu, (float*)gx0, (float*)partial, B, N, accumulate,
        residual);
  } else {
    cross_bwd_kernel<1><<<grid_of(N, 1, row_blocks), THREADS, 0, st>>>(
        (const float*)g, (const float*)x0, (const float*)u, (const float*)b,
        (float*)gu, (float*)gx0, (float*)partial, B, N, accumulate,
        residual);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cross_bias_sum_kernel<<<(unsigned)((N + THREADS - 1) / THREADS), THREADS,
                          0, st>>>((const float*)partial, (float*)gb,
                                   row_blocks, N);
  return (int)cudaGetLastError();
}
