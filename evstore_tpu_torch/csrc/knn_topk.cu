// The alt-key kNN for Hopper (sm_90a): for each query row, the k rows of a
// key set with the smallest squared euclidean distance, self excluded.
//
// Replaces no TPU kernel.  The JAX package computes this function as XLA
// (evstore_tpu/tools/gen_altkeys.py:36::block_topk: the [block, N] distance
// matrix ||q||^2 + ||x||^2 - 2 q.x from one matmul, then lax.top_k), and the
// port's plain version (ops/cuda_knn.py::knn_topk_ref) does the same with
// torch.addmm and torch.topk.  That matrix is 276.6 GB for a block of 2,048
// queries over the Criteo Kaggle tables' 33,762,577 rows: it cannot be held
// on an 80 GB card.  This kernel writes no [Q, N] matrix: its memory is its
// tiles and k + m candidates a query row.
//
// Bound on this card: operations.  The full Kaggle kNN is 33.76M^2 pairs x
// 36 x 2 = 8.21e16 flop: 1,225 s at the float32 FMA peak (67 TFLOP/s), 184 s
// in TF32 on the tensor cores (D padded to 40, 495 TFLOP/s).  So the
// distances go through the tensor cores, and TF32 rounding is made safe by
// a lower bound and a certificate:
//
// - Pass 1 (knn_candidates, mode 0).  A block takes QB query rows (8 warps,
//   16 x MT rows each, their TF32 A fragments held in registers for the
//   whole pass) against every key, streamed through shared memory in
//   tiles of 64 keys on a cp.async ring.  mma.sync m16n8k8 TF32
//   with float32 accumulation computes, per pair,
//       acc = q~.x~ - (1 - c2) ||x||^2 / 2 + c1 ||q|| ||x|| / 2
//   where the last two terms ride in the padded dimensions D, D+1 (the
//   key's -(1-c2)||x||^2/2 split into a TF32 high and low part) and D+2
//   (||q|| against c1 ||x|| / 2); a per-key aux row [N, 4] holds them
//   (knn_prep).  Then LB = (1 - c2) ||q||^2 - 2 acc is a lower bound on the
//   exact float32 distance below: c1 covers the TF32 input rounding (the
//   tensor core truncates each input to 10 mantissa bits, 2^-10 relative)
//   and the accumulation, c2 the float32 norms, the accumulation of the
//   padded terms and the exact distance's own rounding.  Both are relative
//   to each pair, so rows of the Kaggle init's scales (row norms from about
//   3.5 down to 1e-3) side by side keep their bounds (ops/cuda_knn.py::
//   knn_bound_constants; the CPU tests hold the bound against float64 at
//   each of the 26 tables' scales).  The epilogue of each 16 x 8 tile is one
//   compare of acc against the row's threshold in acc space; only when a
//   warp has a hit does it insert each hit (LB, key) into its row's list of
//   L = k + m entries in shared memory (an unsorted array and its maximum),
//   all 32 lanes together.  Inserts are rare after warm-up, about
//   L (1 + ln(n / L)) a row over n keys in random order.
// - Pass 2 (knn_merge).  One warp a query row: the exact float32 distance
//   of every candidate, sum_i (q_i - x_i)^2 in index order (fused
//   multiply-adds), ranked by (distance, key id), so ties go to the lower
//   key as jax.lax.top_k orders them.  The certificate: every key not in
//   the row's list has LB at least the list's maximum M (less a rounding
//   margin); when M - margin exceeds the k-th exact distance, the row's top
//   k is exact.
// - A row that fails the certificate goes through mode 1 of pass 1: the
//   same ring and lists, the exact distance of every pair on the CUDA cores
//   and lists of k, then pass 2 without the certificate.  The wrapper
//   gathers those rows, so a block of them streams the keys once.
//
// Filling the card: a block is QB query rows, so the caller sends enough
// of them a call (tools/gen_altkeys.py::CARD_BLOCK, 131,072 rows: 512
// blocks, about 4 waves of 132 SMs); a call of a few thousand leaves most
// SMs idle.  Offsets into global memory are 64-bit; key ids are int32
// (N < 2^31, checked).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BN = 64;  // keys a ring stage
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_KEY = 0x7fffffff;

// The geometry of a width bucket: KS k-steps of 8 (dims D..D+3 carry the
// bound's terms, so 8 KS >= D + 4), MT m-tiles of 16 rows a warp, NT n-tiles
// of 8 keys a tile (a warp computes its 16 MT x 64 values of a tile at once:
// 8 MT independent chains of KS mma), STAGES ring stages, a row stride SK
// (floats) with SK % 16 == 8, so that a warp's 8-byte B-fragment loads hit
// 32 distinct banks per half-warp.  Mirrored by ops/cuda_knn.py.
template <int KS>
struct Geo {
  static constexpr int MT = KS <= 5 ? 2 : 1;
  static constexpr int NT = BN / 8;
  static constexpr int STAGES = KS <= 8 ? 4 : 2;
  static constexpr int DPAD = 8 * KS;
  static constexpr int SK = DPAD % 16 == 8 ? DPAD : DPAD + 8;
  static constexpr int QB = WARPS * 16 * MT;
};

int bucket_of(int D) { return D <= 12 ? 2 : D <= 36 ? 5 : D <= 60 ? 8 : 17; }

struct CandParams {
  const float* queries;   // [Q, D]
  const int64_t* qids;    // [Q], -1: exclude nothing
  int Q;
  const float* keys;      // [N, D]
  const float4* aux;      // [N]: -(1-c2)|x|^2/2 high, low; c1|x|/2; 0
  int N, D, L;            // L: list length
  float omc2;             // 1 - c2
  float* cand_val;        // [Q, L] list values (LB, or the exact distance)
  int* cand_id;           // [Q, L], -1 for an empty entry
  float* cand_thr;        // [Q] the list's maximum, +inf if not full
};

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// c += a . b, m16n8k8, TF32 inputs (a float's low 13 bits ignored), f32 sum
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// cp.async of 16 or 4 bytes; src_size 0 fills the destination with zeros
__device__ __forceinline__ void cp16z(void* smem, const void* gmem, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4z(void* smem, const void* gmem, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 4 : 0)
               : "memory");
}

// The exact distance: sum over i < D, in index order, of (q_i - x_i)^2 by
// fused multiply-adds.  Mode 1 and pass 2 both call it, so a pair gets the
// same bits in both.
__device__ __forceinline__ float exact_dist(const float* q, const float* x,
                                            int D) {
  float s = 0.0f;
  for (int i = 0; i < D; ++i) {
    const float d = __fsub_rn(q[i], x[i]);
    s = __fmaf_rn(d, d, s);
  }
  return s;
}

// A row's list: L <= 64 entries (value, key) in any order, its count, and
// the entry that is largest by (value, key) once the list is full (+inf and
// NO_KEY before).  The warp that owns the row inserts with all 32 lanes:
// the arguments are the same in every lane, lane 0 writes, and a rescan of
// the full list is one entry or two a lane and a shuffle reduction.
struct Lists {
  float* val;
  int* id;
  float* maxv;
  int* maxid;
  int* pos;
  int* cnt;
};

__device__ __forceinline__ bool above(float v, int i, float w, int j) {
  return v > w || (v == w && i > j);
}

__device__ __noinline__ void warp_insert(Lists ls, int r, int L, float v,
                                         int key, int lane) {
  float* val = ls.val + (int64_t)r * L;
  int* id = ls.id + (int64_t)r * L;
  const int c = ls.cnt[r];
  if (c < L) {
    __syncwarp();
    if (lane == 0) {
      val[c] = v;
      id[c] = key;
      ls.cnt[r] = c + 1;
    }
    __syncwarp();
    if (c + 1 < L) return;
  } else {
    if (!above(ls.maxv[r], ls.maxid[r], v, key)) return;
    const int p = ls.pos[r];
    __syncwarp();
    if (lane == 0) {
      val[p] = v;
      id[p] = key;
    }
    __syncwarp();
  }
  float m = -INFINITY;
  int mid = -1, mp = -1;
  for (int j = lane; j < L; j += 32)
    if (above(val[j], id[j], m, mid)) {
      m = val[j];
      mid = id[j];
      mp = j;
    }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(FULL, m, off);
    const int i2 = __shfl_xor_sync(FULL, mid, off);
    const int p2 = __shfl_xor_sync(FULL, mp, off);
    if (above(m2, i2, m, mid)) {
      m = m2;
      mid = i2;
      mp = p2;
    }
  }
  __syncwarp();
  if (lane == 0) {
    ls.maxv[r] = m;
    ls.maxid[r] = mid;
    ls.pos[r] = mp;
  }
  __syncwarp();
}

// A warp's values of one tile, and its rows: C fragment v[nt][mt][2h + e]
// is row mt*16 + h*8 + g of the warp, key nt*8 + 2t + e of the tile.
template <int MT>
struct TileVals {
  float v[BN / 8][MT][4];
};

template <int MT>
struct WarpRows {
  float T[MT][2], Aq[MT][2];
  int qid[MT][2], rloc[MT][2];
};

// The rare path: every value of the tile that passes its row's threshold,
// row by row of the warp, inserted by the whole warp in turn (warp_insert
// checks each against the list's current maximum).  Out of line, so that
// the hot loop keeps its registers.
template <int MT, bool EXACT>
__device__ __noinline__ void tile_inserts(TileVals<MT> tv, WarpRows<MT> rw,
                                          Lists ls, int L, int kt, int kend,
                                          int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned mask = 0;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = tv.v[nt][mt][2 * h + e];
          const int key = kt + nt * 8 + 2 * t + e;
          const bool in = (EXACT ? x <= rw.T[mt][h] : x > rw.T[mt][h]) &&
                          key < kend && key != rw.qid[mt][h];
          mask |= (unsigned)in << (2 * nt + e);
        }
      unsigned who = __ballot_sync(FULL, mask != 0);
      while (who) {
        const int src = __ffs(who) - 1;
        who &= who - 1;
        unsigned m = __shfl_sync(FULL, mask, src);
        const int r = __shfl_sync(FULL, rw.rloc[mt][h], src);
        const float A = __shfl_sync(FULL, rw.Aq[mt][h], src);
        while (m) {
          const int bit = __ffs(m) - 1;
          m &= m - 1;
          const int nt = bit >> 1, e = bit & 1;
          const float x = __shfl_sync(FULL, tv.v[nt][mt][2 * h + e], src);
          warp_insert(ls, r, L, EXACT ? x : __fmaf_rn(-2.0f, x, A),
                      kt + nt * 8 + 2 * (src & 3) + e, lane);
        }
      }
    }
}

template <int KS>
constexpr int64_t smem_floats(int L) {
  using G = Geo<KS>;
  return (int64_t)(G::STAGES * BN + G::QB) * G::SK + (int64_t)G::QB * L * 2 +
         (int64_t)G::QB * 5;
}

// Pass 1.  EXACT: mode 1 (exact distances, lists of the L smallest).
// VEC4: rows of D % 4 == 0 floats on 16-byte boundaries (16-byte copies).
template <int KS, bool EXACT, bool VEC4>
__global__ void __launch_bounds__(THREADS, 1)
    knn_candidates_kernel(CandParams p) {
  using G = Geo<KS>;
  constexpr int MT = G::MT, NT = G::NT, STAGES = G::STAGES, SK = G::SK,
                QB = G::QB;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                   // [STAGES][BN][SK]
  float* qs = ring + STAGES * BN * SK;  // [QB][SK]
  Lists ls;
  ls.val = qs + QB * SK;                 // [QB][L]
  ls.id = (int*)(ls.val + QB * p.L);     // [QB][L]
  ls.maxv = (float*)(ls.id + QB * p.L);  // [QB]
  ls.maxid = (int*)(ls.maxv + QB);
  ls.pos = ls.maxid + QB;
  ls.cnt = ls.pos + QB;
  float* rowA = (float*)(ls.cnt + QB);  // (1 - c2) |q|^2

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * QB;
  const int kend = p.N;
  const int ntiles = (kend + BN - 1) / BN;
  const int D = p.D, L = p.L;

  // zero the ring and the query tile: the padded columns stay zero
  for (int i = tid; i < (STAGES * BN + QB) * SK; i += THREADS) smem[i] = 0.0f;
  __syncthreads();
  for (int i = tid; i < QB * D; i += THREADS) {
    const int r = i / D, c = i - r * D;
    if (q0 + r < p.Q) qs[r * SK + c] = p.queries[(int64_t)(q0 + r) * D + c];
  }
  __syncthreads();
  if (tid < QB) {
    float* qr = qs + tid * SK;
    float sq = 0.0f;
    for (int i = 0; i < D; ++i) sq = __fmaf_rn(qr[i], qr[i], sq);
    rowA[tid] = __fmul_rn(p.omc2, sq);
    if (!EXACT) {  // the query's side of the bound's terms
      qr[D] = 1.0f;
      qr[D + 1] = 1.0f;
      qr[D + 2] = sqrtf(sq);
    }
    ls.maxv[tid] = INFINITY;
    ls.maxid[tid] = NO_KEY;
    ls.pos[tid] = 0;
    ls.cnt[tid] = 0;
  }
  __syncthreads();

  // this thread's rows: (mt, h) -> local row warp*16*MT + mt*16 + h*8 + g
  int rloc[MT][2], qid[MT][2];
  bool live[MT][2];
  float T[MT][2], Aq[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 * MT + mt * 16 + h * 8 + g;
      rloc[mt][h] = r;
      live[mt][h] = q0 + r < p.Q;
      qid[mt][h] = live[mt][h] ? (int)p.qids[q0 + r] : -1;
      Aq[mt][h] = rowA[r];
    }
  // the threshold in the compare's space; a padded row never hits
  auto threshold = [&](int mt, int h, float m) -> float {
    if (!live[mt][h]) return EXACT ? -INFINITY : INFINITY;
    return EXACT ? m : __fmul_rn(__fsub_rn(Aq[mt][h], m), 0.5f);
  };
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) T[mt][h] = threshold(mt, h, INFINITY);

  // A fragments, the k-slots permuted within each group of 8 dims (slot t
  // is dim 2t, slot t+4 dim 2t+1) so that a B fragment is one 8-byte load
  uint32_t a[MT][KS][4];
  if (!EXACT) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const float* r0 = qs + (warp * 16 * MT + mt * 16 + g) * SK + ks * 8 +
                          2 * t;
        const float* r1 = r0 + 8 * SK;
        a[mt][ks][0] = tf32_rna(r0[0]);
        a[mt][ks][1] = tf32_rna(r1[0]);
        a[mt][ks][2] = tf32_rna(r0[1]);
        a[mt][ks][3] = tf32_rna(r1[1]);
      }
  }

  // the tile's copies: chunk c = j * cpk + part of key j (16-byte chunks of
  // the row, then its aux row; or 4-byte ones), THREADS chunks apart
  const int cpk = VEC4 ? D / 4 + 1 : D + 4;
  const int j0 = tid / cpk, p0 = tid - j0 * cpk;
  const int dj = THREADS / cpk, dp = THREADS - dj * cpk;
  auto load_tile = [&](int i, int slot) {
    float* dst = ring + slot * BN * SK;
    const int kt = i * BN;
    int j = j0, part = p0;
    while (j < BN) {
      const bool ok = kt + j < kend;
      const int key = ok ? kt + j : 0;
      if (VEC4) {
        const void* src =
            part < cpk - 1 ? (const void*)(p.keys + (int64_t)key * D + 4 * part)
                           : (const void*)(p.aux + key);
        cp16z(dst + j * SK + 4 * part, src, ok);
      } else {
        const float* src = part < D ? p.keys + (int64_t)key * D + part
                                    : (const float*)(p.aux + key) + (part - D);
        cp4z(dst + j * SK + part, src, ok);
      }
      j += dj;
      part += dp;
      if (part >= cpk) {
        part -= cpk;
        ++j;
      }
    }
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ntiles) load_tile(i, i);
    evstore::cp_async_commit();
  }

#pragma unroll 1
  for (int i = 0; i < ntiles; ++i) {
    evstore::cp_async_wait<STAGES - 2>();
    __syncthreads();
    {
      const int nx = i + STAGES - 1;
      if (nx < ntiles) load_tile(nx, nx % STAGES);
      evstore::cp_async_commit();
    }
    const float* tile = ring + (i % STAGES) * BN * SK;
    const int kt = i * BN;
    TileVals<MT> tv;
    if (!EXACT) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b[KS][2];
        const float* kr = tile + (nt * 8 + g) * SK + 2 * t;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const float2 w = *(const float2*)(kr + ks * 8);
          b[ks][0] = __float_as_uint(w.x);
          b[ks][1] = __float_as_uint(w.y);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float* c = tv.v[nt][mt];
          c[0] = c[1] = c[2] = c[3] = 0.0f;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) mma_tf32(c, a[mt][ks], b[ks]);
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              tv.v[nt][mt][2 * h + e] = exact_dist(
                  qs + rloc[mt][h] * SK, tile + (nt * 8 + 2 * t + e) * SK, D);
    }
    bool hit = false;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          hit |= EXACT ? tv.v[nt][mt][c] <= T[mt][c >> 1]
                       : tv.v[nt][mt][c] > T[mt][c >> 1];
    if (__any_sync(FULL, hit)) {
      WarpRows<MT> rw;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          rw.T[mt][h] = T[mt][h];
          rw.Aq[mt][h] = Aq[mt][h];
          rw.qid[mt][h] = qid[mt][h];
          rw.rloc[mt][h] = rloc[mt][h];
        }
      tile_inserts<MT, EXACT>(tv, rw, ls, L, kt, kend, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          T[mt][h] = threshold(mt, h, ls.maxv[rloc[mt][h]]);
    }
  }
  evstore::cp_async_wait<0>();
  __syncthreads();

  for (int i = tid; i < QB * L; i += THREADS) {
    const int r = i / L, j = i - r * L;
    if (q0 + r >= p.Q) continue;
    const bool full = j < ls.cnt[r];
    const int64_t o = (int64_t)(q0 + r) * L + j;
    p.cand_val[o] = full ? ls.val[i] : INFINITY;
    p.cand_id[o] = full ? ls.id[i] : -1;
  }
  if (tid < QB && q0 + tid < p.Q)
    p.cand_thr[q0 + tid] = ls.cnt[tid] == L ? ls.maxv[tid] : INFINITY;
}

// The bound's per-key terms: -(1 - c2)|x|^2 / 2 as a TF32 high part and the
// float32 remainder (exact), and c1 |x| / 2.
__global__ void knn_prep_kernel(const float* __restrict__ keys, int N, int D,
                                float hsq, float c1h, float4* aux) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const float* x = keys + (int64_t)i * D;
  float sq = 0.0f;
  for (int d = 0; d < D; ++d) sq = __fmaf_rn(x[d], x[d], sq);
  const float v = __fmul_rn(hsq, sq);
  const float hi =
      __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);
  aux[i] = make_float4(hi, __fsub_rn(v, hi), __fmul_rn(c1h, sqrtf(sq)), 0.0f);
}

// Pass 2: one warp a query row.  The L candidates' exact distances, ranked
// by (distance, key); out[q] gets the first k keys; ok[q] whether the
// list's maximum, less the margin, exceeds the k-th distance (always 1
// without the certificate).
struct MergeParams {
  const float* queries;
  int Q;
  const float* keys;
  int D, k, L;
  const int* cand_id;
  const float* cand_thr;
  int cert;
  float margin;  // relative: M - margin (|q|^2 + |M|) must exceed d_k
  int64_t* out;
  int* ok;
};

constexpr int MERGE_MAX_D = 128;

__global__ void __launch_bounds__(THREADS) knn_merge_kernel(MergeParams m) {
  extern __shared__ __align__(16) float msm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = m.L;
  float* qrow = msm + warp * (MERGE_MAX_D + 2 * C + 1);
  float* cd = qrow + MERGE_MAX_D;
  int* ci = (int*)(cd + C);
  float* kth = (float*)(ci + C);
  const int q = blockIdx.x * WARPS + warp;
  if (q >= m.Q) return;  // the whole warp: no block-wide barrier follows
  for (int i = lane; i < m.D; i += 32)
    qrow[i] = m.queries[(int64_t)q * m.D + i];
  __syncwarp();
  for (int c = lane; c < C; c += 32) {
    const int id = m.cand_id[(int64_t)q * m.L + c];
    cd[c] = id >= 0 ? exact_dist(qrow, m.keys + (int64_t)id * m.D, m.D)
                    : INFINITY;
    ci[c] = id >= 0 ? id : NO_KEY;
  }
  __syncwarp();
  for (int c = lane; c < C; c += 32) {
    const float d = cd[c];
    const int key = ci[c];
    if (key == NO_KEY) continue;
    int rank = 0;
    for (int o = 0; o < C; ++o) {
      const float d2 = cd[o];
      rank += d2 < d || (d2 == d && ci[o] < key);
    }
    if (rank < m.k) m.out[(int64_t)q * m.k + rank] = key;
    if (rank == m.k - 1) *kth = d;
  }
  __syncwarp();
  if (lane == 0) {
    bool good = true;
    if (m.cert) {
      float sq = 0.0f;
      for (int i = 0; i < m.D; ++i) sq = __fmaf_rn(qrow[i], qrow[i], sq);
      const float M = m.cand_thr[q];
      if (M != INFINITY) good = M - m.margin * (sq + fabsf(M)) > *kth;
    }
    m.ok[q] = good ? 1 : 0;
  }
}

template <int KS, bool EXACT, bool VEC4>
cudaError_t launch_cand(const CandParams& p, cudaStream_t st) {
  using G = Geo<KS>;
  const size_t smem = (size_t)smem_floats<KS>(p.L) * 4;
  if (smem > (size_t)evstore::kMaxDynamicSmem) return cudaErrorInvalidValue;
  auto kern = knn_candidates_kernel<KS, EXACT, VEC4>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<(p.Q + G::QB - 1) / G::QB, THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

template <int KS>
cudaError_t launch_bucket(const CandParams& p, bool exact, bool vec4,
                          cudaStream_t st) {
  if (exact)
    return vec4 ? launch_cand<KS, true, true>(p, st)
                : launch_cand<KS, true, false>(p, st);
  return vec4 ? launch_cand<KS, false, true>(p, st)
              : launch_cand<KS, false, false>(p, st);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" int knn_prep(const void* keys, int64_t N, int D, float hsq,
                        float c1h, void* aux, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N <= 0 || N >= INT32_MAX || D <= 0 || D > MERGE_MAX_D ||
      !aligned16(aux))
    return (int)cudaErrorInvalidValue;
  const int blocks = (int)((N + THREADS - 1) / THREADS);
  knn_prep_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)keys, (int)N, D, hsq, c1h, (float4*)aux);
  return (int)cudaGetLastError();
}

extern "C" int knn_candidates(const void* queries, const void* qids,
                              int64_t Q, const void* keys, const void* aux,
                              int64_t N, int D, int L, int exact,
                              float omc2, void* cand_val,
                              void* cand_id, void* cand_thr, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Q <= 0 || Q >= INT32_MAX || N <= 0 || N >= INT32_MAX || D <= 0 ||
      D > MERGE_MAX_D || L <= 0 || !aligned16(aux))
    return (int)cudaErrorInvalidValue;
  CandParams p{(const float*)queries, (const int64_t*)qids, (int)Q,
               (const float*)keys, (const float4*)aux, (int)N, D, L, omc2,
               (float*)cand_val, (int*)cand_id, (float*)cand_thr};
  const bool vec4 = D % 4 == 0 && aligned16(keys);
  cudaStream_t st = (cudaStream_t)stream;
  switch (bucket_of(D)) {
    case 2: return (int)launch_bucket<2>(p, exact, vec4, st);
    case 5: return (int)launch_bucket<5>(p, exact, vec4, st);
    case 8: return (int)launch_bucket<8>(p, exact, vec4, st);
    default: return (int)launch_bucket<17>(p, exact, vec4, st);
  }
}

extern "C" int knn_merge(const void* queries, int64_t Q, const void* keys,
                         int D, int k, int L, const void* cand_id,
                         const void* cand_thr, int cert, float margin,
                         void* out, void* ok, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Q <= 0 || Q >= INT32_MAX || D <= 0 || D > MERGE_MAX_D || k <= 0 ||
      k > L)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)WARPS * (MERGE_MAX_D + 2 * L + 1) * 4;
  if (smem > (size_t)evstore::kMaxDynamicSmem)
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(knn_merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  MergeParams m{(const float*)queries, (int)Q, (const float*)keys, D, k, L,
                (const int*)cand_id, (const float*)cand_thr, cert, margin,
                (int64_t*)out, (int*)ok};
  const int blocks = (int)((Q + WARPS - 1) / WARPS);
  knn_merge_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(m);
  return (int)cudaGetLastError();
}
