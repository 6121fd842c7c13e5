// FCCO contrastive-loss kernels for Hopper (sm_90a), four passes with a
// plain C interface, loaded through ctypes by
// repro_torch/kernels/gcl_loss.py.
//
// K1 (gcl_stats_partial + gcl_stats_merge) replaces the TPU kernel
// src/repro/kernels/gcl_loss.py `gcl_pair_stats` (body `_stats_kernel`):
// shift-decomposed row statistics of the (b, B) pair matrix, both sides,
//     s1 = e1_rows . e2_cols,  s2 = e2_rows . e1_cols,
//     z  = (s - s_ii) / tau_row, masked off the global diagonal,
// with the row max m, g = sum exp(z - m) and dg = sum exp(z - m) *
// -(s - s_ii) / tau^2, sums divided by B - 1.
//
// K2 (gcl_grads_weights + gcl_grads_product) replaces `gcl_pair_grads`
// (bodies `_grads_kernel` and `_grads_kernel_dblocked`): the closed-form
// backward of the FCCO surrogate from log-domain weights lwt = lw - log tau,
//     A1 = exp(min((s1 - s_ii)/t1_i + lwt1_i, 60)),  A2 likewise,
//     M1 = exp(min((s2 - s_jj)/t1_j + lwt1_j, 60)),  M2 likewise,
//     de1 = (A1 + M2) . e2_cols,  de2 = (A2 + M1) . e1_cols,
//     r1 = sum A1, r2 = sum A2,
// (A + M) rounded to the column dtype before the product, then the finish
// kappa (de - (r1 + r2) e) that the TPU version runs outside pallas_call.
//
// What bounds them.  At the training shape (b = B = 256 anchors and
// columns, d = 512, f32) K1 is two 256 x 256 x 512 products (134 MFLOP)
// and K2 four (268 MFLOP) on ~1 MB of features: 2.0 / 4.0 us at the f32
// rate, 0.8 / 1.6 us as split TF32 on the tensor cores, with the bytes
// under 0.4 us.  At the paper's sharded shape (b = 256 local anchors
// against B = 2048 gathered columns) the work is 8x that.  So the
// products set the floor, and what kept PR 12's kernels at ~100x it was
// the design: one block per 8 anchor rows (32 blocks on 132 SMs at any B),
// every column tile staged with blocking loads between barriers, f32 FMA
// on the CUDA cores, and K2 reading each column tile twice.
//
// Design.  The pair matrix is cut into 32 x 32 tiles, one block (4 warps,
// 2 x 2, each 16 rows x 16 columns) per tile: a column "split" is one
// 32-column tile, so the grid is ceil(b / 32) x ceil(B / 32) (64 blocks
// at the training shape, 512 at the sharded one).  A block streams its
// rows and columns of e1 and e2 through a two-stage cp.async ring, 32
// feature dims at a time (16-byte copies, zero-filled past B and d; rows
// whose byte length or base is not 16-byte aligned, e.g. f32 with d % 4
// != 0, take plain loads into the same tiles), and computes s1 and s2 of
// its tile from the same staged rows and columns on the tensor cores:
// split TF32 on mma.sync m16n8k8 (mma_tf32.cuh), three TF32 products per
// f32 product with hi*hi and the small terms in separate accumulators,
// the hi*hi sums of each 32-wide chunk added to an f32 total rounded to
// nearest (the tensor cores truncate theirs); bf16 inputs are exact in
// TF32 and take one product.
//
// - gcl_stats_partial: the row statistics of the tile (quad shuffles in
//   the m16n8 accumulator layout, the two column warps combined through
//   shared memory) -> a per-split (m, g, dg) of each side in a
//   (2, 3, n_splits, b) scratch.  A split with no unmasked column (only
//   the anchor's own column, or only padding past B) leaves m = MASK_NEG,
//   g = dg = 0.
// - gcl_stats_merge, one thread per (side, row): the splits combined in split
//   order by the online-max rule, m = max m_s, g = sum g_s exp(m_s - m),
//   dg likewise, then divided by B - 1.  MASK_NEG = -1e30 is finite, so
//   an all-masked split contributes exp(MASK_NEG - m) * 0 = 0 and two of
//   them exp(0) * 0 = 0, never NaN.
// - gcl_grads_weights: A1, A2, M1, M2 of the tile; (A1 + M2) and
//   (A2 + M1), rounded to the feature dtype, into a (2, b, Bp) scratch
//   (Bp = 32 n_splits, zero where masked), and the tile's row sums of A1
//   and A2, in f64, into a (2, n_splits, b) scratch.
// - gcl_grads_product, one block per 32 rows x 32 feature dims, two
//   groups of 4 warps each taking half of every chunk's columns (their
//   sums added in order at the end): de1 = P1 . e2_cols and de2 = P2 .
//   e1_cols over all Bp columns through the same ring, then the finish
//   with r1 + r2 summed over the splits.  The weights stay in the L2 (0.5 MB at the training shape,
//   4 MB at the sharded one), so no partial de is kept per split and no
//   reduction pass is needed.  In f32 these products run on the f64
//   tensor cores (mma.sync m8n8k4, exact products summed in f64): where a
//   row's weights clamp at exp(60), the finish cancels de against
//   (r1 + r2) e to ~1e-4 of its terms, so a de or an r1 + r2 off by a few
//   f32 ulps, as split TF32's or an f32 sum's, misses the tolerance.  So
//   de and the row sums are summed in f64 and rounded to f32 once, and the
//   finish rounds step by step as the plain version's torch ops do.  bf16
//   weights and columns are exact in TF32 and take one TF32 product.
//
// Measured on the H100 (PERF.md): 0.030 / 0.041 ms for K1 / K2 at the
// training shape in f32, 15x / 10x the f32-rate bound; 64 blocks of 4 warps
// leave the similarity passes bound by latency, not by their products.
//
// Every sum runs in a fixed order with no atomics: two calls on the same
// inputs give the same bits.  Any d works.  Masking is (row != col) &
// (col < B) & (row >= 0) with the global row id row_offset + i, as the
// TPU version pads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "mma_tf32.cuh"

namespace {

constexpr int TM = 32;               // anchor rows per block
constexpr int TN = 32;               // columns per split (similarity passes)
constexpr int DK = 32;               // contraction elements per staged chunk
constexpr int SP = DK + 8;           // row pitch (elements) of a staged chunk
constexpr int TD = 32;               // feature dims per block (product pass)
constexpr int NT = TD / 16;          // n8 tiles of a warp there (2 x 2 warps)
constexpr int PKG = 2;               // warp groups of a product block, each taking
                                     // 1 / PKG of every chunk's columns
constexpr int THREADS = 128;         // 4 warps, 2 x 2 over the tile
constexpr int PRODUCT_THREADS = THREADS * PKG;
constexpr float MASK_NEG = -1e30f;   // losses.MASK_NEG
constexpr float EXP_CLAMP = 60.f;    // losses.EXP_CLAMP

using bf16 = __nv_bfloat16;

template <typename T>
constexpr bool kExact = std::is_same<T, bf16>::value;   // exact in TF32

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// p[0], p[1] as TF32 bit patterns (f32 as it is; bf16 widened, exactly)
__device__ __forceinline__ void load_pair(const float* p, uint32_t& x0, uint32_t& x1) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  x0 = __float_as_uint(v.x);
  x1 = __float_as_uint(v.y);
}
__device__ __forceinline__ void load_pair(const bf16* p, uint32_t& x0, uint32_t& x1) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  x0 = w << 16;
  x1 = w & 0xffff0000u;
}
__device__ __forceinline__ uint32_t load_one(const float* p) { return __float_as_uint(*p); }
__device__ __forceinline__ uint32_t load_one(const bf16* p) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(*p)) << 16;
}

template <bool EXACT>
__device__ __forceinline__ void split(uint32_t x, uint32_t& hi, uint32_t& lo) {
  if constexpr (EXACT) {
    hi = x;
    lo = 0u;
  } else {
    tc::split_tf32(__uint_as_float(x), hi, lo);
  }
}

__device__ __forceinline__ void store_pair(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void store_pair(bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
template <typename F>
__device__ __forceinline__ F quad_sum(F x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// dst[r][c] = src[(row0 + r) * ld + k0 + c] for r < ROWS, c < COLS, zero
// where row0 + r >= nrows or k0 + c >= ncols.  `vec`: every row is
// 16-byte aligned and ncols a multiple of the 16-byte group, so the tile
// goes by cp.async (the caller commits); otherwise element by element.
template <typename T, int ROWS, int COLS, int PITCH>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, long long ld, int row0,
                                      int nrows, int k0, int ncols, bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    constexpr int PER_ROW = COLS / V;
    for (int idx = threadIdx.x; idx < ROWS * PER_ROW; idx += blockDim.x) {
      const int r = idx / PER_ROW, c = (idx % PER_ROW) * V;
      const int gr = row0 + r, gk = k0 + c;
      const bool in = gr < nrows && gk < ncols;
      tc::cp_async16(dst + r * PITCH + c, in ? src + gr * ld + gk : src, in);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * COLS; idx += blockDim.x) {
      const int r = idx / COLS, c = idx % COLS;
      const int gr = row0 + r, gk = k0 + c;
      dst[r * PITCH + c] = (gr < nrows && gk < ncols) ? src[gr * ld + gk] : static_cast<T>(0.f);
    }
  }
}

// A fragment of rows row, row + 8 of a staged tile, contraction slots t
// and t + 4 holding elements kk + 2t and kk + 2t + 1.
template <typename T>
__device__ __forceinline__ void frag_a(const T* tile, int row, int kk, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  uint32_t x[4];
  load_pair(tile + (row + g) * SP + kk + 2 * t, x[0], x[2]);
  load_pair(tile + (row + g + 8) * SP + kk + 2 * t, x[1], x[3]);
#pragma unroll
  for (int i = 0; i < 4; ++i) split<kExact<T>>(x[i], hi[i], lo[i]);
}

// sum += part in f32, rounded to nearest.  The tensor cores truncate the
// sums they accumulate, a bias of up to an ulp per 8-wide step that grows
// with the contraction length (past the tolerances at d = 3072 in f32), so
// each chunk's hi*hi products start from zero and are added here; the
// small terms, ~2^-10 of them, stay in one accumulator.
template <int N>
__device__ __forceinline__ void flush(float (&sum)[N][4], const float (&part)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) sum[n][c] += part[n][c];
}

// s1 = e1[rows] . e2a[cols]^T and s2 = e2[rows] . e1a[cols]^T for the
// block's 32 x 32 tile (rows r0.., columns c0..), over all of d; each
// warp's 16 x 16 quarter in the m16n8 accumulator layout, two n8 tiles.
// Staged chunk k of the ring: tiles[k & 1][0..3] = e1, e2 rows, e1a, e2a
// columns.
template <typename T>
__device__ __forceinline__ void similarity(T (*tiles)[4][TM * SP], const T* __restrict__ e1,
                                           const T* __restrict__ e2, const T* __restrict__ e1a,
                                           const T* __restrict__ e2a, int r0, int b, int c0,
                                           int B, int d, bool vec, float (&s1)[2][4],
                                           float (&s2)[2][4]) {
  static_assert(TM == TN, "rows and columns share the tile shape");
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int wm = warp / 2, wn = warp % 2;
  float sum1[2][4] = {}, small1[2][4] = {}, sum2[2][4] = {}, small2[2][4] = {};
  const int nk = (d + DK - 1) / DK;
  auto load = [&](int st, int k0) {
    stage<T, TM, DK, SP>(tiles[st][0], e1, d, r0, b, k0, d, vec);
    stage<T, TM, DK, SP>(tiles[st][1], e2, d, r0, b, k0, d, vec);
    stage<T, TN, DK, SP>(tiles[st][2], e1a, d, c0, B, k0, d, vec);
    stage<T, TN, DK, SP>(tiles[st][3], e2a, d, c0, B, k0, d, vec);
    tc::cp_async_commit();
  };
  load(0, 0);
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) {
      load((kc + 1) & 1, (kc + 1) * DK);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const T* r1 = tiles[kc & 1][0];
    const T* r2 = tiles[kc & 1][1];
    const T* c1 = tiles[kc & 1][2];
    const T* c2 = tiles[kc & 1][3];
    float big1[2][4] = {}, big2[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < DK; kk += 8) {
      uint32_t a1h[4], a1l[4], a2h[4], a2l[4];
      frag_a(r1, wm * 16, kk, a1h, a1l);
      frag_a(r2, wm * 16, kk, a2h, a2l);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int n = wn * 16 + nt * 8 + g;
        uint32_t x0, x1, h0, h1, l0, l1;
        load_pair(c2 + n * SP + kk + 2 * t, x0, x1);
        split<kExact<T>>(x0, h0, l0);
        split<kExact<T>>(x1, h1, l1);
        tc::mma_split<kExact<T>, kExact<T>>(big1[nt], small1[nt], a1h, a1l, h0, h1, l0, l1);
        load_pair(c1 + n * SP + kk + 2 * t, x0, x1);
        split<kExact<T>>(x0, h0, l0);
        split<kExact<T>>(x1, h1, l1);
        tc::mma_split<kExact<T>, kExact<T>>(big2[nt], small2[nt], a2h, a2l, h0, h1, l0, l1);
      }
    }
    flush(sum1, big1);
    flush(sum2, big2);
    __syncthreads();                 // the stage is consumed before it is refilled
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s1[nt][c] = sum1[nt][c] + small1[nt][c];
      s2[nt][c] = sum2[nt][c] + small2[nt][c];
    }
}

// (m, g, dg) of b merged into a by the online-max rule
__device__ __forceinline__ void merge(float& m, float& g, float& dg, float mb, float gb,
                                      float dgb) {
  const float mn = fmaxf(m, mb);
  const float ea = expf(m - mn), eb = expf(mb - mn);
  g = g * ea + gb * eb;
  dg = dg * ea + dgb * eb;
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
stats_partial_kernel(const T* __restrict__ e1, const T* __restrict__ e2,
                     const T* __restrict__ e1a, const T* __restrict__ e2a,
                     const float* __restrict__ sd, const float* __restrict__ t1,
                     const float* __restrict__ t2, int b, int B, int d, int row_offset, bool vec,
                     float* __restrict__ part, int ns) {
  __shared__ __align__(16) unsigned char tiles_raw[2 * 4 * TM * SP * sizeof(T)];
  auto tiles = reinterpret_cast<T(*)[4][TM * SP]>(tiles_raw);
  __shared__ float red[2][TM][2][3];   // [column warp][row][side][m, g, dg]
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int wm = warp / 2, wn = warp % 2;
  const int r0 = blockIdx.x * TM, split_id = blockIdx.y, c0 = split_id * TN;
  float s[2][2][4];
  similarity<T>(tiles, e1, e2, e1a, e2a, r0, b, c0, B, d, vec, s[0], s[1]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int lr = wm * 16 + g + 8 * h, i = r0 + lr, rid = row_offset + i;
    const bool row_ok = i < b && rid >= 0;
    const float sdr = i < b ? sd[i] : 0.f;
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const float tau = i < b ? (side ? t2[i] : t1[i]) : 1.f;
      float z[4], diff[4], mx = MASK_NEG;
      bool mk[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int j = c0 + wn * 16 + nt * 8 + 2 * t + q, e = nt * 2 + q;
          mk[e] = row_ok && j < B && rid != j;
          diff[e] = s[side][nt][2 * h + q] - sdr;
          z[e] = mk[e] ? diff[e] / tau : MASK_NEG;
          mx = fmaxf(mx, z[e]);
        }
      mx = quad_max(mx);
      float gs = 0.f, pd = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = mk[e] ? expf(z[e] - mx) : 0.f;
        gs += p;
        pd += p * -diff[e];
      }
      gs = quad_sum(gs);
      pd = quad_sum(pd);
      if (t == 0) {
        red[wn][lr][side][0] = mx;
        red[wn][lr][side][1] = gs;
        red[wn][lr][side][2] = pd / (tau * tau);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * TM) {
    const int lr = threadIdx.x / 2, side = threadIdx.x % 2, i = r0 + lr;
    float m = red[0][lr][side][0], gsum = red[0][lr][side][1], dg = red[0][lr][side][2];
    merge(m, gsum, dg, red[1][lr][side][0], red[1][lr][side][1], red[1][lr][side][2]);
    if (i < b) {
      const long long base = (static_cast<long long>(side) * 3 * ns + split_id) * b + i;
      part[base] = m;
      part[base + static_cast<long long>(ns) * b] = gsum;
      part[base + 2LL * ns * b] = dg;
    }
  }
}

__global__ void __launch_bounds__(256)
stats_merge_kernel(const float* __restrict__ part, int b, int ns, float denom,
                   float* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;   // one thread per (side, row)
  if (idx >= 2 * b) return;
  const int side = idx / b, i = idx % b;
  const float* pm = part + static_cast<long long>(side) * 3 * ns * b + i;
  const float* pg = pm + static_cast<long long>(ns) * b;
  const float* pdg = pg + static_cast<long long>(ns) * b;
  float m = MASK_NEG, g = 0.f, dg = 0.f;
#pragma unroll 8
  for (int s = 0; s < ns; ++s) {     // unrolled: the loads of 8 splits in flight
    const long long o = static_cast<long long>(s) * b;
    merge(m, g, dg, pm[o], pg[o], pdg[o]);
  }
  out[static_cast<long long>(side) * b + i] = g / denom;          // g1, g2
  out[static_cast<long long>(2 + side) * b + i] = dg / denom;   // dg1, dg2
  out[static_cast<long long>(4 + side) * b + i] = m;            // m1, m2
}

// losses.guarded_exp, zero off the mask.
__device__ __forceinline__ float pair_weight(bool mask, float z) {
  return mask ? expf(fminf(z, EXP_CLAMP)) : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
grads_weights_kernel(const T* __restrict__ e1, const T* __restrict__ e2,
                     const T* __restrict__ e1a, const T* __restrict__ e2a,
                     const float* __restrict__ sd, const float* __restrict__ sda,
                     const float* __restrict__ lwt1, const float* __restrict__ lwt2,
                     const float* __restrict__ lwt1a, const float* __restrict__ lwt2a,
                     const float* __restrict__ t1, const float* __restrict__ t2,
                     const float* __restrict__ t1a, const float* __restrict__ t2a, int b, int B,
                     int d, int row_offset, bool vec, T* __restrict__ pw,
                     double* __restrict__ rpart, int ns) {
  __shared__ __align__(16) unsigned char tiles_raw[2 * 4 * TM * SP * sizeof(T)];
  auto tiles = reinterpret_cast<T(*)[4][TM * SP]>(tiles_raw);
  __shared__ double red[2][TM][2];     // [column warp][row][side]
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int wm = warp / 2, wn = warp % 2;
  const int r0 = blockIdx.x * TM, split_id = blockIdx.y, c0 = split_id * TN;
  const long long Bp = static_cast<long long>(ns) * TN;
  float s1[2][4], s2[2][4];
  similarity<T>(tiles, e1, e2, e1a, e2a, r0, b, c0, B, d, vec, s1, s2);
  // the transpose terms' column quantities, this thread's four columns
  float sdc[4], lc1[4], lc2[4], tc1[4], tc2[4];
  bool cin[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = c0 + wn * 16 + (e / 2) * 8 + 2 * t + e % 2;
    cin[e] = j < B;
    sdc[e] = cin[e] ? sda[j] : 0.f;
    lc1[e] = cin[e] ? lwt1a[j] : MASK_NEG;
    lc2[e] = cin[e] ? lwt2a[j] : MASK_NEG;
    tc1[e] = cin[e] ? t1a[j] : 1.f;
    tc2[e] = cin[e] ? t2a[j] : 1.f;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int lr = wm * 16 + g + 8 * h, i = r0 + lr, rid = row_offset + i;
    const bool row_ok = i < b && rid >= 0;
    const float sdr = i < b ? sd[i] : 0.f;
    const float lr1 = i < b ? lwt1[i] : MASK_NEG, lr2 = i < b ? lwt2[i] : MASK_NEG;
    const float tr1 = i < b ? t1[i] : 1.f, tr2 = i < b ? t2[i] : 1.f;
    double ra1 = 0.0, ra2 = 0.0;       // the row sums in f64 (see the product pass)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float p1[2], p2[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int e = nt * 2 + q, j = c0 + wn * 16 + nt * 8 + 2 * t + q;
        const bool mk = row_ok && cin[e] && rid != j;
        const float v1 = s1[nt][2 * h + q], v2 = s2[nt][2 * h + q];
        const float a1 = pair_weight(mk, (v1 - sdr) / tr1 + lr1);
        const float a2 = pair_weight(mk, (v2 - sdr) / tr2 + lr2);
        // transpose terms: A1[j, i] = exp((e1_j . e2_i - s_jj)/t1_j + lwt1_j),
        // and e1_j . e2_i is s2 of (i, j); likewise A2[j, i] from s1
        const float mm1 = pair_weight(mk, (v2 - sdc[e]) / tc1[e] + lc1[e]);
        const float mm2 = pair_weight(mk, (v1 - sdc[e]) / tc2[e] + lc2[e]);
        ra1 += a1;
        ra2 += a2;
        p1[q] = a1 + mm2;
        p2[q] = a2 + mm1;
      }
      if (i < b) {
        const long long o = static_cast<long long>(i) * Bp + c0 + wn * 16 + nt * 8 + 2 * t;
        store_pair(pw + o, p1[0], p1[1]);
        store_pair(pw + static_cast<long long>(b) * Bp + o, p2[0], p2[1]);
      }
    }
    ra1 = quad_sum(ra1);
    ra2 = quad_sum(ra2);
    if (t == 0) {
      red[wn][lr][0] = ra1;
      red[wn][lr][1] = ra2;
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * TM) {
    const int lr = threadIdx.x / 2, side = threadIdx.x % 2, i = r0 + lr;
    if (i < b)
      rpart[(static_cast<long long>(side) * ns + split_id) * b + i] =
          red[0][lr][side] + red[1][lr][side];
  }
}

// Row pitches (elements) of the product pass's tiles.  f32, read one
// element per thread (m8n8k4 f64 fragments): P at 36 and the column chunk
// at 40 put a warp's reads on distinct banks.  bf16, read as TF32 pairs:
// P at SP, the column chunk (rows 2t, 2t + 1) at 40.
template <typename T>
constexpr int PP = kExact<T> ? SP : DK + 4;
constexpr int EP = TD + 8;

template <typename T>
constexpr int PRODUCT_STAGE = 2 * TM * PP<T> + 2 * DK * EP;   // elements per ring stage

template <typename T>
constexpr int PRODUCT_SMEM = 2 * PRODUCT_STAGE<T> * static_cast<int>(sizeof(T));
static_assert((PKG - 1) * 2 * 2 * NT * 2 * 128 * 8 <= PRODUCT_SMEM<float> &&
                  (PKG - 1) * 2 * NT * 4 * 128 * 4 <= PRODUCT_SMEM<bf16>,
              "the ring holds the warp groups' sums");

// c += a b on the f64 tensor cores (m8n8k4: a = A[g][t], b = B[t][g],
// c = C[g][2t], C[g][2t + 1]).  An f32 product is exact in f64.
__device__ __forceinline__ void mma_f64(double (&c)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
               : "+d"(c[0]), "+d"(c[1])
               : "d"(a), "d"(b));
}

// The product pass's sums of one block, (2 products) x (the warp's 16
// rows x 32 dims).  f32 inputs: exact products summed in f64 on the f64
// tensor cores, rounded to f32 once, so the finish (which cancels where a
// row's weights are clamped) starts from de rounded to nearest.  bf16
// inputs (exact in TF32): one TF32 product, the sums of each chunk added
// to an f32 total.
template <typename T>
struct ProductAcc;

template <>
struct ProductAcc<float> {
  static constexpr int N = 2 * 2 * NT * 2;
  double acc[2][2][NT][2] = {};      // [product][m8 tile][n8 tile][c]

  // x[e * 128 + slot] = element e of the sums, or += from x
  template <bool ADD>
  __device__ __forceinline__ void exchange(double* x, int slot) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      double& a = acc[e / (2 * NT * 2)][e / (NT * 2) % 2][e / 2 % NT][e % 2];
      if constexpr (ADD) a += x[e * 128 + slot];
      else x[e * 128 + slot] = a;
    }
  }

  // columns k0.. of one staged chunk: pa, pb = P1, P2 (TM x PP); ea, eb =
  // e2a, e1a (DK x EP)
  __device__ __forceinline__ void chunk(const float* pa, const float* pb, const float* ea,
                                        const float* eb, int k0, int wm, int wn, int g,
                                        int t) {
#pragma unroll
    for (int kk = k0; kk < k0 + DK / PKG; kk += 4) {
      double a[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int o = (wm * 16 + mt * 8 + g) * PP<float> + kk + t;
        a[0][mt] = pa[o];
        a[1][mt] = pb[o];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int o = (kk + t) * EP + wn * (TD / 2) + nt * 8 + g;
        const double b0 = ea[o], b1 = eb[o];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_f64(acc[0][mt][nt], a[0][mt], b0);
          mma_f64(acc[1][mt][nt], a[1][mt], b1);
        }
      }
    }
  }

  // row (of the warp's 16) and dim (of its 32) of element e of n8 tile nt
  __device__ __forceinline__ float value(int p, int nt, int e, int g, int t, int& row,
                                         int& col) const {
    const int mt = e / 2, q = e % 2;
    row = mt * 8 + g;
    col = nt * 8 + 2 * t + q;
    return static_cast<float>(acc[p][mt][nt][q]);
  }
};

template <>
struct ProductAcc<bf16> {
  static constexpr int N = 2 * NT * 4;
  float sum[2][NT][4] = {};          // [product][n8 tile][c], m16n8 layout

  template <bool ADD>
  __device__ __forceinline__ void exchange(float* x, int slot) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      float& a = sum[e / (NT * 4)][e / 4 % NT][e % 4];
      if constexpr (ADD) a += x[e * 128 + slot];
      else x[e * 128 + slot] = a;
    }
  }

  __device__ __forceinline__ void chunk(const bf16* pa, const bf16* pb, const bf16* ea,
                                        const bf16* eb, int k0, int wm, int wn, int g,
                                        int t) {
    float big[2][NT][4] = {}, small[2][NT][4] = {};
#pragma unroll
    for (int kk = k0; kk < k0 + DK / PKG; kk += 8) {
      uint32_t ah[2][4], al[2][4];
      frag_a(pa, wm * 16, kk, ah[0], al[0]);
      frag_a(pb, wm * 16, kk, ah[1], al[1]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int o0 = (kk + 2 * t) * EP + wn * (TD / 2) + nt * 8 + g,
                  o1 = o0 + EP;
        tc::mma_split<true, true>(big[0][nt], small[0][nt], ah[0], al[0], load_one(ea + o0),
                                  load_one(ea + o1), 0u, 0u);
        tc::mma_split<true, true>(big[1][nt], small[1][nt], ah[1], al[1], load_one(eb + o0),
                                  load_one(eb + o1), 0u, 0u);
      }
    }
    flush(sum[0], big[0]);
    flush(sum[1], big[1]);
  }

  __device__ __forceinline__ float value(int p, int nt, int e, int g, int t, int& row,
                                         int& col) const {
    row = g + (e >= 2 ? 8 : 0);
    col = nt * 8 + 2 * t + (e & 1);
    return sum[p][nt][e];
  }
};

// de1 = P1 . e2a and de2 = P2 . e1a for rows r0.. and feature dims k0..
// of the block, over all Bp columns; then out = kappa (de - (r1 + r2) e),
// rounded step by step as the plain version's torch ops round it.
template <typename T>
__global__ void __launch_bounds__(PRODUCT_THREADS, 1)   // without the 1, ptxas spills
grads_product_kernel(const T* __restrict__ pw, const T* __restrict__ e1a,
                     const T* __restrict__ e2a, const T* __restrict__ e1,
                     const T* __restrict__ e2, const double* __restrict__ rpart, int b, int B,
                     int d, int ns, float kappa, bool vec, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  constexpr int NQ = PRODUCT_THREADS / TM;   // threads summing a row's splits
  __shared__ double rq[NQ][TM][2];   // their partial r1, r2
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int kg = warp / 4, wm = warp % 4 / 2, wn = warp % 2;
  const int r0 = blockIdx.x * TM, k0 = blockIdx.y * TD;
  const int Bp = ns * TN;
  const T* p1 = pw;
  const T* p2 = pw + static_cast<long long>(b) * Bp;
  auto tile = [&](int st, int k) { // 0, 1: P1, P2 (TM x PP); 2, 3: e2a, e1a (DK x EP)
    return smem + st * PRODUCT_STAGE<T> +
           (k < 2 ? k * TM * PP<T> : 2 * TM * PP<T> + (k - 2) * DK * EP);
  };
  auto load = [&](int st, int j0) {
    stage<T, TM, DK, PP<T>>(tile(st, 0), p1, Bp, r0, b, j0, Bp, true);
    stage<T, TM, DK, PP<T>>(tile(st, 1), p2, Bp, r0, b, j0, Bp, true);
    stage<T, DK, TD, EP>(tile(st, 2), e2a + k0, d, j0, B, 0, d - k0, vec);
    stage<T, DK, TD, EP>(tile(st, 3), e1a + k0, d, j0, B, 0, d - k0, vec);
    tc::cp_async_commit();
  };
  load(0, 0);
  {                                  // r1, r2 of the block's rows while it lands
    const int q = threadIdx.x / TM, lr = threadIdx.x % TM, i = r0 + lr;
    double ra = 0.0, rb = 0.0;
    if (i < b) {
      for (int s = q; s < ns; s += NQ) {
        ra += rpart[static_cast<long long>(s) * b + i];
        rb += rpart[static_cast<long long>(ns + s) * b + i];
      }
    }
    rq[q][lr][0] = ra;
    rq[q][lr][1] = rb;
  }
  ProductAcc<T> acc;
  const int nj = ns;                 // one DK-column chunk per split (DK == TN)
  for (int jc = 0; jc < nj; ++jc) {
    if (jc + 1 < nj) {
      load((jc + 1) & 1, (jc + 1) * DK);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    acc.chunk(tile(jc & 1, 0), tile(jc & 1, 1), tile(jc & 1, 2), tile(jc & 1, 3),
              kg * (DK / PKG), wm, wn, g, t);
    __syncthreads();
  }
  // the ring is free: the other groups' sums pass through it to group 0
  using F = std::conditional_t<kExact<T>, float, double>;
  constexpr int N = ProductAcc<T>::N;
  F* xch = reinterpret_cast<F*>(smem_raw);
  const int slot = (warp % 4) * 32 + lane;
  if (kg > 0) acc.template exchange<false>(xch + (kg - 1) * N * 128, slot);
  __syncthreads();
  if (kg > 0) return;
  for (int k = 1; k < PKG; ++k) acc.template exchange<true>(xch + (k - 1) * N * 128, slot);
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int row, col;
        const float de = acc.value(p, nt, e, g, t, row, col);
        const int lr = wm * 16 + row, i = r0 + lr, k = k0 + wn * (TD / 2) + col;
        if (i < b && k < d) {
          double ra = 0.0, rb = 0.0;
          for (int q = 0; q < NQ; ++q) {
            ra += rq[q][lr][0];
            rb += rq[q][lr][1];
          }
          const float rs = __fadd_rn(static_cast<float>(ra), static_cast<float>(rb));
          const long long o = static_cast<long long>(i) * d + k;
          // the finish of de1 takes e2, of de2 e1
          const float re = __fmul_rn(rs, to_f32(p == 0 ? e2[o] : e1[o]));
          out[static_cast<long long>(p) * b * d + o] = __fmul_rn(kappa, __fsub_rn(de, re));
        }
      }
}

template <typename T>
bool rows_vec(int d, std::initializer_list<const void*> ptrs) {
  if ((static_cast<long long>(d) * sizeof(T)) % 16 != 0) return false;
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return true;
}

inline int n_splits(int B) { return (B + TN - 1) / TN; }

template <typename T>
cudaError_t launch_stats_partial(const void* e1, const void* e2, const void* e1a,
                                 const void* e2a, const float* sd, const float* t1,
                                 const float* t2, int b, int B, int d, int row_offset,
                                 float* part, cudaStream_t st) {
  const int ns = n_splits(B);
  stats_partial_kernel<T><<<dim3((b + TM - 1) / TM, ns), THREADS, 0, st>>>(
      static_cast<const T*>(e1), static_cast<const T*>(e2), static_cast<const T*>(e1a),
      static_cast<const T*>(e2a), sd, t1, t2, b, B, d, row_offset,
      rows_vec<T>(d, {e1, e2, e1a, e2a}), part, ns);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_grads_weights(const void* e1, const void* e2, const void* e1a,
                                 const void* e2a, const float* sd, const float* sda,
                                 const float* lwt1, const float* lwt2, const float* lwt1a,
                                 const float* lwt2a, const float* t1, const float* t2,
                                 const float* t1a, const float* t2a, int b, int B, int d,
                                 int row_offset, void* pw, double* rpart, cudaStream_t st) {
  const int ns = n_splits(B);
  grads_weights_kernel<T><<<dim3((b + TM - 1) / TM, ns), THREADS, 0, st>>>(
      static_cast<const T*>(e1), static_cast<const T*>(e2), static_cast<const T*>(e1a),
      static_cast<const T*>(e2a), sd, sda, lwt1, lwt2, lwt1a, lwt2a, t1, t2, t1a, t2a, b, B, d,
      row_offset, rows_vec<T>(d, {e1, e2, e1a, e2a}), static_cast<T*>(pw), rpart, ns);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_grads_product(const void* pw, const void* e1a, const void* e2a,
                                 const void* e1, const void* e2, const double* rpart, int b,
                                 int B, int d, float kappa, float* out, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(grads_product_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         PRODUCT_SMEM<T>);
  if (err != cudaSuccess) return err;
  grads_product_kernel<T><<<dim3((b + TM - 1) / TM, (d + TD - 1) / TD), PRODUCT_THREADS,
                            PRODUCT_SMEM<T>, st>>>(
      static_cast<const T*>(pw), static_cast<const T*>(e1a), static_cast<const T*>(e2a),
      static_cast<const T*>(e1), static_cast<const T*>(e2), rpart, b, B, d, n_splits(B), kappa,
      rows_vec<T>(d, {e1a, e2a}), out);
  return cudaGetLastError();
}

cudaError_t prologue(int device, int dtype, int b, int B, int d) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (b < 0 || B <= 0 || d <= 0 || B > 65535 * TN) return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the feature arrays e1, e2 (b, d), e1a,
// e2a (B, d), and the weights pw); rpart is float64, every other array
// float32.  Arrays are contiguous, row-major.  n_splits = ceil(B / 32),
// Bp = 32 n_splits.  Scratch and outputs are allocated by the caller: part
// (2, 3, n_splits, b) = [side][m, g, dg][split][row]; out6 (6, b) = g1,
// g2, dg1, dg2, m1, m2; pw (2, b, Bp) = A1 + M2, A2 + M1; rpart (2,
// n_splits, b) = [side][split][row] sums of A1, A2; out (2, b, d) = the
// finished de1, de2.
// Each returns the cudaError_t of its launch (0 = success); the kernels
// run async on `stream`.

// K1, pass 1: per-split row statistics of both sides
extern "C" int gcl_stats_partial(int device, int dtype, const void* e1, const void* e2,
                                 const void* e1a, const void* e2a, const float* sd,
                                 const float* t1, const float* t2, int b, int B, int d,
                                 int row_offset, float* part, void* stream) {
  cudaError_t err = prologue(device, dtype, b, B, d);
  if (err != cudaSuccess || b == 0) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = dtype == 0 ? launch_stats_partial<float>(e1, e2, e1a, e2a, sd, t1, t2, b, B, d,
                                                 row_offset, part, st)
                   : launch_stats_partial<bf16>(e1, e2, e1a, e2a, sd, t1, t2, b, B, d,
                                                row_offset, part, st);
  return static_cast<int>(err);
}

// K1, pass 2: the splits merged in order, sums divided by denom (B - 1)
extern "C" int gcl_stats_merge(int device, const float* part, int b, int B, float denom,
                               float* out6, void* stream) {
  cudaError_t err = prologue(device, 0, b, B, 1);
  if (err != cudaSuccess || b == 0) return static_cast<int>(err);
  stats_merge_kernel<<<(2 * b + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      part, b, n_splits(B), denom, out6);
  return static_cast<int>(cudaGetLastError());
}

// K2, pass 1: the pair weights (A + M, rounded to dtype) and row sums of A
extern "C" int gcl_grads_weights(int device, int dtype, const void* e1, const void* e2,
                                 const void* e1a, const void* e2a, const float* sd,
                                 const float* sda, const float* lwt1, const float* lwt2,
                                 const float* lwt1a, const float* lwt2a, const float* t1,
                                 const float* t2, const float* t1a, const float* t2a, int b,
                                 int B, int d, int row_offset, void* pw, double* rpart,
                                 void* stream) {
  cudaError_t err = prologue(device, dtype, b, B, d);
  if (err != cudaSuccess || b == 0) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = dtype == 0
            ? launch_grads_weights<float>(e1, e2, e1a, e2a, sd, sda, lwt1, lwt2, lwt1a, lwt2a,
                                          t1, t2, t1a, t2a, b, B, d, row_offset, pw, rpart, st)
            : launch_grads_weights<bf16>(e1, e2, e1a, e2a, sd, sda, lwt1, lwt2, lwt1a, lwt2a,
                                         t1, t2, t1a, t2a, b, B, d, row_offset, pw, rpart, st);
  return static_cast<int>(err);
}

// K2, pass 2: de = P . e_cols over all columns, finished with kappa
extern "C" int gcl_grads_product(int device, int dtype, const void* pw, const void* e1a,
                                 const void* e2a, const void* e1, const void* e2,
                                 const double* rpart, int b, int B, int d, float kappa,
                                 float* out, void* stream) {
  cudaError_t err = prologue(device, dtype, b, B, d);
  if (err != cudaSuccess || b == 0) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = dtype == 0
            ? launch_grads_product<float>(pw, e1a, e2a, e1, e2, rpart, b, B, d, kappa, out, st)
            : launch_grads_product<bf16>(pw, e1a, e2a, e1, e2, rpart, b, B, d, kappa, out, st);
  return static_cast<int>(err);
}
