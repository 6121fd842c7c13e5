// FCCO contrastive-loss kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes by repro_torch/kernels/gcl_loss.py.
//
// K1, gcl_pair_stats_fwd, replaces the TPU kernel
// src/repro/kernels/gcl_loss.py `gcl_pair_stats` (body `_stats_kernel`):
// shift-decomposed row statistics of the (b, B) pair matrix, both sides,
//     s1 = e1_rows . e2_cols,  s2 = e2_rows . e1_cols,
//     z  = (s - s_ii) / tau_row, masked off the global diagonal,
// with an online row max m (rescaling the running sums when it grows),
// g = sum exp(z - m) and dg = sum exp(z - m) * -(s - s_ii) / tau^2.  The
// sums leave here undivided; the wrapper divides by B - 1.
//
// K2, gcl_pair_grads_bwd, replaces `gcl_pair_grads` (bodies
// `_grads_kernel` and `_grads_kernel_dblocked`): the closed-form backward
// of the FCCO surrogate from log-domain weights lwt = lw - log tau,
//     A1 = exp(min((s1 - s_ii)/t1_i + lwt1_i, 60)),  A2 likewise,
//     M1 = exp(min((s2 - s_jj)/t1_j + lwt1_j, 60)),  M2 likewise,
//     de1 += (A1 + M2) . e2_cols,  de2 += (A2 + M1) . e1_cols,
//     r1 = sum A1, r2 = sum A2,
// (A + M) rounded to the column dtype before the product.  The finish
// kappa * (de - (r1 + r2) e) runs in the wrapper, as it runs outside
// pallas_call in the TPU version.
//
// What bounds them: at the main path's shape (b = B = 256 anchors and
// columns, d = 512, f32) K1 does two 256x256x512 products (134 MFLOP,
// 2.0 us at 67 TFLOP/s f32) on ~1 MB of features (0.3 us at 3.35 TB/s),
// K2 four (268 MFLOP, 4.0 us): both are bound by operations.
//
// Design.  The TPU grid carries the row state (m, g, dg in K1; de, r in
// K2) across a sequential column axis in VMEM.  Here one block owns BR
// anchor rows, one warp per row, and loops over all column tiles itself,
// so the row state stays in registers (K1) or in the block's own rows of
// the output (K2), no block reads another's, and the result needs no
// atomics and is deterministic.  A column tile is BC = 32 columns, one
// per lane; features are staged in shared memory DK = 32 dims at a time,
// so any d works (the TPU d_block path was a VMEM-size device).  The
// row reductions of the online update are warp shuffles.  All products
// run in f32 FMA on the CUDA cores (bf16 inputs are widened when staged:
// f32 statistics and accumulation); tensor cores are left for later, and
// at b = 256 the grid is 32 blocks on 132 SMs (low occupancy, noted in
// PERF.md).  Masking is (row != col) & (col < B) & (row >= 0) with the
// global row id row_offset + i; MASK_NEG = -1e30 is finite, so
// exp(MASK_NEG - MASK_NEG) = 1 on a row that is still empty, never NaN.
// Columns past B are staged as zeros with lwt = MASK_NEG and tau = 1, as
// the TPU wrapper pads them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BR = 8;                // anchor rows per block, one warp each
constexpr int BC = 32;               // columns per tile, one per lane
constexpr int DK = 32;               // feature dims staged per chunk
constexpr int THREADS = BR * 32;
constexpr float MASK_NEG = -1e30f;   // losses.MASK_NEG
constexpr float EXP_CLAMP = 60.f;    // losses.EXP_CLAMP

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to T and widened back to f32 (`.astype(e.dtype)` before the
// product in the TPU kernel).
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

struct Tiles {
  float rows1[BR][DK + 1];           // e1 anchor rows, one chunk of d
  float rows2[BR][DK + 1];           // e2 anchor rows
  float cols1[BC][DK + 1];           // e1 columns
  float cols2[BC][DK + 1];           // e2 columns
};

// dst[r][k] = src[row0 + r][k0 + k] widened to f32, zero past n_valid rows
// or past d.  Neighbouring threads read neighbouring dims (coalesced).
template <typename T, int N>
__device__ __forceinline__ void stage(float (*dst)[DK + 1], const T* __restrict__ src, int row0,
                                      int n_valid, int d, int k0) {
  for (int idx = threadIdx.x; idx < N * DK; idx += THREADS) {
    const int r = idx / DK, k = idx % DK;
    const int gr = row0 + r, gk = k0 + k;
    dst[r][k] = (gr < n_valid && gk < d) ? to_f32(src[(long long)gr * d + gk]) : 0.f;
  }
}

// s1 = e1[r0 + warp] . e2a[c0 + lane], s2 = e2[r0 + warp] . e1a[c0 + lane]
// over the whole feature dim, chunk by chunk.
template <typename T>
__device__ __forceinline__ void similarity(Tiles& t, const T* __restrict__ e1,
                                           const T* __restrict__ e2, const T* __restrict__ e1a,
                                           const T* __restrict__ e2a, int r0, int b, int c0,
                                           int B, int d, float& s1, float& s2) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  s1 = 0.f;
  s2 = 0.f;
  for (int k0 = 0; k0 < d; k0 += DK) {
    __syncthreads();                 // the previous chunk is consumed
    stage<T, BR>(t.rows1, e1, r0, b, d, k0);
    stage<T, BR>(t.rows2, e2, r0, b, d, k0);
    stage<T, BC>(t.cols1, e1a, c0, B, d, k0);
    stage<T, BC>(t.cols2, e2a, c0, B, d, k0);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < DK; ++k) {
      s1 = fmaf(t.rows1[w][k], t.cols2[lane][k], s1);
      s2 = fmaf(t.rows2[w][k], t.cols1[lane][k], s2);
    }
  }
}

// One column tile of the online-softmax recurrence for one row (the warp);
// every lane ends with the same m, g, dg.
__device__ __forceinline__ void online_update(bool mask, float s, float sdr, float tau, float& g,
                                              float& dg, float& m) {
  const float diff = s - sdr;
  const float z = mask ? diff / tau : MASK_NEG;
  const float m_new = fmaxf(m, warp_max(z));
  const float alpha = expf(m - m_new);
  const float p = mask ? expf(z - m_new) : 0.f;
  const float psum = warp_sum(p);
  const float pdsum = warp_sum(p * -diff);
  g = g * alpha + psum;
  dg = dg * alpha + pdsum / (tau * tau);
  m = m_new;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
stats_kernel(const T* __restrict__ e1, const T* __restrict__ e2, const T* __restrict__ e1a,
             const T* __restrict__ e2a, const float* __restrict__ sd,
             const float* __restrict__ t1, const float* __restrict__ t2, int b, int B, int d,
             int row_offset, float* __restrict__ g1o, float* __restrict__ g2o,
             float* __restrict__ dg1o, float* __restrict__ dg2o, float* __restrict__ m1o,
             float* __restrict__ m2o) {
  __shared__ Tiles tiles;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = blockIdx.x * BR;
  const int i = r0 + w;              // this warp's anchor row
  const bool row_ok = i < b;
  const int rid = row_offset + i;    // its global index (diagonal mask)
  const float sdr = row_ok ? sd[i] : 0.f;
  const float tr1 = row_ok ? t1[i] : 1.f;
  const float tr2 = row_ok ? t2[i] : 1.f;
  float g1 = 0.f, g2 = 0.f, dg1 = 0.f, dg2 = 0.f, m1 = MASK_NEG, m2 = MASK_NEG;
  for (int c0 = 0; c0 < B; c0 += BC) {
    float s1, s2;
    similarity<T>(tiles, e1, e2, e1a, e2a, r0, b, c0, B, d, s1, s2);
    const int j = c0 + lane;
    const bool mask = row_ok && rid >= 0 && j < B && rid != j;
    online_update(mask, s1, sdr, tr1, g1, dg1, m1);
    online_update(mask, s2, sdr, tr2, g2, dg2, m2);
  }
  if (row_ok && lane == 0) {
    g1o[i] = g1;
    g2o[i] = g2;
    dg1o[i] = dg1;
    dg2o[i] = dg2;
    m1o[i] = m1;
    m2o[i] = m2;
  }
}

// losses.guarded_exp, zero off the mask.
__device__ __forceinline__ float pair_weight(bool mask, float z) {
  return mask ? expf(fminf(z, EXP_CLAMP)) : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
grads_kernel(const T* __restrict__ e1, const T* __restrict__ e2, const T* __restrict__ e1a,
             const T* __restrict__ e2a, const float* __restrict__ sd,
             const float* __restrict__ sda, const float* __restrict__ lwt1,
             const float* __restrict__ lwt2, const float* __restrict__ lwt1a,
             const float* __restrict__ lwt2a, const float* __restrict__ t1,
             const float* __restrict__ t2, const float* __restrict__ t1a,
             const float* __restrict__ t2a, int b, int B, int d, int row_offset,
             float* __restrict__ de1, float* __restrict__ de2, float* __restrict__ r1o,
             float* __restrict__ r2o) {
  __shared__ Tiles tiles;
  __shared__ float p1[BR][BC + 1];   // A1 + M2 of this column tile
  __shared__ float p2[BR][BC + 1];   // A2 + M1
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = blockIdx.x * BR;
  const int i = r0 + w;
  const bool row_ok = i < b;
  const int rid = row_offset + i;
  const float sdr = row_ok ? sd[i] : 0.f;
  const float lr1 = row_ok ? lwt1[i] : MASK_NEG;
  const float lr2 = row_ok ? lwt2[i] : MASK_NEG;
  const float tr1 = row_ok ? t1[i] : 1.f;
  const float tr2 = row_ok ? t2[i] : 1.f;
  float* de1_row = de1 + (long long)i * d;
  float* de2_row = de2 + (long long)i * d;
  // each thread zeroes exactly the gradient entries it accumulates below
  if (row_ok) {
    for (int k = lane; k < d; k += 32) {
      de1_row[k] = 0.f;
      de2_row[k] = 0.f;
    }
  }
  float r1 = 0.f, r2 = 0.f;
  for (int c0 = 0; c0 < B; c0 += BC) {
    float s1, s2;
    similarity<T>(tiles, e1, e2, e1a, e2a, r0, b, c0, B, d, s1, s2);
    const int j = c0 + lane;
    const bool in = j < B;
    const float sdc = in ? sda[j] : 0.f;
    const float lc1 = in ? lwt1a[j] : MASK_NEG;
    const float lc2 = in ? lwt2a[j] : MASK_NEG;
    const float tc1 = in ? t1a[j] : 1.f;
    const float tc2 = in ? t2a[j] : 1.f;
    const bool mask = row_ok && rid >= 0 && in && rid != j;
    const float a1 = pair_weight(mask, (s1 - sdr) / tr1 + lr1);
    const float a2 = pair_weight(mask, (s2 - sdr) / tr2 + lr2);
    // transpose terms: A1[j, i] = exp((e1_j.e2_i - s_jj)/t1_j + lwt1_j), and
    // e1_j.e2_i is s2 of (i, j); likewise A2[j, i] from s1
    const float mm1 = pair_weight(mask, (s2 - sdc) / tc1 + lc1);
    const float mm2 = pair_weight(mask, (s1 - sdc) / tc2 + lc2);
    r1 += a1;
    r2 += a2;
    p1[w][lane] = round_to<T>(a1 + mm2);
    p2[w][lane] = round_to<T>(a2 + mm1);
    for (int k0 = 0; k0 < d; k0 += DK) {
      __syncthreads();               // p tiles written, previous chunk consumed
      stage<T, BC>(tiles.cols1, e1a, c0, B, d, k0);
      stage<T, BC>(tiles.cols2, e2a, c0, B, d, k0);
      __syncthreads();
      const int k = k0 + lane;
      if (row_ok && k < d) {
        float acc1 = 0.f, acc2 = 0.f;
#pragma unroll
        for (int c = 0; c < BC; ++c) {
          acc1 = fmaf(p1[w][c], tiles.cols2[c][lane], acc1);
          acc2 = fmaf(p2[w][c], tiles.cols1[c][lane], acc2);
        }
        de1_row[k] += acc1;
        de2_row[k] += acc2;
      }
    }
  }
  r1 = warp_sum(r1);
  r2 = warp_sum(r2);
  if (row_ok && lane == 0) {
    r1o[i] = r1;
    r2o[i] = r2;
  }
}

inline dim3 grid_for(int b) { return dim3((b + BR - 1) / BR); }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the four feature arrays); every other
// array is float32.  Features are row-major (rows, d), contiguous.  Each
// launcher returns the cudaError_t of its launch (cudaSuccess = 0); the
// kernel itself runs async on `stream`.
extern "C" cudaError_t gcl_pair_stats_fwd(int device, int dtype, const void* e1, const void* e2,
                                          const void* e1a, const void* e2a, const float* sd,
                                          const float* t1, const float* t2, int b, int B, int d,
                                          int row_offset, float* g1, float* g2, float* dg1,
                                          float* dg2, float* m1, float* m2, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (b <= 0) return cudaSuccess;
  if (B <= 0 || d <= 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    stats_kernel<float><<<grid_for(b), THREADS, 0, st>>>(
        static_cast<const float*>(e1), static_cast<const float*>(e2),
        static_cast<const float*>(e1a), static_cast<const float*>(e2a), sd, t1, t2, b, B, d,
        row_offset, g1, g2, dg1, dg2, m1, m2);
  } else if (dtype == 1) {
    stats_kernel<__nv_bfloat16><<<grid_for(b), THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(e1), static_cast<const __nv_bfloat16*>(e2),
        static_cast<const __nv_bfloat16*>(e1a), static_cast<const __nv_bfloat16*>(e2a), sd, t1,
        t2, b, B, d, row_offset, g1, g2, dg1, dg2, m1, m2);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" cudaError_t gcl_pair_grads_bwd(int device, int dtype, const void* e1, const void* e2,
                                          const void* e1a, const void* e2a, const float* sd,
                                          const float* sda, const float* lwt1,
                                          const float* lwt2, const float* lwt1a,
                                          const float* lwt2a, const float* t1, const float* t2,
                                          const float* t1a, const float* t2a, int b, int B, int d,
                                          int row_offset, float* de1, float* de2, float* r1,
                                          float* r2, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (b <= 0) return cudaSuccess;
  if (B <= 0 || d <= 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    grads_kernel<float><<<grid_for(b), THREADS, 0, st>>>(
        static_cast<const float*>(e1), static_cast<const float*>(e2),
        static_cast<const float*>(e1a), static_cast<const float*>(e2a), sd, sda, lwt1, lwt2,
        lwt1a, lwt2a, t1, t2, t1a, t2a, b, B, d, row_offset, de1, de2, r1, r2);
  } else if (dtype == 1) {
    grads_kernel<__nv_bfloat16><<<grid_for(b), THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(e1), static_cast<const __nv_bfloat16*>(e2),
        static_cast<const __nv_bfloat16*>(e1a), static_cast<const __nv_bfloat16*>(e2a), sd, sda,
        lwt1, lwt2, lwt1a, lwt2a, t1, t2, t1a, t2a, b, B, d, row_offset, de1, de2, r1, r2);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
