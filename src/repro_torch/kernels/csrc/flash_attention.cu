// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by repro_torch/kernels/flash_attention.py.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`, body `_flash_kernel`): online-softmax attention with
// causal / sliding-window / ragged-edge masks, f32 running max `m`, sum `l`
// and accumulator, `p` rounded to the value dtype before the PV product,
// `l` clamped at 1e-30, output in the input dtype.
//
// What bounds it: at the serving shapes (S = 50 and 77, hd = 64) the work
// per (batch, head) is a few hundred kFLOP on ~40 KB of q/k/v/o, so the
// least time is set by moving those bytes, and in practice by launch
// latency.  The TPU kernel's 256x256 tiles padded S = 50 to 256 (about 26x
// the score work); here a block takes 64 query rows and walks the keys in
// 32-row tiles staged in shared memory, masks its own ragged edge, and
// skips key tiles that the causal or window mask removes entirely, so the
// work follows S and not a tile size.  Scores and the PV product run in
// f32 on the CUDA cores; tensor cores (wgmma) and TMA are left for later.
//
// Layout: q/k/v/o are (B, H, S, hd) index spaces with arbitrary element
// strides for B, H and S and a contiguous hd, so (B, S, H, hd) tensors go
// in without a transposing copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;               // query rows per block
constexpr int TPR = 4;               // threads per query row
constexpr int BK = 32;               // keys per shared-memory tile (one mask word)
constexpr int THREADS = BQ * TPR;
constexpr float NEG = -1e30f;        // finite mask fill, as in the TPU kernel

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int H, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
                 Strides os, float scale, int causal, int window) {
  constexpr int DPT = HD / TPR;      // dims per thread: d = i * TPR + part
  __shared__ float k_tile[BK][HD];
  __shared__ float v_tile[BK][HD];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int q0 = blockIdx.y * BQ;
  const int qpos = q0 + row;
  const bool row_valid = qpos < Sq;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = row_valid ? to_f32(qb[qpos * qs.s + i * TPR + part]) : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG, l = 0.f;

  // Key tiles that some row of this block can see; tiles outside them are
  // fully masked and would leave m, l and acc unchanged, so they are skipped.
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? (max(0, q0 - window + 1) / BK) * BK : 0;

  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();                 // the previous tile is consumed
    for (int idx = tid; idx < BK * HD; idx += THREADS) {
      const int j = idx / HD, d = idx % HD;
      const int kpos = kt + j;
      float kx = 0.f, vx = 0.f;      // zero past Sk: masked p times v stays 0
      if (kpos < Sk) {
        kx = to_f32(kb[kpos * ks.s + d]);
        vx = to_f32(vb[kpos * vs.s + d]);
      }
      k_tile[j][d] = kx;
      v_tile[j][d] = vx;
    }
    __syncthreads();

    float s[BK];
    unsigned allowed = 0u;
    float tile_max = NEG;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) dot = fmaf(qr[i], k_tile[j][i * TPR + part], dot);
      // the TPR threads of a row are neighbouring lanes of one warp
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kpos = kt + j;
      const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                      (window <= 0 || kpos > qpos - window);
      s[j] = ok ? dot * scale : NEG;
      allowed |= (ok ? 1u : 0u) << j;
      tile_max = fmaxf(tile_max, s[j]);
    }

    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = ((allowed >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
      psum += p;
      const float pv = to_f32(from_f32<T>(p));   // p.astype(v.dtype)
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(pv, v_tile[j][i * TPR + part], acc[i]);
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (row_valid) {
    const float lc = fmaxf(l, 1e-30f);
    T* ob = o + b * os.b + h * os.h + qpos * os.s;
#pragma unroll
    for (int i = 0; i < DPT; ++i) ob[i * TPR + part] = from_f32<T>(acc[i] / lc);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq,
                   int Sk, Strides qs, Strides ks, Strides vs, Strides os, float scale,
                   int causal, int window, cudaStream_t stream) {
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_fwd_kernel<T, HD><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Sq, Sk, qs, ks, vs, os, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v, void* o, int B, int H,
                      int Sq, int Sk, Strides qs, Strides ks, Strides vs, Strides os,
                      float scale, int causal, int window, cudaStream_t stream) {
  // The head dims of the ported configs: 64 at full width (both towers),
  // 32 in the reduced ViT tower.
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, scale, causal, window, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, scale, causal, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  Returns the
// cudaError_t of the launch (0 = success); the kernel itself runs async on
// `stream`.
extern "C" int flash_attention_fwd(int device, const void* q, const void* k, const void* v,
                                   void* o, int dtype, int B, int H, int Sq, int Sk, int hd,
                                   long long q_sb, long long q_sh, long long q_ss,
                                   long long k_sb, long long k_sh, long long k_ss,
                                   long long v_sb, long long v_sh, long long v_ss,
                                   long long o_sb, long long o_sh, long long o_ss, float scale,
                                   int causal, int window, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B * H == 0 || Sq == 0) return 0;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch_hd<float>(hd, q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, scale, causal, window, st);
  } else if (dtype == 1) {
    err = launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, scale, causal,
                                   window, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
