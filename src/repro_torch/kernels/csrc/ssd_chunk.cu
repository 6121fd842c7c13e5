// Mamba2 chunkwise SSD scan for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by repro_torch/kernels/ssd_chunk.py.
//
// Replaces the TPU kernel src/repro/kernels/ssd_chunk.py
// (`ssd_chunked_pallas`, body `_ssd_kernel`).  For each (batch, head) it
// walks the chunks of Lc rows in order, carrying the state S (N x P, f32)
// from zero:
//
//     F      = cumsum(log_a)                              over the chunk
//     y      = ((C B^T) o exp(F_i - F_j) o tril) x + exp(F) o (C S)
//     S_next = exp(F_L) S + B^T diag(exp(F_L - F)) x
//
// Rows past T behave as the TPU version's padding (log_a = 0, x = B = C =
// 0) and are not written.
//
// What bounds it: at the zamba2-1.2b prefill shape (B = 2, T = 4096,
// H = P = N = 64, Lc = 256) the scan does ~17 GFLOP on ~270 MB of x, y,
// log_a, B and C, so it is bound by operations (f32 on the CUDA cores),
// not by bytes.  The TPU kernel holds the whole (Lc x Lc) score matrix in
// VMEM; at Lc = 256 that is 256 KB in f32, more than an SM's 227 KB of
// shared memory.  So a block tiles inside the chunk: 64-row query tiles
// against the 64-row key tiles j <= i, one 64 x 64 tile of M at a time in
// shared memory, while keeping the requested chunk's semantics (decay
// inside a chunk, the state pass between chunks).  Every exponent is a
// difference of cumulative sums and is <= 0 (exp(F_i - F_j), exp(F_L - F_j),
// exp(F_i) from the chunk start): the ratio form exp(F_i) / exp(F_j)
// underflows to 0/0 once |F| passes ~87 over a chunk.
//
// Design: one block of 256 threads per (batch, head), looping over the
// chunks (the state pass is sequential); each thread owns a 4 x 4 tile of
// every 64 x 64 product, strided by 16 rows and columns so that shared
// memory reads spread over the banks (tiles padded to 65 floats a row).
// B and C are shared by all heads (one group): they are read at the batch
// index, never broadcast to (B*H, T, N) copies.  x and y are read and
// written in the model's (B, T, H, P) layout through their strides.  All
// math and the state are f32; B and C may be f32 or bf16.  Tensor cores
// (wgmma), TMA and sharing C B^T across heads are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;          // rows of a query or key tile
constexpr int DMAX = 64;          // largest N and P
constexpr int LD = DMAX + 1;      // padded row stride of the shared tiles
constexpr int MAX_LC = 256;       // largest chunk
constexpr int THREADS = 256;      // 16 x 16 threads, a 4 x 4 tile each
constexpr int SMEM_FLOATS = MAX_LC + 4 * TILE * LD + DMAX * LD;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// dst[r][col] = src[(row0 + r) * st + col] for r < rows (zero for the
// rest of the TILE rows), col < cols.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long st, int row0,
                                          int rows, int cols) {
  for (int idx = threadIdx.x; idx < TILE * cols; idx += THREADS) {
    const int r = idx / cols, col = idx % cols;
    dst[r * LD + col] = r < rows ? to_f32(src[(long long)(row0 + r) * st + col]) : 0.f;
  }
}

template <typename TB>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ la,
                 const TB* __restrict__ bm, const TB* __restrict__ cm, float* __restrict__ y,
                 int H, int T, int P, int N, int Lc, int n_chunks, long long x_sb,
                 long long x_st, long long x_sh, long long la_sb, long long la_st,
                 long long la_sh, long long bm_sb, long long bm_st, long long cm_sb,
                 long long cm_st, long long y_sb, long long y_st, long long y_sh) {
  extern __shared__ float smem[];
  float* Fs = smem;                 // cumsum of log_a over the chunk
  float* Cs = Fs + MAX_LC;          // C rows of the query tile
  float* Bs = Cs + TILE * LD;       // B rows of the key tile
  float* Xs = Bs + TILE * LD;       // x rows of the key tile
  float* Ms = Xs + TILE * LD;       // one 64 x 64 tile of M
  float* Ss = Ms + TILE * LD;       // the carried state, N x P

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float* xb = x + b * x_sb + h * x_sh;
  const float* lab = la + b * la_sb + h * la_sh;
  const TB* bb = bm + b * bm_sb;
  const TB* cb = cm + b * cm_sb;
  float* yb = y + b * y_sb + h * y_sh;

  for (int i = tid; i < DMAX * LD; i += THREADS) Ss[i] = 0.f;
  const int n_tiles = (Lc + TILE - 1) / TILE;

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Lc;
    __syncthreads();                // the previous chunk is done with Fs and Ss
    if (tid < 32) {                 // F = cumsum(log_a): a warp scan
      const int per = (Lc + 31) / 32;
      const int lo = tid * per;
      float run = 0.f;
      for (int k = 0; k < per; ++k) {
        const int i = lo + k;
        if (i < Lc) {
          const int t = t0 + i;
          run += t < T ? lab[(long long)t * la_st] : 0.f;
          Fs[i] = run;
        }
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, tot, off);
        if (tid >= off) tot += o;
      }
      const float excl = tot - run;
      for (int k = 0; k < per; ++k) {
        const int i = lo + k;
        if (i < Lc) Fs[i] += excl;
      }
    }
    __syncthreads();
    const float FL = Fs[Lc - 1];

    // ---- outputs, one query tile at a time
    for (int qt = 0; qt < n_tiles; ++qt) {
      const int q0 = qt * TILE;
      const int q_rows = min(TILE, min(Lc - q0, T - (t0 + q0)));
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][e] = 0.f;

      for (int kt = 0; kt <= qt; ++kt) {
        const int k0 = kt * TILE;
        const int k_rows = min(TILE, min(Lc - k0, T - (t0 + k0)));
        __syncthreads();            // the previous tiles are consumed
        if (kt == 0) load_tile(Cs, cb, cm_st, t0 + q0, q_rows, N);
        load_tile(Bs, bb, bm_st, t0 + k0, k_rows, N);
        load_tile(Xs, xb, x_st, t0 + k0, k_rows, P);
        __syncthreads();
        // M = (C B^T) o exp(F_i - F_j) for j <= i
        float g[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) g[a][e] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = Cs[(ty + 16 * a) * LD + n];
#pragma unroll
          for (int e = 0; e < 4; ++e) bv[e] = Bs[(tx + 16 * e) * LD + n];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e) g[a][e] = fmaf(cv[a], bv[e], g[a][e]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = q0 + ty + 16 * a;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = k0 + tx + 16 * e;
            Ms[(ty + 16 * a) * LD + tx + 16 * e] =
                (j <= i && i < Lc) ? g[a][e] * expf(Fs[i] - Fs[j]) : 0.f;
          }
        }
        __syncthreads();
        // acc += M x
        const int j_end = min(TILE, Lc - k0);
#pragma unroll 4
        for (int j = 0; j < j_end; ++j) {
          float mv[4], xv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) mv[a] = Ms[(ty + 16 * a) * LD + j];
#pragma unroll
          for (int e = 0; e < 4; ++e) xv[e] = Xs[j * LD + tx + 16 * e];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[a][e] = fmaf(mv[a], xv[e], acc[a][e]);
        }
      }
      // inter-chunk part: exp(F_i) (C_i . S)
      float cs[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) cs[a][e] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = Cs[(ty + 16 * a) * LD + n];
#pragma unroll
        for (int e = 0; e < 4; ++e) sv[e] = Ss[n * LD + tx + 16 * e];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) cs[a][e] = fmaf(cv[a], sv[e], cs[a][e]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty + 16 * a;
        if (r >= q_rows) continue;
        const float ef = expf(Fs[q0 + r]);
        float* yr = yb + (long long)(t0 + q0 + r) * y_st;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = tx + 16 * e;
          if (p < P) yr[p] = acc[a][e] + ef * cs[a][e];
        }
      }
    }

    if (c + 1 == n_chunks) break;   // the final state is not an output

    // ---- state: S <- exp(F_L) S + B^T diag(exp(F_L - F)) x
    float sacc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[a][e] = 0.f;
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * TILE;
      const int k_rows = min(TILE, min(Lc - k0, T - (t0 + k0)));
      __syncthreads();
      load_tile(Bs, bb, bm_st, t0 + k0, k_rows, N);
      load_tile(Xs, xb, x_st, t0 + k0, k_rows, P);
      __syncthreads();
      for (int idx = tid; idx < k_rows * N; idx += THREADS) {
        const int r = idx / N, n = idx % N;
        Bs[r * LD + n] *= expf(FL - Fs[k0 + r]);
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < k_rows; ++j) {
        float bv[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) bv[a] = Bs[j * LD + ty + 16 * a];
#pragma unroll
        for (int e = 0; e < 4; ++e) xv[e] = Xs[j * LD + tx + 16 * e];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[a][e] = fmaf(bv[a], xv[e], sacc[a][e]);
      }
    }
    const float aL = expf(FL);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int n = ty + 16 * a;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = tx + 16 * e;
        // each (n, p) is read and written by its owner thread only
        if (n < N && p < P) Ss[n * LD + p] = aL * Ss[n * LD + p] + sacc[a][e];
      }
    }
  }
}

template <typename TB>
cudaError_t launch(const void* x, const void* la, const void* bm, const void* cm, void* y, int B,
                   int T, int H, int P, int N, int Lc, long long x_sb, long long x_st,
                   long long x_sh, long long la_sb, long long la_st, long long la_sh,
                   long long bm_sb, long long bm_st, long long cm_sb, long long cm_st,
                   long long y_sb, long long y_st, long long y_sh, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_kernel<TB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int n_chunks = (T + Lc - 1) / Lc;
  ssd_chunk_kernel<TB><<<B * H, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(la), static_cast<const TB*>(bm),
      static_cast<const TB*>(cm), static_cast<float*>(y), H, T, P, N, Lc, n_chunks, x_sb, x_st,
      x_sh, la_sb, la_st, la_sh, bm_sb, bm_st, cm_sb, cm_st, y_sb, y_st, y_sh);
  return cudaGetLastError();
}

}  // namespace

// x (B, T, H, P) f32, log_a (B, T, H) f32, bm/cm (B, T, N) f32 or bf16
// (bc_dtype 0 / 1), y (B, T, H, P) f32; strides in elements, the last axis
// of x, y, bm and cm contiguous.  1 <= P, N <= 64 and 1 <= Lc <= 256.
// Returns the cudaError_t of the launch (0 = success); the kernel runs
// async on `stream`.
extern "C" int ssd_chunk_fwd(int device, const void* x, const void* la, const void* bm,
                             const void* cm, void* y, int bc_dtype, int B, int T, int H, int P,
                             int N, int Lc, long long x_sb, long long x_st, long long x_sh,
                             long long la_sb, long long la_st, long long la_sh, long long bm_sb,
                             long long bm_st, long long cm_sb, long long cm_st, long long y_sb,
                             long long y_st, long long y_sh, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (P < 1 || P > DMAX || N < 1 || N > DMAX || Lc < 1 || Lc > MAX_LC)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B * H == 0 || T == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bc_dtype == 0) {
    err = launch<float>(x, la, bm, cm, y, B, T, H, P, N, Lc, x_sb, x_st, x_sh, la_sb, la_st,
                        la_sh, bm_sb, bm_st, cm_sb, cm_st, y_sb, y_st, y_sh, st);
  } else if (bc_dtype == 1) {
    err = launch<__nv_bfloat16>(x, la, bm, cm, y, B, T, H, P, N, Lc, x_sb, x_st, x_sh, la_sb,
                                la_st, la_sh, bm_sb, bm_st, cm_sb, cm_st, y_sb, y_st, y_sh, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
