// Mamba2 chunkwise SSD scan for Hopper (sm_90a), four passes with a plain
// C interface, loaded through ctypes by repro_torch/kernels/ssd_chunk.py.
//
// Replaces the TPU kernel src/repro/kernels/ssd_chunk.py
// (`ssd_chunked_pallas`, body `_ssd_kernel`).  For each (batch, head) and
// chunk of Lc rows, with the state S (N x P, f32) zero before chunk 0:
//
//     F      = cumsum(log_a)                              over the chunk
//     y      = ((C B^T) o exp(F_i - F_j) o tril) x + exp(F) o (C S)
//     S_next = exp(F_L) S + B^T diag(exp(F_L - F)) x
//
// Rows past T behave as the TPU version's padding (log_a = 0, x = B = C =
// 0) and are not written.  Every exponent is a difference of cumulative
// sums and is <= 0 (the ratio form exp(F_i) / exp(F_j) is 0/0 once |F|
// passes ~87 over a chunk).
//
// The TPU kernel walks the chunks of a (batch, head) in order on one
// core, carrying S in VMEM.  On the H100 that order left 128 blocks (one
// per (batch, head)) for 132 SMs, and C B^T, shared by all heads, was
// recomputed per head.  The passes here follow Mamba2's SSD
// decomposition instead; only pass 3 is sequential over the chunks, and
// it moves a few MB:
//
// 1. ssd_cb_kernel, one block per (batch, chunk, causal 64 x 64 tile):
//    G = C B^T over the chunk's rows, once for all heads, written to a
//    (B, n_chunks, Lc, Lc) f32 scratch (zeros above the diagonal of the
//    diagonal tiles; the tiles above it are not written).  0.2 GFLOP at
//    the zamba2-1.2b prefill shape: bound by its launch and its 8 MB.
// 2. ssd_state_kernel, one block per (batch, chunk, head): the chunk's
//    cumsum F (a warp scan) into a (B, H, n_chunks * Lc) scratch, and its
//    local state B^T diag(exp(F_L - F)) x into a (B, H, n_chunks, N, P)
//    scratch (34 MB at the prefill shape: it stays in the 50 MB L2).
//    Reads x once (134 MB, 0.04 ms at 3.35 TB/s); its products (4.3
//    GFLOP, as split TF32) and the instructions that feed them set its
//    time.
// 3. ssd_state_pass_kernel, one thread per (batch, head, n, p): walks
//    the chunks, S_in[c + 1] = exp(F_L[c]) S_in[c] + S_loc[c], and
//    overwrites each local state with the chunk's incoming state.
//    Bound by bytes (2 x 34 MB, mostly from L2).
// 4. ssd_scan_kernel, one block per (batch, chunk, head, 64-row query
//    tile), the last query tiles first (they have the most key tiles):
//    y_i = sum_j A_ij exp(F_i - F_j) V_j over "key tiles" that stream
//    through one two-stage cp.async ring: first the inter-chunk part
//    (A = C, V = S_in, F_j = 0), then the key tiles kt <= qt (A = G,
//    V = x, j <= i on the diagonal).  The products are 12.9 of the 17.2
//    GFLOP the scan needs at the prefill shape; the bytes set its time:
//    each block streams its G, x, C and S tiles from L2 (~1.1 GB per
//    call at the prefill shape; G alone is read once per head): a
//    variant that only loaded and stored took most of its time.
//
// Products run on the tensor cores: split TF32 on mma.sync m16n8k8
// (mma_tf32.cuh), three TF32 products per f32 product, with the hi*hi
// and the small terms in separate accumulators added at the end (the
// tensor cores' sums are not rounded to nearest).  A bf16 B or C is
// exact in TF32, so pass 1 takes one TF32 product for it.  A warp owns
// 16 rows; inside each 8-wide step the contraction slots t and t + 4
// hold indices 2t and 2t + 1, so a thread reads one float2 from a row,
// and the shared-memory row strides (72 for float2 rows, 68 for rows
// read two apart) put a warp's reads on distinct banks.  The decays are
// exp2 of (F_i - F_j) log2(e) (ex2.approx, ~2 ulp).  Measured on the H100
// (PERF.md): splitting V once per block in shared memory (fewer splits,
// one more barrier, one block less per SM) and ordering the grid so a
// head's query tiles run together were both slower; wgmma (A from
// registers, V split and transposed into swizzled K-major tiles) was no
// faster than mma.sync here.
//
// Tiles are 64 x 64 with N and P zero-padded to 64 in shared memory.
// f32 tiles (and F) whose rows are 16-byte aligned go by cp.async, bf16 tiles
// with 8-byte aligned groups of 4 by vector loads, others element by
// element.  x and y are read and written in the model's (B, T, H, P)
// layout through their strides; B and C are read at the batch index (one
// group for all heads).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tf32.cuh"

namespace {

using namespace tc;

constexpr int TILE = 64;          // rows of a query or key tile; N, P padded to it
constexpr int MAX_DIM = 64;       // largest N and P
constexpr int MAX_LC = 256;       // largest chunk
constexpr int WARPS = 4;          // 16 rows each
constexpr int THREADS = 32 * WARPS;
constexpr int LDR = TILE + 8;     // tiles read as float2 along a row
constexpr int LDC = TILE + 4;     // tiles read down a column, rows 2t and 2t + 1

constexpr float LOG2E = 1.4426950408889634f;

template <typename T>
constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;   // exact in TF32

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// 2^x by the SFU (ex2.approx, ~2 ulp; denormal results flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// x = hi + lo in TF32; an exact x (a bf16 value) is its own hi
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (EXACT) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    split_tf32(x, hi, lo);
  }
}

// A fragment of rows g and g + 8 of `rows`, contraction along the row at
// columns d, d + 1 (slots t, t + 4)
template <bool EXACT>
__device__ __forceinline__ void frag_a_rows(const float* rows, int ld, int d, int g,
                                            uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const float2 x0 = *reinterpret_cast<const float2*>(rows + g * ld + d);
  const float2 x1 = *reinterpret_cast<const float2*>(rows + (g + 8) * ld + d);
  split<EXACT>(x0.x, ah[0], al[0]);
  split<EXACT>(x1.x, ah[1], al[1]);
  split<EXACT>(x0.y, ah[2], al[2]);
  split<EXACT>(x1.y, ah[3], al[3]);
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.f;
}

// dst (64 x 64, row stride ld) = rows row0 .. row0 + rows - 1 and columns
// 0 .. cols - 1 of src (row stride st), zeros elsewhere.  `src` at row 0
// is readable.  With `vec` (rows of 4-element groups aligned to 4
// elements, cols % 4 == 0) f32 goes by cp.async (the caller commits and
// waits) and bf16 by 8-byte loads, all of a thread's loads issued before
// its stores; else by element loads.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, long long st,
                                          int row0, int rows, int cols, bool vec) {
  if (vec) {
    if constexpr (std::is_same<T, float>::value) {
      for (int idx = threadIdx.x; idx < TILE * TILE / 4; idx += THREADS) {
        const int r = idx / (TILE / 4), col = 4 * (idx % (TILE / 4));
        const bool in = r < rows && col < cols;
        cp_async16(dst + r * ld + col, in ? src + (row0 + r) * st + col : src, in);
      }
    } else {
      constexpr int PER = TILE * TILE / 4 / THREADS;
      uint2 v[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int idx = threadIdx.x + k * THREADS;
        const int r = idx / (TILE / 4), col = 4 * (idx % (TILE / 4));
        v[k] = r < rows && col < cols
                   ? *reinterpret_cast<const uint2*>(src + (row0 + r) * st + col)
                   : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int idx = threadIdx.x + k * THREADS;
        const int r = idx / (TILE / 4), col = 4 * (idx % (TILE / 4));
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[k]);
        const float2 lo = __bfloat1622float2(h[0]), hi = __bfloat1622float2(h[1]);
        *reinterpret_cast<float4*>(dst + r * ld + col) = make_float4(lo.x, lo.y, hi.x, hi.y);
      }
    }
    return;
  }
  for (int idx = threadIdx.x; idx < TILE * TILE; idx += THREADS) {
    const int r = idx / TILE, col = idx % TILE;
    dst[r * ld + col] = r < rows && col < cols ? to_f32(src[(row0 + r) * st + col]) : 0.f;
  }
}

// Fs[i] = log_a summed over rows t0 .. t0 + i (zero past T), i < Lc:
// a scan by the 32 lanes of warp 0
__device__ __forceinline__ void chunk_cumsum(float* Fs, const float* lab, long long la_st,
                                             int t0, int T, int Lc) {
  const int lane = threadIdx.x;
  const int per = (Lc + 31) / 32;
  const int lo = lane * per;
  float v[MAX_LC / 32];             // this lane's rows, loaded together
#pragma unroll
  for (int k = 0; k < MAX_LC / 32; ++k) {
    const int i = lo + k;
    v[k] = k < per && i < Lc && t0 + i < T ? lab[(t0 + i) * la_st] : 0.f;
  }
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < MAX_LC / 32; ++k) {
    const int i = lo + k;
    run += v[k];
    if (k < per && i < Lc) Fs[i] = run;
  }
  float tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, tot, off);
    if (lane >= off) tot += o;
  }
  const float excl = tot - run;
  for (int k = 0; k < per; ++k) {
    const int i = lo + k;
    if (i < Lc) Fs[i] += excl;
  }
}

// ---------------------------------------------------------------------------
// 1. G = C B^T per (batch, chunk); grid (B * nc, nt * nt), tiles kt <= qt
// ---------------------------------------------------------------------------
template <typename TB>
__global__ void __launch_bounds__(THREADS)
ssd_cb_kernel(const TB* __restrict__ bm, const TB* __restrict__ cm, float* __restrict__ gout,
              int T, int N, int Lc, int nc, long long bm_sb, long long bm_st, long long cm_sb,
              long long cm_st, bool vec) {
  __shared__ __align__(16) float Cs[TILE * LDR];
  __shared__ __align__(16) float Bs[TILE * LDR];
  const int nt = (Lc + TILE - 1) / TILE;
  const int qt = blockIdx.y / nt, kt = blockIdx.y % nt;
  if (kt > qt) return;
  const int b = blockIdx.x / nc, c = blockIdx.x % nc;
  const int t0 = c * Lc, q0 = qt * TILE, k0 = kt * TILE;
  load_tile(Cs, LDR, cm + b * cm_sb, cm_st, t0 + q0, min(TILE, min(Lc - q0, T - t0 - q0)), N,
            vec);
  load_tile(Bs, LDR, bm + b * bm_sb, bm_st, t0 + k0, min(TILE, min(Lc - k0, T - t0 - k0)), N,
            vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  constexpr bool E = kExact<TB>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float big[TILE / 8][4], small[TILE / 8][4];
  zero(big);
  zero(small);
#pragma unroll
  for (int kk = 0; kk < MAX_DIM / 8; ++kk) {
    const int d = 8 * kk + 2 * t;
    uint32_t ah[4], al[4];
    frag_a_rows<E>(Cs + 16 * warp * LDR, LDR, d, g, ah, al);
#pragma unroll
    for (int nd = 0; nd < TILE / 8; ++nd) {
      const float2 bv = *reinterpret_cast<const float2*>(Bs + (8 * nd + g) * LDR + d);
      uint32_t bh0, bl0, bh1, bl1;
      split<E>(bv.x, bh0, bl0);
      split<E>(bv.y, bh1, bl1);
      mma_split<E, E>(big[nd], small[nd], ah, al, bh0, bh1, bl0, bl1);
    }
  }
  float* gb = gout + static_cast<long long>(blockIdx.x) * Lc * Lc;
#pragma unroll
  for (int nd = 0; nd < TILE / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = q0 + 16 * warp + g + (e >= 2 ? 8 : 0);
      const int j = k0 + 8 * nd + 2 * t + (e & 1);
      if (i < Lc && j < Lc)
        gb[static_cast<long long>(i) * Lc + j] = j <= i ? big[nd][e] + small[nd][e] : 0.f;
    }
}

// ---------------------------------------------------------------------------
// 2. F and the local state per (batch, chunk, head); grid B * nc * H
// ---------------------------------------------------------------------------
constexpr int STATE_STAGE = 2 * TILE * LDC;                    // B tile, x tile
constexpr int STATE_SMEM = (2 * MAX_LC + 2 * STATE_STAGE) * 4;

template <typename TB>
__global__ void __launch_bounds__(THREADS)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ la,
                 const TB* __restrict__ bm, float* __restrict__ fout, float* __restrict__ sout,
                 int H, int T, int P, int N, int Lc, int nc, long long x_sb, long long x_st,
                 long long x_sh, long long la_sb, long long la_st, long long la_sh,
                 long long bm_sb, long long bm_st, bool vec_x, bool vec_b) {
  extern __shared__ __align__(16) float smem[];
  float* Fs = smem;                 // cumsum over the chunk
  float* ws = Fs + MAX_LC;          // exp(F_L - F), zero past the chunk
  float* ring = ws + MAX_LC;        // two stages of (B tile, x tile)
  const int h = blockIdx.x % H, bc = blockIdx.x / H;
  const int b = bc / nc, c = bc % nc;
  const int t0 = c * Lc;
  const int nt = (Lc + TILE - 1) / TILE;
  const float* xb = x + b * x_sb + h * x_sh;
  const TB* bb = bm + b * bm_sb;

  auto load_stage = [&](int kt) {
    float* st = ring + (kt & 1) * STATE_STAGE;
    const int k0 = kt * TILE;
    const int rows = min(TILE, min(Lc - k0, T - t0 - k0));
    load_tile(st, LDC, bb, bm_st, t0 + k0, rows, N, vec_b);
    load_tile(st + TILE * LDC, LDC, xb, x_st, t0 + k0, rows, P, vec_x);
  };

  load_stage(0);
  cp_async_commit();
  if (threadIdx.x < 32) chunk_cumsum(Fs, la + b * la_sb + h * la_sh, la_st, t0, T, Lc);
  __syncthreads();
  const float FL = Fs[Lc - 1];
  float* fb = fout + (static_cast<long long>(b * H + h) * nc + c) * Lc;
  for (int i = threadIdx.x; i < nt * TILE; i += THREADS) {
    if (i < Lc) fb[i] = Fs[i];
    ws[i] = i < Lc ? expf(FL - Fs[i]) : 0.f;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int n0 = 16 * warp + g;
  // hi*hi products, and the small terms summed apart
  float acc[TILE / 8][4], small[TILE / 8][4];
  zero(acc);
  zero(small);
  for (int kt = 0; kt < nt; ++kt) {
    if (kt + 1 < nt) load_stage(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                // tile kt (and ws) visible to all
    const float* bs = ring + (kt & 1) * STATE_STAGE;
    const float* xs = bs + TILE * LDC;
    const float* w = ws + kt * TILE;
#pragma unroll
    for (int s = 0; s < TILE / 8; ++s) {
      // A = (B diag(w))^T: rows n, contraction over the rows j of the tile
      const int j = 8 * s + 2 * t;
      const float w0 = w[j], w1 = w[j + 1];
      uint32_t ah[4], al[4];
      split<false>(bs[j * LDC + n0] * w0, ah[0], al[0]);
      split<false>(bs[j * LDC + n0 + 8] * w0, ah[1], al[1]);
      split<false>(bs[(j + 1) * LDC + n0] * w1, ah[2], al[2]);
      split<false>(bs[(j + 1) * LDC + n0 + 8] * w1, ah[3], al[3]);
#pragma unroll
      for (int nd = 0; nd < TILE / 8; ++nd) {
        uint32_t bh0, bl0, bh1, bl1;
        split<false>(xs[j * LDC + 8 * nd + g], bh0, bl0);
        split<false>(xs[(j + 1) * LDC + 8 * nd + g], bh1, bl1);
        mma_split<false, false>(acc[nd], small[nd], ah, al, bh0, bh1, bl0, bl1);
      }
    }
    __syncthreads();                // this stage is consumed before it is refilled
  }
  float* sb = sout + (static_cast<long long>(b * H + h) * nc + c) * N * P;
#pragma unroll
  for (int nd = 0; nd < TILE / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + (e >= 2 ? 8 : 0), p = 8 * nd + 2 * t + (e & 1);
      if (n < N && p < P) sb[n * P + p] = acc[nd][e] + small[nd][e];
    }
}

// ---------------------------------------------------------------------------
// 3. the state pass: one thread per (batch, head, n, p)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
ssd_state_pass_kernel(const float* __restrict__ f, float* __restrict__ s, int N, int P,
                      int Lc, int nc, long long total) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (idx >= total) return;
  const long long np = static_cast<long long>(N) * P;
  const long long bh = idx / np;
  float* sp = s + bh * nc * np + idx % np;
  const float* fl = f + bh * nc * Lc + (Lc - 1);     // F_L of each chunk
  float carry = 0.f;
  for (int c0 = 0; c0 < nc; c0 += 8) {              // 8 chunks' loads in flight
    float loc[8], a[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (c0 + k < nc) {
        loc[k] = sp[(c0 + k) * np];
        a[k] = expf(fl[static_cast<long long>(c0 + k) * Lc]);
      }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (c0 + k < nc) {
        sp[(c0 + k) * np] = carry;
        carry = a[k] * carry + loc[k];
      }
  }
}

// ---------------------------------------------------------------------------
// 4. y per (batch, chunk, head, query tile); grid (B * nc * H, nt)
// ---------------------------------------------------------------------------
// y_i = sum_j A_ij exp(F_i - F_j) V_j over "key tiles" that pass through
// one ring: first the inter-chunk part (A = C, V = S_in, F_j = 0), then
// the key tiles kt <= qt (A = G, V = x, masked j <= i on the diagonal).
constexpr int SCAN_STAGE = TILE * LDR + TILE * LDC + TILE;     // A, V, F of the keys
constexpr int SCAN_SMEM = (TILE + 2 * SCAN_STAGE) * 4;

template <typename TB>
__global__ void __launch_bounds__(THREADS, 3)
ssd_scan_kernel(const float* __restrict__ x, const TB* __restrict__ cm,
                const float* __restrict__ gin, const float* __restrict__ fin,
                const float* __restrict__ s_in, float* __restrict__ y, int H, int T, int P, int N,
                int Lc, int nc, long long x_sb, long long x_st, long long x_sh, long long cm_sb,
                long long cm_st, long long y_sb, long long y_st, long long y_sh, bool vec_x,
                bool vec_c, bool vec_g, bool vec_s) {
  extern __shared__ __align__(16) float smem[];
  float* Fq = smem;                 // F of the query rows
  float* ring = Fq + TILE;          // two stages of (A tile, V tile, F of the keys)
  const int nt = (Lc + TILE - 1) / TILE;
  const int qt = nt - 1 - blockIdx.y;                 // the last query tiles first
  const int h = blockIdx.x % H, bc = blockIdx.x / H;
  const int b = bc / nc, c = bc % nc;
  const int t0 = c * Lc, q0 = qt * TILE;
  const float* xb = x + b * x_sb + h * x_sh;
  const float* gb = gin + static_cast<long long>(bc) * Lc * Lc;
  const float* fb = fin + (static_cast<long long>(b * H + h) * nc + c) * Lc;
  const float* sb = s_in + (static_cast<long long>(b * H + h) * nc + c) * N * P;

  // F of rows row0 .. row0 + 63 (zeros past the chunk, and for row0 < 0);
  // by cp.async where the rows are 16-byte aligned
  auto load_f = [&](float* dst, int row0) {
    if (row0 >= 0 && vec_g) {
      if (threadIdx.x < TILE / 4) {
        const int i = 4 * threadIdx.x;
        cp_async16(dst + i, fb + (row0 + i < Lc ? row0 + i : 0), row0 + i < Lc);
      }
    } else {
      for (int i = threadIdx.x; i < TILE; i += THREADS)
        dst[i] = row0 >= 0 && row0 + i < Lc ? fb[row0 + i] : 0.f;
    }
  };
  // stage `it`: 0 the inter-chunk part, 1 + kt key tile kt
  auto load_stage = [&](int it) {
    float* st = ring + (it & 1) * SCAN_STAGE;
    if (it == 0) {
      load_tile(st, LDR, cm + b * cm_sb, cm_st, t0 + q0, min(TILE, min(Lc - q0, T - t0 - q0)),
                N, vec_c);
      load_tile(st + TILE * LDR, LDC, sb, static_cast<long long>(P), 0, N, P, vec_s);
      load_f(st + TILE * LDR + TILE * LDC, -1);
    } else {
      const int k0 = (it - 1) * TILE;
      load_tile(st, LDR, gb + k0, static_cast<long long>(Lc), q0, min(TILE, Lc - q0),
                min(TILE, Lc - k0), vec_g);
      load_tile(st + TILE * LDR, LDC, xb, x_st, t0 + k0, min(TILE, min(Lc - k0, T - t0 - k0)),
                P, vec_x);
      load_f(st + TILE * LDR + TILE * LDC, k0);
    }
  };

  load_f(Fq, q0);
  load_stage(0);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp + g;     // this thread's rows of the tile: r0, r0 + 8
  // hi*hi products, and the small terms summed apart
  float acc[TILE / 8][4], small[TILE / 8][4];
  zero(acc);
  zero(small);
  const int n_it = qt + 2;
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) load_stage(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                // stage `it` (and Fq) visible to all
    const float* as = ring + (it & 1) * SCAN_STAGE;
    const float* vs = as + TILE * LDR;
    const float* fk = vs + TILE * LDC;
    const bool diag = it == n_it - 1;   // off the diagonal every key precedes every query
    const float fi0 = Fq[r0], fi1 = Fq[r0 + 8];
#pragma unroll
    for (int s = 0; s < TILE / 8; ++s) {
      const int j = 8 * s + 2 * t;  // keys j, j + 1 in slots t, t + 4
      const float2 a0 = *reinterpret_cast<const float2*>(as + r0 * LDR + j);
      const float2 a1 = *reinterpret_cast<const float2*>(as + (r0 + 8) * LDR + j);
      const float fj0 = fk[j], fj1 = fk[j + 1];
      // the difference first, then log2 units: exp(F_i - F_i) stays 1
      float m00 = a0.x * exp2_approx((fi0 - fj0) * LOG2E);
      float m01 = a0.y * exp2_approx((fi0 - fj1) * LOG2E);
      float m10 = a1.x * exp2_approx((fi1 - fj0) * LOG2E);
      float m11 = a1.y * exp2_approx((fi1 - fj1) * LOG2E);
      if (diag) {                   // select, not multiply: exp above the diagonal may be inf
        m00 = j <= r0 ? m00 : 0.f;
        m01 = j + 1 <= r0 ? m01 : 0.f;
        m10 = j <= r0 + 8 ? m10 : 0.f;
        m11 = j + 1 <= r0 + 8 ? m11 : 0.f;
      }
      uint32_t ah[4], al[4];
      split<false>(m00, ah[0], al[0]);
      split<false>(m10, ah[1], al[1]);
      split<false>(m01, ah[2], al[2]);
      split<false>(m11, ah[3], al[3]);
#pragma unroll
      for (int nd = 0; nd < TILE / 8; ++nd) {
        uint32_t bh0, bl0, bh1, bl1;
        split<false>(vs[j * LDC + 8 * nd + g], bh0, bl0);
        split<false>(vs[(j + 1) * LDC + 8 * nd + g], bh1, bl1);
        mma_split<false, false>(acc[nd], small[nd], ah, al, bh0, bh1, bl0, bl1);
      }
    }
    __syncthreads();                // this stage is consumed before it is refilled
  }
  float* yb = y + b * y_sb + h * y_sh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = q0 + r0 + 8 * half;
    if (i >= Lc || t0 + i >= T) continue;
    float* yr = yb + (t0 + i) * y_st;
#pragma unroll
    for (int nd = 0; nd < TILE / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = 8 * nd + 2 * t + e;
        if (p < P) yr[p] = acc[nd][2 * half + e] + small[nd][2 * half + e];
      }
  }
}

// rows of `item`-byte elements that load_tile reads 4 at a time: the base
// aligned to 4 elements, every stride and the width multiples of 4
bool rows_vec(const void* p, long long s0, long long s1, long long s2, int cols, int item) {
  return reinterpret_cast<uintptr_t>(p) % (4 * item) == 0 && s0 % 4 == 0 && s1 % 4 == 0 &&
         s2 % 4 == 0 && cols % 4 == 0;
}

bool dims_ok(int P, int N, int Lc) {
  return P >= 1 && P <= MAX_DIM && N >= 1 && N <= MAX_DIM && Lc >= 1 && Lc <= MAX_LC;
}

template <typename TB>
cudaError_t launch_cb(const void* bm, const void* cm, void* g, int B, int T, int N, int Lc,
                      long long bm_sb, long long bm_st, long long cm_sb, long long cm_st,
                      cudaStream_t stream) {
  const int nc = (T + Lc - 1) / Lc, nt = (Lc + TILE - 1) / TILE;
  const bool vec = rows_vec(bm, bm_sb, bm_st, 0, N, sizeof(TB)) &&
                   rows_vec(cm, cm_sb, cm_st, 0, N, sizeof(TB));
  ssd_cb_kernel<TB><<<dim3(B * nc, nt * nt), THREADS, 0, stream>>>(
      static_cast<const TB*>(bm), static_cast<const TB*>(cm), static_cast<float*>(g), T, N, Lc,
      nc, bm_sb, bm_st, cm_sb, cm_st, vec);
  return cudaGetLastError();
}

template <typename TB>
cudaError_t launch_state(const void* x, const void* la, const void* bm, void* f, void* s, int B,
                         int T, int H, int P, int N, int Lc, long long x_sb, long long x_st,
                         long long x_sh, long long la_sb, long long la_st, long long la_sh,
                         long long bm_sb, long long bm_st, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(ssd_state_kernel<TB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, STATE_SMEM);
  if (err != cudaSuccess) return err;
  const int nc = (T + Lc - 1) / Lc;
  ssd_state_kernel<TB><<<B * nc * H, THREADS, STATE_SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(la), static_cast<const TB*>(bm),
      static_cast<float*>(f), static_cast<float*>(s), H, T, P, N, Lc, nc, x_sb, x_st, x_sh,
      la_sb, la_st, la_sh, bm_sb, bm_st, rows_vec(x, x_sb, x_st, x_sh, P, 4),
      rows_vec(bm, bm_sb, bm_st, 0, N, sizeof(TB)));
  return cudaGetLastError();
}

template <typename TB>
cudaError_t launch_scan(const void* x, const void* cm, const void* g, const void* f,
                        const void* s, void* y, int B, int T, int H, int P, int N, int Lc,
                        long long x_sb, long long x_st, long long x_sh, long long cm_sb,
                        long long cm_st, long long y_sb, long long y_st, long long y_sh,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<TB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SCAN_SMEM);
  if (err != cudaSuccess) return err;
  const int nc = (T + Lc - 1) / Lc, nt = (Lc + TILE - 1) / TILE;
  ssd_scan_kernel<TB><<<dim3(B * nc * H, nt), THREADS, SCAN_SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const TB*>(cm), static_cast<const float*>(g),
      static_cast<const float*>(f), static_cast<const float*>(s), static_cast<float*>(y), H, T,
      P, N, Lc, nc, x_sb, x_st, x_sh, cm_sb, cm_st, y_sb, y_st, y_sh,
      rows_vec(x, x_sb, x_st, x_sh, P, 4), rows_vec(cm, cm_sb, cm_st, 0, N, sizeof(TB)),
      Lc % 4 == 0, P % 4 == 0);
  return cudaGetLastError();
}

}  // namespace

// The four passes.  x (B, T, H, P) f32, log_a (B, T, H) f32, bm/cm (B, T,
// N) f32 or bf16 (bc_dtype 0 / 1), y (B, T, H, P) f32, strides in
// elements with the last axis of x, y, bm and cm contiguous; 1 <= P, N <=
// 64 and 1 <= Lc <= 256.  Scratch (contiguous f32, allocated by the
// caller), nc = ceil(T / Lc): g (B, nc, Lc, Lc), f (B, H, nc * Lc),
// s (B, H, nc, N, P).  Each returns the cudaError_t of its launch (0 =
// success); the kernels run async on `stream`.

// 1. g = tril(C B^T) per chunk (the tiles above the diagonal unwritten)
extern "C" int ssd_chunk_cb(int device, const void* bm, const void* cm, void* g, int bc_dtype,
                            int B, int T, int N, int Lc, long long bm_sb, long long bm_st,
                            long long cm_sb, long long cm_st, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!dims_ok(1, N, Lc)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || T == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bc_dtype == 0)
    err = launch_cb<float>(bm, cm, g, B, T, N, Lc, bm_sb, bm_st, cm_sb, cm_st, st);
  else if (bc_dtype == 1)
    err = launch_cb<__nv_bfloat16>(bm, cm, g, B, T, N, Lc, bm_sb, bm_st, cm_sb, cm_st, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// 2. f = cumsum(log_a) per chunk, s = each chunk's local state
extern "C" int ssd_chunk_state(int device, const void* x, const void* la, const void* bm,
                               void* f, void* s, int bc_dtype, int B, int T, int H, int P, int N,
                               int Lc, long long x_sb, long long x_st, long long x_sh,
                               long long la_sb, long long la_st, long long la_sh,
                               long long bm_sb, long long bm_st, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!dims_ok(P, N, Lc)) return static_cast<int>(cudaErrorInvalidValue);
  if (B * H == 0 || T == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bc_dtype == 0)
    err = launch_state<float>(x, la, bm, f, s, B, T, H, P, N, Lc, x_sb, x_st, x_sh, la_sb,
                              la_st, la_sh, bm_sb, bm_st, st);
  else if (bc_dtype == 1)
    err = launch_state<__nv_bfloat16>(x, la, bm, f, s, B, T, H, P, N, Lc, x_sb, x_st, x_sh,
                                      la_sb, la_st, la_sh, bm_sb, bm_st, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// 3. s[c] <- the state entering chunk c (zero for chunk 0), in place
extern "C" int ssd_state_pass(int device, const void* f, void* s, int B, int H, int N, int P,
                              int Lc, int nc, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!dims_ok(P, N, Lc) || nc < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(B) * H * N * P;
  if (total == 0 || nc == 0) return 0;
  ssd_state_pass_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<float*>(s), N, P, Lc, nc, total);
  return static_cast<int>(cudaGetLastError());
}

// 4. y from x, C, g, f and the incoming states s
extern "C" int ssd_chunk_scan(int device, const void* x, const void* cm, const void* g,
                              const void* f, const void* s, void* y, int bc_dtype, int B, int T,
                              int H, int P, int N, int Lc, long long x_sb, long long x_st,
                              long long x_sh, long long cm_sb, long long cm_st, long long y_sb,
                              long long y_st, long long y_sh, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!dims_ok(P, N, Lc)) return static_cast<int>(cudaErrorInvalidValue);
  if (B * H == 0 || T == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bc_dtype == 0)
    err = launch_scan<float>(x, cm, g, f, s, y, B, T, H, P, N, Lc, x_sb, x_st, x_sh, cm_sb,
                             cm_st, y_sb, y_st, y_sh, st);
  else if (bc_dtype == 1)
    err = launch_scan<__nv_bfloat16>(x, cm, g, f, s, y, B, T, H, P, N, Lc, x_sb, x_st, x_sh,
                                     cm_sb, cm_st, y_sb, y_st, y_sh, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
