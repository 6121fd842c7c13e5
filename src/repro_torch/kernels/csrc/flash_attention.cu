// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by repro_torch/kernels/flash_attention.py.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`, body `_flash_kernel`): online-softmax attention with
// causal / sliding-window / ragged-edge masks, f32 running max `m`, sum `l`
// and accumulator, `p` rounded to the value dtype before the PV product,
// `l` clamped at 1e-30, output in the input dtype.
//
// What bounds it: at the hybrid prefill shape (2 x 32 heads x 4096 x 64,
// causal) and at qwen3-1.7b's (2 x 16 x 4096 x 128, the same products)
// the two products are 137 GFLOP against 67 MB of q/k/v/o, so the
// tensor cores set the pace; at the serving and training shapes (S = 50
// and 77) the bytes and the launch do.
//
// Design:
// - Both products run on the tensor cores.  bf16 inputs use `wgmma`
//   (m64n64k16, bf16 in, f32 accumulate), one warpgroup per block: Q and
//   K from shared memory in the 128-byte (hd 64, 128) or 64-byte (hd 32)
//   swizzled layout the descriptors name, p from registers, V N-major
//   from shared memory.  At hd 128 a tile is two slices of 64 dims, each
//   laid out as an hd-64 tile: Q K^T steps across both, and P V runs one
//   wgmma per slice.  f32 inputs keep f32 accuracy through split TF32
//   on warp-level `mma.sync` m16n8k8: each operand is x = hi + lo with
//   hi = tf32(x), lo = tf32(x - hi), and each product is hi*hi + hi*lo +
//   lo*hi accumulated in f32 (the dropped lo*lo is ~2^-22 relative).
//   wgmma's TF32 form takes K-major operands only, and V is N-major in
//   memory; with mma.sync every thread loads its own f32 fragments, so
//   the contraction index inside an 8-wide step is permuted freely: the
//   score accumulator of one key tile is then, register for register,
//   the A fragment of the PV product, and no shuffle moves p.  At hd 128
//   the running accumulator lives in shared memory and P V runs in two
//   slices of 64 dims, so that nothing spills; the K/V ring, Q and the
//   accumulator take 201 KB there, one block per SM.
// - A warp owns 16 query rows (in the warpgroup's accumulator, or its
//   own); the online softmax runs on the accumulator registers (a row's
//   max and sum once per 64-key tile, a quad shuffle for the max, the
//   sum reduced once at the end; the scale folds into the exponent).
// - Q is copied once, and K/V tiles of 64 keys go through a two-stage
//   ring in shared memory, by 16-byte `cp.async` copies (zero-filled past
//   Sq and Sk), so the next tile's load overlaps this tile's products.
//   bf16 stays bf16 in shared memory; f32 rows are padded so that the
//   fragment loads hit 32 distinct banks.
// - Grid: (B*H, query tiles) with the last query tiles first, so under
//   a causal mask the heaviest blocks start first and leave no tail.
//   Key tiles that the causal or window mask removes for a whole block
//   are not loaded, and on the f32 route for a whole warp not computed.
//   A block is 4 warps (64 rows) at every shape: at the serving shapes,
//   blocks of 1 or 2 warps (more blocks on the card) measured slower, as
//   each warp's chain of dependent products sets the time there.

// Layout: q/k/v/o are (B, H, S, hd) index spaces with arbitrary element
// strides for B, H and S and a contiguous hd, so (B, S, H, hd) tensors go
// in without a transposing copy.  cp.async needs 16-byte aligned rows:
// base pointers and the B, H and S strides in bytes are multiples of 16
// (the wrapper checks it and raises).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BK = 64;               // keys per shared-memory tile
constexpr int STAGES = 2;            // K/V ring depth
constexpr int WARPS = 4;             // 16 query rows each
constexpr int BQ = 16 * WARPS;       // query rows per block
constexpr float NEG = -1e30f;        // finite mask fill, as in the TPU kernel
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, h, s;
};

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; `valid == false` writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x by the SFU (ex2.approx, ~2 ulp; denormal results flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// wgmma (sm_90a): D (64 x N, f32, in registers) += A (64 x 16) B (16 x N),
// run by the 4 warps of a warpgroup together.  Warp w holds rows
// 16w .. 16w + 15 of D in the m16n8 accumulator order, n-tile after
// n-tile.  scale_d = 0 ignores the old D.
__device__ __forceinline__ void wgmma_n64_ss(float (&d)[8][4], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,"
      "%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, p, 1,"
      " 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

// A from registers (the m16n8k16 A fragment of the warp's 16 rows); B is
// N-major ("transposed"), as V's (key, dim) tile with dims contiguous.
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,"
      "%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, {%32,%33,%34,"
      "%35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[4][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, {%16,%17,%18,"
      "%19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin the accumulator registers at this point of the program: wgmma
// writes them asynchronously, so no read may move above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

// shared memory written by threads (cp.async, st.shared), then read by
// wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory matrix descriptor: start address, the byte strides
// along the leading and the strided dimension; the swizzle mode is or-ed
// into bits 62-63.
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo, int sbo) {
  return (static_cast<uint64_t>(smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// The two products, per dtype.  Fragment names follow the PTX ISA: in a
// warp, lane = 4 * g + t; an m16n8 accumulator holds c0 = (g, 2t),
// c1 = (g, 2t + 1), c2 = (g + 8, 2t), c3 = (g + 8, 2t + 1).
// ---------------------------------------------------------------------------

// The running output accumulator of a thread: its m16n8 fragments, 4
// floats per 8-dim n tile (rows g and g + 8, columns 2t and 2t + 1).  In
// registers, or, for the f32 route at hd 128, in shared memory.
template <int HD>
struct RegAcc {
  float v[HD / 8][4];
  __device__ __forceinline__ void init(float*, int) {
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) v[nd][0] = v[nd][1] = v[nd][2] = v[nd][3] = 0.f;
  }
  __device__ __forceinline__ void scale(const float (&alpha)[2]) {
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) {
      v[nd][0] *= alpha[0];
      v[nd][1] *= alpha[0];
      v[nd][2] *= alpha[1];
      v[nd][3] *= alpha[1];
    }
  }
  __device__ __forceinline__ float4 frag(int nd) const {
    return make_float4(v[nd][0], v[nd][1], v[nd][2], v[nd][3]);
  }
};

// One float4 per n tile, the block's threads side by side, so a warp's
// 16-byte accesses are contiguous (no bank conflict).
template <int HD>
struct SmemAcc {
  static constexpr int BYTES = 32 * WARPS * HD / 2 * sizeof(float);
  float4* a;
  __device__ __forceinline__ float4& at(int nd) { return a[nd * 32 * WARPS]; }
  __device__ __forceinline__ void init(float* base, int tid) {
    a = reinterpret_cast<float4*>(base) + tid;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) at(nd) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ float4 frag(int nd) const { return a[nd * 32 * WARPS]; }
};

template <typename T, int HD>
struct Mma;

// f32: split TF32 on mma.m16n8k8.  In step kk of Q K^T the k slots t and
// t + 4 hold dims 8kk + 2t and 8kk + 2t + 1 (float2 loads of q and k); in
// step j of P V they hold keys 8j + 2t and 8j + 2t + 1, which is where the
// score accumulator of key block j already has them.  The tensor cores do
// not round their f32 sums to nearest (one accumulator for all three
// products and for every tile's P V measured 5x the error of a
// round-to-nearest emulation at S = 4096), so the hi*hi and the small
// terms go to separate accumulators, and each tile's P V starts from zero
// and is added to the running accumulator in f32.  The warp's 16 query
// rows wait in shared memory and are split one k step at a time (held
// split in registers they would take 64 of them and push the kernel past
// 255 registers).  At hd 128 the running accumulator (64 floats a thread)
// lives in shared memory, 32 KB a block: in registers, beside the score
// and P V sums, every layout tried spilled at 255 registers (P V in
// slices of 16 to 128 dims, the score loop unrolled 1 to 16 times,
// pinned K/V loads, each split product added to the sum at once).  Each
// tile reads it, scales it by the softmax correction and adds its P V,
// one 64-dim slice at a time.
template <int HD>
struct Mma<float, HD> {
  static constexpr bool WARPGROUP = false;   // each warp runs its own products
  static constexpr bool ACC_SMEM = HD > 64;
  using Acc = std::conditional_t<ACC_SMEM, SmemAcc<HD>, RegAcc<HD>>;
  static constexpr int ACC_BYTES = ACC_SMEM ? SmemAcc<HD>::BYTES : 0;
  static constexpr int K_LD = HD + 8;   // float2 rows 8 banks apart
  static constexpr int V_LD = HD + 4;   // rows 2t and 2t + 1: 8 banks apart
  static constexpr int Q_LD = HD + 8;   // as K
  static constexpr int K_ELEMS = BK * K_LD, V_ELEMS = BK * V_LD, Q_ELEMS = BQ * Q_LD;
  static constexpr int KS = HD / 8;

  // padded rows: 16-byte chunk `idx` of a tile is (row r, elements col ..)
  static __device__ __forceinline__ void chunk(int idx, int& r, int& col) {
    r = idx / (HD / 4);
    col = 4 * (idx % (HD / 4));
  }
  static __device__ __forceinline__ int k_off(int r, int col) { return r * K_LD + col; }
  static __device__ __forceinline__ int v_off(int r, int col) { return r * V_LD + col; }

  struct QFrag {
    const float* q;                     // this warp's 16 rows, zeros past Sq
  };

  static __device__ __forceinline__ int q_off(int r, int col) { return r * Q_LD + col; }
  static __device__ __forceinline__ QFrag q_frag(const float* qsm, int warp) {
    return QFrag{qsm + 16 * warp * Q_LD};
  }

  static __device__ __forceinline__ void scores(const QFrag& f, const float* ks,
                                                float (&s)[BK / 8][4], int lane) {
    const int g = lane / 4, t = lane % 4;
    float sl[BK / 8][4];                // the small terms, summed apart
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = sl[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int d = 8 * kk + 2 * t;
      const float2 x0 = *reinterpret_cast<const float2*>(f.q + g * Q_LD + d);
      const float2 x1 = *reinterpret_cast<const float2*>(f.q + (g + 8) * Q_LD + d);
      uint32_t ah[4], al[4];
      split_tf32(x0.x, ah[0], al[0]);
      split_tf32(x1.x, ah[1], al[1]);
      split_tf32(x0.y, ah[2], al[2]);
      split_tf32(x1.y, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float2 kx = *reinterpret_cast<const float2*>(ks + (8 * j + g) * K_LD + d);
        uint32_t h0, l0, h1, l1;
        split_tf32(kx.x, h0, l0);
        split_tf32(kx.y, h1, l1);
        mma_tf32(sl[j], al, h0, h1);
        mma_tf32(sl[j], ah, l0, l1);
        mma_tf32(s[j], ah, h0, h1);
      }
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += sl[j][e];
  }

  // P V by slices of at most 64 dims (two at hd 128), each with its own
  // hi*hi and small-term sums.
  static constexpr int NSLICE = HD > 64 ? HD / 64 : 1;
  static constexpr int SN = HD / 8 / NSLICE;   // n tiles of 8 dims per slice

  // acc = acc * alpha (the softmax correction of rows g, g + 8) + P V
  static __device__ __forceinline__ void pv(const float (&p)[BK / 8][4], const float* vs,
                                            Acc& acc, const float (&alpha)[2], int lane) {
    const int g = lane / 4, t = lane % 4;
    if constexpr (!ACC_SMEM) acc.scale(alpha);
#pragma unroll 1   // the slice only moves addresses (at hd <= 64 there is one)
    for (int sl = 0; sl < NSLICE; ++sl) {
      float big[SN][4], small[SN][4];   // this tile's P V: hi*hi, and the rest
#pragma unroll
      for (int nd = 0; nd < SN; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) big[nd][e] = small[nd][e] = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        uint32_t ah[4], al[4];
        split_tf32(p[j][0], ah[0], al[0]);
        split_tf32(p[j][2], ah[1], al[1]);
        split_tf32(p[j][1], ah[2], al[2]);
        split_tf32(p[j][3], ah[3], al[3]);
        const float* v0 = vs + (8 * j + 2 * t) * V_LD + 8 * SN * sl + g;
#pragma unroll
        for (int nd = 0; nd < SN; ++nd) {
          uint32_t h0, l0, h1, l1;
          split_tf32(v0[8 * nd], h0, l0);
          split_tf32(v0[V_LD + 8 * nd], h1, l1);
          mma_tf32(small[nd], al, h0, h1);
          mma_tf32(small[nd], ah, l0, l1);
          mma_tf32(big[nd], ah, h0, h1);
        }
      }
#pragma unroll
      for (int nd = 0; nd < SN; ++nd) {
        if constexpr (ACC_SMEM) {
          float4 x = acc.at(SN * sl + nd);
          x.x = x.x * alpha[0] + (big[nd][0] + small[nd][0]);
          x.y = x.y * alpha[0] + (big[nd][1] + small[nd][1]);
          x.z = x.z * alpha[1] + (big[nd][2] + small[nd][2]);
          x.w = x.w * alpha[1] + (big[nd][3] + small[nd][3]);
          acc.at(SN * sl + nd) = x;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc.v[SN * sl + nd][e] += big[nd][e] + small[nd][e];
        }
      }
    }
  }

  static __device__ __forceinline__ void store(float* orow, int col, float x, float y) {
    *reinterpret_cast<float2*>(orow + col) = make_float2(x, y);
  }
};

// bf16: wgmma, the warpgroup (the block's 4 warps) at once.  Q K^T reads
// Q and K from shared memory (K-major: dims are the contraction); P V
// takes p from registers, rounded to bf16 as it is packed into the A
// fragment (p.astype(v.dtype)), and V from shared memory N-major (dims
// contiguous, keys the contraction).
template <int HD>
struct Mma<__nv_bfloat16, HD> {
  static constexpr bool WARPGROUP = true;   // the 4 warps run each wgmma together
  using Acc = RegAcc<HD>;
  static constexpr int ACC_BYTES = 0;
  static constexpr int K_ELEMS = BK * HD, V_ELEMS = BK * HD, Q_ELEMS = BQ * HD;
  static constexpr int KS = HD / 16;
  // A tile is stored as column slices of at most 64 dims, one after the
  // other (two at hd 128).  A row of a slice is one swizzle span (128 B
  // at hd 64 and 128, 64 B at hd 32); its 16-byte chunks are permuted by
  // the row's index within 8 rows, so wgmma reads 8 rows without a bank
  // conflict.  The 8-row atoms start on 1024-byte boundaries (the ring
  // is aligned to 1024, and a slice of 64 rows is a multiple of it).
  static constexpr int SPAN = HD >= 64 ? 128 : 2 * HD;   // bytes
  static constexpr int SLICE_DIMS = SPAN / 2;
  static constexpr int NSLICE = HD / SLICE_DIMS;
  static_assert(BK == BQ, "Q, K and V tiles share the slice size");
  static constexpr int SLICE_BYTES = BK * SPAN;
  static constexpr int ATOM = 8 * SPAN;
  static constexpr uint64_t MODE = SPAN == 128 ? 1 : 2;   // 128-byte / 64-byte swizzle

  // a row's chunks come from neighbouring threads
  static __device__ __forceinline__ void chunk(int idx, int& r, int& col) {
    r = idx / (HD / 8);
    col = 8 * (idx % (HD / 8));
  }
  static __device__ __forceinline__ int tiled(int r, int col) {   // elements
    const int sl = col / SLICE_DIMS, c = col % SLICE_DIMS;
    const int sw = SPAN == 128 ? r % 8 : (r / 2) % 4;
    return (sl * SLICE_BYTES + r * SPAN + (((c / 8) ^ sw) * 16)) / 2;
  }
  static __device__ __forceinline__ int k_off(int r, int col) { return tiled(r, col); }
  static __device__ __forceinline__ int v_off(int r, int col) { return tiled(r, col); }
  static __device__ __forceinline__ int q_off(int r, int col) { return tiled(r, col); }
  // Descriptors.  Either stride field is the 8-row atom: along the rows
  // for Q and K (K-major, the 16 dims of a step lie inside one span of
  // one slice), and along the keys for V (N-major, a slice's 64 or 32
  // dims are one span).
  // Q, K at k step kk (16 dims, 32 bytes into its slice's span):
  static __device__ __forceinline__ uint64_t qk_desc(const __nv_bfloat16* base, int kk) {
    constexpr int STEPS = SLICE_DIMS / 16;   // k steps per slice
    return smem_desc(reinterpret_cast<const char*>(base) + (kk / STEPS) * SLICE_BYTES +
                         32 * (kk % STEPS),
                     ATOM, ATOM) |
           (MODE << 62);
  }
  // V at k step jj (16 keys, two atoms) in dim slice sl:
  static __device__ __forceinline__ uint64_t v_desc(const __nv_bfloat16* base, int jj, int sl) {
    return smem_desc(reinterpret_cast<const char*>(base) + sl * SLICE_BYTES + 2 * ATOM * jj,
                     ATOM, ATOM) |
           (MODE << 62);
  }

  struct QFrag {
    const __nv_bfloat16* q;                 // the block's 64 rows, zeros past Sq
  };
  static __device__ __forceinline__ QFrag q_frag(const __nv_bfloat16* qsm, int) {
    return QFrag{qsm};
  }

  static __device__ __forceinline__ void scores(const QFrag& f, const __nv_bfloat16* ks,
                                                float (&s)[BK / 8][4], int) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)         // 16 dims a step
      wgmma_n64_ss(s, qk_desc(f.q, kk), qk_desc(ks, kk), kk > 0);
    wgmma_commit_and_wait();
    fence_regs(s);
  }

  static __device__ __forceinline__ void pv(const float (&p)[BK / 8][4],
                                            const __nv_bfloat16* vs, Acc& acc,
                                            const float (&alpha)[2], int) {
    acc.scale(alpha);
    uint32_t a[BK / 16][4];
#pragma unroll
    for (int jj = 0; jj < BK / 16; ++jj) {
      a[jj][0] = pack_bf16(p[2 * jj][0], p[2 * jj][1]);
      a[jj][1] = pack_bf16(p[2 * jj][2], p[2 * jj][3]);
      a[jj][2] = pack_bf16(p[2 * jj + 1][0], p[2 * jj + 1][1]);
      a[jj][3] = pack_bf16(p[2 * jj + 1][2], p[2 * jj + 1][3]);
    }
    fence_regs(acc.v);
    wgmma_fence();
#pragma unroll
    for (int jj = 0; jj < BK / 16; ++jj)    // 16 keys a step
#pragma unroll
      for (int sl = 0; sl < NSLICE; ++sl)   // one wgmma per dim slice
        wgmma_rs(reinterpret_cast<float(&)[SLICE_DIMS / 8][4]>(acc.v[sl * (SLICE_DIMS / 8)]),
                 a[jj], v_desc(vs, jj, sl));
    wgmma_commit_and_wait();
    fence_regs(acc.v);
  }

  static __device__ __forceinline__ void store(__nv_bfloat16* orow, int col, float x, float y) {
    *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16(x, y);
  }
};

template <typename T, int HD>
__host__ __device__ constexpr int stage_elems() {
  return Mma<T, HD>::K_ELEMS + Mma<T, HD>::V_ELEMS;
}

template <typename T, int HD>
__host__ __device__ constexpr int smem_bytes() {
  return (STAGES * stage_elems<T, HD>() + Mma<T, HD>::Q_ELEMS) *
             static_cast<int>(sizeof(T)) +
         Mma<T, HD>::ACC_BYTES + 1024;   // room to align the ring
}

// Copy keys [kt, kt + BK) of K and V into one ring stage, zeros past Sk.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* ks, const T* kb, const T* vb, long long kss,
                                          long long vss, int kt, int Sk, int tid) {
  using M = Mma<T, HD>;
  T* vs = ks + M::K_ELEMS;
  for (int idx = tid; idx < BK * HD * sizeof(T) / 16; idx += 32 * WARPS) {
    int r, col;
    M::chunk(idx, r, col);
    const bool in = kt + r < Sk;
    const long long pos = in ? kt + r : 0;
    cp_async16(ks + M::k_off(r, col), kb + pos * kss + col, in);
    cp_async16(vs + M::v_off(r, col), vb + pos * vss + col, in);
  }
}

// Copy the block's query rows [q0, q0 + BQ), zeros past Sq.
template <typename T, int HD>
__device__ __forceinline__ void load_q_tile(T* qsm, const T* qb, long long qss, int q0, int Sq,
                                            int tid) {
  using M = Mma<T, HD>;
  for (int idx = tid; idx < BQ * HD * sizeof(T) / 16; idx += 32 * WARPS) {
    int r, col;
    M::chunk(idx, r, col);
    const bool in = q0 + r < Sq;
    cp_async16(qsm + M::q_off(r, col), qb + (in ? q0 + r : 0) * qss + col, in);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(32 * WARPS, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int H, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
                 Strides os, float scale_log2, int causal, int window) {
  using M = Mma<T, HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // swizzle atoms start on 1024-byte boundaries
  T* ring = reinterpret_cast<T*>(smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;           // last tiles first
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int wq0 = q0 + 16 * warp;                             // this warp's rows
  const int wq_last = min(wq0 + 15, Sq - 1);
  const bool warp_live = wq0 < Sq;
  const int r0 = wq0 + g, r1 = r0 + 8;                        // this thread's rows

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

  T* qsm = ring + STAGES * stage_elems<T, HD>();
  const typename M::QFrag qf = M::q_frag(qsm, warp);

  typename M::Acc acc;
  acc.init(reinterpret_cast<float*>(qsm + M::Q_ELEMS), tid);
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};   // rows r0, r1 (l: this thread's columns)

  // Key tiles that some row of this block can see; the others would leave
  // m, l and acc unchanged, so they are not loaded.
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? (max(0, q0 - window + 1) / BK) * BK : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  if (n_tiles > 0) {
    load_q_tile<T, HD>(qsm, qb, qs.s, q0, Sq, tid);
    load_tile<T, HD>(ring, kb, vb, ks.s, vs.s, k_begin, Sk, tid);
  }
  cp_async_commit();
  for (int i = 0; i < n_tiles; ++i) {
    const int kt = k_begin + i * BK;
    if (i + 1 < n_tiles)
      load_tile<T, HD>(ring + ((i + 1) % STAGES) * stage_elems<T, HD>(), kb, vb, ks.s, vs.s,
                       kt + BK, Sk, tid);
    cp_async_commit();
    cp_async_wait<1>();              // tile i has landed (tile i + 1 may be in flight)
    if constexpr (M::WARPGROUP) fence_proxy_async();
    __syncthreads();
    const T* kst = ring + (i % STAGES) * stage_elems<T, HD>();
    const T* vst = kst + M::K_ELEMS;

    // a warp skips a tile its rows cannot see, unless its products are
    // the warpgroup's
    const bool skip = !M::WARPGROUP && (!warp_live || (causal && kt > wq_last) ||
                                        (window > 0 && kt + BK - 1 <= wq0 - window));
    if (!skip) {
      float s[BK / 8][4];
      M::scores(qf, kst, s, lane);
      // mask only where the tile crosses an edge; m is kept in raw score
      // units and the scale folds into the exponent's FMA
      const bool edge = kt + BK > Sk || (causal && kt + BK - 1 > wq0) ||
                        (window > 0 && kt <= wq_last - window);
      float tmax[2] = {NEG, NEG};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (edge) {
            const int qpos = e < 2 ? r0 : r1;
            const int kpos = kt + 8 * j + 2 * t + (e & 1);
            const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                            (window <= 0 || kpos > qpos - window);
            s[j][e] = ok ? s[j][e] : NEG;
          }
          tmax[e / 2] = fmaxf(tmax[e / 2], s[j][e]);
        }
      }
      float alpha[2], mc[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the four threads of a row are lanes 4g .. 4g + 3
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
        const float m_new = fmaxf(m[r], tmax[r]);
        alpha[r] = exp2_approx((m[r] - m_new) * scale_log2);
        mc[r] = m_new * scale_log2;
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // masked scores (NEG) give 0, also in a row with no key yet
          float p = exp2_approx(fmaf(s[j][e], scale_log2, -mc[e / 2]));
          if (edge) p = s[j][e] > NEG ? p : 0.f;
          psum[e / 2] += p;
          s[j][e] = p;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
      M::pv(s, vst, acc, alpha, lane);
    }
    __syncthreads();                 // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (!warp_live) return;
  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? r1 : r0;
    if (row >= Sq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    T* orow = ob + row * os.s;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) {
      const float4 a = acc.frag(nd);
      M::store(orow, 8 * nd + 2 * t, (r ? a.z : a.x) / lc, (r ? a.w : a.y) / lc);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int H, int Sq, int Sk, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, int causal, int window, cudaStream_t stream) {
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  constexpr int smem = smem_bytes<T, HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, HD><<<grid, 32 * WARPS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Sq, Sk, qs, ks, vs, os, scale * LOG2E, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                      int B, int H, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
                      Strides os, float scale, int causal, int window, cudaStream_t stream) {
  // The head dims of the ported configs: 128 in the dense LMs (qwen3,
  // yi, granite, qwen1.5), 64 in both towers and zamba2's shared block,
  // 32 in the reduced ViT tower.
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, scale, causal,
                           window, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, scale, causal,
                           window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, scale, causal,
                            window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p, const Strides& s, int item) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (s.b * item) % 16 == 0 &&
         (s.h * item) % 16 == 0 && (s.s * item) % 16 == 0;
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
  const int item = dtype == 0 ? 4 : 2;
  if (!aligned16(q, qs, item) || !aligned16(k, ks, item) || !aligned16(v, vs, item) ||
      !aligned16(o, os, item))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch_hd<float>(hd, q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, scale, causal,
                           window, st);
  } else if (dtype == 1) {
    err = launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, Sq, Sk, qs, ks, vs, os, scale,
                                   causal, window, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
