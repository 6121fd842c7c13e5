// Split-TF32 products on the tensor cores, and 16-byte asynchronous
// copies, for the port's CUDA kernels (sm_90a).
//
// An f32 operand is split x = hi + lo with hi = x truncated to TF32 (its
// top 19 bits) and lo = x - hi, which is exact in f32; an f32 product is
// then hi*hi + hi*lo + lo*hi, three TF32 `mma.sync` m16n8k8 products
// accumulated in f32.  The tensor cores read the top 19 bits of each
// operand, so lo enters truncated to TF32: the split carries 21 bits of
// x and the dropped lo*lo is ~2^-20 relative.  (A round-to-nearest split
// by `cvt.rna.tf32.f32` is a few bits tighter and measured slower in the
// SSD scan on the H100, where the splits share the issue slots with the
// products.)  The tensor cores do not round their f32 sums to
// nearest, so a caller keeps hi*hi and the small terms in separate
// accumulators and adds them in f32 at the end.
//
// Fragment names follow the PTX ISA: in a warp, lane = 4 * g + t; the A
// fragment of a 16 x 8 tile holds a0 = (g, t), a1 = (g + 8, t),
// a2 = (g, t + 4), a3 = (g + 8, t + 4); the B fragment of an 8 x 8 tile
// b0 = (k t, n g), b1 = (k t + 4, n g); the m16n8 accumulator
// c0 = (g, 2t), c1 = (g, 2t + 1), c2 = (g + 8, 2t), c3 = (g + 8, 2t + 1).
// Since every thread loads its own fragments, a caller may permute the
// contraction index inside an 8-wide step: slots t and t + 4 holding
// indices 2t and 2t + 1 lets a thread read one float2 per row.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

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

// x = hi + lo: hi is x truncated to TF32, lo = x - hi (exact)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b on the tensor cores (m16n8k8, TF32 in, f32 accumulate)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 8-wide step of a split product: big += ah bh, small += al bh + ah bl.
// A_EXACT (A's values are TF32 numbers, e.g. bf16 inputs, al = 0) and
// B_EXACT drop the products that would add zero.
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma_split(float (&big)[4], float (&small)[4],
                                          const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                          uint32_t bh0, uint32_t bh1, uint32_t bl0,
                                          uint32_t bl1) {
  if constexpr (!A_EXACT) mma_tf32(small, al, bh0, bh1);
  if constexpr (!B_EXACT) mma_tf32(small, ah, bl0, bl1);
  mma_tf32(big, ah, bh0, bh1);
}

}  // namespace tc
