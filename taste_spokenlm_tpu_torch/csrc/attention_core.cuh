// Device helpers shared by the attention kernels (flash_attention.cu,
// fused_dit.cu, relpos_attention.cu):
//  * the storage-type conversions and the bf16 cast point (to_f32, from_f32,
//    round_to) and the Pallas kernels' finite -inf (kNegInf);
//  * the bf16 tensor-core path: cp.async copies with zero fill, ldmatrix
//    (plain and transposed), mma.sync m16n8k16 with bf16 operands and f32
//    sums, the SFU's ex2 and the packing of two floats into a bf16 pair.
//
// The mma accumulator layout used throughout: lane (g, t4) = (lane / 4,
// lane % 4) of a warp holds rows g and g + 8 of a 16-row tile and columns
// 2 t4 and 2 t4 + 1 of every 8-wide column tile (c[0..1] row g, c[2..3]
// row g + 8).  Two 8-wide accumulator tiles, rounded to bf16 and packed,
// are one 16-wide A operand (pack order: row g, row g + 8 of the first
// tile, then of the second).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tsk {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// value after a cast to the storage type T (a bf16 cast point)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

constexpr float kNegInf = -1e30f;  // the Pallas kernels' finite -inf
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// copy `BYTES` (16 or 4) from global to shared memory, or zeros when !in
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool in) {
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(in ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Operand addresses for one warp, `ld` the row stride in elements:
//  * a_rows: A (16 x 16 at k-offset kk) from a row-major [m][k] tile;
//  * a_cols: A from a k-major [k][m] tile (ldsm_x4_trans), m-offset m0;
//  * b_rows: B fragments of two 8-wide n tiles (n0, n0 + 8) from an [n][k]
//    tile (ldsm_x4: r[0..1] the first tile, r[2..3] the second);
//  * b_cols: the same from a k-major [k][n] tile (ldsm_x4_trans).
__device__ __forceinline__ const bf16* a_rows(const bf16* t, int ld, int m0,
                                              int kk, int lane) {
  return t + (m0 + (lane & 15)) * ld + kk + (lane >> 4) * 8;
}
__device__ __forceinline__ const bf16* a_cols(const bf16* t, int ld, int m0,
                                              int kk, int lane) {
  return t + (kk + (lane & 7) + (lane >> 4) * 8) * ld + m0 +
         ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ const bf16* b_rows(const bf16* t, int ld, int n0,
                                              int kk, int lane) {
  return t + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + kk +
         ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ const bf16* b_cols(const bf16* t, int ld, int n0,
                                              int kk, int lane) {
  return t + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
         (lane >> 4) * 8;
}

// 2^x by the SFU's ex2 (about 2 ulp; flushes results below 2^-126 to 0,
// far under what a bf16 P or an f32 row sum keeps of them)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the low and the high bf16 of a packed pair, as f32 (exact)
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A operand of k-step kk (16 columns = accumulator tiles 2 kk, 2 kk + 1)
// from f32 accumulators, rounded to bf16
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

}  // namespace tsk
