// bf16 tensor-core products with float32 accumulation for the training
// kernels' bf16 instantiations (grad_reduce.cu's GEMMs, the chains of
// embed_gru_bwd.cu and gru_fwd_chain.cu, decoder_ce.cu's CE head):
// mma.sync.m16n8k16 fragments, ldmatrix, the chains' swizzled weight slab
// and the three-piece split of a float32 operand.
//
// Every product of the Pallas kernels in bf16 pairs a bf16 operand with a
// float32 one that JAX keeps unrounded (preferred_element_type=F32), or
// two bf16 operands. A float32 x is split into three bf16 pieces, hi =
// bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid) (each difference is
// exact in float32), so x = hi + mid + lo to within 2^-24 of |x| or so:
// float32's 24-bit significand. With the other operand bf16, each piece's
// product is exact in float32, and three MMAs (lo, mid, hi, into one
// float32 accumulator) give the float32 product to float32 rounding. Two
// bf16 operands take one MMA. Rounding the float32 operand once to bf16,
// or feeding it to TF32, would change the function the TPU kernels
// compute; neither is done.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, q = lane % 4): A (16 x
// 16, row-major) a[0] = rows g, k 2q..2q+1; a[1] rows g+8, same k; a[2] rows
// g, k 2q+8..2q+9; a[3] rows g+8, k 2q+8..2q+9. B (16 x 8) b[0] = k 2q..2q+1
// at column g, b[1] = k 2q+8..2q+9. C (16 x 8) c[0..1] = row g, columns
// 2q..2q+1; c[2..3] = row g+8. The lower-indexed element sits in a
// register's low half.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace fader {

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two floats rounded to bf16 (nearest even), x0 in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  return bf16x2_bits(__floats2bfloat162_rn(x0, x1));
}

// The three-piece split of (x0, x1): x = hi + mid + lo (see above).
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = __fsub_rn(x0, hf.x), r1 = __fsub_rn(x1, hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = bf16x2_bits(h);
  mid = bf16x2_bits(m);
  lo = pack_bf16(__fsub_rn(r0, mf.x), __fsub_rn(r1, mf.y));
}

// c += a b on the tensor cores (bf16 in, float32 accumulate). Not
// volatile: a function of its registers alone, so the compiler may
// interleave independent MMAs (a dependent one waits out the MMA's
// latency; the callers order the three pieces of a split piece-major, each
// accumulator still taking lo, mid, hi in that order).
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Element (k, c) of a k-major bf16 slab of 32 columns (64-byte rows), the
// chains' weight slabs: at k * 32 + its swizzled column, the 16-byte chunk
// c / 8 of row k stored at chunk (c / 8) ^ ((k / 2) % 4), so that
// ldmatrix's 8 consecutive rows fall on distinct banks.
__device__ __forceinline__ int swz(int k, int c) {
  return k * 32 + ((((c >> 3) ^ (k >> 1)) & 3) << 3) + (c & 7);
}

// Four 8 x 8 b16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8 (16 bytes, 16-byte aligned). Plain: r[j] holds
// matrix j's (row g, columns 2q, 2q+1); .trans: (rows 2q, 2q+1, column g).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

}  // namespace fader
