// bf16 tensor-core products with float32 accumulation for the training
// kernels' bf16 instantiations (grad_reduce.cu's GEMMs, the chains of
// embed_gru_bwd.cu and gru_fwd_chain.cu, decoder_ce.cu's CE head):
// mma.sync.m16n8k16 fragments, ldmatrix, the chains' swizzled weight slab
// and the three-piece split of a float32 operand; and Hopper's wgmma, for
// the float32 dW GEMM that splits both of its operands.
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

// ---- wgmma (sm_90a): a warpgroup's asynchronous bf16 product from shared
// memory (grad_reduce.cu's float32 dW GEMM)
//
// Both operands MN-major with the 128-byte swizzle: an atom is 8 k rows of
// 64 bf16 along M (or N), 128 bytes a row, 1024-byte aligned, the 16-byte
// chunk c of row k stored at chunk c ^ k; the descriptor's leading byte
// offset (LBO) is the step between atoms along M (N), its stride byte
// offset (SBO) the step between atoms along k. Accumulator of m64nNk16
// (lane = 32 w + 4 g + q, w the warp of the warpgroup): d[4 j + 2 h + e]
// is row 16 w + g + 8 h, column 8 j + 2 q + e.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* smem,
                                                     int lbo, int sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(smem);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Returns when all but the N newest committed groups of this warpgroup's
// products have completed (their accumulators written, their shared memory
// read).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Generic-proxy writes to shared memory (st.shared) made visible to the
// async proxy that wgmma reads through; each writer runs it before the
// barrier that precedes the product.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory barriers (mbarrier) between the warps that fill a ring
// slot and those that read it: init (one thread, before a __syncthreads),
// arrive (one count of the current phase, from the threads for which
// `pred` holds), and a wait that returns once the phase of the given
// parity has completed (a fresh barrier's "phase 1" counts as completed,
// so a first wait on parity 1 passes). The predicate and the wait's loop
// stay inside the asm: the compiler then sees no divergent branch around
// the wgmma that follow. The whole warp waits together: the same wait by
// one thread of a warp, inside a branch, hung on an H100.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(a),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar, bool pred = true) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(bar);
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(a),
      "r"((int)pred)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(bar);
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(a),
      "r"(parity)
      : "memory");
}

// mbarrier_init made visible to the async proxy (the TMA's transaction
// counts); before the __syncthreads that follows the inits.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of TMA transactions on bar.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(a),
               "r"(bytes)
               : "memory");
}

// The TMA copy of the box at (c0, c1, c2) of the tensor map `tmap` (a
// __grid_constant__ kernel parameter) into smem; its bytes complete a
// transaction count on bar. Parts of the box outside the tensor read as 0.
__device__ __forceinline__ void tma_load_3d(void* smem, const void* tmap,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t b = (uint32_t)__cvta_generic_to_shared(bar);
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(d),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1), "r"(c2),
      "r"(b)
      : "memory");
}

// Pins the registers of d here: volatile asm keeps its order with the
// wgmma asm around it, so no read of d moves above a wgmma_wait and no
// other access moves across a product's issue.
template <int N>
__device__ __forceinline__ void pin_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128) = a (64 x 16) b (16 x 128) + (accumulate ? d : 0), a and b
// bf16 MN-major in shared memory (descriptors da, db), float32 d.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

}  // namespace fader
