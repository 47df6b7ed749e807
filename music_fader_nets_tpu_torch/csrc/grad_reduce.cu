// Weight-gradient reductions of the training backward kernels
// (embed_gru_bwd.cu, stacked_gru.cu, decoder_ce_bwd.cu): dW = h_prev^T dpre
// over all T*B rows, the scatter of dpre_x rows into embedding rows by
// token or class, and the bias / per-sequence sums.
//
// Replaces the accumulator updates inside the TPU backward kernels
// (pallas_gru.py:600-603 `dwih += onehot^T dpx`, `dw += h_prev^T dph`,
// :944-947, :1294-1301, :1682-1684), which ran once per time block there.
// Here they run once per backward call, after the dh chain, over the
// dpre_x / dpre_h rows the chain stashed in device memory.
//
// What bounds them on an H100: dW_hh is float32 work (encoder: 4 x 2 x 512
// x 1536 x 12800 = 80.5 GFLOP, 1.2 ms at the CUDA cores' 67 TFLOP/s; on
// the tensor cores it takes six bf16 products each, 483 GFLOP, 0.49 ms at
// 989); the sums and the scatter read each stashed row once (bytes).
//
// Design: the float32 gemm_tn runs on Hopper's wgmma (gemm_tn_wg_kernel).
// Each product has to keep float32 accuracy over 12,800-term sums: plain
// TF32 (11-bit operands) errs by about a hundred times more and fails the
// training cells' gradient checks. Both operands are split into three
// bf16 pieces, x = hi + mid + lo (mma_bf16.cuh::split3; x to within 2^-24
// |x|), and each 16-deep k-step takes the six piece products of order
// 2^-16 and above, lowest first: mid.mid, hi.lo, lo.hi, hi.mid, mid.hi,
// hi.hi; the three left out (mid.lo, lo.mid, lo.lo) are 2^-24 of a product
// and less. Each piece product is exact in the tensor cores, but their
// float32 accumulator adds with truncation: 4,800 such additions into one
// sum err 25 to 40 times more than the CUDA-core kernel (measured on an
// H100, GRU-like operands), so the products of kWgPromote slabs go into a
// step accumulator that is waited for and added into a float32 sum in
// registers, rounded to nearest; that sum errs less than the CUDA-core
// kernel's (tests/test_torch_f32_split.py; train/dw_gemm.py on the card).
// Both operands are row-major with k outermost (MN-major in the product),
// which wgmma takes for 16-bit types only, so the pieces are MN-major: a
// block of 512 threads owns a 128 x 128 tile; the TMA lands 16 x 128
// float32 slabs of A and of B in a ring of four; two warpgroups split
// them into their pieces in a second ring (128-byte swizzled atoms, each
// thread four float4s a slab, 8-byte stores on distinct banks); two
// warpgroups of 64 rows each run the six m64n128k16 products a slab from
// shared memory; mbarriers order the rings, so the three stages overlap.
// What bounds it is the block's shared memory, which the TMA's writes, the
// split's reads and stores and the products' operand reads share (128 KB
// a slab); it reaches 75-82 TFLOP/s at K = 12,800 (the CUDA-core kernel
// 37-45), and its split of K fills waves of one block an SM. The tensor
// cores take every call whose rows are 16-byte multiples at 16-byte
// aligned bases and whose SplitRows seam falls on a 16-row slab or is
// absent (the TMA's descriptors; every call of the training cells); any
// other keeps the CUDA-core kernel gemm_tn_kernel, a register-blocked
// float32 FMA GEMM: a block owns a 128 x 128 output tile, a thread 8 x 8
// outputs in registers (64 FMAs for four 16-byte shared-memory reads), a
// ring of 4 16-deep k-slabs filled by 16-byte cp.async copies, slab k+3
// landing while slab k is multiplied; the SplitRows seam is resolved once
// a copy (two copies a thread and slab), ragged edges by zero-filling
// copies. Both kernels split K into S parts (S chosen so the blocks fill
// whole waves), each part writes its partial tile to scratch and a second
// pass adds the S partials in order: the same bits every run, no float
// atomics. The column sums split the rows over blocks the same way
// (256-row chunks, 8 warps a chunk, 16-byte loads, partials added in chunk
// order). The scatter compacts each chunk's matching rows with warp
// ballots and adds them in row order. gemm_nn (the decoder backward's
// products off its recurrences: dh2_head = dlogits @ w_out^T, 5 GFLOP, and
// the cotangent layer 2 sends layer 1, dpre2x @ w_ih2^T, 20 GFLOP at T*B =
// 12,800 rows) has gemm_tn_kernel's tile, ring and register block; its A
// slab is 128 rows of 16 contiguous k, so it lands row-major (rows padded
// to 20 floats) and a thread reads its 8 rows 4 k at a time as float4s. No
// split of K: M = T*B has 100-400 row tiles.
//
// bf16 operands (mixed-precision training): gemm_tn's A (the h_prev rows,
// from the bf16 h_seq) and gemm_nn's B (a bf16 weight) may be bf16. Those
// instantiations run on the tensor cores (gemm_tn_tc_kernel,
// gemm_nn_tc_kernel; mma.sync.m16n8k16, mma_bf16.cuh): the bf16 operand
// lands in shared memory by 16-byte cp.async copies (8 bf16) and enters
// the MMAs unsplit, through ldmatrix; the float32 operand (dpre, dlogits,
// the float32 h1) lands as it does for the float path and is split into
// three bf16 pieces as it goes from shared memory into fragments, three
// MMAs a product, so each product is the float32 one to float32 rounding
// (the Pallas kernels keep that operand float32). A block owns the same
// 128 x 128 output tile with the same 16-deep k-slabs and ring, 8 warps of
// 64 x 32 (gemm_tn) or 32 x 64 (gemm_nn) outputs; the split-K plan, the
// partial tiles' ordered sum and the column sums are the float path's.
// gemm_nn_tc_kernel also takes bf16 A rows (one MMA a product) and a bias:
// the bf16 stacked GRU's backward recomputes pre_h = h_prev @ w_hh + b_hh
// with it (gemm_nn_bf16). gemm_nn's float32 instantiation is the CUDA-core
// kernel as it was.
#include <cuda.h>
#include <stdint.h>

#include "gru_tile.cuh"
#include "mma_bf16.cuh"
#include "train_ops.cuh"

namespace fader {

constexpr int kBM = 128;      // gemm_tn output tile rows (m)
constexpr int kBN = 128;      // gemm_tn output tile columns (n)
constexpr int kBK = 16;       // k-slab depth
constexpr int kStages = 4;    // slabs in the shared-memory ring
constexpr int kMaxSplits = 32;
constexpr int kMinSplitK = 256;   // least k rows worth a split of their own
constexpr size_t kGemmSmem =
    (size_t)kStages * kBK * (kBM + kBN) * sizeof(float);

// C_part[l, sp] (M, N) = sum over k in [sp*kchunk, (sp+1)*kchunk) of
// A(k, m) B[l](k, n); blockIdx.z = l * S + sp. VEC: 16-byte copies (M, N,
// the strides and the base addresses are multiples of 4 floats), else
// 4-byte copies.
template <bool VEC>
__global__ void __launch_bounds__(256, 2)
    gemm_tn_kernel(int M, int N, int K, int S, int kchunk, SplitRows a,
                   const float* __restrict__ b, long long b_ls,
                   float* __restrict__ c, long long c_ls, long long c_ss) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);     // [stage][kBK][kBM]
  float* Bs = As + kStages * kBK * kBM;            // [stage][kBK][kBN]
  const int l = blockIdx.z / S, sp = blockIdx.z % S;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int kbeg = sp * kchunk;
  const int kend = min(K, kbeg + kchunk);
  const int nslab = kend > kbeg ? (kend - kbeg + kBK - 1) / kBK : 0;
  const float* bl = b + l * b_ls;
  const float* a0l = a.a0 + l * a.a0_ls;
  const float* a1l = a.a1 + l * a.a1_ls;

  constexpr int W = VEC ? 4 : 1;              // floats a copy
  constexpr int kPerRow = kBM / W;            // copies a k-row (kBM == kBN)
  constexpr int kCopies = kBK * kPerRow / 256;
  auto a_row = [&](int k) {
    return (k < a.n0) ? a0l + (long long)k * a.lda
                      : a1l + (long long)(k - a.n0) * a.lda;
  };
  auto fill_slab = [&](int sl) {
    float* as = As + (sl % kStages) * kBK * kBM;
    float* bs = Bs + (sl % kStages) * kBK * kBN;
    const int k0 = kbeg + sl * kBK;
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int idx = tid + i * 256;
      const int kk = idx / kPerRow, col = (idx % kPerRow) * W;
      const int k = k0 + kk;
      const bool a_ok = k < kend && m0 + col < M;
      cp_async<4 * W>(as + kk * kBM + col, a_ok ? a_row(k) + m0 + col : bl,
                      a_ok ? 4 * W : 0);
      const bool b_ok = k < kend && n0 + col < N;
      cp_async<4 * W>(bs + kk * kBN + col,
                      b_ok ? bl + (long long)k * N + n0 + col : bl,
                      b_ok ? 4 * W : 0);
    }
  };

  float acc[8][8] = {};
#pragma unroll
  for (int sl = 0; sl < kStages - 1; ++sl) {
    if (sl < nslab) fill_slab(sl);
    cp_async_commit();
  }
  for (int sl = 0; sl < nslab; ++sl) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // the stage refilled here was read in iteration sl - 1, which every
    // thread has left
    if (sl + kStages - 1 < nslab) fill_slab(sl + kStages - 1);
    cp_async_commit();
    const float* as = As + (sl % kStages) * kBK * kBM + ty * 4;
    const float* bs = Bs + (sl % kStages) * kBK * kBN + tx * 4;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a_lo = *reinterpret_cast<const float4*>(as + kk * kBM);
      const float4 a_hi = *reinterpret_cast<const float4*>(as + kk * kBM + 64);
      const float4 b_lo = *reinterpret_cast<const float4*>(bs + kk * kBN);
      const float4 b_hi = *reinterpret_cast<const float4*>(bs + kk * kBN + 64);
      const float ar[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                           a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float br[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w,
                           b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // thread (ty, tx) holds rows m0 + {0, 64} + ty*4 + 0..3 and columns
  // n0 + {0, 64} + tx*4 + 0..3
  float* cl = c + l * c_ls + sp * c_ss;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i / 4) * 64 + ty * 4 + (i % 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j / 4) * 64 + tx * 4 + (j % 4);
      if (n < N) cl[(long long)m * N + n] = acc[i][j];
    }
  }
}

// gemm_tn_kernel on the tensor cores (see the header). Four warpgroups:
// 0 and 1 split, 2 and 3 multiply (setmaxnreg moves registers from the
// first two to the others). The TMA lands the float32 slabs (16 k x 128
// columns of A, from the tensor map of a0 or of a1, and of B) in a ring of
// kWgStages, issued by thread 0 and counted by tfull[s]; splitting thread
// t takes the float4s (k = t / 32 + 8 j, four columns from 4 (t % 32)), j
// < 2, of A's and of B's slab, splits them and stores the pieces into a
// ring of kWgBufs split slabs: the hi, mid and lo pieces of A, then of B,
// a piece kWgPiece bytes, 128 rows of 16 k as MN-major 128-byte-swizzled
// atoms (wgmma_desc_sw128; piece_offset). full[i] counts the splitting
// threads' arrivals at split slab i, empty[i] the eight multiplying warps'
// releases of it. Multiplying warpgroup w owns rows 64 w .. +64 of the
// 128 x 128 tile: six m64n128k16 products a slab, lowest order first,
// into a step accumulator that every kWgPromote slabs (and at the end) is
// waited for and added into the float32 sum `acc`.
constexpr int kWgStages = 4;      // float32 slabs in flight
constexpr int kWgBufs = 4;        // split slabs
constexpr int kWgRows = 64;       // output rows of a multiplying warpgroup
constexpr int kWgSplit = 256;     // splitting threads: two warpgroups
constexpr int kWgThreads = 512;   // and two multiplying ones
constexpr int kWgSplitRegs = 56;  // registers of a splitting thread
constexpr int kWgMulRegs = 200;   // of a multiplying one
constexpr int kWgPromote = 4;     // slabs a step accumulator sums
constexpr int kWgPiece = kBM * kBK * 2;
constexpr int kWgSlab = kBK * kBM * 4;   // bytes of a float32 slab
constexpr size_t kWgRingBytes =
    (size_t)kWgBufs * 6 * kWgPiece + (size_t)kWgStages * 2 * kWgSlab;
// the rings start at the first 1024-byte boundary of the block's memory
constexpr size_t kGemmWgSmem =
    1024 + kWgRingBytes + (2 * kWgBufs + kWgStages) * sizeof(uint64_t);

// Byte of (row r, k) in a piece: 128-byte-swizzled atoms of 8 k x 64
// rows, two along the rows 1024 bytes apart (LBO), two along k 2048 bytes
// apart (SBO).
__device__ __forceinline__ int piece_offset(int r, int k) {
  return (k >> 3) * 2048 + (r >> 6) * 1024 + (k & 7) * 128 +
         ((((r >> 3) & 7) ^ (k & 7)) << 4) + (r & 7) * 2;
}

// The TMA descriptors of a gemm_tn_wg call: a0 (M, n0, L), a1 (M, K - n0,
// L) and B (N, K, L), float32, boxes of 128 x 16 x 1 (a0 or a1 stands in
// for the other where all rows lie in one).
struct WgMaps {
  CUtensorMap a0, a1, b;
};

__global__ void __launch_bounds__(kWgThreads, 1)
    gemm_tn_wg_kernel(const __grid_constant__ WgMaps maps, int M, int N,
                      int K, int n0, int S, int kchunk,
                      float* __restrict__ c, long long c_ls,
                      long long c_ss) {
  extern __shared__ float4 smem4[];
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem4);
  uint8_t* P =
      reinterpret_cast<uint8_t*>(smem4) + ((1024 - (base & 1023)) & 1023);
  uint8_t* F = P + kWgBufs * 6 * kWgPiece;    // [stage][A, B][16][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(P + kWgRingBytes);
  uint64_t* empty = full + kWgBufs;
  uint64_t* tfull = empty + kWgBufs;
  const int l = blockIdx.z / S, sp = blockIdx.z % S;
  const int m0 = blockIdx.y * kBM, n0c = blockIdx.x * kBN;
  // the warpgroup through a shuffle: warp-uniform to the compiler, so
  // that the wgmma below sit on no divergent path
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int kbeg = sp * kchunk;
  const int kend = min(K, kbeg + kchunk);
  const int nslab = kend > kbeg ? (kend - kbeg + kBK - 1) / kBK : 0;
  if (tid == 0) {
    for (int i = 0; i < kWgBufs; ++i) {
      mbar_init(full + i, kWgSplit);
      mbar_init(empty + i, 8);
    }
    for (int i = 0; i < kWgStages; ++i) mbar_init(tfull + i, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg < kWgSplit / 128) {
    // ---- split
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWgSplitRegs)
                 : "memory");
    auto fetch = [&](int sl) {   // thread 0: slab sl into its stage
      if (sl >= nslab) return;
      const int st = sl % kWgStages, k = kbeg + sl * kBK;
      uint8_t* f = F + st * 2 * kWgSlab;
      mbar_expect_tx(tfull + st, 2 * kWgSlab);
      if (k < n0)
        tma_load_3d(f, &maps.a0, m0, k, l, tfull + st);
      else
        tma_load_3d(f, &maps.a1, m0, k - n0, l, tfull + st);
      tma_load_3d(f + kWgSlab, &maps.b, n0c, k, l, tfull + st);
    };
    if (tid == 0)
      for (int sl = 0; sl < kWgStages; ++sl) fetch(sl);
    // thread tid: float4s (k = tid / 32 + 8 j, columns 4 (tid % 32) ..)
    const int c4 = (tid & 31) * 4, kr = tid >> 5;
    for (int sl = 0; sl < nslab; ++sl) {
      const int st = sl % kWgStages, i = sl % kWgBufs;
      mbar_wait(tfull + st, (sl / kWgStages) & 1);
      mbar_wait(empty + i, ((sl / kWgBufs) & 1) ^ 1);
      const float* x = reinterpret_cast<const float*>(F + st * 2 * kWgSlab) +
                       kr * kBM + c4;
      uint8_t* buf = P + i * 6 * kWgPiece;
#pragma unroll
      for (int op = 0; op < 2; ++op)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(
              x + (op * kBK + 8 * j) * kBM);
          uint2 hi, mid, lo;
          split3(v.x, v.y, hi.x, mid.x, lo.x);
          split3(v.z, v.w, hi.y, mid.y, lo.y);
          uint8_t* d = buf + 3 * op * kWgPiece + piece_offset(c4, kr + 8 * j);
          *reinterpret_cast<uint2*>(d) = hi;
          *reinterpret_cast<uint2*>(d + kWgPiece) = mid;
          *reinterpret_cast<uint2*>(d + 2 * kWgPiece) = lo;
        }
      fence_proxy_async();
      mbar_arrive(full + i);
      // every splitting thread has read stage st: refill it
      asm volatile("bar.sync 1, %0;\n" ::"n"(kWgSplit) : "memory");
      if (tid == 0) fetch(sl + kWgStages);
    }
    return;
  }

  // ---- multiply: warpgroup wg owns rows 64 (wg - 2) .. +64
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWgMulRegs)
               : "memory");
  const int w0 = wg - kWgSplit / 128;
  const uint64_t desc0 = wgmma_desc_sw128(P, 1024, 2048);
  float acc[64], tmp[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const bool lead = (tid & 31) == 0;   // releases for its warp
  // groups of kWgPromote slabs: each slab's products go into tmp (the
  // group's first product overwrites it), a slab's split slab is released
  // once the next slab's products are issued and its own have completed,
  // and the group's sum is added into acc after a full wait
  for (int s0 = 0; s0 < nslab; s0 += kWgPromote) {
    const int n = min(kWgPromote, nslab - s0);
#pragma unroll
    for (int j = 0; j < kWgPromote; ++j) {
      if (j < n) {
        const int sl = s0 + j, i = sl % kWgBufs;
        mbar_wait(full + i, (sl / kWgBufs) & 1);
        // descriptors of piece 0 of A (this warpgroup's 64 rows: one atom
        // along M) and of B; piece p is p * kWgPiece bytes on
        const uint64_t da = desc0 + ((i * 6 * kWgPiece + w0 * 1024) >> 4);
        const uint64_t db = desc0 + ((i * 6 + 3) * kWgPiece >> 4);
        constexpr uint64_t kP = kWgPiece >> 4;
        wgmma_fence();
        // mid.mid, hi.lo, lo.hi, hi.mid, mid.hi, hi.hi (pieces 0 hi, 1
        // mid, 2 lo)
        wgmma_m64n128k16(tmp, da + kP, db + kP, j > 0);
        wgmma_m64n128k16(tmp, da, db + 2 * kP, 1);
        wgmma_m64n128k16(tmp, da + 2 * kP, db, 1);
        wgmma_m64n128k16(tmp, da, db + kP, 1);
        wgmma_m64n128k16(tmp, da + kP, db, 1);
        wgmma_m64n128k16(tmp, da, db, 1);
        wgmma_commit();
        if (j > 0) {
          wgmma_wait<1>();
          mbar_arrive(empty + (sl - 1) % kWgBufs, lead);
        }
      }
    }
    wgmma_wait<0>();
    mbar_arrive(empty + (s0 + n - 1) % kWgBufs, lead);
    pin_regs(tmp);
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] += tmp[j];
  }

  // lane 32 w + 4 g + q of the warpgroup: rows m0 + 64 w0 + 16 w + g +
  // 8 h, columns n0 + 8 j + 2 q + e hold acc[4 j + 2 h + e]
  const int lane = tid & 31, w = (tid >> 5) & 3;
  const int g = lane >> 2, q = lane & 3;
  float* cl = c + l * c_ls + sp * c_ss;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + w0 * kWgRows + 16 * w + g + 8 * h;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0c + 8 * j + 2 * q + e;
        if (n < N) cl[(long long)m * N + n] = acc[4 * j + 2 * h + e];
      }
  }
}

// gemm_tn_kernel with a bf16 A on the tensor cores (see the header). Slabs:
// A [kBK][kTcAPad] bf16 (k-major, as stored: ldmatrix.trans gives the
// row-major fragments; 272-byte rows keep its 8 rows on distinct banks), B
// [kBK][kTcBPad] floats (132-float rows: a lane's four scalar reads, k =
// 2q.., column g, fall on distinct banks). Warp w owns rows (w / 4) * 64
// .. +64 and columns (w % 4) * 32 .. +32 of the tile: 4 x 4 MMA tiles, a B
// fragment split once a slab and used by the 4 row tiles. VEC: 16-byte
// copies (M, lda and the A strides multiples of 8 bf16; N, b_ls multiples
// of 4 floats; 16-byte aligned bases), else element loads of A and 4-byte
// copies of B.
constexpr int kTcAPad = kBM + 8;
constexpr int kTcBPad = kBN + 4;
constexpr size_t kGemmTcSmem =
    (size_t)kStages * kBK * (kTcAPad * sizeof(bf16) + kTcBPad * sizeof(float));

template <bool VEC>
__global__ void __launch_bounds__(256, 2)
    gemm_tn_tc_kernel(int M, int N, int K, int S, int kchunk,
                      SplitRowsT<bf16> a, const float* __restrict__ b,
                      long long b_ls, float* __restrict__ c, long long c_ls,
                      long long c_ss) {
  extern __shared__ float4 smem4[];
  bf16* As = reinterpret_cast<bf16*>(smem4);       // [stage][kBK][kTcAPad]
  float* Bs = reinterpret_cast<float*>(As + kStages * kBK * kTcAPad);
  const int l = blockIdx.z / S, sp = blockIdx.z % S;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int kbeg = sp * kchunk;
  const int kend = min(K, kbeg + kchunk);
  const int nslab = kend > kbeg ? (kend - kbeg + kBK - 1) / kBK : 0;
  const float* bl = b + l * b_ls;
  const bf16* a0l = a.a0 + l * a.a0_ls;
  const bf16* a1l = a.a1 + l * a.a1_ls;
  auto a_row = [&](int k) {
    return (k < a.n0) ? a0l + (long long)k * a.lda
                      : a1l + (long long)(k - a.n0) * a.lda;
  };
  auto fill_slab = [&](int sl) {
    bf16* as = As + (sl % kStages) * kBK * kTcAPad;
    float* bs = Bs + (sl % kStages) * kBK * kTcBPad;
    const int k0 = kbeg + sl * kBK;
    if constexpr (VEC) {
      {   // A: 16 copies of 8 bf16 a k-row, one a thread
        const int kk = tid / 16, col = (tid % 16) * 8, k = k0 + kk;
        const bool ok = k < kend && m0 + col < M;
        cp_async<16>(as + kk * kTcAPad + col, ok ? a_row(k) + m0 + col : a0l,
                     ok ? 16 : 0);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {   // B: 32 copies of 4 floats a k-row
        const int idx = tid + i * 256;
        const int kk = idx / 32, col = (idx % 32) * 4, k = k0 + kk;
        const bool ok = k < kend && n0 + col < N;
        cp_async<16>(bs + kk * kTcBPad + col,
                     ok ? bl + (long long)k * N + n0 + col : bl, ok ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBK * kBM / 256; ++i) {
        const int idx = tid + i * 256;
        const int kk = idx / kBM, col = idx % kBM, k = k0 + kk;
        const bool a_ok = k < kend && m0 + col < M;
        as[kk * kTcAPad + col] =
            a_ok ? a_row(k)[m0 + col] : __float2bfloat16_rn(0.f);
        const bool b_ok = k < kend && n0 + col < N;
        cp_async<4>(bs + kk * kTcBPad + col,
                    b_ok ? bl + (long long)k * N + n0 + col : bl,
                    b_ok ? 4 : 0);
      }
    }
  };

  float acc[4][4][4] = {};
#pragma unroll
  for (int sl = 0; sl < kStages - 1; ++sl) {
    if (sl < nslab) fill_slab(sl);
    cp_async_commit();
  }
  // lane's ldmatrix row: k (lane / 16) * 8 + lane % 8, rows + ((lane / 8)
  // % 2) * 8 of the warp's 16-row tile
  const int a_off = ((lane >> 4) * 8 + (lane & 7)) * kTcAPad + wm +
                    ((lane >> 3) & 1) * 8;
  for (int sl = 0; sl < nslab; ++sl) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (sl + kStages - 1 < nslab) fill_slab(sl + kStages - 1);
    cp_async_commit();
    const bf16* as = As + (sl % kStages) * kBK * kTcAPad + a_off;
    const float* bs = Bs + (sl % kStages) * kBK * kTcBPad + wn + g;
    uint32_t bh[4][2], bm[4][2], bo[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* p = bs + (2 * q + 8 * h) * kTcBPad + 8 * j;
        split3(p[0], p[kTcBPad], bh[j][h], bm[j][h], bo[j][h]);
      }
    uint32_t af[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ldsm_x4_trans(af[i], as + 16 * i);
    // piece-major: 16 independent MMAs between two into one accumulator
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bo[j][0], bo[j][1]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bm[j][0], bm[j][1]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bh[j][0], bh[j][1]);
  }
  cp_async_wait<0>();

  float* cl = c + l * c_ls + sp * c_ss;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + 8 * j + 2 * q;
        if (n < N) cl[(long long)m * N + n] = acc[i][j][2 * h];
        if (n + 1 < N) cl[(long long)m * N + n + 1] = acc[i][j][2 * h + 1];
      }
    }
}

// c[l, i] = part[l, 0, i] + part[l, 1, i] + ... + part[l, S-1, i], i < n.
__global__ void __launch_bounds__(256)
    splitk_sum_kernel(long long n, int S, const float* __restrict__ part,
                      float* __restrict__ c, long long c_ls) {
  const int l = blockIdx.y;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  const float* pl = part + (long long)l * S * n + i;
  float s = pl[0];
  for (int sp = 1; sp < S; ++sp) s += pl[sp * n];
  c[l * c_ls + i] = s;
}

constexpr int kAPad = kBK + 4;   // floats a row of gemm_nn's A slab
constexpr size_t kGemmNNSmem =
    (size_t)kStages * (kBM * kAPad + kBK * kBN) * sizeof(float);

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// C (M, N) = A (M, K) @ B (K, N), and + add[m, :] on rows m < add_rows; all
// row-major and contiguous. VEC: 16-byte copies and stores (K, N and the
// base addresses are multiples of 4 floats), else 4-byte ones.
template <bool VEC>
__global__ void __launch_bounds__(256, 2)
    gemm_nn_kernel(int M, int N, int K, const float* __restrict__ a,
                   const float* __restrict__ b, float* __restrict__ c,
                   const float* __restrict__ add, int add_rows) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);     // [stage][kBM][kAPad]
  float* Bs = As + kStages * kBM * kAPad;          // [stage][kBK][kBN]
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int nslab = (K + kBK - 1) / kBK;

  constexpr int W = VEC ? 4 : 1;              // floats a copy
  constexpr int kACopies = kBM * kBK / W / 256;
  constexpr int kBCopies = kBK * kBN / W / 256;
  auto fill_slab = [&](int sl) {
    float* as = As + (sl % kStages) * kBM * kAPad;
    float* bs = Bs + (sl % kStages) * kBK * kBN;
    const int k0 = sl * kBK;
#pragma unroll
    for (int i = 0; i < kACopies; ++i) {
      const int idx = tid + i * 256;
      const int row = idx / (kBK / W), kc = (idx % (kBK / W)) * W;
      const bool ok = m0 + row < M && k0 + kc < K;
      cp_async<4 * W>(as + row * kAPad + kc,
                      ok ? a + (long long)(m0 + row) * K + k0 + kc : a,
                      ok ? 4 * W : 0);
    }
#pragma unroll
    for (int i = 0; i < kBCopies; ++i) {
      const int idx = tid + i * 256;
      const int kk = idx / (kBN / W), col = (idx % (kBN / W)) * W;
      const bool ok = k0 + kk < K && n0 + col < N;
      cp_async<4 * W>(bs + kk * kBN + col,
                      ok ? b + (long long)(k0 + kk) * N + n0 + col : b,
                      ok ? 4 * W : 0);
    }
  };

  float acc[8][8] = {};
#pragma unroll
  for (int sl = 0; sl < kStages - 1; ++sl) {
    if (sl < nslab) fill_slab(sl);
    cp_async_commit();
  }
  // thread (ty, tx) holds rows m0 + {0, 64} + ty*4 + 0..3 and columns
  // n0 + {0, 64} + tx*4 + 0..3
  for (int sl = 0; sl < nslab; ++sl) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (sl + kStages - 1 < nslab) fill_slab(sl + kStages - 1);
    cp_async_commit();
    const float* as = As + (sl % kStages) * kBM * kAPad + ty * 4 * kAPad;
    const float* bs = Bs + (sl % kStages) * kBK * kBN + tx * 4;
#pragma unroll
    for (int k4 = 0; k4 < kBK; k4 += 4) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const float4*>(
            as + ((i / 4) * 64 + (i % 4)) * kAPad + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b_lo =
            *reinterpret_cast<const float4*>(bs + (k4 + kk) * kBN);
        const float4 b_hi =
            *reinterpret_cast<const float4*>(bs + (k4 + kk) * kBN + 64);
        const float br[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w,
                             b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float ai = lane_of(av[i], kk);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ai, br[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i / 4) * 64 + ty * 4 + (i % 4);
    if (m >= M) continue;
    const bool plus = m < add_rows;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      const long long at = (long long)m * N + n;
      if constexpr (VEC) {
        if (n >= N) continue;
        float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                               acc[i][4 * h + 2], acc[i][4 * h + 3]);
        if (plus) {
          const float4 e = *reinterpret_cast<const float4*>(add + at);
          v = make_float4(v.x + e.x, v.y + e.y, v.z + e.z, v.w + e.w);
        }
        *reinterpret_cast<float4*>(c + at) = v;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N)
            c[at + j] = plus ? acc[i][4 * h + j] + add[at + j]
                             : acc[i][4 * h + j];
      }
    }
  }
}

// C[l] (M, N) = A[l] (M, K) @ B[l] (K, N) with a bf16 B on the tensor cores
// (see the header), + add[m, :] on rows m < add_rows, + bias[l] (N) when
// bias is not null. A's rows are a SplitRows of AT: float32 A is split into
// three pieces (three MMAs a product), bf16 A enters unsplit (one). Slabs:
// A [kBM][kTcRowPad] (row-major, as stored: float2 reads for a float32
// fragment, ldmatrix for a bf16 one; 24-element rows keep both free of
// bank conflicts), B [kBK][kTcAPad] bf16 (ldmatrix.trans). Warp w owns rows
// (w / 2) * 32 .. +32 and columns (w % 2) * 64 .. +64 of the tile: 2 x 8
// MMA tiles, an A fragment split once a slab and used by the 8 column
// tiles. VEC: 16-byte copies (K, lda and the A strides multiples of 16
// bytes' elements; N, b_ls multiples of 8; 16-byte aligned bases), else
// 4-byte copies of a float32 A and element loads of the rest.
constexpr int kTcRowPad = kBK + 8;

template <typename AT>
constexpr size_t gemm_nn_tc_smem() {
  return (size_t)kStages *
         (kBM * kTcRowPad * sizeof(AT) + kBK * kTcAPad * sizeof(bf16));
}

template <bool VEC, typename AT>
__global__ void __launch_bounds__(256, 2)
    gemm_nn_tc_kernel(int M, int N, int K, SplitRowsT<AT> a,
                      const bf16* __restrict__ b, long long b_ls,
                      float* __restrict__ c, long long c_ls,
                      const float* __restrict__ add, int add_rows,
                      const bf16* __restrict__ bias, long long bias_ls) {
  extern __shared__ float4 smem4[];
  AT* As = reinterpret_cast<AT*>(smem4);           // [stage][kBM][kTcRowPad]
  bf16* Bs = reinterpret_cast<bf16*>(As + kStages * kBM * kTcRowPad);
  const int l = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  const int nslab = (K + kBK - 1) / kBK;
  const AT* a0l = a.a0 + l * a.a0_ls;
  const AT* a1l = a.a1 + l * a.a1_ls;
  const bf16* bl = b + l * b_ls;
  auto a_row = [&](int m) {
    return (m < a.n0) ? a0l + (long long)m * a.lda
                      : a1l + (long long)(m - a.n0) * a.lda;
  };
  auto fill_slab = [&](int sl) {
    AT* as = As + (sl % kStages) * kBM * kTcRowPad;
    bf16* bs = Bs + (sl % kStages) * kBK * kTcAPad;
    const int k0 = sl * kBK;
    if constexpr (VEC) {
      constexpr int WA = 16 / sizeof(AT);       // A elements a copy
      constexpr int kPer = kBK / WA;            // copies an A row
#pragma unroll
      for (int i = 0; i < kBM * kPer / 256; ++i) {
        const int idx = tid + i * 256;
        const int row = idx / kPer, kc = (idx % kPer) * WA;
        const bool ok = m0 + row < M && k0 + kc < K;
        cp_async<16>(as + row * kTcRowPad + kc,
                     ok ? a_row(m0 + row) + k0 + kc : a0l, ok ? 16 : 0);
      }
      {   // B: 16 copies of 8 bf16 a k-row, one a thread
        const int kk = tid / 16, col = (tid % 16) * 8;
        const bool ok = k0 + kk < K && n0 + col < N;
        cp_async<16>(bs + kk * kTcAPad + col,
                     ok ? bl + (long long)(k0 + kk) * N + n0 + col : bl,
                     ok ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBM * kBK / 256; ++i) {
        const int idx = tid + i * 256;
        const int row = idx / kBK, k = idx % kBK;
        const bool ok = m0 + row < M && k0 + k < K;
        if constexpr (is_f32<AT>)
          cp_async<4>(as + row * kTcRowPad + k,
                      ok ? a_row(m0 + row) + k0 + k : a0l, ok ? 4 : 0);
        else
          as[row * kTcRowPad + k] =
              ok ? a_row(m0 + row)[k0 + k] : __float2bfloat16_rn(0.f);
        const int kk = idx / kBN, col = idx % kBN;
        const bool b_ok = k0 + kk < K && n0 + col < N;
        bs[kk * kTcAPad + col] = b_ok ? bl[(long long)(k0 + kk) * N + n0 + col]
                                      : __float2bfloat16_rn(0.f);
      }
    }
  };

  float acc[2][8][4] = {};
#pragma unroll
  for (int sl = 0; sl < kStages - 1; ++sl) {
    if (sl < nslab) fill_slab(sl);
    cp_async_commit();
  }
  // lane's ldmatrix.trans row of B: k (lane % 8) + ((lane / 8) % 2) * 8,
  // columns + (lane / 16) * 8 (two 8-column tiles a call)
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * kTcAPad + wn +
                    (lane >> 4) * 8;
  for (int sl = 0; sl < nslab; ++sl) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (sl + kStages - 1 < nslab) fill_slab(sl + kStages - 1);
    cp_async_commit();
    const AT* as = As + (sl % kStages) * kBM * kTcRowPad;
    const bf16* bs = Bs + (sl % kStages) * kBK * kTcAPad + b_off;
    if constexpr (is_f32<AT>) {
      uint32_t ah[2][4], am[2][4], al[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* p = as + (wm + 16 * i + g) * kTcRowPad + 2 * q;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 v = *reinterpret_cast<const float2*>(
              p + (r & 1) * 8 * kTcRowPad + (r >> 1) * 8);
          split3(v.x, v.y, ah[i][r], am[i][r], al[i][r]);
        }
      }
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, bs + 16 * jp);
        // piece-major: 4 independent MMAs between two into one accumulator
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * jp], al[i], bf[0], bf[1]);
          mma_bf16(acc[i][2 * jp + 1], al[i], bf[2], bf[3]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * jp], am[i], bf[0], bf[1]);
          mma_bf16(acc[i][2 * jp + 1], am[i], bf[2], bf[3]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * jp], ah[i], bf[0], bf[1]);
          mma_bf16(acc[i][2 * jp + 1], ah[i], bf[2], bf[3]);
        }
      }
    } else {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(af[i], as + (wm + 16 * i + (lane & 15)) * kTcRowPad +
                           (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, bs + 16 * jp);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * jp], af[i], bf[0], bf[1]);
          mma_bf16(acc[i][2 * jp + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  float* cl = c + l * c_ls;
  const bf16* bsl = bias == nullptr ? nullptr : bias + l * bias_ls;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + g + 8 * h;
      if (m >= M) continue;
      const bool plus = m < add_rows;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + 8 * j + 2 * q + e;
          if (n >= N) continue;
          const long long at = (long long)m * N + n;
          float v = acc[i][j][2 * h + e];
          if (plus) v += add[at];
          if (bsl != nullptr) v += to_f32(bsl[n]);
          cl[at] = v;
        }
    }
}

__global__ void __launch_bounds__(256)
    segment_rows_kernel(int R, int N, int V, const int* __restrict__ ids,
                        const float* __restrict__ x,
                        float* __restrict__ out) {
  __shared__ int list[256];
  __shared__ int wcount[8];
  const int l = blockIdx.z, v = blockIdx.y;
  const int c = blockIdx.x * 256 + threadIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* il = ids + (long long)l * R;
  const float* xl = x + (long long)l * R * N;
  float acc = 0.f;
  for (int r0 = 0; r0 < R; r0 += 256) {
    const int r = r0 + threadIdx.x;
    const bool match = r < R && il[r] == v;
    const unsigned ballot = __ballot_sync(0xffffffffu, match);
    if (lane == 0) wcount[warp] = __popc(ballot);
    __syncthreads();
    int base = 0, total = 0;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      base += (w < warp) ? wcount[w] : 0;
      total += wcount[w];
    }
    if (match) list[base + __popc(ballot & ((1u << lane) - 1u))] = r;
    __syncthreads();
    if (c < N)
      for (int i = 0; i < total; ++i)
        acc += xl[(long long)list[i] * N + c];
    __syncthreads();
  }
  if (c < N) out[((long long)l * V + v) * N + c] = acc;
}

constexpr int kSumRows = 256;   // rows a column-sum block walks

// part[l, chunk, :] = sum over the chunk's rows of x[l, r, :]. A block owns
// 32 * W columns of one 256-row chunk; warp w takes rows w, w + 8, ... and
// the 8 warps' sums are added in warp order. W = 4: 16-byte loads.
template <int W>
__global__ void __launch_bounds__(256)
    colsum_part_kernel(int R, int N, const float* __restrict__ x,
                       float* __restrict__ part) {
  __shared__ float sums[8][32 * W + 1];
  const int l = blockIdx.z, chunk = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = (blockIdx.x * 32 + lane) * W;
  const int r1 = min(R, (chunk + 1) * kSumRows);
  const float* xl = x + (long long)l * R * N + c;
  float s[2][W] = {};
  if (c < N) {
    int r = chunk * kSumRows + warp;
    for (; r + 8 < r1; r += 16) {
      if constexpr (W == 4) {
        const float4 u =
            *reinterpret_cast<const float4*>(xl + (long long)r * N);
        const float4 v =
            *reinterpret_cast<const float4*>(xl + (long long)(r + 8) * N);
        s[0][0] += u.x;
        s[0][1] += u.y;
        s[0][2] += u.z;
        s[0][3] += u.w;
        s[1][0] += v.x;
        s[1][1] += v.y;
        s[1][2] += v.z;
        s[1][3] += v.w;
      } else {
        s[0][0] += xl[(long long)r * N];
        s[1][0] += xl[(long long)(r + 8) * N];
      }
    }
    if (r < r1) {
#pragma unroll
      for (int i = 0; i < W; ++i) s[0][i] += xl[(long long)r * N + i];
    }
  }
#pragma unroll
  for (int i = 0; i < W; ++i) sums[warp][lane * W + i] = s[0][i] + s[1][i];
  __syncthreads();
  const int nchunk = gridDim.y;
  for (int i = threadIdx.x; i < 32 * W; i += 256) {
    const int col = blockIdx.x * 32 * W + i;
    if (col >= N) continue;
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) t += sums[w][i];
    part[((long long)l * nchunk + chunk) * N + col] = t;
  }
}

// out[l, c] = part[l, 0, c] + part[l, 1, c] + ... in chunk order.
__global__ void __launch_bounds__(256)
    colsum_final_kernel(int nchunk, int N, const float* __restrict__ part,
                        float* __restrict__ out) {
  const int l = blockIdx.y;
  const int c = blockIdx.x * 256 + threadIdx.x;
  if (c >= N) return;
  const float* pl = part + (long long)l * nchunk * N + c;
  float s = pl[0];
  for (int k = 1; k < nchunk; ++k) s += pl[(long long)k * N];
  out[(long long)l * N + c] = s;
}

__global__ void __launch_bounds__(256)
    sum_over_t_kernel(int T, int n, const float* __restrict__ x,
                      float* __restrict__ out) {
  const int l = blockIdx.y;
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  const float* xl = x + (long long)l * T * n + i;
  float s = 0.f;
  for (int t = 0; t < T; ++t) s += xl[(long long)t * n];
  out[(long long)l * n + i] = s;
}

namespace {

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      n < 1)
    return 1;
  return n;
}

// The split of K for a gemm_tn kernel that holds `per_sm` blocks an SM:
// the least S whose L * tiles * S blocks fill at least nine tenths of whole
// waves, or the S that fills them best; a split has at least kMinSplitK
// rows of k.
struct GemmPlan {
  int S, kchunk;
};

GemmPlan gemm_plan(int L, int M, int N, int K, int per_sm) {
  const long long tiles =
      (long long)L * ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  const long long slots = (long long)per_sm * sm_count();
  const int max_s = max(1, min(kMaxSplits, K / kMinSplitK));
  int best = 1;
  double best_fill = 0.0;
  for (int S = 1; S <= max_s; ++S) {
    const long long blocks = tiles * S;
    const long long waves = (blocks + slots - 1) / slots;
    const double fill = (double)blocks / (double)(waves * slots);
    if (fill > best_fill) {
      best = S;
      best_fill = fill;
    }
    if (fill >= 0.9) break;
  }
  const int per = (K + best - 1) / best;
  return {best, (per + kBK - 1) / kBK * kBK};
}

int colsum_chunks(int R) { return (R + kSumRows - 1) / kSumRows; }

// Which kernel a float32 gemm_tn runs: kTnRule, the fixed rule (the
// tensor cores wherever gemm_tn_wg takes the call); kTnFma, the CUDA-core
// kernel; kTnWg, the tensor cores (an error where they cannot take the
// call).
enum TnRoute { kTnRule = 0, kTnFma = 1, kTnWg = 2 };

// Launches kernel (two blocks an SM, `smem` bytes each) over gemm_tn's
// grid with the split of K, then the ordered sum of the partial tiles.
template <typename AT>
cudaError_t launch_tn(void (*kernel)(int, int, int, int, int, SplitRowsT<AT>,
                                     const float*, long long, float*,
                                     long long, long long),
                      size_t smem, int L, int M, int N, int K,
                      SplitRowsT<AT> a, const float* b, long long b_ls,
                      float* c, long long c_ls, float* scratch,
                      cudaStream_t s) {
  const GemmPlan p = gemm_plan(L, M, N, K, 2);
  if (p.S > 1 && scratch == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long mn = (long long)M * N;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, L * p.S);
  if (p.S == 1) {
    kernel<<<grid, 256, smem, s>>>(M, N, K, 1, p.kchunk, a, b, b_ls, c, c_ls,
                                   0);
    return cudaGetLastError();
  }
  kernel<<<grid, 256, smem, s>>>(M, N, K, p.S, p.kchunk, a, b, b_ls, scratch,
                                 p.S * mn, mn);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid_sum((unsigned)((mn + 255) / 256), L);
  splitk_sum_kernel<<<grid_sum, 256, 0, s>>>(mn, p.S, scratch, c, c_ls);
  return cudaGetLastError();
}

template <typename AT>
bool tn_vec(int M, int N, const SplitRowsT<AT>& a, const float* b,
            long long b_ls) {
  constexpr int av = is_f32<AT> ? 4 : 8;     // A elements a 16-byte copy
  return M % av == 0 && N % 4 == 0 && a.lda % av == 0 && a.a0_ls % av == 0 &&
         a.a1_ls % av == 0 && b_ls % 4 == 0 && aligned16(a.a0) &&
         aligned16(a.a1) && aligned16(b);
}

// cuTensorMapEncodeTiled, looked up in libcuda at first use (the library
// links only the CUDA runtime).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The map of L layers of `rows` rows of `cols` float32 at base (row stride
// ld, layer stride ls floats), boxes of 128 columns x 16 rows x 1 layer;
// false where the TMA cannot describe it.
bool tile_map(CUtensorMap* m, const float* base, int cols, int rows, int L,
              long long ld, long long ls) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr || rows < 1) return false;
  const cuuint64_t dim[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                             (cuuint64_t)L};
  const cuuint64_t stride[2] = {(cuuint64_t)ld * 4,
                                (cuuint64_t)(L > 1 ? ls : ld * rows) * 4};
  const cuuint32_t box[3] = {kBM, kBK, 1}, step[3] = {1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base),
             dim, stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// gemm_tn_wg_kernel over gemm_tn's grid (one block an SM) with the split
// of K, then the ordered sum of the partial tiles. It takes A and B rows
// of 16-byte multiples at 16-byte aligned bases (the TMA's strides) and a
// seam on a 16-row slab (n0 % 16 == 0, or all rows in one tensor: n0 <= 0
// or n0 >= K), and returns cudaErrorNotSupported for any other call.
cudaError_t launch_wg(int L, int M, int N, int K, const SplitRows& a,
                      const float* b, long long b_ls, float* c, long long c_ls,
                      float* scratch, cudaStream_t s) {
  WgMaps maps;
  const bool in_a0 = a.n0 > 0, in_a1 = a.n0 < K;
  if (!tn_vec(M, N, a, b, b_ls) || (in_a0 && in_a1 && a.n0 % kBK != 0) ||
      (in_a0 && !tile_map(&maps.a0, a.a0, M, min(a.n0, K), L, a.lda,
                          a.a0_ls)) ||
      (in_a1 && !tile_map(&maps.a1, a.a1, M, K - max(a.n0, 0), L, a.lda,
                          a.a1_ls)) ||
      !tile_map(&maps.b, b, N, K, L, N, b_ls))
    return cudaErrorNotSupported;
  if (!in_a0) maps.a0 = maps.a1;     // a map the kernel never reads
  if (!in_a1) maps.a1 = maps.a0;
  const GemmPlan p = gemm_plan(L, M, N, K, 1);
  if (p.S > 1 && scratch == nullptr) return cudaErrorInvalidValue;
  auto kernel = gemm_tn_wg_kernel;
  cudaError_t err = allow_smem(kernel, kGemmWgSmem);
  if (err != cudaSuccess) return err;
  const long long mn = (long long)M * N;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, L * p.S);
  float* out = p.S == 1 ? c : scratch;
  kernel<<<grid, kWgThreads, kGemmWgSmem, s>>>(
      maps, M, N, K, max(a.n0, 0), p.S, p.kchunk, out,
      p.S == 1 ? c_ls : p.S * mn, mn);
  if ((err = cudaGetLastError()) != cudaSuccess || p.S == 1) return err;
  const dim3 grid_sum((unsigned)((mn + 255) / 256), L);
  splitk_sum_kernel<<<grid_sum, 256, 0, s>>>(mn, p.S, scratch, c, c_ls);
  return cudaGetLastError();
}

cudaError_t gemm_tn_f32(int route, int L, int M, int N, int K, SplitRows a,
                        const float* b, long long b_ls, float* c,
                        long long c_ls, float* scratch, cudaStream_t s) {
  if (route == kTnRule || route == kTnWg) {
    const cudaError_t err =
        launch_wg(L, M, N, K, a, b, b_ls, c, c_ls, scratch, s);
    if (err != cudaErrorNotSupported || route == kTnWg) return err;
    route = kTnFma;
  }
  if (route != kTnFma) return cudaErrorInvalidValue;
  const bool vec = tn_vec(M, N, a, b, b_ls);
  return launch_tn(vec ? gemm_tn_kernel<true> : gemm_tn_kernel<false>,
                   kGemmSmem, L, M, N, K, a, b, b_ls, c, c_ls, scratch, s);
}

}  // namespace

long long reduce_scratch_floats(int L, int M, int N, int K) {
  long long gemm = 0;
  for (int per_sm = 1; per_sm <= 2; ++per_sm) {
    const GemmPlan p = gemm_plan(L, M, N, K, per_sm);
    if (p.S > 1) gemm = max(gemm, (long long)L * p.S * M * N);
  }
  const int nchunk = colsum_chunks(K);
  const long long sums = nchunk > 1 ? (long long)L * nchunk * N : 0;
  return max(gemm, sums);
}

template <typename AT>
cudaError_t gemm_tn(int L, int M, int N, int K, SplitRowsT<AT> a,
                    const float* b, long long b_ls, float* c, long long c_ls,
                    float* scratch, cudaStream_t s) {
  if constexpr (is_f32<AT>) {
    return gemm_tn_f32(kTnRule, L, M, N, K, a, b, b_ls, c, c_ls, scratch, s);
  } else {
    const bool vec = tn_vec(M, N, a, b, b_ls);
    return launch_tn(vec ? gemm_tn_tc_kernel<true> : gemm_tn_tc_kernel<false>,
                     kGemmTcSmem, L, M, N, K, a, b, b_ls, c, c_ls, scratch,
                     s);
  }
}

namespace {

template <typename AT>
cudaError_t gemm_nn_tc(int L, int M, int N, int K, SplitRowsT<AT> a,
                       const bf16* b, long long b_ls, float* c,
                       long long c_ls, const float* add, int add_rows,
                       const bf16* bias, long long bias_ls, cudaStream_t s) {
  constexpr int av = 16 / sizeof(AT);        // A elements a 16-byte copy
  const bool vec = K % av == 0 && a.lda % av == 0 && a.a0_ls % av == 0 &&
                   a.a1_ls % av == 0 && N % 8 == 0 && b_ls % 8 == 0 &&
                   aligned16(a.a0) && aligned16(a.a1) && aligned16(b);
  auto kernel =
      vec ? gemm_nn_tc_kernel<true, AT> : gemm_nn_tc_kernel<false, AT>;
  constexpr size_t smem = gemm_nn_tc_smem<AT>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, L);
  kernel<<<grid, 256, smem, s>>>(M, N, K, a, b, b_ls, c, c_ls, add,
                                 add == nullptr ? 0 : add_rows, bias,
                                 bias_ls);
  return cudaGetLastError();
}

}  // namespace

template <typename BT>
cudaError_t gemm_nn(int M, int N, int K, const float* a, const BT* b,
                    float* c, const float* add, int add_rows,
                    cudaStream_t s) {
  if constexpr (!is_f32<BT>) {
    return gemm_nn_tc<float>(1, M, N, K, SplitRowsT<float>{a, 0, M, a, 0, K},
                             b, 0, c, 0, add, add_rows, nullptr, 0, s);
  } else {
    const bool vec = K % 4 == 0 && N % 4 == 0 && aligned16(a) &&
                     aligned16(b) && aligned16(c) &&
                     (add == nullptr || aligned16(add));
    auto kernel = vec ? gemm_nn_kernel<true> : gemm_nn_kernel<false>;
    cudaError_t err = allow_smem(kernel, kGemmNNSmem);
    if (err != cudaSuccess) return err;
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, 1);
    kernel<<<grid, 256, kGemmNNSmem, s>>>(M, N, K, a, b, c, add,
                                          add == nullptr ? 0 : add_rows);
    return cudaGetLastError();
  }
}

cudaError_t gemm_nn_bf16(int L, int M, int N, int K, SplitRowsT<bf16> a,
                         const bf16* b, long long b_ls, const bf16* bias,
                         long long bias_ls, float* c, long long c_ls,
                         cudaStream_t s) {
  return gemm_nn_tc<bf16>(L, M, N, K, a, b, b_ls, c, c_ls, nullptr, 0, bias,
                          bias_ls, s);
}

template cudaError_t gemm_tn<float>(int, int, int, int, SplitRowsT<float>,
                                    const float*, long long, float*,
                                    long long, float*, cudaStream_t);
template cudaError_t gemm_tn<bf16>(int, int, int, int, SplitRowsT<bf16>,
                                   const float*, long long, float*, long long,
                                   float*, cudaStream_t);
template cudaError_t gemm_nn<float>(int, int, int, const float*, const float*,
                                    float*, const float*, int, cudaStream_t);
template cudaError_t gemm_nn<bf16>(int, int, int, const float*, const bf16*,
                                   float*, const float*, int, cudaStream_t);

cudaError_t segment_rows(int L, int R, int N, int V, const int* ids,
                         const float* x, float* out, cudaStream_t s) {
  const dim3 grid((N + 255) / 256, V, L);
  segment_rows_kernel<<<grid, 256, 0, s>>>(R, N, V, ids, x, out);
  return cudaGetLastError();
}

cudaError_t colsum(int L, int R, int N, const float* x, float* out,
                   float* scratch, cudaStream_t s) {
  const int nchunk = colsum_chunks(R);
  if (nchunk > 1 && scratch == nullptr) return cudaErrorInvalidValue;
  float* part = nchunk > 1 ? scratch : out;
  if (N % 4 == 0 && aligned16(x)) {
    const dim3 grid((N + 127) / 128, nchunk, L);
    colsum_part_kernel<4><<<grid, 256, 0, s>>>(R, N, x, part);
  } else {
    const dim3 grid((N + 31) / 32, nchunk, L);
    colsum_part_kernel<1><<<grid, 256, 0, s>>>(R, N, x, part);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nchunk == 1) return err;
  const dim3 grid_fin((N + 255) / 256, L);
  colsum_final_kernel<<<grid_fin, 256, 0, s>>>(nchunk, N, scratch, out);
  return cudaGetLastError();
}

cudaError_t sum_over_t(int L, int T, int n, const float* x, float* out,
                       cudaStream_t s) {
  const dim3 grid((n + 255) / 256, L);
  sum_over_t_kernel<<<grid, 256, 0, s>>>(T, n, x, out);
  return cudaGetLastError();
}

}  // namespace fader

// Floats of scratch that gemm_tn(L, M, N, K) and colsum(L, K, N) need.
extern "C" long long fader_reduce_scratch_floats(int L, int M, int N, int K) {
  return fader::reduce_scratch_floats(L, M, N, K);
}

// The float32 dW GEMM alone, for its measurement: C[l] = A^T B[l] as the
// backward entries compute it (route 0), or on the CUDA cores (1), or on
// the tensor cores (2). A is the SplitRows (a0, a0_ls, n0, a1, a1_ls, lda).
extern "C" int fader_gemm_tn(int route, int L, int M, int N, int K,
                             const float* a0, long long a0_ls, int n0,
                             const float* a1, long long a1_ls, int lda,
                             const float* b, long long b_ls, float* c,
                             long long c_ls, float* scratch,
                             long long scratch_floats, void* stream) {
  if (scratch_floats < fader::reduce_scratch_floats(L, M, N, K))
    return (int)cudaErrorInvalidValue;
  return (int)fader::gemm_tn_f32(
      route, L, M, N, K, fader::SplitRows{a0, a0_ls, n0, a1, a1_ls, lda}, b,
      b_ls, c, c_ls, scratch, static_cast<cudaStream_t>(stream));
}
