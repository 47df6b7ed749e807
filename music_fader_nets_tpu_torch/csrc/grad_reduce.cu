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
// What bounds them on an H100: dW_hh is float32 FMA work (encoder:
// 4 x 2 x 512 x 1536 x 12800 = 80.5 GFLOP, 1.2 ms at 67 TFLOP/s); the sums
// and the scatter read each stashed row once (bytes).
//
// Design: gemm_tn is a register-blocked float32 FMA GEMM on the CUDA cores
// (tensor cores would need a 3 x TF32 split to hold the gradients' 1e-4
// bound over 12,800-term sums; not done). A block owns a 128 x 128 output
// tile, a thread 8 x 8 outputs in registers (64 FMAs for four 16-byte
// shared-memory reads). Both operands are row-major with k outermost, so a
// 16-deep k-slab is 16 contiguous row segments of each: a ring of 4 slabs
// in shared memory is filled by 16-byte cp.async copies, slab k+3 landing
// while slab k is multiplied; the SplitRows seam is resolved once a copy
// (two copies a thread and slab), ragged edges by zero-filling copies.
// With 128 x 128 tiles one direction has only 4 x 12 tiles, so K is split
// into S parts (S chosen so the blocks fill whole waves of two blocks an
// SM), each part writes its partial tile to scratch and a second pass adds
// the S partials in order: the same bits every run, no float atomics. The
// column sums split the rows over blocks the same way (256-row chunks, 8
// warps a chunk, 16-byte loads, partials added in chunk order). The
// scatter compacts each chunk's matching rows with warp ballots and adds
// them in row order. gemm_nn (the decoder backward's products off its
// recurrences: dh2_head = dlogits @ w_out^T, 5 GFLOP, and the cotangent
// layer 2 sends layer 1, dpre2x @ w_ih2^T, 20 GFLOP at T*B = 12,800 rows)
// has gemm_tn's tile, ring and register block; its A slab is 128 rows of
// 16 contiguous k, so it lands row-major (rows padded to 20 floats) and a
// thread reads its 8 rows 4 k at a time as float4s. No split of K: M = T*B
// has 100-400 row tiles.
//
// bf16 operands (mixed-precision training): gemm_tn's A (the h_prev rows,
// from the bf16 h_seq) and gemm_nn's B (a bf16 weight) may be bf16. Those
// are not copied by cp.async but loaded into registers a ring stage ahead
// (8 bf16, 16 bytes, a load on the vector path: M or N a multiple of 8 and
// 16-byte aligned rows; else one element a load, which takes any shape),
// widened and stored into the same float32 slab after the stage in hand is
// multiplied; everything else, the float32 accumulation and the sums, is
// the float path's. The dpre operands and all results stay float32.
#include <stdint.h>

#include "gru_tile.cuh"
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

// Widen 8 bf16 held in a uint4 into 8 floats at dst (16-byte aligned).
__device__ __forceinline__ void widen8(float* dst, const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// C_part[l, sp] (M, N) = sum over k in [sp*kchunk, (sp+1)*kchunk) of
// A(k, m) B[l](k, n); blockIdx.z = l * S + sp. VEC: 16-byte copies (M, N,
// the strides and the base addresses are multiples of 4 floats; for a bf16
// A, M, lda and the strides multiples of 8), else 4-byte copies.
template <bool VEC, typename AT>
__global__ void __launch_bounds__(256, 2)
    gemm_tn_kernel(int M, int N, int K, int S, int kchunk, SplitRowsT<AT> a,
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
  const AT* a0l = a.a0 + l * a.a0_ls;
  const AT* a1l = a.a1 + l * a.a1_ls;

  constexpr int W = VEC ? 4 : 1;              // floats a copy
  constexpr int kPerRow = kBM / W;            // copies a k-row (kBM == kBN)
  constexpr int kCopies = kBK * kPerRow / 256;
  // a bf16 A: elements a register load, loads a thread and slab
  constexpr int WA = VEC ? 8 : 1;
  constexpr int kALoads = kBK * kBM / WA / 256;
  float areg[kALoads * WA];   // a stage of it, from its load to its store
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
      if constexpr (is_f32<AT>) {
        const bool a_ok = k < kend && m0 + col < M;
        cp_async<4 * W>(as + kk * kBM + col, a_ok ? a_row(k) + m0 + col : bl,
                        a_ok ? 4 * W : 0);
      }
      const bool b_ok = k < kend && n0 + col < N;
      cp_async<4 * W>(bs + kk * kBN + col,
                      b_ok ? bl + (long long)k * N + n0 + col : bl,
                      b_ok ? 4 * W : 0);
    }
    if constexpr (!is_f32<AT>) {
#pragma unroll
      for (int i = 0; i < kALoads; ++i) {
        const int idx = tid + i * 256;
        const int kk = idx / (kBM / WA), col = (idx % (kBM / WA)) * WA;
        const int k = k0 + kk;
        const bool a_ok = k < kend && m0 + col < M;
        if constexpr (VEC) {
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (a_ok) v = *reinterpret_cast<const uint4*>(a_row(k) + m0 + col);
          widen8(areg + i * WA, v);
        } else {
          areg[i] = a_ok ? to_f32(a_row(k)[m0 + col]) : 0.f;
        }
      }
    }
  };
  // a bf16 A's registers into stage sl's slab
  auto store_a = [&](int sl) {
    float* as = As + (sl % kStages) * kBK * kBM;
#pragma unroll
    for (int i = 0; i < kALoads; ++i) {
      const int idx = tid + i * 256;
      const int kk = idx / (kBM / WA), col = (idx % (kBM / WA)) * WA;
#pragma unroll
      for (int e = 0; e < WA; ++e) as[kk * kBM + col + e] = areg[i * WA + e];
    }
  };

  float acc[8][8] = {};
#pragma unroll
  for (int sl = 0; sl < kStages - 1; ++sl) {
    if (sl < nslab) {
      fill_slab(sl);
      if constexpr (!is_f32<AT>) store_a(sl);
    }
    cp_async_commit();
  }
  for (int sl = 0; sl < nslab; ++sl) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // the stage refilled here was read in iteration sl - 1, which every
    // thread has left
    const bool refill = sl + kStages - 1 < nslab;
    if (refill) fill_slab(sl + kStages - 1);
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
    // (a bf16 A: that stage was read in iteration sl - 1 too)
    if constexpr (!is_f32<AT>) {
      if (refill) store_a(sl + kStages - 1);
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
// base addresses are multiples of 4 floats; for a bf16 B, N a multiple of
// 8), else 4-byte ones.
template <bool VEC, typename BT>
__global__ void __launch_bounds__(256, 2)
    gemm_nn_kernel(int M, int N, int K, const float* __restrict__ a,
                   const BT* __restrict__ b, float* __restrict__ c,
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
  // a bf16 B: elements a register load, loads a thread and slab
  constexpr int WB = VEC ? 8 : 1;
  constexpr int kBLoads = kBK * kBN / WB / 256;
  float breg[kBLoads * WB];   // a stage of it, from its load to its store
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
    if constexpr (is_f32<BT>) {
#pragma unroll
      for (int i = 0; i < kBCopies; ++i) {
        const int idx = tid + i * 256;
        const int kk = idx / (kBN / W), col = (idx % (kBN / W)) * W;
        const bool ok = k0 + kk < K && n0 + col < N;
        cp_async<4 * W>(bs + kk * kBN + col,
                        ok ? b + (long long)(k0 + kk) * N + n0 + col : b,
                        ok ? 4 * W : 0);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBLoads; ++i) {
        const int idx = tid + i * 256;
        const int kk = idx / (kBN / WB), col = (idx % (kBN / WB)) * WB;
        const bool ok = k0 + kk < K && n0 + col < N;
        const BT* src = b + (long long)(k0 + kk) * N + n0 + col;
        if constexpr (VEC) {
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (ok) v = *reinterpret_cast<const uint4*>(src);
          widen8(breg + i * WB, v);
        } else {
          breg[i] = ok ? to_f32(*src) : 0.f;
        }
      }
    }
  };
  // a bf16 B's registers into stage sl's slab
  auto store_b = [&](int sl) {
    float* bs = Bs + (sl % kStages) * kBK * kBN;
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) {
      const int idx = tid + i * 256;
      const int kk = idx / (kBN / WB), col = (idx % (kBN / WB)) * WB;
#pragma unroll
      for (int e = 0; e < WB; ++e) bs[kk * kBN + col + e] = breg[i * WB + e];
    }
  };

  float acc[8][8] = {};
#pragma unroll
  for (int sl = 0; sl < kStages - 1; ++sl) {
    if (sl < nslab) {
      fill_slab(sl);
      if constexpr (!is_f32<BT>) store_b(sl);
    }
    cp_async_commit();
  }
  // thread (ty, tx) holds rows m0 + {0, 64} + ty*4 + 0..3 and columns
  // n0 + {0, 64} + tx*4 + 0..3
  for (int sl = 0; sl < nslab; ++sl) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const bool refill = sl + kStages - 1 < nslab;
    if (refill) fill_slab(sl + kStages - 1);
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
    // (a bf16 B: that stage was read in iteration sl - 1 too)
    if constexpr (!is_f32<BT>) {
      if (refill) store_b(sl + kStages - 1);
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

// The split of K for gemm_tn: the least S whose L * tiles * S blocks fill
// at least nine tenths of whole waves of two blocks an SM, or the S that
// fills them best; a split has at least kMinSplitK rows of k.
struct GemmPlan {
  int S, kchunk;
};

GemmPlan gemm_plan(int L, int M, int N, int K) {
  const long long tiles =
      (long long)L * ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  const long long slots = 2LL * sm_count();
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

}  // namespace

long long reduce_scratch_floats(int L, int M, int N, int K) {
  const GemmPlan p = gemm_plan(L, M, N, K);
  const long long gemm = p.S > 1 ? (long long)L * p.S * M * N : 0;
  const int nchunk = colsum_chunks(K);
  const long long sums = nchunk > 1 ? (long long)L * nchunk * N : 0;
  return max(gemm, sums);
}

template <typename AT>
cudaError_t gemm_tn(int L, int M, int N, int K, SplitRowsT<AT> a,
                    const float* b, long long b_ls, float* c, long long c_ls,
                    float* scratch, cudaStream_t s) {
  const GemmPlan p = gemm_plan(L, M, N, K);
  if (p.S > 1 && scratch == nullptr) return cudaErrorInvalidValue;
  constexpr int av = is_f32<AT> ? 4 : 8;     // A elements a 16-byte copy
  const bool vec = M % av == 0 && N % 4 == 0 && a.lda % av == 0 &&
                   a.a0_ls % av == 0 && a.a1_ls % av == 0 && b_ls % 4 == 0 &&
                   aligned16(a.a0) && aligned16(a.a1) && aligned16(b);
  auto kernel = vec ? gemm_tn_kernel<true, AT> : gemm_tn_kernel<false, AT>;
  cudaError_t err = allow_smem(kernel, kGemmSmem);
  if (err != cudaSuccess) return err;
  const long long mn = (long long)M * N;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, L * p.S);
  if (p.S == 1) {
    kernel<<<grid, 256, kGemmSmem, s>>>(M, N, K, 1, p.kchunk, a, b, b_ls, c,
                                        c_ls, 0);
    return cudaGetLastError();
  }
  kernel<<<grid, 256, kGemmSmem, s>>>(M, N, K, p.S, p.kchunk, a, b, b_ls,
                                      scratch, p.S * mn, mn);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid_sum((unsigned)((mn + 255) / 256), L);
  splitk_sum_kernel<<<grid_sum, 256, 0, s>>>(mn, p.S, scratch, c, c_ls);
  return cudaGetLastError();
}

template <typename BT>
cudaError_t gemm_nn(int M, int N, int K, const float* a, const BT* b,
                    float* c, const float* add, int add_rows,
                    cudaStream_t s) {
  constexpr int bv = is_f32<BT> ? 4 : 8;     // B elements a 16-byte copy
  const bool vec = K % 4 == 0 && N % bv == 0 && aligned16(a) &&
                   aligned16(b) && aligned16(c) &&
                   (add == nullptr || aligned16(add));
  auto kernel = vec ? gemm_nn_kernel<true, BT> : gemm_nn_kernel<false, BT>;
  cudaError_t err = allow_smem(kernel, kGemmNNSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, 1);
  kernel<<<grid, 256, kGemmNNSmem, s>>>(M, N, K, a, b, c, add,
                                        add == nullptr ? 0 : add_rows);
  return cudaGetLastError();
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
