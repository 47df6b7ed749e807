// Weight-gradient reductions of the training backward kernels
// (embed_gru_bwd.cu, decoder_ce_bwd.cu): dW = h_prev^T dpre over all T*B
// rows, the scatter of dpre_x rows into embedding rows by token or class,
// and the bias / per-sequence sums.
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
// Design: a plain shared-memory tiled GEMM (64 x 64 output tile, k-slabs of
// 16, 4 x 4 outputs per thread, float32 FMA on the CUDA cores; tensor cores
// are later work). Every sum runs in a fixed order, so results are the
// same from run to run: the scatter compacts each chunk's matching rows
// with warp ballots and adds them in row order (no float atomics); the
// column sums give each warp every 8th row and add the 8 partial sums in
// warp order.
#include "train_ops.cuh"

namespace fader {

constexpr int kGT = 64;   // GEMM output tile (rows and columns)
constexpr int kGK = 16;   // k-slab depth

template <bool kTransA>
__global__ void __launch_bounds__(256)
    gemm_kernel(int M, int N, int K, SplitRows a, const float* __restrict__ b,
                long long b_ls, float* __restrict__ c, long long c_ls) {
  __shared__ __align__(16) float As[kGK][kGT];
  __shared__ __align__(16) float Bs[kGK][kGT];
  const int l = blockIdx.z;
  const int m0 = blockIdx.y * kGT, n0 = blockIdx.x * kGT;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const float* bl = b + l * b_ls;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kGK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * 256;
      if (kTransA) {
        const int kk = idx / kGT, mm = idx % kGT;
        const int k = k0 + kk, m = m0 + mm;
        float v = 0.f;
        if (k < K && m < M) {
          const float* row = (k < a.n0)
              ? a.a0 + l * a.a0_ls + (long long)k * a.lda
              : a.a1 + l * a.a1_ls + (long long)(k - a.n0) * a.lda;
          v = row[m];
        }
        As[kk][mm] = v;
      } else {
        const int mm = idx / kGK, kk = idx % kGK;
        const int k = k0 + kk, m = m0 + mm;
        As[kk][mm] =
            (k < K && m < M) ? a.a1[(long long)m * a.lda + k] : 0.f;
      }
      const int kk = idx / kGT, nn = idx % kGT;
      const int k = k0 + kk, n = n0 + nn;
      Bs[kk][nn] = (k < K && n < N) ? bl[(long long)k * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* cl = c + l * c_ls;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) cl[(long long)m * N + n] = acc[i][j];
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

__global__ void __launch_bounds__(256)
    colsum_kernel(int R, int N, const float* __restrict__ x,
                  float* __restrict__ out) {
  __shared__ float part[8][33];
  const int l = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * 32 + lane;
  const float* xl = x + (long long)l * R * N;
  float s0 = 0.f, s1 = 0.f;
  if (c < N) {
    int r = warp;
    for (; r + 8 < R; r += 16) {
      s0 += xl[(long long)r * N + c];
      s1 += xl[(long long)(r + 8) * N + c];
    }
    if (r < R) s0 += xl[(long long)r * N + c];
  }
  part[warp][lane] = s0 + s1;
  __syncthreads();
  if (warp == 0 && c < N) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += part[w][lane];
    out[(long long)l * N + c] = s;
  }
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

cudaError_t gemm_tn(int L, int M, int N, int K, SplitRows a, const float* b,
                    long long b_ls, float* c, long long c_ls,
                    cudaStream_t s) {
  const dim3 grid((N + kGT - 1) / kGT, (M + kGT - 1) / kGT, L);
  gemm_kernel<true><<<grid, 256, 0, s>>>(M, N, K, a, b, b_ls, c, c_ls);
  return cudaGetLastError();
}

cudaError_t gemm_nn(int M, int N, int K, const float* a, const float* b,
                    float* c, cudaStream_t s) {
  SplitRows ar{nullptr, 0, 0, a, 0, K};
  const dim3 grid((N + kGT - 1) / kGT, (M + kGT - 1) / kGT, 1);
  gemm_kernel<false><<<grid, 256, 0, s>>>(M, N, K, ar, b, 0, c, 0);
  return cudaGetLastError();
}

cudaError_t segment_rows(int L, int R, int N, int V, const int* ids,
                         const float* x, float* out, cudaStream_t s) {
  const dim3 grid((N + 255) / 256, V, L);
  segment_rows_kernel<<<grid, 256, 0, s>>>(R, N, V, ids, x, out);
  return cudaGetLastError();
}

cudaError_t colsum(int L, int R, int N, const float* x, float* out,
                   cudaStream_t s) {
  const dim3 grid((N + 31) / 32, L);
  colsum_kernel<<<grid, 256, 0, s>>>(R, N, x, out);
  return cudaGetLastError();
}

cudaError_t sum_over_t(int L, int T, int n, const float* x, float* out,
                       cudaStream_t s) {
  const dim3 grid((n + 255) / 256, L);
  sum_over_t_kernel<<<grid, 256, 0, s>>>(T, n, x, out);
  return cudaGetLastError();
}

}  // namespace fader
