// Shared device code of the port's GRU kernels (embed_gru.cu, decode.cu).
//
// A block computes a TB-row x 32-column tile of A (rows, K) @ W (K, ldw) for
// NG column groups at W columns g*gs + j (g < NG). For a GRU, NG = 3 and
// gs = H: the block owns 32 hidden units with all three of their gate
// columns (r, z, n), so the gate maths needs nothing from other blocks.
//
// Split-K: the block's 8 warps each take every 8th k; lane l owns column
// j0 + l. The A tile sits in shared memory transposed ([k][row], rows
// padded to TB + 4 floats) so a warp reads 4 rows with one broadcast
// float4; the weights go from L2 straight into registers, one coalesced
// 128-byte row segment per warp, k and gate, several k-steps ahead. Every
// weight read feeds TB FMAs. splitk_reduce then sums the 8 warps' partial tiles through shared
// memory in warp order (deterministic), leaving warp w with rows w, w+8,
// ... of its lane's column. Accumulation is plain float32 FMA on the CUDA
// cores.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fader {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 32;  // output columns per block, one per lane

// Dynamic shared memory of a block holding `na` A tiles of K x TB rows and
// the cross-warp reduction buffer.
template <int TB>
constexpr size_t smem_bytes(int na, int K) {
  return ((size_t)na * K * (TB + 4) + (size_t)kWarps * TB * 32) *
         sizeof(float);
}

// sA[k * (TB + 4) + r] = A[b0 + r, k], zero for rows past `rows`.
template <int TB>
__device__ __forceinline__ void load_a_tile(float* sA,
                                            const float* __restrict__ A,
                                            int lda, int rows, int b0,
                                            int K) {
#pragma unroll 8
  for (int idx = threadIdx.x; idx < TB * K; idx += kThreads) {
    const int r = idx / K, k = idx - r * K;
    sA[k * (TB + 4) + r] =
        (b0 + r < rows) ? __ldg(A + (size_t)(b0 + r) * lda + k) : 0.f;
  }
}

// acc[r][g] += sum over this warp's k of sA[k][r] * W[k, g*gs + j]. The
// weights of the warp's next U k-steps are loaded before their FMAs, so U
// L2 reads per gate are in flight at once: the phases wait on L2 latency,
// not on arithmetic.
template <int TB, int NG>
__device__ __forceinline__ void splitk_gemm(float (&acc)[TB][NG],
                                            const float* sA, int K,
                                            const float* __restrict__ W,
                                            int ldw, int gs, bool col_ok,
                                            int j) {
  static_assert(TB % kWarps == 0, "TB must be a multiple of 8");
  // 8-row tiles have registers to spare for deeper prefetch; 16-row tiles
  // (the encoder, two blocks per SM) do not
  constexpr int U = (NG == 1 ? 32 : 16) / (TB / kWarps);
  const int warp = threadIdx.x >> 5;
  for (int k0 = warp; k0 < K; k0 += kWarps * U) {
    float w[U][NG];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * kWarps;
#pragma unroll
      for (int g = 0; g < NG; ++g)
        w[u][g] = (col_ok && k < K)
                      ? __ldg(W + (size_t)k * ldw + g * gs + j) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * kWarps;
      if (k >= K) break;
      const float4* a4 =
          reinterpret_cast<const float4*>(sA + k * (TB + 4));
#pragma unroll
      for (int q = 0; q < TB / 4; ++q) {
        const float4 a = a4[q];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          acc[4 * q + 0][g] = fmaf(a.x, w[u][g], acc[4 * q + 0][g]);
          acc[4 * q + 1][g] = fmaf(a.y, w[u][g], acc[4 * q + 1][g]);
          acc[4 * q + 2][g] = fmaf(a.z, w[u][g], acc[4 * q + 2][g]);
          acc[4 * q + 3][g] = fmaf(a.w, w[u][g], acc[4 * q + 3][g]);
        }
      }
    }
  }
}

// Sum the 8 warps' partial tiles: out[i][g] is row warp + 8*i of this
// lane's column. `red` holds kWarps * TB * 32 floats.
template <int TB, int NG>
__device__ __forceinline__ void splitk_reduce(float (&acc)[TB][NG],
                                              float (&out)[TB / kWarps][NG],
                                              float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int g = 0; g < NG; ++g) {
#pragma unroll
    for (int r = 0; r < TB; ++r) red[(warp * TB + r) * 32 + lane] = acc[r][g];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TB / kWarps; ++i) {
      const int r = warp + kWarps * i;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        s = __fadd_rn(s, red[(w * TB + r) * 32 + lane]);
      out[i][g] = s;
    }
    __syncthreads();
  }
}

// Opt a kernel into `bytes` of dynamic shared memory (above 48 KB this is
// required; beyond the 227 KB a block may use, the launch would fail).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > 232448) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// h' = (1 - z) * n + z * h with r = sigmoid(xr + hr), z = sigmoid(xz + hz),
// n = tanh(xn + r * hn): the gate maths of ops/gru.py::_gates, one rounding
// per operation as PyTorch's elementwise ops round (no contraction to FMA).
__device__ __forceinline__ float gru_combine(float xr, float xz, float xn,
                                             float hr, float hz, float hn,
                                             float h) {
  const float r = sigmoid_f32(__fadd_rn(xr, hr));
  const float z = sigmoid_f32(__fadd_rn(xz, hz));
  const float n = tanhf(__fadd_rn(xn, __fmul_rn(r, hn)));
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, z), n), __fmul_rn(z, h));
}

}  // namespace fader
