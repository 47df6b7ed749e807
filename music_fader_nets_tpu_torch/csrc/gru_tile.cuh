// Shared device code of the port's GRU kernels: the persistent chains'
// barriers, row layout and cooperative launch (gru_fwd_chain.cu,
// embed_gru_bwd.cu, decode.cu), the gate maths, cp.async, and the split-K
// tile of the decoder's heads (decoder_ce.cu).
//
// The split-K tile: a block computes a TB-row x 32-column tile of A (rows,
// K) @ W (K, ldw) for NG column groups at W columns g*gs + j (g < NG; the
// heads take NG = 1). The block's 8 warps each take every 8th k; lane l
// owns column j0 + l. The A tile sits in shared memory transposed
// ([k][row], rows padded to TB + 4 floats) so a warp reads 4 rows with one
// broadcast float4; the weights go from L2 straight into registers, one
// coalesced 128-byte row segment per warp, k and group, several k-steps
// ahead. Every weight read feeds TB FMAs. splitk_reduce then sums the 8
// warps' partial tiles through shared memory in warp order
// (deterministic), leaving warp w with rows w, w+8, ... of its lane's
// column. Accumulation is plain float32 FMA on the CUDA cores.
//
// Storage types: the training kernels are instantiated for float and for
// bf16 (__nv_bfloat16) operands. A bf16 value is widened to float when it
// is loaded (to_f32), every product, sum and gate runs in float32, and a
// value is rounded to the storage type (nearest even) only where it is
// stored (from_f32) — the rounding points of the Pallas kernels, whose
// output refs take the input's dtype and whose scratch is float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace fader {

using bf16 = __nv_bfloat16;

template <typename S>
constexpr bool is_f32 = std::is_same<S, float>::value;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename S>
__device__ __forceinline__ S from_f32(float v) {
  if constexpr (is_f32<S>)
    return v;
  else
    return __float2bfloat16_rn(v);
}

// A read-only load through the texture path for float; bf16 loads are
// plain and widened.
__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f32(const bf16* p) {
  return __bfloat162float(*p);
}

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
template <int TB, typename AT = float>
__device__ __forceinline__ void load_a_tile(float* sA,
                                            const AT* __restrict__ A,
                                            int lda, int rows, int b0,
                                            int K) {
#pragma unroll 8
  for (int idx = threadIdx.x; idx < TB * K; idx += kThreads) {
    const int r = idx / K, k = idx - r * K;
    sA[k * (TB + 4) + r] =
        (b0 + r < rows) ? ldg_f32(A + (size_t)(b0 + r) * lda + k) : 0.f;
  }
}

// acc[r][g] += sum over this warp's k of sA[k][r] * W[k, g*gs + j]. The
// weights of the warp's next U k-steps are loaded before their FMAs, so U
// L2 reads per gate are in flight at once: the phases wait on L2 latency,
// not on arithmetic.
template <int TB, int NG, typename WT = float>
__device__ __forceinline__ void splitk_gemm(float (&acc)[TB][NG],
                                            const float* sA, int K,
                                            const WT* __restrict__ W,
                                            int ldw, int gs, bool col_ok,
                                            int j) {
  static_assert(TB % kWarps == 0, "TB must be a multiple of 8");
  // k-steps of weights in flight: fewer as the tile's rows take registers
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
                      ? ldg_f32(W + (size_t)k * ldw + g * gs + j) : 0.f;
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

// ---- the persistent chains (gru_fwd_chain.cu, embed_gru_bwd.cu; decode.cu
// takes try_cooperative)
//
// A block owns 32 hidden units of a row tile of 16, 32 or 64 rows for all
// T steps; the blocks of one row tile meet at a counter barrier a step, the
// counters kCtrStride ints apart, one per 16 rows at most, zeroed before
// each launch. Rows are exchanged k-major, padded to a multiple of
// kChainBPad rows.
constexpr int kCtrStride = 32;    // ints between two barriers' counters
constexpr int kChainBPad = 64;    // k-major scratch rows are padded to this

inline int chain_bp(int B) {
  return (B + kChainBPad - 1) / kChainBPad * kChainBPad;
}

inline long long chain_counter_floats(int L, int B) {
  return (long long)L * ((B + 15) / 16) * kCtrStride;
}

// Row i of the RB/8 rows a thread of warp `warp` owns in a chain's gate
// phase and epilogue: quads of 4 consecutive rows, quad index warp (+ 8);
// with RB = 16, rows 2*warp and 2*warp + 1, half of quad warp/2.
template <int RB>
__device__ __forceinline__ int chain_row(int warp, int i) {
  if constexpr (RB == 16) return 2 * warp + i;
  return (i / 4) * 32 + 4 * warp + (i % 4);
}

// Launch `kernel(p)` cooperatively on `grid` x kThreads with `smem` bytes
// of dynamic shared memory when the whole grid can be resident at once on
// the current device (*fits then true); else launch nothing and return
// cudaSuccess with *fits false. Shared memory over what a block may use
// returns an error.
template <typename Params>
inline cudaError_t try_cooperative(void (*kernel)(Params), dim3 grid,
                                   size_t smem, Params p, bool* fits,
                                   cudaStream_t s) {
  *fits = false;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  if ((long long)grid.x * grid.y * grid.z > (long long)per_sm * sms)
    return cudaSuccess;
  *fits = true;
  void* kargs[] = {&p};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), grid,
                                     dim3(kThreads), kargs, smem, s);
}

// Asynchronous copies from device memory into shared memory (cp.async):
// `BYTES` (16 or 4) are written, the first `src_bytes` of them read from
// `gmem` and the rest zero-filled, so src_bytes = 0 masks a ragged edge
// (gmem must still be a valid address aligned to BYTES). The 16-byte form
// goes through L2 only. A thread's copies complete in the order of its
// commit groups: cp_async_wait<N>() returns when all but its N newest
// groups have landed; other threads see them after a __syncthreads().
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int src_bytes) {
  static_assert(BYTES == 16 || BYTES == 4, "cp.async of 16 or 4 bytes");
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(gmem), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(gmem), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// h' = (1 - z) * n + z * h with r = sigmoid(xr + hr), z = sigmoid(xz + hz),
// n = tanh(xn + r * hn): the gate maths of ops/gru.py::_gates, one rounding
// per operation as PyTorch's elementwise ops round (no contraction to FMA).
// r, z and n are returned too, for the training forward's gate stash.
__device__ __forceinline__ float gru_gates(float xr, float xz, float xn,
                                           float hr, float hz, float hn,
                                           float h, float& r, float& z,
                                           float& n) {
  r = sigmoid_f32(__fadd_rn(xr, hr));
  z = sigmoid_f32(__fadd_rn(xz, hz));
  n = tanhf(__fadd_rn(xn, __fmul_rn(r, hn)));
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, z), n), __fmul_rn(z, h));
}

__device__ __forceinline__ float gru_combine(float xr, float xz, float xn,
                                             float hr, float hz, float hn,
                                             float h) {
  float r, z, n;
  return gru_gates(xr, xz, xn, hr, hz, hn, h, r, z, n);
}

// The gate backward of pallas_gru.py::_gate_bwd for one hidden unit: from
// the cotangent dh on h' and the stashed r, z, n, hn (the n-section of the
// hidden projection, b_hh included) and h_prev, the cotangents of the input
// projection [dar, daz, dan] and of the hidden projection [dar, daz, dhn].
// The direct term into h_prev is dh * z.
__device__ __forceinline__ void gate_bwd(float dh, float r, float z, float n,
                                         float hn, float h_prev, float& dar,
                                         float& daz, float& dan,
                                         float& dhn) {
  const float dn = dh * (1.0f - z);
  const float dz = dh * (h_prev - n);
  dan = dn * (1.0f - n * n);
  const float dr = dan * hn;
  dhn = dan * r;
  dar = dr * r * (1.0f - r);
  daz = dz * z * (1.0f - z);
}

}  // namespace fader
