// Generic stacked GRU over precomputed input projections, forward and
// backward.
//
// Replaces: music_fader_nets_tpu/ops/pallas_gru.py::_fwd_kernel (:147, the
// forward of stacked_gru_pallas :333; entry fader_stacked_gru) and
// ::_bwd_kernel (:238, its backward; entry fader_stacked_gru_bwd).
//
// What it computes, for each direction l < L and step t < T:
//   h' = gates(pre[l, t], h @ w_hh[l] + b_hh[l], h)   (r, z, n as ops/gru.py)
// writing h_seq[l, t] and, when a gradient is wanted, the gate stash
// [r, z, n, hn_h] (L, T, B, 4H). The backward walks t from T-1 down to 0
// with dh = 0:
//   dh += g_seq[l, t] ; (dpre[l, t], dpre_h) = gate_bwd(dh, stash, h_prev)
//   dh  = dh * z + dpre_h @ w_hh[l]^T
// then dW_hh = h_prev^T dpre_h and db_hh = sum of dpre_h over all T*B rows,
// and dh0 = dh.
//
// What bounds it on an H100: float32 FMA. At the CVAE encoder's shape (L=2,
// T=100, B=128, H=512) the forward is 2 L T B H 3H = 40.3 GFLOP, 0.60 ms at
// 67 TFLOP/s; the backward twice that, 1.20 ms (the dh chain's
// dpre_h @ w_hh^T and the dW_hh GEMM; the gate stash spares it the
// h @ w_hh recompute).
// pre and dpre (157 MB each there) are read and written once.
//
// Design: the embedded-id kernels' (embed_gru.cu, embed_gru_bwd.cu) with
// the input row read from pre in place of a gather. One launch per step
// from a C host loop (h_{t+1} needs all of h_t); a block owns (direction,
// 32 hidden units with their r/z/n columns, 16 batch rows), the split-K
// tile of gru_tile.cuh. The backward chain is embed_gru_bwd.cu's step,
// whose input-projection cotangent is the output dpre; dW_hh and db_hh are
// grad_reduce.cu's deterministic GEMM and column sums (no float atomics).
#include "gru_tile.cuh"
#include "train_ops.cuh"

namespace fader {

constexpr int kStackTB = 16;

template <int TB>
__global__ void __launch_bounds__(kThreads, 2)
    stacked_gru_step(int T, int B, int H, int t, const float* __restrict__ pre,
                     const float* __restrict__ w_hh,
                     const float* __restrict__ b_hh,
                     const float* __restrict__ h_in, long long h_in_ls,
                     float* __restrict__ h_seq, float* __restrict__ stash) {
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);
  float* red = sA + (size_t)H * (TB + 4);
  const int l = blockIdx.z;
  const int G = 3 * H;
  const int warp = threadIdx.x >> 5;
  const int j = blockIdx.x * kTileN + (threadIdx.x & 31);
  const int b0 = blockIdx.y * TB;

  load_a_tile<TB>(sA, h_in + l * h_in_ls, H, B, b0, H);
  __syncthreads();
  float acc[TB][3] = {};
  splitk_gemm<TB, 3>(acc, sA, H, w_hh + (size_t)l * H * G, G, H, j < H, j);
  float ph[TB / kWarps][3];
  splitk_reduce<TB, 3>(acc, ph, red);

  if (j >= H) return;
  const float* bh = b_hh + (size_t)l * G;
#pragma unroll
  for (int i = 0; i < TB / kWarps; ++i) {
    const int r = warp + kWarps * i;
    const int b = b0 + r;
    if (b >= B) continue;
    const size_t lt = ((size_t)l * T + t) * B + b;
    const float* px = pre + lt * G;
    const float hr = __fadd_rn(ph[i][0], bh[j]);
    const float hz = __fadd_rn(ph[i][1], bh[H + j]);
    const float hn = __fadd_rn(ph[i][2], bh[2 * H + j]);
    float rg, zg, ng;
    h_seq[lt * H + j] = gru_gates(px[j], px[H + j], px[2 * H + j], hr, hz,
                                  hn, sA[j * (TB + 4) + r], rg, zg, ng);
    if (stash != nullptr) {
      float* st = stash + lt * 4 * H;
      st[j] = rg;
      st[H + j] = zg;
      st[2 * H + j] = ng;
      st[3 * H + j] = hn;
    }
  }
}

}  // namespace fader

// pre (L,T,B,3H) the input projections (b_ih included, reversed directions
// already time-flipped); w_hh (L,H,3H); b_hh (L,3H); h0 (L,B,H). Outputs:
// h_seq (L,T,B,H); stash (L,T,B,4H) or null (no gradient wanted). All
// contiguous float32 on one device. T launches on `stream`. T >= 1.
extern "C" int fader_stacked_gru(int L, int T, int B, int H, const float* pre,
                                 const float* w_hh, const float* b_hh,
                                 const float* h0, float* h_seq, float* stash,
                                 void* stream) {
  using namespace fader;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes<kStackTB>(1, H);
  cudaError_t err = allow_smem(stacked_gru_step<kStackTB>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + kTileN - 1) / kTileN, (B + kStackTB - 1) / kStackTB, L);
  const long long BH = (long long)B * H;
  for (int t = 0; t < T; ++t) {
    const float* h_in = t == 0 ? h0 : h_seq + (t - 1) * BH;
    const long long h_in_ls = t == 0 ? BH : T * BH;
    stacked_gru_step<kStackTB><<<grid, kThreads, smem, s>>>(
        T, B, H, t, pre, w_hh, b_hh, h_in, h_in_ls, h_seq, stash);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// g (L,T,B,H) the h_seq cotangent; stash (L,T,B,4H), h_seq (L,T,B,H) and h0
// (L,B,H) from the forward; w_hhT (L,3H,H) = w_hh transposed. Scratch:
// dh_buf (2,L,B,H), dph (L,T,B,3H). Outputs: dpre (L,T,B,3H); dw_hh
// (L,H,3H); db_hh (L,3H); dh0 (L,B,H). T >= 1.
extern "C" int fader_stacked_gru_bwd(int L, int T, int B, int H,
                                     const float* g, const float* stash,
                                     const float* h_seq, const float* h0,
                                     const float* w_hhT, float* dh_buf,
                                     float* dph, float* dpre, float* dw_hh,
                                     float* db_hh, float* dh0, void* stream) {
  using namespace fader;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long BH = (long long)B * H, G = 3LL * H;
  cudaError_t err = cudaMemsetAsync(dh_buf, 0, BH * L * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  const float* dh_in = dh_buf;
  for (int t = T - 1; t >= 0; --t) {
    float* dh_out = (t == 0) ? dh0 : dh_buf + ((T - t) % 2) * BH * L;
    const float* hp = t == 0 ? h0 : h_seq + (t - 1) * BH;
    const long long hp_ls = t == 0 ? BH : T * BH;
    err = launch_gru_bwd_step(L, T, B, H, t, g + t * BH, T * BH, stash, hp,
                              hp_ls, w_hhT, dh_in, dh_out, dpre, dph, s);
    if (err != cudaSuccess) return (int)err;
    dh_in = dh_out;
  }
  const int R = T * B;
  const SplitRows h_prev{h0, BH, B, h_seq, T * BH, H};
  if ((err = gemm_tn(L, H, (int)G, R, h_prev, dph, R * G, dw_hh, H * G, s)) !=
      cudaSuccess)
    return (int)err;
  return (int)colsum(L, R, (int)G, dph, db_hh, s);
}
