// Embedded-id GRU kernels, backward: the gradient of L stacked GRU
// directions from their gate stash.
//
// Replaces: music_fader_nets_tpu/ops/pallas_gru.py::_bwd_embed_kernel
// (backward of stacked_gru_embed_finals, the encoder: cotangent on the
// final states only) and ::_bwd_embed_seq_kernel (backward of
// stacked_gru_embed_seq, the sub-decoders: a cotangent on every step).
// One entry, fader_embed_gru_bwd; `seq_grad` picks the cotangent form.
//
// What it computes, walking t from T-1 down to 0 with dh = 0:
//   dh      += g_t                      (g_fin at t = T-1, or g_seq[t])
//   dpre_x, dpre_h = gate_bwd(dh, stash[t], h_prev(t))   (_gate_bwd :1205)
//   dh       = dh * z + dpre_h @ w_hh^T
// then, from the dpre rows of all steps:
//   dW_in[v] = sum of dpre_x over the (t, b) whose id is v (by row id)
//   db_in    = sum of dpre_x      (encoder)  | dprez[b] = sum_t dpre_x[t, b]
//   dW_hh    = h_prev^T dpre_h,  db_hh = sum of dpre_h,  dh0 = dh.
//
// What bounds it on an H100: float32 FMA. Encoder, B=128: the chain is
// 4 x 100 x 2 x 128 x 1536 x 512 = 80.5 GFLOP and dW_hh as much again,
// 2.4 ms at 67 TFLOP/s; the dpre stashes (2 x 315 MB) are written once and
// read once.
//
// Design: the chain launches once per step (dh needs all of the previous
// step's dh), T launches from one host call. A block owns 32 hidden units
// of 8 batch rows: it runs the gate backward of ALL H units of its rows
// into a shared-memory A tile (the 3H-deep dpre_h rows; the elementwise
// work is repeated by the H/32 column blocks, the price of one launch a
// step), stores dpre_x / dpre_h of its own 32 units, and multiplies the
// tile by its 32 columns of w_hh^T (pre-transposed so lanes read
// consecutive addresses) with the split-K tile of gru_tile.cuh. The weight
// gradients are grad_reduce.cu's deterministic GEMM, scatter and sums.
#include "gru_tile.cuh"
#include "train_ops.cuh"

namespace fader {

constexpr int kBwdTB = 8;

template <int TB>
__global__ void __launch_bounds__(kThreads, 2)
    gru_bwd_step(int T, int B, int H, int t, const float* __restrict__ g,
                 long long g_ls, const float* __restrict__ stash,
                 const float* __restrict__ h_prev, long long hp_ls,
                 const float* __restrict__ w_hhT,
                 const float* __restrict__ dh_in, float* __restrict__ dh_out,
                 float* __restrict__ dpx, float* __restrict__ dph) {
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);
  const int G = 3 * H;
  float* red = sA + (size_t)G * (TB + 4);
  const int l = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int j0 = blockIdx.x * kTileN;
  const int j = j0 + (threadIdx.x & 31);
  const int b0 = blockIdx.y * TB;
  const float* gl = g ? g + l * g_ls : nullptr;
  const float* hpl = h_prev + l * hp_ls;
  const float* dhl = dh_in + (size_t)l * B * H;

  for (int idx = threadIdx.x; idx < TB * H; idx += kThreads) {
    const int r = idx / H, k = idx - r * H;
    const int b = b0 + r;
    float dar = 0.f, daz = 0.f, dan = 0.f, dhn = 0.f;
    if (b < B) {
      const size_t lt = ((size_t)l * T + t) * B + b;
      const float* st = stash + lt * 4 * H;
      float dh = dhl[(size_t)b * H + k];
      if (gl) dh += gl[(size_t)b * H + k];
      gate_bwd(dh, st[k], st[H + k], st[2 * H + k], st[3 * H + k],
               hpl[(size_t)b * H + k], dar, daz, dan, dhn);
      if (k >= j0 && k < j0 + kTileN) {
        float* px = dpx + lt * G;
        float* pq = dph + lt * G;
        px[k] = dar;
        px[H + k] = daz;
        px[2 * H + k] = dan;
        pq[k] = dar;
        pq[H + k] = daz;
        pq[2 * H + k] = dhn;
      }
    }
    sA[(size_t)k * (TB + 4) + r] = dar;
    sA[(size_t)(H + k) * (TB + 4) + r] = daz;
    sA[(size_t)(2 * H + k) * (TB + 4) + r] = dhn;
  }
  __syncthreads();
  float acc[TB][1] = {};
  splitk_gemm<TB, 1>(acc, sA, G, w_hhT + (size_t)l * G * H, H, 0, j < H, j);
  float out[TB / kWarps][1];
  splitk_reduce<TB, 1>(acc, out, red);

  if (j >= H) return;
#pragma unroll
  for (int i = 0; i < TB / kWarps; ++i) {
    const int b = b0 + warp + kWarps * i;
    if (b >= B) continue;
    const size_t lt = ((size_t)l * T + t) * B + b;
    float dh = dhl[(size_t)b * H + j];
    if (gl) dh += gl[(size_t)b * H + j];
    const float z = stash[lt * 4 * H + H + j];
    dh_out[(size_t)l * B * H + (size_t)b * H + j] = dh * z + out[i][0];
  }
}

cudaError_t launch_gru_bwd_step(int L, int T, int B, int H, int t,
                                const float* g, long long g_ls,
                                const float* stash, const float* h_prev,
                                long long hp_ls, const float* w_hhT,
                                const float* dh_in, float* dh_out,
                                float* dpx, float* dph, cudaStream_t s) {
  const size_t smem = smem_bytes<kBwdTB>(3, H);
  cudaError_t err = allow_smem(gru_bwd_step<kBwdTB>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((H + kTileN - 1) / kTileN, (B + kBwdTB - 1) / kBwdTB, L);
  gru_bwd_step<kBwdTB><<<grid, kThreads, smem, s>>>(
      T, B, H, t, g, g_ls, stash, h_prev, hp_ls, w_hhT, dh_in, dh_out, dpx,
      dph);
  return cudaGetLastError();
}

}  // namespace fader

// ids (L,T,B) int32; g: (L,B,H) final-state cotangent (seq_grad = 0) or
// (L,T,B,H) per-step cotangent (seq_grad = 1); stash (L,T,B,4H), h_seq
// (L,T,B,H), h0 (L,B,H) from the forward; w_hhT (L,3H,H) = w_hh
// transposed. Scratch: dh_buf (2,L,B,H), dpx / dph (L,T,B,3H). Outputs:
// dw_in (L,V,3H); db_in (L,3H) or null; dprez (L,B,3H) or null; dw_hh
// (L,H,3H); db_hh (L,3H); dh0 (L,B,H). T >= 1.
extern "C" int fader_embed_gru_bwd(int L, int T, int B, int H, int V,
                                   int seq_grad, const int* ids,
                                   const float* g, const float* stash,
                                   const float* h_seq, const float* h0,
                                   const float* w_hhT, float* dh_buf,
                                   float* dpx, float* dph, float* dw_in,
                                   float* db_in, float* dprez, float* dw_hh,
                                   float* db_hh, float* dh0, void* stream) {
  using namespace fader;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long BH = (long long)B * H, G = 3LL * H;
  cudaError_t err = cudaMemsetAsync(dh_buf, 0, BH * L * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  const float* dh_in = dh_buf;
  for (int t = T - 1; t >= 0; --t) {
    float* dh_out = (t == 0) ? dh0 : dh_buf + ((T - t) % 2) * BH * L;
    const float* g_t = seq_grad ? g + t * BH : (t == T - 1 ? g : nullptr);
    const long long g_ls = seq_grad ? T * BH : BH;
    const float* hp = t == 0 ? h0 : h_seq + (t - 1) * BH;
    const long long hp_ls = t == 0 ? BH : T * BH;
    err = launch_gru_bwd_step(L, T, B, H, t, g_t, g_ls, stash, hp, hp_ls,
                              w_hhT, dh_in, dh_out, dpx, dph, s);
    if (err != cudaSuccess) return (int)err;
    dh_in = dh_out;
  }
  const int R = T * B;
  if ((err = segment_rows(L, R, (int)G, V, ids, dpx, dw_in, s)) != cudaSuccess)
    return (int)err;
  if (db_in && (err = colsum(L, R, (int)G, dpx, db_in, s)) != cudaSuccess)
    return (int)err;
  if (dprez &&
      (err = sum_over_t(L, T, (int)(BH * 3), dpx, dprez, s)) != cudaSuccess)
    return (int)err;
  SplitRows hp{h0, BH, B, h_seq, T * BH, H};
  if ((err = gemm_tn(L, H, (int)G, R, hp, dph, R * G, dw_hh, H * G, s)) !=
      cudaSuccess)
    return (int)err;
  return (int)colsum(L, R, (int)G, dph, db_hh, s);
}
