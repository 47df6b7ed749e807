// Teacher-forced 2-layer GRU decoder with the cross-entropy head, forward.
//
// Replaces: music_fader_nets_tpu/ops/pallas_gru.py::_dec_fwd_ce_kernel
// with head="ce" (the forward of decoder_teacher_fused_nll, through
// _dec_nll_core), entry fader_decoder_ce.
//
// What it computes, for t < T (h2 = 0, h1 = h1_0):
//   layer 1: pre1 = w_tok[tok[t]] + pre_z ; h1' = gates(pre1, h1 @ w_hh1
//            + b_hh1, h1)
//   layer 2: h2p = h1' at t = 0 (the reference's step-0 rule,
//            pallas_gru.py:1520), else h2 ; h2' = gates(h1' @ w_ih2 + b_ih2,
//            h2p @ w_hh2 + b_hh2, h2p)
//   head   : logits = h2' @ w_out + b_out over Vp lanes (pads -1e30),
//            nll[t, b] = logsumexp(logits) - logits[tgt[t, b]]
// and writes h1_seq, h2_seq and the stashes [r, z, n, hn_h] of both layers
// (g41, g42) for the backward. The (T, B, V) log-probs never exist.
//
// What bounds it on an H100: float32 FMA. At T=100, B=128, H=512,
// Vp=384: 2 x 100 x 128 x (3 x 512 x 1536 + 512 x 384) = 65 GFLOP,
// 0.97 ms at 67 TFLOP/s.
//
// Design: two launches a step (layer 1 is the embedded-id training step of
// embed_gru.cu with pre_z as the per-sequence add; layer 2 multiplies its
// two 8-row A tiles, h1' and h2p, by its 32 columns of w_ih2 and w_hh2),
// 2T launches from one host call. Teacher forcing makes every step's h2'
// known once the recurrence ends, so the head is not in the loop: one
// launch over all T*B rows, 16 rows a block, computes each row's Vp logits
// (split-K tile, 32 lanes at a time) into shared memory and reduces them to
// the row's NLL there; only the NLL reaches device memory.
#include "gru_tile.cuh"
#include "train_ops.cuh"

namespace fader {

constexpr int kDecCeTB = 8;
constexpr int kHeadTB = 16;

template <int TB>
__global__ void __launch_bounds__(kThreads)
    dec_ce_layer2(int B, int H, const float* __restrict__ h1,
                  const float* __restrict__ h2_prev,
                  const float* __restrict__ w_ih2,
                  const float* __restrict__ b_ih2,
                  const float* __restrict__ w_hh2,
                  const float* __restrict__ b_hh2, float* __restrict__ h_out,
                  float* __restrict__ stash) {
  extern __shared__ float4 smem4[];
  float* sX = reinterpret_cast<float*>(smem4);
  float* sH = sX + (size_t)H * (TB + 4);
  float* red = sH + (size_t)H * (TB + 4);
  const int G = 3 * H;
  const int warp = threadIdx.x >> 5;
  const int j = blockIdx.x * kTileN + (threadIdx.x & 31);
  const int b0 = blockIdx.y * TB;

  load_a_tile<TB>(sX, h1, H, B, b0, H);
  load_a_tile<TB>(sH, h2_prev, H, B, b0, H);
  __syncthreads();
  float px[TB / kWarps][3], ph[TB / kWarps][3];
  {
    float acc[TB][3] = {};
    splitk_gemm<TB, 3>(acc, sX, H, w_ih2, G, H, j < H, j);
    splitk_reduce<TB, 3>(acc, px, red);
  }
  {
    float acc[TB][3] = {};
    splitk_gemm<TB, 3>(acc, sH, H, w_hh2, G, H, j < H, j);
    splitk_reduce<TB, 3>(acc, ph, red);
  }

  if (j >= H) return;
#pragma unroll
  for (int i = 0; i < TB / kWarps; ++i) {
    const int r = warp + kWarps * i;
    const int b = b0 + r;
    if (b >= B) continue;
    const float xr = __fadd_rn(px[i][0], b_ih2[j]);
    const float xz = __fadd_rn(px[i][1], b_ih2[H + j]);
    const float xn = __fadd_rn(px[i][2], b_ih2[2 * H + j]);
    const float hr = __fadd_rn(ph[i][0], b_hh2[j]);
    const float hz = __fadd_rn(ph[i][1], b_hh2[H + j]);
    const float hn = __fadd_rn(ph[i][2], b_hh2[2 * H + j]);
    float rg, zg, ng;
    h_out[(size_t)b * H + j] =
        gru_gates(xr, xz, xn, hr, hz, hn, sH[j * (TB + 4) + r], rg, zg, ng);
    if (stash != nullptr) {
      float* st = stash + (size_t)b * 4 * H;
      st[j] = rg;
      st[H + j] = zg;
      st[2 * H + j] = ng;
      st[3 * H + j] = hn;
    }
  }
}

// The CE head over R rows of h2 (16 a block). Forward (g null): nll[row] =
// lse - logit[tgt]. Backward (g given): dlogits[row, :] = (softmax - onehot
// (tgt)) * g[row] (pad lanes give exactly 0: exp(-1e30 - max) is 0).
template <int TB>
__global__ void __launch_bounds__(kThreads)
    ce_head(int R, int H, int Vp, const float* __restrict__ h2,
            const float* __restrict__ w_out, const float* __restrict__ b_out,
            const int* __restrict__ tgt, const float* __restrict__ g,
            float* __restrict__ nll, float* __restrict__ dlogits) {
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);
  float* red = sA + (size_t)H * (TB + 4);
  float* sL = red + (size_t)kWarps * TB * 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * TB;

  load_a_tile<TB>(sA, h2, H, R, r0, H);
  __syncthreads();
  for (int c0 = 0; c0 < Vp; c0 += kTileN) {
    const int j = c0 + lane;
    float out[TB / kWarps][1];
    {
      float acc[TB][1] = {};
      splitk_gemm<TB, 1>(acc, sA, H, w_out, Vp, 0, j < Vp, j);
      splitk_reduce<TB, 1>(acc, out, red);
    }
    if (j < Vp) {
#pragma unroll
      for (int i = 0; i < TB / kWarps; ++i)
        sL[(size_t)(warp + kWarps * i) * Vp + j] =
            __fadd_rn(out[i][0], b_out[j]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TB / kWarps; ++i) {
    const int r = warp + kWarps * i;
    const int row = r0 + r;
    if (row >= R) continue;
    const float* lg = sL + (size_t)r * Vp;
    float m = -3.4028235e38f;  // lowest float
    for (int c = lane; c < Vp; c += 32) m = fmaxf(m, lg[c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));
    float sum = 0.f;
    for (int c = lane; c < Vp; c += 32) sum += expf(lg[c] - m);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xFFFFFFFFu, sum, off);
    const float lse = m + logf(sum);
    const int tg = tgt[row];
    if (g == nullptr) {
      if (lane == 0)
        nll[row] = lse - ((tg >= 0 && tg < Vp) ? lg[tg] : 0.f);
    } else {
      const float gr = g[row];
      float* dl = dlogits + (size_t)row * Vp;
      for (int c = lane; c < Vp; c += 32)
        dl[c] = (expf(lg[c] - lse) - (c == tg ? 1.f : 0.f)) * gr;
    }
  }
}

cudaError_t launch_ce_head(int R, int H, int Vp, const float* h2,
                           const float* w_out, const float* b_out,
                           const int* tgt, const float* g, float* nll,
                           float* dlogits, cudaStream_t s) {
  const size_t smem =
      smem_bytes<kHeadTB>(1, H) + (size_t)kHeadTB * Vp * sizeof(float);
  cudaError_t err = allow_smem(ce_head<kHeadTB>, smem);
  if (err != cudaSuccess) return err;
  ce_head<kHeadTB><<<(R + kHeadTB - 1) / kHeadTB, kThreads, smem, s>>>(
      R, H, Vp, h2, w_out, b_out, tgt, g, nll, dlogits);
  return cudaGetLastError();
}

}  // namespace fader

// tok, tgt (T,B) int32 (tok[0] = the start id V-1); w_tok (Vp,3H); pre_z
// (B,3H) = z @ w_z + b_ih; w_hh1, w_ih2, w_hh2 (H,3H); b_hh1, b_ih2, b_hh2
// (3H); h1_0 (B,H); w_out (H,Vp); b_out (Vp), pad lanes -1e30. Outputs:
// h1_seq, h2_seq (T,B,H); g41, g42 (T,B,4H) or both null (no gradient);
// nll (T,B). 2T + 1 launches. T >= 1.
extern "C" int fader_decoder_ce(int T, int B, int H, int Vp, const int* tok,
                                const int* tgt, const float* w_tok,
                                const float* pre_z, const float* w_hh1,
                                const float* b_hh1, const float* w_ih2,
                                const float* b_ih2, const float* w_hh2,
                                const float* b_hh2, const float* h1_0,
                                const float* w_out, const float* b_out,
                                float* h1_seq, float* h2_seq, float* g41,
                                float* g42, float* nll, void* stream) {
  using namespace fader;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long BH = (long long)B * H, G = 3LL * H;
  const size_t smem2 = smem_bytes<kDecCeTB>(2, H);
  cudaError_t err = allow_smem(dec_ce_layer2<kDecCeTB>, smem2);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + kTileN - 1) / kTileN, (B + kDecCeTB - 1) / kDecCeTB);
  for (int t = 0; t < T; ++t) {
    const float* h1_prev = t == 0 ? h1_0 : h1_seq + (t - 1) * BH;
    err = launch_embed_train_step(1, T, B, H, Vp, t, tok, w_tok, pre_z,
                                  B * G, (int)G, w_hh1, b_hh1, h1_prev, 0,
                                  h1_seq, g41, s);
    if (err != cudaSuccess) return (int)err;
    const float* h1_new = h1_seq + t * BH;
    dec_ce_layer2<kDecCeTB><<<grid, kThreads, smem2, s>>>(
        B, H, h1_new, t == 0 ? h1_new : h2_seq + (t - 1) * BH, w_ih2, b_ih2,
        w_hh2, b_hh2, h2_seq + t * BH, g42 ? g42 + t * BH * 4 : nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)launch_ce_head(T * B, H, Vp, h2_seq, w_out, b_out, tgt,
                             nullptr, nll, nullptr, s);
}
