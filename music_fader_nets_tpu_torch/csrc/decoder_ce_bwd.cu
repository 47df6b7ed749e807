// Teacher-forced 2-layer GRU decoder with the cross-entropy head, backward.
//
// Replaces: music_fader_nets_tpu/ops/pallas_gru.py::_dec_bwd_ce_kernel
// with head="ce" (the backward of decoder_teacher_fused_nll, through
// _dec_nll_core and the shared chain _dec_bwd_chain :1222), entry
// fader_decoder_ce_bwd.
//
// What it computes, from the NLL cotangent g (T, B) and the forward's
// h1_seq, h2_seq and gate stashes g41, g42:
//   head   : dlogits = (softmax(h2 @ w_out + b_out) - onehot(tgt)) * g ;
//            dh2_head = dlogits @ w_out^T ; dW_out, db_out from dlogits
//   chains, t from T-1 down to 0 (dh1 = dh2 = 0):
//     layer 2: dh2 += dh2_head[t] ; (dpre2x, dpre2h) = gate_bwd(dh2, g42[t],
//              h2p(t)) ; dh2 = dh2 * z2 + dpre2h @ w_hh2^T
//     dh1 += dpre2x @ w_ih2^T, and at t = 0 also the layer-2 dh2 (its
//              h2p(0) was h1' : the reference's step-0 rule)
//     layer 1: (dpre1x, dpre1h) = gate_bwd(dh1, g41[t], h1_prev(t)) ;
//              dh1 = dh1 * z1 + dpre1h @ w_hh1^T
//   weights: dW_tok[v] = sum of dpre1x over rows whose input token is v;
//            dpre_z[b] = sum_t dpre1x[t, b]; dW_hh1 = h1_prev^T dpre1h;
//            dW_ih2 = h1_seq^T dpre2x; dW_hh2 = h2p^T dpre2h; the biases
//            are the column sums; dh1_0 = dh1.
//
// What bounds it on an H100: float32 FMA, ~2x the forward's 65 GFLOP
// (the chains' dh products, the weight-gradient GEMMs and the head's logits
// and dh2_head), ~2 ms at 67 TFLOP/s at T=100, B=128.
//
// Design: the head runs first and batched over all T*B rows (ce_head in
// decoder_ce.cu writes dlogits, then one hand-written GEMM gives dh2_head
// for every step). The chains then take three launches a step: the layer-2
// step of embed_gru_bwd.cu (gate backward + dh2 @ w_hh2^T), rows_gemm_add
// (dh1 += dpre2x @ w_ih2^T), and the layer-1 step; each stashes its dpre
// rows, and grad_reduce.cu turns them into the weight gradients after the
// chain with deterministic GEMMs, scatter and sums.
#include "gru_tile.cuh"
#include "train_ops.cuh"

namespace fader {

constexpr int kAddTB = 8;

// out[b, j] = add1[b, j] + A[b, :] @ W[:, j] (+ add2[b, j] when given);
// A (B, K) rows, W (K, H).
template <int TB>
__global__ void __launch_bounds__(kThreads, 2)
    rows_gemm_add(int B, int H, int K, const float* __restrict__ A,
                  const float* __restrict__ W,
                  const float* __restrict__ add1,
                  const float* __restrict__ add2, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);
  float* red = sA + (size_t)K * (TB + 4);
  const int warp = threadIdx.x >> 5;
  const int j = blockIdx.x * kTileN + (threadIdx.x & 31);
  const int b0 = blockIdx.y * TB;

  load_a_tile<TB>(sA, A, K, B, b0, K);
  __syncthreads();
  float acc[TB][1] = {};
  splitk_gemm<TB, 1>(acc, sA, K, W, H, 0, j < H, j);
  float o[TB / kWarps][1];
  splitk_reduce<TB, 1>(acc, o, red);
  if (j >= H) return;
#pragma unroll
  for (int i = 0; i < TB / kWarps; ++i) {
    const int b = b0 + warp + kWarps * i;
    if (b >= B) continue;
    const size_t at = (size_t)b * H + j;
    float v = add1[at] + o[i][0];
    if (add2 != nullptr) v += add2[at];
    out[at] = v;
  }
}

}  // namespace fader

// tok, tgt (T,B) int32; g (T,B) the NLL cotangent; h1_seq, h2_seq (T,B,H),
// g41, g42 (T,B,4H) from fader_decoder_ce; h1_0 (B,H); w_hh1T, w_ih2T,
// w_hh2T (3H,H) the transposed weights; w_out (H,Vp), b_out (Vp), w_outT
// (Vp,H). Scratch: dlogits (T,B,Vp); dh2_head (T,B,H); dh2_buf (2,B,H);
// dh1_carry, dh1_mid (B,H); s1x, s1h, s2x, s2h (T,B,3H). Outputs: dw_tok
// (Vp,3H); dpre_z (B,3H); dw_hh1, dw_ih2, dw_hh2 (H,3H); db_hh1, db_ih2,
// db_hh2 (3H); dh1_0 (B,H); dw_out (H,Vp); db_out (Vp). T >= 1.
extern "C" int fader_decoder_ce_bwd(
    int T, int B, int H, int Vp, const int* tok, const int* tgt,
    const float* g, const float* h1_seq, const float* h2_seq,
    const float* g41, const float* g42, const float* h1_0,
    const float* w_hh1T, const float* w_ih2T, const float* w_hh2T,
    const float* w_out, const float* b_out, const float* w_outT,
    float* dlogits, float* dh2_head, float* dh2_buf, float* dh1_carry,
    float* dh1_mid, float* s1x, float* s1h, float* s2x, float* s2h,
    float* dw_tok, float* dpre_z, float* dw_hh1, float* db_hh1,
    float* dw_ih2, float* db_ih2, float* dw_hh2, float* db_hh2,
    float* dh1_0, float* dw_out, float* db_out, void* stream) {
  using namespace fader;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long BH = (long long)B * H, G = 3LL * H;
  const int R = T * B;
  cudaError_t err;
  if ((err = launch_ce_head(R, H, Vp, h2_seq, w_out, b_out, tgt, g, nullptr,
                            dlogits, s)) != cudaSuccess ||
      (err = gemm_nn(R, H, Vp, dlogits, w_outT, dh2_head, s)) != cudaSuccess)
    return (int)err;
  if ((err = cudaMemsetAsync(dh2_buf, 0, BH * sizeof(float), s)) !=
          cudaSuccess ||
      (err = cudaMemsetAsync(dh1_carry, 0, BH * sizeof(float), s)) !=
          cudaSuccess)
    return (int)err;
  const size_t smem_add = smem_bytes<kAddTB>(3, H);
  if ((err = allow_smem(rows_gemm_add<kAddTB>, smem_add)) != cudaSuccess)
    return (int)err;
  const dim3 grid_add((H + kTileN - 1) / kTileN, (B + kAddTB - 1) / kAddTB);
  for (int t = T - 1; t >= 0; --t) {
    const float* dh2_in = dh2_buf + ((T - 1 - t) % 2) * BH;
    float* dh2_out = dh2_buf + ((T - t) % 2) * BH;
    const float* h2p = t == 0 ? h1_seq : h2_seq + (t - 1) * BH;
    err = launch_gru_bwd_step(1, T, B, H, t, dh2_head + t * BH, 0, g42, h2p,
                              0, w_hh2T, dh2_in, dh2_out, s2x, s2h, s);
    if (err != cudaSuccess) return (int)err;
    rows_gemm_add<kAddTB><<<grid_add, kThreads, smem_add, s>>>(
        B, H, (int)G, s2x + t * B * G, w_ih2T, dh1_carry,
        t == 0 ? dh2_out : nullptr, dh1_mid);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const float* h1p = t == 0 ? h1_0 : h1_seq + (t - 1) * BH;
    err = launch_gru_bwd_step(1, T, B, H, t, nullptr, 0, g41, h1p, 0,
                              w_hh1T, dh1_mid, t == 0 ? dh1_0 : dh1_carry,
                              s1x, s1h, s);
    if (err != cudaSuccess) return (int)err;
  }
  const SplitRows h1prev{h1_0, 0, B, h1_seq, 0, H};
  const SplitRows h1cur{nullptr, 0, 0, h1_seq, 0, H};
  const SplitRows h2prev{h1_seq, 0, B, h2_seq, 0, H};
  const SplitRows h2cur{nullptr, 0, 0, h2_seq, 0, H};
  if ((err = segment_rows(1, R, (int)G, Vp, tok, s1x, dw_tok, s)) ||
      (err = sum_over_t(1, T, (int)(B * G), s1x, dpre_z, s)) ||
      (err = gemm_tn(1, H, (int)G, R, h1prev, s1h, 0, dw_hh1, 0, s)) ||
      (err = colsum(1, R, (int)G, s1h, db_hh1, s)) ||
      (err = gemm_tn(1, H, (int)G, R, h1cur, s2x, 0, dw_ih2, 0, s)) ||
      (err = colsum(1, R, (int)G, s2x, db_ih2, s)) ||
      (err = gemm_tn(1, H, (int)G, R, h2prev, s2h, 0, dw_hh2, 0, s)) ||
      (err = colsum(1, R, (int)G, s2h, db_hh2, s)) ||
      (err = gemm_tn(1, H, Vp, R, h2cur, dlogits, 0, dw_out, 0, s)) ||
      (err = colsum(1, R, Vp, dlogits, db_out, s)))
    return (int)err;
  return (int)cudaSuccess;
}
