// Teacher-forced 2-layer GRU decoder, backward: without a head, with the
// cross-entropy head and with the masses head.
//
// Replaces: music_fader_nets_tpu/ops/pallas_gru.py::_dec_bwd_kernel :1304
// (the backward of decoder_teacher_fused :2269, from the cotangent of
// h2_seq, through the shared chain _dec_bwd_chain :1222; entry
// fader_decoder_teacher_bwd) and ::_dec_bwd_ce_kernel with head="ce" (the
// backward of decoder_teacher_fused_nll, through _dec_nll_core and the same
// chain; entry fader_decoder_ce_bwd) and with head = vocabulary ranges (the
// backward of decoder_teacher_fused_masses, through _dec_mask_core; entry
// fader_decoder_masses_bwd).
//
// What it computes, from the head's cotangent g (NLL: (T, B); masses:
// (T, K, B); no head: dh2_head = g (T, B, H) itself) and the forward's
// h1_seq, h2_seq and gate stashes g41, g42:
//   head   : CE:     dlogits = (softmax(h2 @ w_out + b_out) - onehot(tgt)) g
//            masses: dlogits = p * sum_k g_k (1[j in range k] - m_k)
//                    (pallas_gru.py:1672-1681)
//            dh2_head = dlogits @ w_out^T ; dW_out, db_out from dlogits
//   chains, t from T-1 down to 0 (dh1 = dh2 = 0):
//     layer 2: dh2 += dh2_head[t] ; (dpre2x, dpre2h) = gate_bwd(dh2, g42[t],
//              h2p(t)) ; dh2 = dh2 * z2 + dpre2h @ w_hh2^T
//     dh1 += dpre2x @ w_ih2^T, and at t = 0 also the layer-2 dh2 (its
//              h2p(0) was h1' : the reference's step-0 rule)
//     layer 1: (dpre1x, dpre1h) = gate_bwd(dh1, g41[t], h1_prev(t)) ;
//              dh1 = dh1 * z1 + dpre1h @ w_hh1^T
//   weights: dW_tok[v] = sum of dpre1x over rows whose input token is v
//            (with n_rep copies sharing B0 = B/n_rep token rows, dpre1x is
//            first folded over the copies, pallas_gru.py:1692-1701: each
//            token row's sum is then the same terms in another order);
//            dpre_z[b] = sum_t dpre1x[t, b]; dW_hh1 = h1_prev^T dpre1h;
//            dW_ih2 = h1_seq^T dpre2x; dW_hh2 = h2p^T dpre2h; the biases
//            are the column sums; dh1_0 = dh1.
//
// What bounds it on an H100: float32 FMA, ~2x the forward's 65 GFLOP
// (the chains' dh products, the weight-gradient GEMMs and the head's logits
// and dh2_head), ~2 ms at 67 TFLOP/s at T=100, B=128; the masses head at
// 512 rows 544 GFLOP, 8.1 ms; without a head 2 x 60.4 GFLOP, 1.8 ms.
//
// Design: the head runs first and batched over all T*B rows (ce_head or
// mass_head in decoder_ce.cu writes dlogits, then one hand-written GEMM
// gives dh2_head for every step; decoder_bwd_from_dlogits). All three
// entries share what follows (decoder_bwd_from_dh2): without a head the
// cotangent of h2_seq is dh2_head as it stands. The chains take three
// launches a step: the layer-2 step of embed_gru_bwd.cu (gate backward +
// dh2 @ w_hh2^T), rows_gemm_add (dh1 += dpre2x @ w_ih2^T), and the
// layer-1 step; each stashes its dpre
// rows, and grad_reduce.cu turns them into the weight gradients after the
// chain with deterministic GEMMs (split-K through scratch), scatter and
// sums.
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

// The two chains and the recurrence's weight gradients, from dh2_head
// (T, B, H), the cotangent of h2_seq. tok (T, B/n_rep) are the input ids of
// the B/n_rep distinct sequences; fold (T, B/n_rep, 3H) is scratch when
// n_rep > 1 (else unused).
cudaError_t decoder_bwd_from_dh2(
    int T, int B, int H, int Vp, int n_rep, const int* tok,
    const float* h1_seq, const float* h2_seq, const float* g41,
    const float* g42, const float* h1_0, const float* w_hh1T,
    const float* w_ih2T, const float* w_hh2T, const float* dh2_head,
    float* dh2_buf, float* dh1_carry, float* dh1_mid, float* s1x, float* s1h,
    float* s2x, float* s2h, float* fold, float* dw_tok, float* dpre_z,
    float* dw_hh1, float* db_hh1, float* dw_ih2, float* db_ih2,
    float* dw_hh2, float* db_hh2, float* dh1_0, float* red, cudaStream_t s) {
  const long long BH = (long long)B * H, G = 3LL * H;
  const int R = T * B;
  cudaError_t err;
  if ((err = cudaMemsetAsync(dh2_buf, 0, BH * sizeof(float), s)) !=
          cudaSuccess ||
      (err = cudaMemsetAsync(dh1_carry, 0, BH * sizeof(float), s)) !=
          cudaSuccess)
    return err;
  const size_t smem_add = smem_bytes<kAddTB>(3, H);
  if ((err = allow_smem(rows_gemm_add<kAddTB>, smem_add)) != cudaSuccess)
    return err;
  const dim3 grid_add((H + kTileN - 1) / kTileN, (B + kAddTB - 1) / kAddTB);
  for (int t = T - 1; t >= 0; --t) {
    const float* dh2_in = dh2_buf + ((T - 1 - t) % 2) * BH;
    float* dh2_out = dh2_buf + ((T - t) % 2) * BH;
    const float* h2p = t == 0 ? h1_seq : h2_seq + (t - 1) * BH;
    err = launch_gru_bwd_step(1, T, B, H, t, dh2_head + t * BH, 0, g42, h2p,
                              0, w_hh2T, dh2_in, dh2_out, s2x, s2h, s);
    if (err != cudaSuccess) return err;
    rows_gemm_add<kAddTB><<<grid_add, kThreads, smem_add, s>>>(
        B, H, (int)G, s2x + t * B * G, w_ih2T, dh1_carry,
        t == 0 ? dh2_out : nullptr, dh1_mid);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const float* h1p = t == 0 ? h1_0 : h1_seq + (t - 1) * BH;
    err = launch_gru_bwd_step(1, T, B, H, t, nullptr, 0, g41, h1p, 0,
                              w_hh1T, dh1_mid, t == 0 ? dh1_0 : dh1_carry,
                              s1x, s1h, s);
    if (err != cudaSuccess) return err;
  }
  // dW_tok: with n_rep copies, fold dpre1x over them first (sum_over_t
  // over the copy axis of s1x viewed as (T, n_rep, B0 * 3H)), then scatter
  // the T * B0 folded rows by their token
  const int B0 = B / n_rep;
  const float* tok_rows = s1x;
  if (n_rep > 1) {
    if ((err = sum_over_t(T, n_rep, (int)(B0 * G), s1x, fold, s)) !=
        cudaSuccess)
      return err;
    tok_rows = fold;
  }
  const SplitRows h1prev{h1_0, 0, B, h1_seq, 0, H};
  const SplitRows h1cur{nullptr, 0, 0, h1_seq, 0, H};
  const SplitRows h2prev{h1_seq, 0, B, h2_seq, 0, H};
  if ((err = segment_rows(1, T * B0, (int)G, Vp, tok, tok_rows, dw_tok, s)) ||
      (err = sum_over_t(1, T, (int)(B * G), s1x, dpre_z, s)) ||
      (err = gemm_tn(1, H, (int)G, R, h1prev, s1h, 0, dw_hh1, 0, red, s)) ||
      (err = colsum(1, R, (int)G, s1h, db_hh1, red, s)) ||
      (err = gemm_tn(1, H, (int)G, R, h1cur, s2x, 0, dw_ih2, 0, red, s)) ||
      (err = colsum(1, R, (int)G, s2x, db_ih2, red, s)) ||
      (err = gemm_tn(1, H, (int)G, R, h2prev, s2h, 0, dw_hh2, 0, red, s)) ||
      (err = colsum(1, R, (int)G, s2h, db_hh2, red, s)))
    return err;
  return cudaSuccess;
}

// Everything after a head, from its dlogits (T*B, Vp): dh2_head = dlogits @
// w_out^T, the shared chains and gradients, and the head's own dW_out,
// db_out.
cudaError_t decoder_bwd_from_dlogits(
    int T, int B, int H, int Vp, int n_rep, const int* tok,
    const float* h1_seq, const float* h2_seq, const float* g41,
    const float* g42, const float* h1_0, const float* w_hh1T,
    const float* w_ih2T, const float* w_hh2T, const float* w_outT,
    float* dlogits, float* dh2_head, float* dh2_buf, float* dh1_carry,
    float* dh1_mid, float* s1x, float* s1h, float* s2x, float* s2h,
    float* fold, float* dw_tok, float* dpre_z, float* dw_hh1,
    float* db_hh1, float* dw_ih2, float* db_ih2, float* dw_hh2,
    float* db_hh2, float* dh1_0, float* dw_out, float* db_out, float* red,
    cudaStream_t s) {
  const int R = T * B;
  cudaError_t err;
  if ((err = gemm_nn(R, H, Vp, dlogits, w_outT, dh2_head, s)) != cudaSuccess)
    return err;
  err = decoder_bwd_from_dh2(T, B, H, Vp, n_rep, tok, h1_seq, h2_seq, g41,
                             g42, h1_0, w_hh1T, w_ih2T, w_hh2T, dh2_head,
                             dh2_buf, dh1_carry, dh1_mid, s1x, s1h, s2x, s2h,
                             fold, dw_tok, dpre_z, dw_hh1, db_hh1, dw_ih2,
                             db_ih2, dw_hh2, db_hh2, dh1_0, red, s);
  if (err != cudaSuccess) return err;
  const SplitRows h2cur{nullptr, 0, 0, h2_seq, 0, H};
  if ((err = gemm_tn(1, H, Vp, R, h2cur, dlogits, 0, dw_out, 0, red, s)) ||
      (err = colsum(1, R, Vp, dlogits, db_out, red, s)))
    return err;
  return cudaSuccess;
}

}  // namespace fader

// Floats of scratch the three backward entries need at these sizes on the
// current device: the split-K partial tiles of the weight-gradient GEMMs
// ((H, 3H) and, with a head, (H, Vp), over T*B rows) and the column sums'
// partials, one after the other through the same buffer.
extern "C" long long fader_decoder_bwd_scratch_floats(int T, int B, int H,
                                                      int Vp) {
  const long long a = fader::reduce_scratch_floats(1, H, 3 * H, T * B);
  const long long b = fader::reduce_scratch_floats(1, H, Vp, T * B);
  return a > b ? a : b;
}

// The arguments common to the entries, after their head's own: h1_seq,
// h2_seq (T,B,H), g41, g42 (T,B,4H) from the forward; h1_0 (B,H); w_hh1T,
// w_ih2T, w_hh2T (3H,H) the transposed weights; w_out (H,Vp), b_out (Vp),
// w_outT (Vp,H). Scratch: dlogits (T,B,Vp); dh2_head (T,B,H); dh2_buf
// (2,B,H); dh1_carry, dh1_mid (B,H); s1x, s1h, s2x, s2h (T,B,3H); after
// the outputs, scratch with scratch_floats >=
// fader_decoder_bwd_scratch_floats(T,B,H,Vp) floats. Outputs:
// dw_tok (Vp,3H); dpre_z (B,3H); dw_hh1, dw_ih2, dw_hh2 (H,3H); db_hh1,
// db_ih2, db_hh2 (3H); dh1_0 (B,H); dw_out (H,Vp); db_out (Vp). T >= 1.
//
// CE head: tok, tgt (T,B) int32; g (T,B) the NLL cotangent.
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
    float* dh1_0, float* dw_out, float* db_out, float* scratch,
    long long scratch_floats, void* stream) {
  using namespace fader;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scratch_floats < fader_decoder_bwd_scratch_floats(T, B, H, Vp))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_ce_head(T * B, H, Vp, h2_seq, w_out, b_out, tgt,
                                   g, nullptr, dlogits, s);
  if (err != cudaSuccess) return (int)err;
  return (int)decoder_bwd_from_dlogits(
      T, B, H, Vp, 1, tok, h1_seq, h2_seq, g41, g42, h1_0, w_hh1T, w_ih2T,
      w_hh2T, w_outT, dlogits, dh2_head, dh2_buf, dh1_carry, dh1_mid, s1x,
      s1h, s2x, s2h, nullptr, dw_tok, dpre_z, dw_hh1, db_hh1, dw_ih2, db_ih2,
      dw_hh2, db_hh2, dh1_0, dw_out, db_out, scratch, s);
}

// Masses head: K ranges as 2K ints in host memory; n_rep copies (B =
// n_rep * B0 rows); tok (T,B0) int32, the input ids of the B0 distinct
// sequences; g (T,K,B) the masses' cotangent; scratch fold (T,B0,3H) when
// n_rep > 1, else null.
extern "C" int fader_decoder_masses_bwd(
    int T, int B, int H, int Vp, int n_rep, int K, const int* ranges,
    const int* tok, const float* g, const float* h1_seq, const float* h2_seq,
    const float* g41, const float* g42, const float* h1_0,
    const float* w_hh1T, const float* w_ih2T, const float* w_hh2T,
    const float* w_out, const float* b_out, const float* w_outT,
    float* dlogits, float* dh2_head, float* dh2_buf, float* dh1_carry,
    float* dh1_mid, float* s1x, float* s1h, float* s2x, float* s2h,
    float* fold, float* dw_tok, float* dpre_z, float* dw_hh1,
    float* db_hh1, float* dw_ih2, float* db_ih2, float* dw_hh2,
    float* db_hh2, float* dh1_0, float* dw_out, float* db_out,
    float* scratch, long long scratch_floats, void* stream) {
  using namespace fader;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MassRanges rg;
  if (!make_ranges(K, ranges, &rg) || n_rep < 1 || B % n_rep != 0 ||
      (n_rep > 1 && fold == nullptr) ||
      scratch_floats < fader_decoder_bwd_scratch_floats(T, B, H, Vp))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_mass_head(T * B, B, H, Vp, rg, h2_seq, w_out,
                                     b_out, g, nullptr, dlogits, s);
  if (err != cudaSuccess) return (int)err;
  return (int)decoder_bwd_from_dlogits(
      T, B, H, Vp, n_rep, tok, h1_seq, h2_seq, g41, g42, h1_0, w_hh1T,
      w_ih2T, w_hh2T, w_outT, dlogits, dh2_head, dh2_buf, dh1_carry,
      dh1_mid, s1x, s1h, s2x, s2h, fold, dw_tok, dpre_z, dw_hh1, db_hh1,
      dw_ih2, db_ih2, dw_hh2, db_hh2, dh1_0, dw_out, db_out, scratch, s);
}

// No head (kernel 8): g2 (T,B,H) is the cotangent of h2_seq, read as
// dh2_head; tok (T,B) int32. No dlogits, dh2_head scratch, w_out or its
// gradients. 3T + 8 launches.
extern "C" int fader_decoder_teacher_bwd(
    int T, int B, int H, int Vp, const int* tok, const float* g2,
    const float* h1_seq, const float* h2_seq, const float* g41,
    const float* g42, const float* h1_0, const float* w_hh1T,
    const float* w_ih2T, const float* w_hh2T, float* dh2_buf,
    float* dh1_carry, float* dh1_mid, float* s1x, float* s1h, float* s2x,
    float* s2h, float* dw_tok, float* dpre_z, float* dw_hh1, float* db_hh1,
    float* dw_ih2, float* db_ih2, float* dw_hh2, float* db_hh2,
    float* dh1_0, float* scratch, long long scratch_floats, void* stream) {
  using namespace fader;
  if (scratch_floats < fader_decoder_bwd_scratch_floats(T, B, H, Vp))
    return (int)cudaErrorInvalidValue;
  return (int)decoder_bwd_from_dh2(
      T, B, H, Vp, 1, tok, h1_seq, h2_seq, g41, g42, h1_0, w_hh1T, w_ih2T,
      w_hh2T, g2, dh2_buf, dh1_carry, dh1_mid, s1x, s1h, s2x, s2h, nullptr,
      dw_tok, dpre_z, dw_hh1, db_hh1, dw_ih2, db_ih2, dw_hh2, db_hh2, dh1_0,
      scratch, static_cast<cudaStream_t>(stream));
}
